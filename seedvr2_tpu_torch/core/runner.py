"""VideoDiffusionRunner: the inference engine around the DiT and the VAE.

Port of seedvr2_tpu.core.runner: VAE encode/decode with the latent
scale/shift, spatial tiling (uniform grid or the reference's stride sweep;
tile_size "auto" resolved per item shape by memory probes run on the card,
utils/memplan.py) and the out-of-memory retry, the sr / t2v / i2v
conditions, the timestep transform, and the plain denoise (condition concat
-> NaDiT -> optional CFG -> Euler endpoint). DiT plans are built once per
(latent shape, text length) and their tables uploaded once. Memory tiering
(core/model_manager.py decides it): a `streamed_dit`
(ops.offload.StreamedNaDiT) streams the DiT's blocks from pinned host
memory, and per-phase offload (`set_phase_offload`) keeps the DiT in pinned
host memory through the VAE phases (`release_dit`, which the pipeline calls
at the entry of encode and decode) and restores it at the entry of
`inference` (`ensure_dit_resident`).

Serving parallelism (`attach_mesh`, parallel/mesh.py): one process a
device, every rank running the same calls on the same inputs. The VAE
phases' items go one a rank over every rank of the mesh (dp x tp: the VAE
has no tensor parallelism), in waves, or the tiled VAE's tiles do; the DiT
phase's items go one a dp group; each wave's results are then shared with
every rank in input order (parallel/comm.spread). Each item runs alone, as
at world size 1, so dp is bit-equal to one rank. Whether and how a VAE
item tiles is agreed by every rank before either branch is taken (each
rank plans alone: its own memory probes and OOM shrinks), and a wave's
failure is agreed before its results are shared, so an OOM retry runs on
every rank alike. Under tp the DiT's blocks are this rank's shard
(parallel/tp.py) and its forward sums the row-sharded projections over the
tp ranks.
"""

import logging
import time
import warnings
from dataclasses import dataclass, replace
from functools import partial
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..models.dit.nadit import (DevicePlan, NaDiT, build_dit_plan,
                                nadit_forward, upload_plan)
from ..models.vae.pipeline_vae import TILE_MODES, VideoVAE
from ..ops.attention import resolve_attention_mode
from ..ops.offload import HostCopy, StreamedNaDiT
from ..parallel.comm import agree_max, spread, tp_reducer, wave_width
from ..parallel.mesh import Mesh
from ..utils import memplan
from ..utils.dtypes import COMPUTE_DTYPE
from . import diffusion
from .configs import RunnerConfig


log = logging.getLogger(__name__)


@dataclass(frozen=True)
class VAETiling:
    """The VAE's spatial tiling settings (pixel sizes, (h, w) pairs), the
    JAX runner's encode_/decode_ tile arguments. A tile size may be "auto":
    the runner picks the fewest-tiles grid that fits the card, per item
    shape (utils/memplan.py). tile_mode "uniform" is the even same-shape
    grid, "ref" the reference's stride sweep."""

    encode_tiled: bool = False
    encode_tile_size: Tuple[int, int] = (512, 512)
    encode_tile_overlap: Tuple[int, int] = (64, 64)
    decode_tiled: bool = False
    decode_tile_size: Tuple[int, int] = (512, 512)
    decode_tile_overlap: Tuple[int, int] = (64, 64)
    tile_mode: str = "uniform"

    def __post_init__(self):
        for kind in ("encode", "decode"):
            for what in ("tile_size", "tile_overlap"):
                v = getattr(self, f"{kind}_{what}")
                if what == "tile_size" and v == "auto":
                    continue
                if (not isinstance(v, tuple) or len(v) != 2
                        or not all(isinstance(i, int) for i in v)):
                    also = ' or "auto"' if what == "tile_size" else ""
                    raise ValueError(f"{kind}_{what} must be an (h, w) pair "
                                     f"of ints{also}, got {v!r}")
        if self.tile_mode not in TILE_MODES:
            raise ValueError(f"tile_mode must be one of {TILE_MODES}, got "
                             f"{self.tile_mode!r}")


class VideoDiffusionRunner:
    # an OOM retry shrinks tiles x0.7 a side down to this many px
    _MIN_TILE = 256

    def __init__(self, dit: Optional[NaDiT], vae: VideoVAE,
                 config: RunnerConfig = RunnerConfig(),
                 compute_dtype=COMPUTE_DTYPE,
                 tiling: VAETiling = VAETiling(),
                 streamed_dit: Optional[StreamedNaDiT] = None,
                 device=None, attention_mode: str = "flash"):
        """dit: the NaDiT, None when `streamed_dit` (the host-streamed DiT,
        whose model it serves) is given. device: where the runner computes;
        by default the streamed DiT's device, else where the DiT's
        parameters are (give it when the DiT starts in host memory, as a
        phase-offloaded one does). attention_mode: "flash" (the kernels) or
        "xla" (the SDPA lane), or an alias (ops.attention), handed to every
        DiT forward."""
        self.tiling = tiling
        self.attention_mode = resolve_attention_mode(attention_mode)
        self.streamed_dit = streamed_dit
        self.dit = streamed_dit.model if streamed_dit is not None else dit
        self.dit_cfg = self.dit.cfg
        self.vae = vae
        self.config = config
        self.compute_dtype = compute_dtype
        if device is not None:
            self.device = torch.device(device)
        elif streamed_dit is not None:
            self.device = streamed_dit.device
        else:
            self.device = next(self.dit.parameters()).device
        # per-phase offload: the DiT's pinned host copy (set_phase_offload)
        self.phase_offload = False
        self._host_dit: Optional[HostCopy] = None
        # seconds of each restore of a phase-offloaded DiT to the device
        self.restore_seconds: List[float] = []
        self.schedule = diffusion.LerpSchedule(config.diffusion.schedule_T)
        self._plans: Dict[Tuple, DevicePlan] = {}
        # resolved plans of an "auto" tile size, by (kind, item shape):
        # (tiled, tile_size px)
        self._auto_tile_cache: Dict[tuple, tuple] = {}
        # device out-of-memory errors the VAE phases caught and retried
        self.oom_retries = 0
        # serving parallelism (attach_mesh): the mesh, and the DiT's
        # tensor-parallel reduce when its blocks are sharded
        self.mesh: Optional[Mesh] = None
        self.tp: Optional[Callable] = None
        # the DiT calls' batch sizes on this rank (tests read the dp spread)
        self.last_batch_sizes: List[int] = []

    # ------------------------------------------------- phase model offload

    def set_phase_offload(self, host_copy: Optional[HostCopy] = None):
        """Engage per-phase DiT offload (the reference's manage_model_device,
        memory_manager.py:573-930): the DiT's weights leave the device
        during the VAE phases so the VAE's workspace fits, and come back at
        phase-2 entry from one pinned host copy made once (here, or given:
        runners built on one cached DiT share its copy). Engaged by
        configure_runner when the resident DiT would crowd out the VAE.
        The DiT is released at once."""
        self._host_dit = host_copy or HostCopy(self.dit, self.device)
        self._host_dit.release()
        self.phase_offload = True

    def ensure_dit_resident(self):
        """Restore a phase-offloaded DiT to the device (one non_blocking
        copy, one synchronise), timed into restore_seconds."""
        if self.phase_offload and not self._host_dit.resident:
            t0 = time.perf_counter()
            self._host_dit.restore()
            self.restore_seconds.append(time.perf_counter() - t0)
            log.info("DiT restored to the device in %.3f s",
                     self.restore_seconds[-1])

    @staticmethod
    def _warn_no_tp(tp: int):
        warnings.warn(
            f"tensor parallelism requested (tp={tp}) but the DiT weight "
            f"layout/dims do not shard that many ways — serving replicated "
            f"instead", stacklevel=3)

    def attach_mesh(self, mesh: Mesh):
        """Serve over a mesh (parallel/mesh.make_mesh; every rank of it
        calls this). The VAE phases spread their items, or the tiled VAE
        its tiles, over every rank; the DiT phase its items over the dp
        axis. With a tp axis > 1 and a DiT whose layout shards that many
        ways (any serving layout, tp.tp_compatible) the DiT serves
        tensor-parallel: this rank keeps its heads and mlp hidden columns
        (tp.tp_shard_dit) and the forward sums the row-sharded projections
        over the tp ranks in fp32. A phase-offloaded DiT is sharded in its
        host copy, so each restore brings back this rank's shard. Otherwise
        the DiT stays whole on every rank, with JAX's warnings: a layout
        that does not divide (resident or phase-offloaded), and a streamed
        DiT (blocks do not shard: each rank streams its own whole blocks,
        and its batches still spread over dp)."""
        from ..parallel.tp import tp_compatible, tp_shard_dit

        self.mesh = mesh
        self.tp = None
        tp = mesh.shape.get("tp", 1)
        if tp > 1:
            if self.streamed_dit is not None:
                warnings.warn(
                    f"tensor parallelism (tp={tp}) does not compose with "
                    f"host block streaming — blocks replicate; pass a "
                    f"tensor_parallel that makes the model fit the card "
                    f"(configure_runner plans per-card bytes) or drop "
                    f"--blocks_to_swap", stacklevel=2)
            elif not tp_compatible(self.dit, tp, self.device):
                self._warn_no_tp(tp)
            else:
                tp_shard_dit(self.dit, mesh)
                if self.phase_offload:
                    # the shard replaces the whole model in the host copy
                    self._host_dit = HostCopy(self.dit, self.device)
                    self._host_dit.release()
                self.tp = tp_reducer(mesh)

    def release_dit(self):
        """Let a phase-offloaded DiT's device storage go (its module's
        tensors point at the pinned host copy). No-op unless phase offload
        is engaged."""
        if self.phase_offload:
            self._host_dit.release()

    # ----------------------------------------------------------------- vae

    def _auto_tile_budget(self) -> Optional[int]:
        """Device bytes a VAE call may still take: the card's limit (its
        total memory scaled by the per-process memory fraction) less what
        the caching allocator holds once its cache is emptied, so what
        stays resident through the call (the VAE, the call's input and the
        DiT: none of it once release_dit() let a phase-offloaded DiT go,
        only the IO parameters, kept blocks and two slots of a streamed
        one; this rank's shard under tensor parallelism, the per-card bytes
        JAX's budget counts) is counted once, as it stands, with the free
        space stuck in segments that live tensors hold (the limit applies
        to reserved memory). None on a device with no memory model (the
        CPU)."""
        if self.device.type != "cuda":
            return None
        torch.cuda.empty_cache()
        return (memplan.memory_limit(self.device)
                - torch.cuda.memory_reserved(self.device))

    def _resolve_tile(self, kind: str, item: torch.Tensor):
        """(tiled, tile_size px) for one item of a VAE phase: the tiling's
        own unless its tile size is "auto", which is planned once per
        (kind, item shape) by memory probes on the card (JAX's
        _resolve_tile). item: (T, H, W, 3) for encode, (Tl, h, w, C) for
        decode. Without a budget (the CPU) "auto" serves the fixed
        1024 px default, as in JAX."""
        tiled = getattr(self.tiling, f"{kind}_tiled")
        tile_size = getattr(self.tiling, f"{kind}_tile_size")
        if tile_size != "auto":
            return tiled, tile_size
        key = (kind, tuple(item.shape))
        hit = self._auto_tile_cache.get(key)
        if hit is not None:
            return hit
        vcfg = self.vae.cfg
        sf, tdf = vcfg.spatial_downsample_factor, vcfg.temporal_downsample_factor
        if kind == "decode":
            h, w = item.shape[1], item.shape[2]
            frames_px = (item.shape[0] - 1) * tdf + 1
        else:
            frames_px = item.shape[0]
            h, w = -(-item.shape[1] // sf), -(-item.shape[2] // sf)
        budget = self._auto_tile_budget()
        if budget is None:
            resolved = (tiled, (1024, 1024))
            log.info("auto tile %s: no device memory limit; using the "
                     "1024 px default", kind)
        else:
            plan = memplan.plan_auto_tile(
                self.vae, kind, (h, w), 1, frames_px,
                getattr(self.tiling, f"{kind}_tile_overlap"), budget)
            resolved = (False, (1024, 1024)) if plan is None else (True, plan)
            log.info("auto tile %s %s: resolved to %s (budget %.1f GB)", kind,
                     tuple(item.shape), "untiled" if plan is None else plan,
                     budget / 1e9)
        self._auto_tile_cache[key] = resolved
        return resolved

    def _tile_plans(self, kind: str, items: List[torch.Tensor]) -> list:
        """(tiled, tile_size px) for each item of a VAE phase, agreed by
        every rank of the mesh, since each rank plans alone (its own "auto"
        probes and OOM shrinks): tiled where any rank tiles, at the
        smallest tile size any rank asks. Without a mesh, this rank's
        plans."""
        plans = [self._resolve_tile(kind, x) for x in items]
        if wave_width(self.mesh) == 1:
            return plans
        flat = agree_max([v for tiled, (th, tw) in plans
                          for v in (int(tiled), -th, -tw)],
                         self.mesh, self.device)
        return [(bool(flat[i]), (-flat[i + 1], -flat[i + 2]))
                for i in range(0, len(flat), 3)]

    def _vae_call_with_oom_retry(self, kind: str, run_one,
                                 item: torch.Tensor, plan: tuple,
                                 mesh: Optional[Mesh]):
        """run_one(tiled, tile_size, mesh) for a VAE phase
        ("encode"/"decode") on `item` under its tile plan (tiled,
        tile_size), resilient to device out-of-memory as in the JAX
        runner: on torch.cuda.OutOfMemoryError first engage tiling, then
        shrink the tile (x0.7 a side, in 64 px steps, floor 256 px) until it
        fits. The shrink sticks: under an "auto" tile size in the item
        shape's plan, else in the runner's tiling. mesh: the ranks that
        share the item's tiles (None: every tile here); they start from one
        agreed plan and the tile waves agree each OOM, so every rank
        retries alike. Any other exception passes through."""
        auto = getattr(self.tiling, f"{kind}_tile_size") == "auto"
        tiled, tile_size = plan
        if auto and self.device.type == "cuda":
            # the plan's probes ran from an empty allocator cache; start
            # the call there too, so earlier phases' cached blocks do not
            # fragment what the plan counted on
            torch.cuda.empty_cache()
        for _ in range(8):
            try:
                return run_one(tiled, tile_size, mesh)
            except torch.cuda.OutOfMemoryError:
                if tiled and min(tile_size) <= self._MIN_TILE:
                    raise
            # outside the except block the failed call's tensors are freed
            self.oom_retries += 1
            torch.cuda.empty_cache()
            if tiled:
                tile_size = tuple(max(self._MIN_TILE, int(t * 0.7) // 64 * 64)
                                  for t in tile_size)
            tiled = True
            log.warning("device OOM during VAE %s; retrying tiled %s", kind,
                        tile_size)
            if auto:
                self._auto_tile_cache[(kind, tuple(item.shape))] = (
                    tiled, tile_size)
            else:
                self.tiling = replace(self.tiling, **{
                    f"{kind}_tiled": tiled, f"{kind}_tile_size": tile_size})
        raise RuntimeError(f"VAE {kind} kept running out of memory down to "
                           f"{tile_size}")

    def _vae_waves(self, kind: str, items: List[torch.Tensor],
                   run_one: Callable) -> List[torch.Tensor]:
        """run_one(item, tiled, tile_size, mesh) for a VAE phase's items
        under their agreed plans (_tile_plans), with the OOM retry. When no
        plan tiles, the items spread one a rank over every rank of the mesh
        (JAX's _batched_waves: the VAE has no tensor parallelism, so the tp
        ranks take items too), each computed here alone (an OOM retry
        tiles it here); otherwise the items run in turn and their tiles
        spread over the mesh."""
        plans = self._tile_plans(kind, items)
        if not any(tiled for tiled, _ in plans):
            return list(spread(
                range(len(items)), lambda i: self._vae_call_with_oom_retry(
                    kind, partial(run_one, items[i]), items[i], plans[i],
                    None),
                self.mesh, None, self.device))
        return [self._vae_call_with_oom_retry(kind, partial(run_one, x), x,
                                              plan, self.mesh)
                for x, plan in zip(items, plans)]

    @torch.no_grad()
    def vae_encode(self, samples: List[torch.Tensor]) -> List[torch.Tensor]:
        """samples: (T, H, W, 3) in [-1, 1] -> latents (Tl, h, w, 16) scaled
        by the VAE scaling factor; spread over the mesh (_vae_waves)."""
        scale = self.config.vae.scaling_factor
        shift = self.config.vae.shifting_factor

        def one(x, tiled, ts, mesh):
            lat = self.vae.encode(
                x[None], tiled=tiled, tile_size=ts,
                tile_overlap=self.tiling.encode_tile_overlap,
                tile_mode=self.tiling.tile_mode, mesh=mesh)[0]
            return ((lat.float() - shift) * scale).to(self.compute_dtype)

        return self._vae_waves("encode", samples, one)

    @torch.no_grad()
    def vae_decode(self, latents: List[torch.Tensor]) -> List[torch.Tensor]:
        """latents (Tl, h, w, 16) -> samples (T, H, W, 3) in the VAE's
        dtype; spread over the mesh (_vae_waves)."""
        scale = self.config.vae.scaling_factor
        shift = self.config.vae.shifting_factor
        zs = [(lat.float() / scale + shift).to(self.vae.dtype)
              for lat in latents]

        def one(z, tiled, ts, mesh):
            return self.vae.decode(
                z[None], tiled=tiled, tile_size=ts,
                tile_overlap=self.tiling.decode_tile_overlap,
                tile_mode=self.tiling.tile_mode, mesh=mesh)[0]

        return self._vae_waves("decode", zs, one)

    # ----------------------------------------------------------- condition

    @staticmethod
    def get_condition(noise: torch.Tensor, latent_blur: torch.Tensor,
                      task: str = "sr") -> torch.Tensor:
        """The DiT's condition channels for (Tl, h, w, C) latents. sr:
        [latent_blur | 1]; t2v: zeros; i2v: zeros but for the first latent
        frame, [noise | 1]."""
        mask = torch.ones((*noise.shape[:-1], 1), dtype=noise.dtype,
                          device=noise.device)
        if task == "sr":
            return torch.cat([latent_blur, mask], dim=-1)
        if task not in ("t2v", "i2v"):
            raise ValueError(f"task must be sr, t2v or i2v, got {task!r}")
        cond = torch.zeros((*latent_blur.shape[:-1], latent_blur.shape[-1]
                            + 1), dtype=latent_blur.dtype,
                           device=latent_blur.device)
        if task == "i2v":
            cond[:1] = torch.cat([noise[:1], mask[:1]], dim=-1)
        return cond

    def timestep_transform(self, timesteps, latent_shapes):
        if not self.config.diffusion.timestep_transform:
            return timesteps
        return diffusion.timestep_shift(
            timesteps, latent_shapes, T=self.schedule.T,
            temporal_down=self.config.vae.temporal_downsample_factor,
            spatial_down=self.config.vae.spatial_downsample_factor)

    # ----------------------------------------------------------- inference

    def plan(self, vid_shape: Tuple[int, int, int], txt_len: int
             ) -> DevicePlan:
        """The device plan for one (latent T, H, W, text length), built and
        uploaded on first use."""
        key = (tuple(vid_shape), txt_len)
        if key not in self._plans:
            self._plans[key] = upload_plan(
                build_dit_plan(self.dit_cfg, key[0], txt_len), self.dit_cfg,
                self.device)
        return self._plans[key]

    @torch.no_grad()
    def inference(self, noises: List[torch.Tensor],
                  conditions: List[torch.Tensor],
                  texts_pos: List[torch.Tensor], texts_neg: List[torch.Tensor],
                  cfg_scale: Optional[float] = None,
                  steps: Optional[int] = None) -> List[torch.Tensor]:
        """One-step (or n-step) denoising of same-shape latents
        (Tl, h, w, C), batched into one DiT call; under a mesh with dp > 1
        the latents go one a dp group instead, each denoised alone (as the
        pipeline's world-size-1 calls are) and shared with every rank. A
        phase-offloaded DiT is restored first; a streamed one streams its
        blocks."""
        if not noises:
            return []
        self.ensure_dit_resident()
        if cfg_scale is None:
            cfg_scale = self.config.diffusion.cfg_scale
        if steps is None:
            steps = self.config.diffusion.sampling_steps
        if len({tuple(x.shape) for x in noises}) != 1:
            raise ValueError("mixed shapes in one inference call")
        if self.mesh is not None and self.mesh.shape.get("dp", 1) > 1:
            return list(spread(
                list(zip(noises, conditions)),
                lambda nc: self._denoise([nc[0]], [nc[1]], texts_pos,
                                         texts_neg, cfg_scale, steps)[0],
                self.mesh, "dp", self.device))
        return self._denoise(noises, conditions, texts_pos, texts_neg,
                             cfg_scale, steps)

    def _denoise(self, noises, conditions, texts_pos, texts_neg,
                 cfg_scale: float, steps: int) -> List[torch.Tensor]:
        """inference's batched DiT call on this rank (its tp group)."""
        tl, h, w, _ = noises[0].shape
        dt = self.compute_dtype
        txt_pos = torch.as_tensor(texts_pos[0], dtype=dt, device=self.device)
        txt_neg = torch.as_tensor(texts_neg[0], dtype=dt, device=self.device)
        plan_pos = self.plan((tl, h, w), txt_pos.shape[0])
        plan_neg = (self.plan((tl, h, w), txt_neg.shape[0])
                    if cfg_scale != 1.0 else None)
        noise = torch.stack(noises).to(dt)
        cond = torch.stack(conditions).to(dt)
        b = noise.shape[0]
        self.last_batch_sizes.append(b)
        txt_pos = txt_pos[None].expand(b, *txt_pos.shape)
        txt_neg = txt_neg[None].expand(b, *txt_neg.shape)
        pred_type = self.config.diffusion.prediction_type
        dit = (self.streamed_dit if self.streamed_dit is not None
               else partial(nadit_forward, self.dit, tp=self.tp))

        def f(x, t):
            vid_in = torch.cat([x, cond], dim=-1)
            tt = torch.full((b,), t, dtype=torch.float32, device=self.device)
            pos = dit(vid_in, txt_pos, tt, plan_pos,
                      attention_mode=self.attention_mode)
            if cfg_scale == 1.0:
                return pos
            neg = dit(vid_in, txt_neg, tt, plan_neg,
                      attention_mode=self.attention_mode)
            return diffusion.classifier_free_guidance(
                pos, neg, cfg_scale, self.config.diffusion.cfg_rescale)

        ts = [float(t) for t in
              diffusion.trailing_timesteps(self.schedule.T, steps)]
        x = noise
        for t, s in zip(ts[:-1], ts[1:]):
            x = diffusion.euler_step_to(self.schedule, f(x, t), x, t, s,
                                        pred_type)
        x0, _ = self.schedule.convert_from_pred(f(x, ts[-1]), pred_type, x,
                                                ts[-1])
        return [x0[i] for i in range(b)]
