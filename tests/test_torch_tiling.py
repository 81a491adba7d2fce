"""The port's uniform VAE tiling against the JAX package on the CPU: the
host-side planners (pinned equal), tiled encode and decode of the tiny VAE
in fp32, and the runner's out-of-memory retry."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seedvr2_tpu.core.configs import VAEConfig as JVAEConfig
from seedvr2_tpu.core.runner import VideoDiffusionRunner as JRunner
from seedvr2_tpu.models.vae import pipeline_vae as jv
from seedvr2_tpu_torch.core.configs import VAEConfig, small_test_config
from seedvr2_tpu_torch.core.runner import VAETiling
from seedvr2_tpu_torch.core.runner import VideoDiffusionRunner as TRunner
from seedvr2_tpu_torch.core.weights import state_dict_from_jax
from seedvr2_tpu_torch.models.dit.nadit import NaDiT
from seedvr2_tpu_torch.models.vae import pipeline_vae as tv
from seedvr2_tpu_torch.models.vae.model import VideoAutoencoder

from .test_torch_dit import random_params

TINY = dict(block_out_channels=(8, 8, 16, 16), layers_per_block=1,
            latent_channels=4, norm_num_groups=4)
# fp32 convolutions summed in other orders by XLA and by PyTorch's CPU
# kernels, as in tests/test_torch_vae.py; the tile blend is the same
# elementwise fp32 arithmetic on both sides
TOL = dict(rtol=1e-4, atol=1e-4)

# the serving shapes of --preset throughput (latent h, w; cap in latent px;
# overlap in latent px; cost): 1080p and 4K, encode (1536 px tiles, 32 px
# overlap) and decode (1088 px, 48 px), with the grids the JAX planner gives
SERVING = [
    ((135, 240, 192 * 192, 4, 4, "area"), (1, 1, 135, 240)),
    ((135, 240, 136 * 136, 6, 6, "aspect"), (2, 1, 71, 240)),
    ((270, 480, 192 * 192, 4, 4, "area"), (2, 2, 137, 242)),
    ((270, 480, 136 * 136, 6, 6, "aspect"), (4, 2, 72, 243)),
]


def _sweep():
    rng = np.random.default_rng(0)
    cases = [c for c, _ in SERVING]
    for _ in range(40):
        h, w = (int(v) for v in rng.integers(1, 300, 2))
        cap = int(rng.integers(1, 150)) ** 2
        ov = int(rng.integers(0, 12))
        cases.append((h, w, cap, ov, ov, ("area", "aspect")[_ % 2]))
    return cases


@pytest.mark.parametrize("case", _sweep())
def test_plan_grid_equal(case):
    h, w, cap, ov_h, ov_w, cost = case
    assert tv._plan_grid(h, w, cap, ov_h, ov_w, cost=cost) == jv._plan_grid(
        h, w, cap, ov_h, ov_w, cost=cost)
    for grid in ((1, 1), (2, 3), (4, 2), (70, 70)):
        assert tv._plan_grid(h, w, cap, ov_h, ov_w, force_grid=grid) == \
            jv._plan_grid(h, w, cap, ov_h, ov_w, force_grid=grid)


@pytest.mark.parametrize("case,grid", SERVING)
def test_serving_grids(case, grid):
    ys, th, xs, tw = tv._plan_grid(*case[:5], cost=case[5])
    assert (len(ys), len(xs), th, tw) == grid


def test_fade_helpers_equal():
    for n in (1, 2, 5, 48):
        np.testing.assert_array_equal(tv._cos_ramp(n), jv._cos_ramp(n))
    for length in (1, 3, 17, 200):
        for ov in (0, 1, 6, 48, 300):
            for a in (False, True):
                for b in (False, True):
                    np.testing.assert_array_equal(
                        tv._fade_weights(length, ov, a, b),
                        jv._fade_weights(length, ov, a, b))
    for total, tile, n in ((240, 71, 4), (135, 135, 1), (480, 243, 2)):
        starts = tv._even_starts(total, tile, n)
        assert starts == jv._even_starts(total, tile, n)
        assert tv._min_overlap(starts, tile) == jv._min_overlap(starts, tile)


@pytest.fixture(scope="module")
def vae_pair():
    params = random_params(lambda k: jv.init_vae_params(
        k, JVAEConfig(**TINY), dtype=jnp.float32), seed=4)
    model = VideoAutoencoder(VAEConfig(**TINY), dtype=torch.float32)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return (jv.VideoVAE(params, JVAEConfig(**TINY), dtype=jnp.float32),
            tv.VideoVAE(model, torch.float32))


# 48x40 px frames (latent 6x5) with 24 px tiles (latent 3x3, cap 9) and an
# 8 px overlap: multi-tile grids; plus a forced 2x2 grid
@pytest.mark.parametrize("frames,grid", [(1, None), (5, None), (5, (2, 2))])
def test_tiled_encode_decode_match_jax(vae_pair, frames, grid):
    jvae, tvae = vae_pair
    kw = dict(tiled=True, tile_size=(24, 24), tile_overlap=(8, 8),
              tile_mode="uniform", tile_grid=grid)
    x = np.random.default_rng(frames).uniform(
        -1, 1, (1, frames, 48, 40, 3)).astype(np.float32)
    z_ref = np.asarray(jvae.encode(jnp.asarray(x), **kw))
    z = tvae.encode(torch.from_numpy(x), **kw)
    assert z.shape == (1, (frames - 1) // 4 + 1, 6, 5, 4)
    np.testing.assert_allclose(z.numpy(), z_ref, **TOL)
    assert tvae.last_encode_tiles == jvae.last_encode_tiles
    assert len(tvae.last_encode_tiles) > 1
    untiled = tvae.encode(torch.from_numpy(x))
    assert not torch.allclose(z, untiled, atol=1e-3)  # the tiles are real

    y_ref = np.asarray(jvae.decode(jnp.asarray(z_ref), **kw))
    y = tvae.decode(torch.from_numpy(z_ref.copy()), **kw)
    assert y.shape == (1, frames, 48, 40, 3)
    np.testing.assert_allclose(y.numpy(), y_ref, **TOL)
    assert tvae.last_decode_tiles == jvae.last_decode_tiles
    assert len(tvae.last_decode_tiles) > 1


def test_small_input_stays_untiled(vae_pair):
    """A frame no larger than one tile takes the untiled path, bit for bit."""
    _, tvae = vae_pair
    x = torch.from_numpy(np.random.default_rng(9).uniform(
        -1, 1, (1, 1, 16, 16, 3)).astype(np.float32))
    assert torch.equal(tvae.encode(x, tiled=True, tile_size=(24, 24)),
                       tvae.encode(x))
    with pytest.raises(ValueError, match="tile_mode"):
        tvae.encode(torch.zeros(1, 1, 48, 48, 3), tiled=True,
                    tile_size=(24, 24), tile_mode="grid")


# ------------------------------------------------------------ OOM retry


class _StubVAE:
    """Raises `exc` on its first `fails` calls, records every call."""

    dtype = torch.float32

    def __init__(self, fails, exc):
        self.fails, self.exc, self.calls = fails, exc, []

    def _call(self, x, tiled, tile_size):
        self.calls.append((tiled, tuple(tile_size)))
        if len(self.calls) <= self.fails:
            raise self.exc
        return x[..., :1]

    def encode(self, x, tiled=False, tile_size=None, tile_overlap=None,
               tile_mode=None, mesh=None):
        return self._call(x, tiled, tile_size)

    decode = encode


def _jax_retry_calls(fails, tiled, size):
    """The JAX runner's retry sequence for the same failures."""
    calls = []

    def run_one(t, ts):
        calls.append((t, tuple(ts)))
        if len(calls) <= fails:
            raise RuntimeError("RESOURCE_EXHAUSTED: out of HBM")
        return None

    runner = JRunner(None, None, None, decode_tiled=tiled,
                     decode_tile_size=size)
    runner._vae_call_with_oom_retry("decode", run_one)
    return calls, (runner.decode_tiled, runner.decode_tile_size)


@pytest.mark.parametrize("fails,tiled,size", [
    (1, False, (1088, 1088)), (2, True, (1024, 1024)), (3, False, (512, 512))])
def test_oom_retry_goes_tiled_and_shrinks(fails, tiled, size):
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory (stub)")
    stub = _StubVAE(fails, oom)
    runner = TRunner(NaDiT(small_test_config(), dtype=torch.float32), stub,
                     tiling=VAETiling(decode_tiled=tiled,
                                      decode_tile_size=size))
    out = runner.vae_decode([torch.zeros(2, 6, 4, 16)])
    assert out[0].shape == (2, 6, 4, 1)
    calls, final = _jax_retry_calls(fails, tiled, size)
    assert stub.calls == calls
    assert (runner.tiling.decode_tiled, runner.tiling.decode_tile_size) == \
        final
    assert runner.tiling.encode_tiled is False  # the other phase untouched


def test_oom_retry_passes_other_errors_and_stops_at_floor():
    dit = NaDiT(small_test_config(), dtype=torch.float32)
    stub = _StubVAE(1, ValueError("not an OOM"))
    runner = TRunner(dit, stub)
    with pytest.raises(ValueError):
        runner.vae_encode([torch.zeros(1, 8, 8, 3)])
    assert len(stub.calls) == 1
    stub = _StubVAE(9, torch.cuda.OutOfMemoryError("stub"))
    runner = TRunner(dit, stub, tiling=VAETiling(encode_tiled=True,
                                                 encode_tile_size=(256, 256)))
    with pytest.raises(torch.cuda.OutOfMemoryError):
        runner.vae_encode([torch.zeros(1, 8, 8, 3)])
    assert stub.calls == [(True, (256, 256))]
    # a tile size is an (h, w) pair of ints or "auto" (the memory-probed
    # plan, tests/test_torch_memplan.py); anything else is refused
    assert VAETiling(decode_tile_size="auto").decode_tile_size == "auto"
    for bad in ("big", (512,), (512, 512.0)):
        with pytest.raises(ValueError, match="decode_tile_size"):
            VAETiling(decode_tile_size=bad)
    with pytest.raises(ValueError, match="encode_tile_overlap"):
        VAETiling(encode_tile_overlap="auto")
    with pytest.raises(ValueError, match="tile_mode"):
        VAETiling(tile_mode="grid")
    assert VAETiling(tile_mode="ref").tile_mode == "ref"
