"""The benchmark's only contact with the program under test, the PyTorch
port (`seedvr2_tpu_torch`): build its runner as the CLI does for the
configuration's lane, load the weights the benchmark drew, convert the DiT
as the lane says, and serve one request through `cli.process_frames`.
Nothing here imports JAX or the JAX package."""

import dataclasses
import gc

import numpy as np
import torch

from . import traffic, weights

# the streams of the run's seed that the weights are drawn from
DIT_STREAM, VAE_STREAM = 0, 5


def draw_weights(cfg: dict, seed: int, device):
    """(DiT, VAE) state dicts in bf16 on `device`, drawn from the seed."""
    return (weights.draw(weights.dit_spec(cfg["dit"]),
                         traffic.generator(device, seed, DIT_STREAM)),
            weights.draw(weights.vae_spec(cfg["vae"]),
                         traffic.generator(device, seed, VAE_STREAM)))


def _check_config(cfg: dict, dit_cfg, vae_cfg) -> None:
    """The configuration file holds what the program runs."""
    for name, want, have in (("dit", cfg["dit"], dit_cfg),
                             ("vae", cfg["vae"], vae_cfg)):
        got = {f.name: getattr(have, f.name) for f in dataclasses.fields(have)}
        for k, v in want.items():
            g = list(got[k]) if isinstance(got[k], tuple) else got[k]
            if g != v:
                raise ValueError(f"{cfg['name']}: {name}.{k} is {v!r} in the "
                                 f"configuration file, {g!r} in the program")


def build(cfg: dict, seed: int, device, lane: dict = None):
    """The runner of `cfg`'s lane (or of `lane`, a dict of lane keys that
    override it, as the control's) with the weights drawn from `seed`."""
    from seedvr2_tpu_torch import cli
    from seedvr2_tpu_torch.core.configs import DiTConfig
    from seedvr2_tpu_torch.core.loader import quantize_dit
    from seedvr2_tpu_torch.core.runner import VAETiling
    from seedvr2_tpu_torch.models.vae.pipeline_vae import VideoVAE

    lane = {**cfg["lane"], **(lane or {})}
    dit = {k: tuple(v) if isinstance(v, list) else v
           for k, v in cfg["dit"].items()}
    dit_cfg = DiTConfig(**dit)
    tiling = VAETiling(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in lane["vae_tiling"].items()})
    runner = cli.make_runner(device, seed=0, quant="none", tiling=tiling,
                             vae_quant="none", dit_cfg=dit_cfg,
                             attention_mode=lane["attention_mode"])
    _check_config(cfg, runner.dit_cfg, runner.vae.cfg)
    dit_state, vae_state = draw_weights(cfg, seed, device)
    runner.dit.load_state_dict(dit_state, strict=True)
    runner.vae.model.load_state_dict(vae_state, strict=True)
    del dit_state, vae_state
    if lane["quant"] != "none":
        quantize_dit(runner.dit, lane["quant"])
    if lane["vae_quant"] != "none":
        # the served convs are quantized when the VAE front end is built
        runner.vae.model.cfg = dataclasses.replace(
            runner.vae.model.cfg, conv_quant=lane["vae_quant"])
        runner.vae = VideoVAE(runner.vae.model, runner.vae.dtype)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return runner


def serve(runner, pool: traffic.Pool, i: int, cfg: dict, seed: int):
    """One request of the pool's i-th input: (output frames, the pipeline's
    phase seconds)."""
    from seedvr2_tpu_torch import cli

    mix = pool.mix
    out, timings = cli.process_frames(
        runner, pool.frames[i], pool.txt, resolution=mix["resolution"],
        seed=seed % (1 << 31), batch_size=mix["batch_size"],
        color_correction=cfg["lane"]["color_correction"],
        noise_override=[pool.noise[i]])
    return np.asarray(out), dict(timings)
