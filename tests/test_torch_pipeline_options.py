"""The rest of the request surface against the JAX pipeline on the CPU in
fp32, with the tiny models of tests/test_torch_pipeline.py (shared weights,
shared noise): RGBA with overlap, uniform batches, both noise scales (the
JAX draws rebuilt here and fed to the port through its overrides), the
tile_debug overlay, ref-mode tiles, the callbacks and the interrupt, the
t2v / i2v conditions, calculate_optimal_batch_params, the CLI's new flags
with RGBA .npy, and the phases' colour defaults.

Tolerances: RGB values as tests/test_torch_pipeline.py holds the default
path, 1e-4 max abs, where the colour method is elementwise (wavelet,
adain); for the binned methods (wavelet_adaptive, hsv) the DiT's fp32
noise can move a value into the neighbouring CDF or hue bin, so, as the lab
path there: at most 1 % of values beyond 1e-4 and all within 1e-2. The
alpha channel: 1e-4 (tests/test_torch_alpha.py holds it to 1e-5 on fixed
RGB; here it is guided by the decoded RGB, which carries the DiT's
noise)."""

import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seedvr2_tpu.core import pipeline as jp
from seedvr2_tpu.core.configs import DiTConfig as JDiTConfig
from seedvr2_tpu.core.configs import RunnerConfig as JRunnerConfig
from seedvr2_tpu.core.configs import VAEConfig as JVAEConfig
from seedvr2_tpu.core.runner import VideoDiffusionRunner as JRunner
from seedvr2_tpu.models.dit.nadit import init_dit_params
from seedvr2_tpu.models.vae.pipeline_vae import VideoVAE as JVAE
from seedvr2_tpu.models.vae.pipeline_vae import init_vae_params
from seedvr2_tpu_torch import cli
from seedvr2_tpu_torch.core import configs as tc
from seedvr2_tpu_torch.core import pipeline as tp
from seedvr2_tpu_torch.core.runner import VAETiling
from seedvr2_tpu_torch.core.runner import VideoDiffusionRunner as TRunner
from seedvr2_tpu_torch.core.weights import state_dict_from_jax
from seedvr2_tpu_torch.models.dit.nadit import NaDiT
from seedvr2_tpu_torch.models.vae.model import VideoAutoencoder
from seedvr2_tpu_torch.models.vae.pipeline_vae import VideoVAE as TVAE
from seedvr2_tpu_torch.models.vae.pipeline_vae import _plan_ref
from seedvr2_tpu_torch.utils import seed as tseed

from .test_torch_dit import random_params
from .test_torch_pipeline import DIT_KW, VAE_KW

SEED = 1
TILES = dict(encode_tile_size=(24, 24), encode_tile_overlap=(8, 8),
             decode_tile_size=(24, 24), decode_tile_overlap=(8, 8))


@pytest.fixture(scope="module")
def models():
    """(JAX untiled, port untiled, JAX ref-tiled, port ref-tiled) runners
    over one set of weights."""
    jv_cfg, jd_cfg = JVAEConfig(**VAE_KW), JDiTConfig(**DIT_KW)
    vae_p = random_params(lambda k: init_vae_params(k, jv_cfg,
                                                    dtype=jnp.float32), 2)
    dit_p = random_params(lambda k: init_dit_params(k, jd_cfg,
                                                    dtype=jnp.float32), 3)
    tv_cfg, td_cfg = tc.VAEConfig(**VAE_KW), tc.DiTConfig(**DIT_KW)
    vae = VideoAutoencoder(tv_cfg, dtype=torch.float32)
    vae.load_state_dict(state_dict_from_jax(vae_p), strict=True)
    dit = NaDiT(td_cfg, dtype=torch.float32)
    dit.load_state_dict(state_dict_from_jax(dit_p), strict=True)
    out = []
    for tiled in (False, True):
        kw = dict(TILES, encode_tiled=True, decode_tiled=True) if tiled else {}
        out.append(JRunner(dit_p, jd_cfg, JVAE(vae_p, jv_cfg,
                                               dtype=jnp.float32),
                           JRunnerConfig(dit=jd_cfg, vae=jv_cfg),
                           compute_dtype=jnp.float32, tile_mode="ref", **kw))
        out.append(TRunner(dit, TVAE(vae, torch.float32),
                           tc.RunnerConfig(dit=td_cfg, vae=tv_cfg),
                           compute_dtype=torch.float32,
                           tiling=VAETiling(tile_mode="ref", **kw)))
    return out


def _inputs(seed, frames, channels=3):
    """Frames of 24 x 20 (to 32 px: 38 x 32 out, 48 x 32 encoded, latent
    6 x 4); for RGBA an alpha that is 0 / 1 but for a soft band."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (frames, 24, 20, channels)).astype(np.float32)
    if channels == 4:
        xx = np.arange(20) / 19.0
        images[..., 3] = np.clip((xx - 0.45) * 8, 0, 1)
    emb = {"pos": rng.standard_normal((7, 16)).astype(np.float32),
           "neg": rng.standard_normal((9, 16)).astype(np.float32)}
    return images, emb, rng


def _jax_run(j_runner, images, emb, noise, opts, calls=None):
    """The JAX pipeline with opts (batch, overlap, uniform, in_scale,
    lat_scale, color, tile_debug); calls collects callback arguments."""
    record = None if calls is None else (lambda *a: calls.append(a))
    ctx = jp.setup_generation_context(
        tile_debug=opts.get("tile_debug", "false"),
        interrupt_fn=None if calls is None else (
            lambda: calls.append("interrupt")))
    ctx = jp.encode_all_batches(
        j_runner, ctx, images, batch_size=opts["batch"],
        uniform_batch_size=opts.get("uniform", False), seed=SEED,
        progress_callback=record, temporal_overlap=opts["overlap"],
        resolution=32, input_noise_scale=opts.get("in_scale", 0.0),
        color_correction=opts["color"])
    ctx["text_embeds"] = emb
    ctx = jp.upscale_all_batches(
        j_runner, ctx, progress_callback=record, seed=SEED,
        latent_noise_scale=opts.get("lat_scale", 0.0), noise_override=noise)
    ctx = jp.decode_all_batches(j_runner, ctx, progress_callback=record)
    ctx = jp.postprocess_all_batches(ctx, progress_callback=record,
                                     color_correction=opts["color"])
    return ctx


def _jax_draws(pads, latent_shapes):
    """JAX's per-batch input-noise draws (fold_in(PRNGKey(seed + 1e6), bi)
    at the transformed batch's shape) and augmentation draws (k2 of
    split(PRNGKey(seed)) at the latent's shape), as numpy."""
    vae_key = jax.random.PRNGKey(SEED + tseed.VAE_SEED_OFFSET)
    _, k2 = jax.random.split(jax.random.PRNGKey(SEED))
    inp = [np.array(jax.random.normal(jax.random.fold_in(vae_key, bi),
                                        (t, 48, 32, 3), jnp.float32))
           for bi, t in enumerate(pads)]
    aug = [np.array(jax.random.normal(k2, shape, jnp.float32))
           for shape in latent_shapes]
    return inp, aug


def _port_run(t_runner, images, emb, noise, opts, in_noise=None, aug=None,
              calls=None):
    record = None if calls is None else (lambda *a: calls.append(a))
    ctx = tp.setup_generation_context(
        "cpu", tile_debug=opts.get("tile_debug", "false"),
        interrupt_fn=None if calls is None else (
            lambda: calls.append("interrupt")))
    ctx["text_embeds"] = emb
    ctx = tp.encode_all_batches(
        t_runner, ctx, images, batch_size=opts["batch"],
        uniform_batch_size=opts.get("uniform", False), seed=SEED,
        progress_callback=record, temporal_overlap=opts["overlap"],
        resolution=32, input_noise_scale=opts.get("in_scale", 0.0),
        input_noise_override=in_noise)
    ctx = tp.upscale_all_batches(
        t_runner, ctx, progress_callback=record, seed=SEED,
        latent_noise_scale=opts.get("lat_scale", 0.0), noise_override=noise,
        aug_noise_override=aug)
    ctx = tp.decode_all_batches(t_runner, ctx, progress_callback=record)
    ctx = tp.postprocess_all_batches(ctx, progress_callback=record,
                                     color_correction=opts["color"])
    return ctx


def _check_close(out, ref, color):
    assert out.shape == ref.shape
    diff = np.abs(out[..., :3] - ref[..., :3])
    if color in ("wavelet_adaptive", "hsv"):
        assert diff.max() < 1e-2 and (diff > 1e-4).mean() < 1e-2
    else:
        assert diff.max() < 1e-4
    if out.shape[-1] == 4:
        assert np.abs(out[..., 3] - ref[..., 3]).max() < 1e-4
        assert 0.0 <= out[..., 3].min() and out[..., 3].max() <= 1.0


# name: (frames, channels, options)
CASES = {
    "rgba_overlap_noise_uniform": (7, 4, dict(
        batch=5, overlap=2, uniform=True, in_scale=0.3, lat_scale=0.1,
        color="wavelet_adaptive")),
    "uniform_batch": (9, 3, dict(batch=7, overlap=2, uniform=True,
                                 color="adain")),
    "noise_scales": (7, 3, dict(batch=5, overlap=2, in_scale=0.5,
                                lat_scale=0.3, color="wavelet")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_options_match_jax_pipeline(models, case):
    """Each case through all four phases with the JAX draws fed to the
    port; the callbacks' and the interrupt's call sequences equal JAX's."""
    j_runner, t_runner = models[:2]
    frames, channels, opts = CASES[case]
    images, emb, rng = _inputs(5, frames, channels)
    batches, _ = tp.batch_indices(frames, opts["batch"], opts["overlap"])
    pads = [tp._prepare_batch(images, s, e, opts["batch"] - (e - s) if (
        opts.get("uniform") and e - s < opts["batch"]) else 0).shape[0]
        for s, e in batches]
    noise = [rng.standard_normal(((t - 1) // 4 + 1, 6, 4, 4)).astype(
        np.float32) for t in pads]
    in_noise, aug = _jax_draws(pads, [n.shape for n in noise])
    j_calls, t_calls = [], []
    ref = _jax_run(j_runner, images, emb, noise, opts, j_calls)
    ctx = _port_run(t_runner, images, emb, noise, opts, in_noise, aug,
                    t_calls)
    out = ctx["final_video"]
    assert out.shape == (frames, 38, 32, channels)
    _check_close(out, ref["final_video"], opts["color"])
    assert ctx["batch_metadata"] == ref["batch_metadata"]
    assert ctx["all_ori_lengths"] == ref["all_ori_lengths"]
    assert ctx["decode_batch_info"] == ref["decode_batch_info"]
    assert t_calls == j_calls
    assert t_calls.count("interrupt") == 4 * len(pads)


def test_uniform_batch_changes_the_padding(models):
    """With batch 7 and 9 frames the trailing batch of 4 frames is padded
    to 7 (then 9 = 4n+1), not to 5: its latent has 3 frames, not 2."""
    _, t_runner = models[:2]
    images, emb, _ = _inputs(6, 9)
    lat = {}
    for uniform in (False, True):
        ctx = tp.setup_generation_context("cpu")
        ctx = tp.encode_all_batches(t_runner, ctx, images, batch_size=7,
                                    uniform_batch_size=uniform,
                                    temporal_overlap=2, resolution=32)
        lat[uniform] = [tuple(x.shape) for x in ctx["all_latents"]]
        assert ctx["batch_metadata"] == [(0, 7, 0), (5, 9, 3 if uniform
                                                     else 0)]
    assert lat == {False: [(3, 6, 4, 4), (2, 6, 4, 4)],
                   True: [(3, 6, 4, 4), (3, 6, 4, 4)]}


@pytest.mark.parametrize("tile_debug", ["encode", "decode"])
def test_ref_tiled_pipeline_and_overlay_match_jax(models, tile_debug):
    """The ref-mode tiled runner (24 px tiles, 8 px overlaps: 3 x 2 tiles
    of 3 / 2 latent columns) through the pipeline with the tile_debug
    overlay, against JAX: the same tiles, the same output, the overlay's
    colour on every recorded boundary."""
    j_runner, t_runner = models[2:]
    images, emb, rng = _inputs(8, 7, 4)
    noise = [rng.standard_normal((2, 6, 4, 4)).astype(np.float32)
             for _ in range(2)]
    opts = dict(batch=5, overlap=2, color="hsv", tile_debug=tile_debug)
    ref = _jax_run(j_runner, images, emb, noise, opts)
    ctx = _port_run(t_runner, images, emb, noise, opts)
    for kind in ("encode", "decode"):
        tiles = ctx[f"{kind}_tile_boundaries"]
        assert tiles == ref[f"{kind}_tile_boundaries"]
        assert tiles == [(y * 8, x * 8, (ye - y) * 8, (xe - x) * 8)
                         for y, ye, x, xe in _plan_ref(6, 4, 3, 3, 1, 1)]
    assert len(tiles) == 6 and {t[3] for t in tiles} == {24, 16}
    out = ctx["final_video"]
    _check_close(out, ref["final_video"], "hsv")
    color = np.array({"decode": [1.0, 0.2, 0.2], "encode": [0.2, 1.0, 0.2]}[
        tile_debug], np.float32)
    for y, x, h, w in ctx[f"{tile_debug}_tile_boundaries"]:
        y2, x2 = min(y + h, 38) - 1, min(x + w, 32) - 1
        for px in (out[:, y:y2 + 1, x], out[:, y:y2 + 1, x2],
                   out[:, y, x:x2 + 1], out[:, y2, x:x2 + 1]):
            np.testing.assert_array_equal(px[..., :3],
                                          np.broadcast_to(color,
                                                          px[..., :3].shape))
    assert 0.0 <= out[..., 3].min() and out[..., 3].max() <= 1.0


@pytest.mark.parametrize("h,w,tile,overlap", [
    (48, 40, 24, 8),    # latent 6 x 5: the 1-column edge sliver is dropped
    (48, 32, 24, 8),    # latent 6 x 4: a 2-column edge tile is kept
    (40, 56, 32, 16),   # latent 5 x 7, stride 2
    (24, 24, 16, 0)])   # no overlap
def test_ref_tiles_match_jax(models, h, w, tile, overlap):
    """The ref planner's rectangles and the encode / decode of one frame
    through them, against JAX's stride sweep."""
    jvae, tvae = models[0].vae, models[1].vae
    x = np.random.default_rng(h + w).uniform(-1, 1, (1, 1, h, w, 3)).astype(
        np.float32)
    kw = dict(tiled=True, tile_size=(tile, tile),
              tile_overlap=(overlap, overlap), tile_mode="ref")
    z_t = tvae.encode(torch.from_numpy(x), **kw)
    z_j = np.asarray(jvae.encode(jnp.asarray(x), **kw))
    assert tvae.last_encode_tiles == jvae.last_encode_tiles
    np.testing.assert_allclose(z_t.numpy(), z_j, atol=1e-4, rtol=0)
    y_t = tvae.decode(z_t, **kw)
    y_j = np.asarray(jvae.decode(jnp.asarray(z_t.numpy()), **kw))
    assert tvae.last_decode_tiles == jvae.last_decode_tiles
    assert len(tvae.last_decode_tiles) > 1
    np.testing.assert_allclose(y_t.numpy(), y_j, atol=1e-4, rtol=0)


def test_interrupt_aborts_every_phase(models):
    """An interrupt_fn that raises on its k-th call stops the request in the
    phase that call falls in (two batches: calls 1-2 encode, 3-4 dit, 5-6
    decode, 7-8 postprocess), after as many calls as JAX's pipeline."""
    j_runner, t_runner = models[:2]
    images, emb, _ = _inputs(9, 7)

    class Stop(Exception):
        pass

    def run(fn, runner, k):
        n = [0]

        def interrupt():
            n[0] += 1
            if n[0] == k:
                raise Stop(k)

        with pytest.raises(Stop):
            fn(runner, interrupt)
        return n[0]

    def port(runner, interrupt):
        ctx = tp.setup_generation_context("cpu", interrupt_fn=interrupt)
        ctx["text_embeds"] = emb
        ctx = tp.encode_all_batches(runner, ctx, images, temporal_overlap=2,
                                    resolution=32)
        ctx = tp.upscale_all_batches(runner, ctx)
        ctx = tp.decode_all_batches(runner, ctx)
        tp.postprocess_all_batches(ctx)

    def jax_(runner, interrupt):
        ctx = jp.setup_generation_context(interrupt_fn=interrupt)
        ctx["text_embeds"] = emb
        ctx = jp.encode_all_batches(runner, ctx, images, temporal_overlap=2,
                                    resolution=32)
        ctx = jp.upscale_all_batches(runner, ctx)
        ctx = jp.decode_all_batches(runner, ctx)
        jp.postprocess_all_batches(ctx)

    for k in (1, 4, 5, 8):
        assert run(port, t_runner, k) == run(jax_, j_runner, k) == k


@pytest.mark.parametrize("task", ["sr", "t2v", "i2v"])
def test_condition_matches_jax(models, task):
    j_runner, t_runner = models[:2]
    rng = np.random.default_rng(11)
    noise, lat = (rng.standard_normal((3, 6, 4, 4)).astype(np.float32)
                  for _ in range(2))
    out = t_runner.get_condition(torch.from_numpy(noise),
                                 torch.from_numpy(lat), task).numpy()
    ref = np.asarray(j_runner.get_condition(jnp.asarray(noise),
                                            jnp.asarray(lat), task))
    np.testing.assert_array_equal(out, ref)
    assert out.shape == (3, 6, 4, 5)
    with pytest.raises(ValueError):
        t_runner.get_condition(torch.from_numpy(noise),
                               torch.from_numpy(lat), "v2v")


@pytest.mark.parametrize("total,batch,overlap", [
    (10, 5, 2), (10, 3, 5), (7, 5, 0), (1, 5, 0), (0, 5, 1), (23, 9, 4)])
def test_calculate_optimal_batch_params_equal(total, batch, overlap):
    assert tp.calculate_optimal_batch_params(total, batch, overlap) == \
        jp.calculate_optimal_batch_params(total, batch, overlap)


def test_seeded_draws_reproducible(models):
    """Without overrides every draw comes from the seed: the same seed
    gives the same output with both noise scales on, another seed another
    one; input-noise streams differ by batch index."""
    _, t_runner = models[:2]
    images, emb, _ = _inputs(12, 7)

    def run(seed):
        out, _ = cli.process_frames(
            t_runner, images, emb, resolution=32, seed=seed,
            temporal_overlap=2, input_noise_scale=0.4,
            latent_noise_scale=0.2, color_correction="none")
        return out

    a, b, c = run(3), run(3), run(4)
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 1e-4
    draws = [torch.randn(64, generator=tseed.input_noise_generator(3, bi,
                                                                   "cpu"))
             for bi in (0, 1)]
    again = torch.randn(64, generator=tseed.input_noise_generator(3, 0,
                                                                  "cpu"))
    assert torch.equal(draws[0], again)
    assert not torch.equal(draws[0], draws[1])
    with pytest.raises(ValueError):
        tseed.input_noise_generator(3, 1 << 16, "cpu")


def test_cli_new_flags_and_rgba_npy(models, tmp_path, monkeypatch):
    """The new flags parse with the JAX CLI's choices and defaults and reach
    the pipeline; an (H, W, 4) .npy comes back as one RGBA frame."""
    _, t_runner = models[:2]
    path = tmp_path / "in.npy"
    img = _inputs(13, 1, 4)[0][0]
    np.save(path, img)
    args = cli.parse_arguments([str(path)])
    assert (args.color_correction, args.input_noise_scale,
            args.latent_noise_scale, args.uniform_batch_size,
            args.tile_debug, args.tile_mode) == ("lab", 0.0, 0.0, False,
                                                 "false", "uniform")
    for method in ("lab", "wavelet", "wavelet_adaptive", "hsv", "adain",
                   "none"):
        assert cli.parse_arguments(
            [str(path), "--color_correction", method]).color_correction \
            == method
    for bad in (["--tile_mode", "grid"], ["--tile_debug", "yes"],
                ["--color_correction", "sepia"]):
        with pytest.raises(SystemExit):
            cli.parse_arguments([str(path), *bad])
    argv = [str(path), "--device", "cpu", "--resolution", "32",
            "--output", str(tmp_path / "out.npy"), "--color_correction",
            "adain", "--input_noise_scale", "0.2", "--latent_noise_scale",
            "0.1", "--uniform_batch_size", "--tile_mode", "ref",
            "--tile_debug", "decode", "--vae_decode_tiled",
            "--vae_decode_tile_size", "24", "--vae_decode_tile_overlap", "8"]
    args = cli.parse_arguments(argv)
    assert cli.tiling_from_args(args).tile_mode == "ref"
    seen = {}

    def make_runner(device, seed, dit_model, vae_model, quant, tiling,
                    vae_quant, **memory):
        seen["tiling"], seen["memory"] = tiling, memory
        return TRunner(t_runner.dit, t_runner.vae, t_runner.config,
                       compute_dtype=torch.float32, tiling=tiling)

    process = cli.process_frames

    def spy(*a, **kw):
        seen["kw"] = kw
        return process(*a, **kw)

    monkeypatch.setattr(cli, "make_runner", make_runner)
    monkeypatch.setattr(cli, "process_frames", spy)
    out = np.load(cli.main(argv))
    assert out.shape == (1, 38, 32, 4) and np.isfinite(out).all()
    assert seen["tiling"].tile_mode == "ref" and seen["tiling"].decode_tiled
    assert seen["memory"] == dict(model_dir="./models", blocks_to_swap=0,
                                  dit_cache=False, vae_cache=False,
                                  attention_mode="flash")
    assert {k: seen["kw"][k] for k in (
        "color_correction", "input_noise_scale", "latent_noise_scale",
        "uniform_batch_size", "tile_debug")} == dict(
        color_correction="adain", input_noise_scale=0.2,
        latent_noise_scale=0.1, uniform_batch_size=True, tile_debug="decode")
    assert 0.0 <= out[..., 3].min() and out[..., 3].max() <= 1.0
    np.testing.assert_array_equal(
        out[0, :, 0, :3],
        np.broadcast_to(np.array([1.0, 0.2, 0.2], np.float32), (38, 3)))


def test_phase_colour_defaults():
    """The phase functions default to wavelet, as JAX's do; the CLI keeps
    lab, as the JAX CLI does (inference_cli.py)."""
    def default(fn):
        return inspect.signature(fn).parameters["color_correction"].default

    assert default(tp.postprocess_all_batches) == "wavelet" == default(
        jp.postprocess_all_batches) == default(jp.encode_all_batches)
    assert cli.parse_arguments(["x.npy"]).color_correction == "lab"
    assert default(cli.process_frames) == "lab"
