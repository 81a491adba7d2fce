"""The port's CLI surface (seedvr2_tpu_torch.cli) against the JAX package's
inference_cli.py on the CPU: the parsers flag by flag, the chunk loop
alone with one deterministic stand-in for process_frames, whole runs
(image, chunked video, directory) through both CLIs on the tiny fp32
models of tests/test_torch_pipeline.py with the same injected noise, the
parity harness, the embeddings' allow_zero, --attention_mode (the SDPA
lane against JAX's XLA attention on both window plans, the aliases, the
runner cache's key), Debug, the doctor and the YAML configs.

Tolerances: the chunk loop and the IO are exact (the stand-in and the
PNG / uint8 paths compute the same floats); whole runs compare the PNG
files the CLIs write, within one uint8 step and >= 99.9 % equal (the
pipelines agree to fp32 noise, tests/test_torch_pipeline.py, which can
move a value across a uint8 rounding boundary); the xla lane's forward
within 1e-5 relative L2 of JAX's at fp32 (SDPA and XLA's einsum sum the
same products in another order)."""

import argparse
import dataclasses
import json
import os
import re
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import inference_cli
from seedvr2_tpu.core import config_yaml as jyaml
from seedvr2_tpu.core import configs as jc
from seedvr2_tpu.core import pipeline as jp
from seedvr2_tpu.core.configs import RunnerConfig as JRunnerConfig
from seedvr2_tpu.core.runner import VideoDiffusionRunner as JRunner
from seedvr2_tpu.models.dit import nadit as jn
from seedvr2_tpu.models.vae.pipeline_vae import VideoVAE as JVAE
from seedvr2_tpu.models.vae.pipeline_vae import init_vae_params
from seedvr2_tpu.ops import attention as jattn
from seedvr2_tpu.utils import debug as jdebug
from seedvr2_tpu.utils import parity as jparity
from seedvr2_tpu.utils import text_embeds as jte
from seedvr2_tpu_torch import cli
from seedvr2_tpu_torch.core import config_yaml as tyaml
from seedvr2_tpu_torch.core import configs as tc
from seedvr2_tpu_torch.core import model_cache
from seedvr2_tpu_torch.core import pipeline as tp
from seedvr2_tpu_torch.core.runner import VideoDiffusionRunner as TRunner
from seedvr2_tpu_torch.core.weights import state_dict_from_jax
from seedvr2_tpu_torch.models.dit import nadit as tn
from seedvr2_tpu_torch.models.vae.model import VideoAutoencoder
from seedvr2_tpu_torch.models.vae.pipeline_vae import VideoVAE as TVAE
from seedvr2_tpu_torch.ops import attention as tattn
from seedvr2_tpu_torch.utils import debug as tdebug
from seedvr2_tpu_torch.utils import doctor as tdoctor
from seedvr2_tpu_torch.utils import parity as tparity
from seedvr2_tpu_torch.utils import text_embeds as tte
from seedvr2_tpu_torch.utils import video_io as tvio

from .test_torch_dit import random_params
from .test_torch_model_manager import DIT_NAME, VAE_NAME, tiny_checkpoints  # noqa: F401
from .test_torch_pipeline import DIT_KW, VAE_KW

# ------------------------------------------------------------- parsers

# every flag of inference_cli.py:45-256 with a value to parse
SAMPLES = {
    "--output": ["o.mp4"], "--output_format": ["png"], "--model_dir": ["/m"],
    "--dit_model": ["x.gguf"], "--vae_model": ["v.safetensors"],
    "--resolution": ["720"], "--max_resolution": ["1920"],
    "--batch_size": ["9"], "--uniform_batch_size": [], "--seed": ["7"],
    "--skip_first_frames": ["3"], "--load_cap": ["4"], "--chunk_size": ["8"],
    "--prepend_frames": ["2"], "--temporal_overlap": ["1"],
    "--color_correction": ["hsv"], "--input_noise_scale": ["0.25"],
    "--latent_noise_scale": ["0.5"], "--vae_encode_tiled": [],
    "--vae_encode_tile_size": ["auto"], "--vae_encode_tile_overlap": ["64"],
    "--vae_decode_tiled": [], "--vae_decode_tile_size": ["768"],
    "--vae_decode_tile_overlap": ["32"], "--tile_debug": ["decode"],
    "--tile_mode": ["ref"], "--preset": ["quality"],
    "--attention_mode": ["sdpa"], "--quant": ["q4k"], "--vae_quant": ["int8"],
    "--compile_dit": [], "--compile_vae": [], "--blocks_to_swap": ["6"],
    "--swap_io_components": [], "--cache_dit": [], "--cache_vae": [],
    "--parity_check": [], "--parity_ref": ["c.npy"],
    "--parity_min_psnr": ["30.5"], "--convert_embeddings": ["a", "b"],
    "--allow_zero_embeddings": [], "--doctor": [], "--device": ["cpu"],
    "--debug": [], "--profile_dir": ["/p"],
    "--data_parallel": ["off"], "--tensor_parallel": ["2"],
    "--num_hosts": ["3"], "--host_index": ["1"], "--join_parts": [],
    "--coordinator_address": ["h0:1234"],
}


def _capture_parser(call):
    """The ArgumentParser that `call` parses with."""
    seen = []
    orig = argparse.ArgumentParser.parse_args

    def spy(self, *a, **kw):
        seen.append(self)
        return orig(self, *a, **kw)

    argparse.ArgumentParser.parse_args = spy
    try:
        call()
    finally:
        argparse.ArgumentParser.parse_args = orig
    return seen[-1]


def _jax_args(argv):
    old = sys.argv
    sys.argv = ["inference_cli.py", *argv]
    try:
        return inference_cli.parse_arguments()
    finally:
        sys.argv = old


def _actions(parser):
    return {s: a for a in parser._actions for s in a.option_strings}


@pytest.fixture(scope="module")
def parsers():
    return (_actions(_capture_parser(lambda: _jax_args(["in.png"]))),
            _actions(_capture_parser(lambda: cli.parse_arguments(
                ["in.png"]))))


def test_flag_list_is_the_jax_surface(parsers):
    """SAMPLES names every JAX flag, the parallel ones among them, and the
    port has no flag JAX lacks."""
    jax_flags = set(parsers[0]) - {"-h", "--help"}
    assert set(SAMPLES) == jax_flags
    assert set(parsers[1]) - {"-h", "--help"} == set(SAMPLES)


@pytest.mark.parametrize("flag", sorted(SAMPLES))
def test_flag_matches_jax(parsers, flag, capsys):
    """Same default, choices, arity and kind of action, and the same parsed
    value; --device takes cuda where JAX takes tpu."""
    ja, ta = parsers[0][flag], parsers[1][flag]
    assert type(ta) is type(ja) and ta.nargs == ja.nargs
    assert ta.default == ja.default
    jchoices = None if ja.choices is None else set(ja.choices)
    if flag == "--device":
        jchoices = {"auto", "cpu", "cuda"}
    assert (None if ta.choices is None else set(ta.choices)) == jchoices
    argv = ["in.png", flag, *SAMPLES[flag]]
    got = getattr(cli.parse_arguments(argv), ta.dest)
    assert got == getattr(_jax_args(argv), ja.dest)


def test_input_positional_optional():
    assert cli.parse_arguments([]).input is None
    assert _jax_args([]).input is None


@pytest.mark.parametrize("argv", [
    [], ["--preset", "throughput"], ["--preset", "quality"],
    ["--preset", "throughput", "--quant", "q8", "--vae_decode_tile_size",
     "512"],
    ["--preset", "throughput", "--vae_encode_tile_overlap", "16",
     "--tile_mode", "ref"]])
def test_presets_and_explicit_flags_as_jax(argv):
    """tests/test_cli.py's preset cases: the bundle applies where a flag was
    left at its default, explicit flags win, 'quality' changes nothing;
    every value equal to JAX's."""
    t, j = cli.parse_arguments(["in.png", *argv]), _jax_args(["in.png",
                                                              *argv])
    tv, jv = vars(t), vars(j)
    assert set(tv) == set(jv)
    assert tv == {k: jv[k] for k in tv}
    if argv[:2] == ["--preset", "throughput"]:
        assert t.vae_decode_tiled and t.vae_encode_tiled
        assert t.quant == ("q8" if "q8" in argv else "w8a8")
    if argv == ["--preset", "quality"]:
        assert tv == vars(cli.parse_arguments(["in.png"])) | {
            "preset": "quality"}


@pytest.mark.parametrize("bad", [
    ["--resolution", "0"], ["--max_resolution", "-1"], ["--batch_size", "0"],
    ["--chunk_size", "-1"], ["--temporal_overlap", "-1"],
    ["--chunk_size", "4", "--temporal_overlap", "4"], ["--seed", "-1"],
    ["--attention_mode", "fast"], ["--output_format", "gif"]])
def test_argument_checks_exit(bad, capsys):
    with pytest.raises(SystemExit) as ei:
        cli.parse_arguments(["in.png", *bad])
    assert ei.value.code == 2
    with pytest.raises(SystemExit):
        _jax_args(["in.png", *bad])


def test_device_choices(capsys):
    """--device: auto (default) | cpu | cuda; JAX's tpu is refused."""
    assert cli.parse_arguments(["in.png"]).device == "auto"
    assert cli.parse_arguments(["in.png", "--device", "cuda"]).device == \
        "cuda"
    with pytest.raises(SystemExit):
        cli.parse_arguments(["in.png", "--device", "tpu"])


def test_noop_flags_note(capsys):
    cli.parse_arguments(["in.png", "--compile_dit", "--swap_io_components"])
    err = capsys.readouterr().err
    assert "--compile_dit, --swap_io_components" in err and "no-op" in err


@pytest.mark.parametrize("argv,code", [
    ([], 2), (["x.gif"], 2), (["missing.mp4"], 2), (["missing.npy"], 2)])
def test_main_input_errors_exit_2(tmp_path, monkeypatch, argv, code, capsys):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as ei:
        cli.main([*argv, "--device", "cpu"])
    assert ei.value.code == code
    assert "error:" in capsys.readouterr().err


def test_default_output_path_as_jax():
    for fmt in ("mp4", "png"):
        a = cli.default_output_path("/d/clip.mov", fmt)
        b = inference_cli.default_output_path("/d/clip.mov", fmt)
        assert re.sub(r"\d", "0", a) == re.sub(r"\d", "0", b)


def test_video_io_without_opencv_names_it(tmp_path, monkeypatch):
    """Without OpenCV a video, image or directory raises an ImportError
    naming it; .npy frames still stream."""
    monkeypatch.setattr(tvio, "cv2", None)
    path = str(tmp_path / "x.png")
    for call in (lambda: tvio.read_image(path),
                 lambda: tvio.write_image(path, np.zeros((2, 2, 3))),
                 lambda: tvio.VideoReader(path),
                 lambda: tvio.VideoWriter(path, 30.0, (2, 2)),
                 lambda: tvio.read_directory(str(tmp_path))):
        with pytest.raises(ImportError, match="OpenCV"):
            call()
    np.save(tmp_path / "f.npy", np.zeros((2, 4, 4, 3), np.float32))
    assert tvio.ArrayReader(str(tmp_path / "f.npy")).read_frames(5).shape == (
        2, 4, 4, 3)
    open(path, "wb").close()
    with pytest.raises(ImportError, match="OpenCV"):
        cli.main([path, "--device", "cpu"])


# ---------------------------------------------------- the chunk loop alone


def _standin(frames, prepend):
    """A deterministic "upscaler": 2x nearest, mixed with each frame's
    place in its chunk (so chunk cuts and seams show) and the prepend."""
    t = frames.shape[0]
    up = frames.repeat(2, axis=1).repeat(2, axis=2)
    ramp = (np.arange(t, dtype=np.float32) / t)[:, None, None, None]
    return np.clip(0.8 * up + 0.15 * ramp + 0.05 * (prepend > 0), 0,
                   1).astype(np.float32)


def _write_mp4(path, frames_u8):
    import cv2

    h, w = frames_u8.shape[1:3]
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"),
                             10.0, (w, h))
    for f in frames_u8:
        writer.write(f)
    writer.release()


def _png_frames(base):
    import cv2

    d, stem = os.path.split(base)
    names = sorted(f for f in os.listdir(d)
                   if f.startswith(stem + "_") and f.endswith(".png"))
    return [cv2.imread(os.path.join(d, f), cv2.IMREAD_UNCHANGED)
            for f in names]


@pytest.fixture
def standin_clis(monkeypatch):
    """Both CLIs with process_frames replaced by the stand-in and no
    runner or embeddings."""
    monkeypatch.setattr(inference_cli, "make_runner",
                        lambda args, debug: object())
    monkeypatch.setattr(
        inference_cli, "process_frames",
        lambda runner, frames, args, debug, prepend_frames=0: _standin(
            frames, prepend_frames))
    runner = types.SimpleNamespace(streamed_dit=None)
    monkeypatch.setattr(cli, "runner_from_args", lambda args, debug: runner)
    monkeypatch.setattr(cli, "_text_embeds", lambda args, r, debug: None)

    def process(r, frames, embeds, prepend_frames=0, **kw):
        return _standin(frames, prepend_frames), {"dit": 0.0}

    monkeypatch.setattr(cli, "process_frames", process)


CHUNK_CASES = [  # chunk, overlap, skip, cap, prepend
    (0, 0, 0, 0, 0), (5, 2, 0, 0, 0), (4, 1, 2, 0, 0), (3, 2, 1, 7, 2),
    (6, 3, 0, 5, 0), (2, 1, 0, 0, 3), (4, 3, 3, 0, 1)]


@pytest.fixture(scope="module")
def clip13(tmp_path_factory):
    pytest.importorskip("cv2")
    d = tmp_path_factory.mktemp("clip")
    rng = np.random.default_rng(11)
    _write_mp4(d / "in.mp4", rng.integers(0, 256, (13, 12, 16, 3),
                                          dtype=np.uint8))
    # the decoded frames as a .npy array: the same input for the port's
    # array path
    r = tvio.VideoReader(str(d / "in.mp4"))
    np.save(d / "in.npy", r.read_frames(13))
    r.close()
    return d


def _flags(case):
    chunk, overlap, skip, cap, prepend = case
    return ["--chunk_size", str(chunk), "--temporal_overlap", str(overlap),
            "--skip_first_frames", str(skip), "--load_cap", str(cap),
            "--prepend_frames", str(prepend), "--batch_size", "5"]


@pytest.mark.parametrize("fmt", ["png", "mp4"])
@pytest.mark.parametrize("case", CHUNK_CASES)
def test_chunk_loop_matches_jax(clip13, tmp_path, standin_clis, case, fmt):
    """Both process_video loops over the same mp4 with the same stand-in:
    the same frames, each written once (PNG: equal bytes; mp4: equal count
    and size)."""
    from seedvr2_tpu.utils.debug import Debug as JDebug
    from seedvr2_tpu.utils import video_io as jvio

    src = str(clip13 / "in.mp4")
    outs = {k: str(tmp_path / k / f"out.{fmt}") for k in ("port", "jax")}
    argv = [src, "--output_format", fmt, *_flags(case)]
    cli.process_video(cli.parse_arguments(argv + ["--output", outs["port"]]),
                      tdebug.Debug())
    inference_cli.process_video(_jax_args(argv + ["--output", outs["jax"]]),
                                JDebug())
    chunk, overlap, skip, cap, prepend = case
    n = min(13 - skip, cap) if cap else 13 - skip
    if fmt == "png":
        a = _png_frames(os.path.splitext(outs["port"])[0])
        b = _png_frames(os.path.splitext(outs["jax"])[0])
        assert len(a) == len(b) == n
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    else:
        a, b = tvio.VideoReader(outs["port"]), jvio.VideoReader(outs["jax"])
        assert (a.total, a.height, a.width) == (b.total, b.height,
                                                b.width) == (n, 24, 32)
        a.close()
        b.close()


@pytest.mark.parametrize("case", CHUNK_CASES)
def test_chunk_loop_npy_matches_jax_png(clip13, tmp_path, standin_clis,
                                        case):
    """The port's .npy path (memory-mapped reader and writer) through the
    same loop gives the frames JAX's loop writes as PNGs from the mp4
    holding the same decoded frames."""
    import cv2
    from seedvr2_tpu.utils.debug import Debug as JDebug

    out = str(tmp_path / "out.npy")
    cli.process_video(cli.parse_arguments(
        [str(clip13 / "in.npy"), "--output", out, *_flags(case)]),
        tdebug.Debug())
    jout = str(tmp_path / "jax" / "out.png")
    inference_cli.process_video(_jax_args(
        [str(clip13 / "in.mp4"), "--output", jout, "--output_format", "png",
         *_flags(case)]), JDebug())
    got = np.load(out)
    ref = _png_frames(os.path.splitext(jout)[0])
    assert got.shape[0] == len(ref) > 0
    u8 = np.clip(got * 255.0, 0, 255).astype(np.uint8)
    for x, y in zip(u8, ref):
        np.testing.assert_array_equal(x, cv2.cvtColor(y, cv2.COLOR_BGR2RGB))


def test_npy_default_output_and_single_frame(tmp_path, standin_clis):
    """A .npy input without --output writes <input>_upscaled.npy; an
    (H, W, C) array is one frame and comes back (1, H', W', C)."""
    img = np.random.default_rng(3).uniform(0, 1, (6, 8, 4)).astype(
        np.float32)
    np.save(tmp_path / "one.npy", img)
    path = cli.main([str(tmp_path / "one.npy"), "--device", "cpu"])
    assert path == str(tmp_path / "one_upscaled.npy")
    np.testing.assert_array_equal(np.load(path), _standin(img[None], 0))


# -------------------------------------- whole runs with injected noise

EMB_RNG = np.random.default_rng(0)
EMB = {"pos": EMB_RNG.standard_normal((7, 16)).astype(np.float32),
       "neg": EMB_RNG.standard_normal((9, 16)).astype(np.float32)}


@pytest.fixture(scope="module")
def runners():
    jv_cfg, jd_cfg = jc.VAEConfig(**VAE_KW), jc.DiTConfig(**DIT_KW)
    vae_p = random_params(lambda k: init_vae_params(k, jv_cfg,
                                                    dtype=jnp.float32), 2)
    dit_p = random_params(lambda k: jn.init_dit_params(k, jd_cfg,
                                                       dtype=jnp.float32), 3)
    j_runner = JRunner(dit_p, jd_cfg, JVAE(vae_p, jv_cfg, dtype=jnp.float32),
                       JRunnerConfig(dit=jd_cfg, vae=jv_cfg),
                       compute_dtype=jnp.float32)
    tv_cfg, td_cfg = tc.VAEConfig(**VAE_KW), tc.DiTConfig(**DIT_KW)
    vae = VideoAutoencoder(tv_cfg, dtype=torch.float32)
    vae.load_state_dict(state_dict_from_jax(vae_p), strict=True)
    dit = tn.NaDiT(td_cfg, dtype=torch.float32)
    dit.load_state_dict(state_dict_from_jax(dit_p), strict=True)
    t_runner = TRunner(dit, TVAE(vae, torch.float32),
                       tc.RunnerConfig(dit=td_cfg, vae=tv_cfg),
                       compute_dtype=torch.float32)
    return j_runner, t_runner


def _inject_noise(monkeypatch, module):
    """Each upscale call of `module`'s pipeline gets numpy noise made from
    its call count and batch index, the same in both packages."""
    orig = module.upscale_all_batches
    calls = [0]

    def upscale(runner, ctx, *a, **kw):
        k = calls[0]
        calls[0] += 1
        kw["noise_override"] = [
            np.random.default_rng(100 * k + i).standard_normal(
                tuple(lat.shape)).astype(np.float32)
            for i, lat in enumerate(ctx["all_latents"])]
        return orig(runner, ctx, *a, **kw)

    monkeypatch.setattr(module, "upscale_all_batches", upscale)
    return calls


@pytest.fixture
def tiny_clis(runners, monkeypatch):
    j_runner, t_runner = runners
    monkeypatch.setattr(inference_cli, "make_runner",
                        lambda args, debug: j_runner)
    monkeypatch.setattr(cli, "make_runner",
                        lambda device, seed, dit, vae, **kw: t_runner)

    def emb(dirs, debug=None, txt_dim=None, allow_zero=False):
        return EMB

    monkeypatch.setattr(inference_cli, "load_text_embeddings", emb)
    monkeypatch.setattr(cli, "load_text_embeddings", emb)
    return _inject_noise(monkeypatch, jp), _inject_noise(monkeypatch, tp)


def _assert_pngs_close(a_frames, b_frames):
    assert len(a_frames) == len(b_frames) > 0
    a = np.stack(a_frames).astype(np.int16)
    b = np.stack(b_frames).astype(np.int16)
    assert a.shape == b.shape
    diff = np.abs(a - b)
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999


RUN_FLAGS = ["--resolution", "32", "--batch_size", "5", "--color_correction",
             "wavelet"]


@pytest.mark.parametrize("kind", ["image", "video", "directory"])
def test_whole_run_matches_jax(tmp_path, tiny_clis, kind):
    """An image, a 12-frame video in chunks of 7 with overlap 2 (PNG out)
    and a directory of 4 frames, each through both CLIs with the same
    weights, embeddings and noise."""
    import cv2
    from seedvr2_tpu.utils.debug import Debug as JDebug

    rng = np.random.default_rng(5)
    if kind == "image":
        src = str(tmp_path / "in.png")
        cv2.imwrite(src, rng.integers(0, 256, (24, 20, 3), dtype=np.uint8))
        flags = []
        run_jax = inference_cli.process_image
    elif kind == "video":
        src = str(tmp_path / "in.mp4")
        _write_mp4(src, rng.integers(0, 256, (12, 24, 20, 3),
                                     dtype=np.uint8))
        flags = ["--chunk_size", "7", "--temporal_overlap", "2",
                 "--output_format", "png"]
        run_jax = inference_cli.process_video
    else:
        src = str(tmp_path / "frames")
        os.makedirs(src)
        for i in range(4):
            cv2.imwrite(os.path.join(src, f"f{i}.png"),
                        rng.integers(0, 256, (24, 20, 3), dtype=np.uint8))
        flags = ["--output_format", "png"]
        run_jax = inference_cli.process_directory
    outs = {k: str(tmp_path / k / "out.png") for k in ("port", "jax")}
    cli.main([src, "--output", outs["port"], "--device", "cpu", *RUN_FLAGS,
              *flags])
    run_jax(_jax_args([src, "--output", outs["jax"], *RUN_FLAGS, *flags]),
            JDebug())
    j_calls, t_calls = tiny_clis
    assert j_calls[0] == t_calls[0] == (2 if kind == "video" else 1)
    if kind == "image":
        a, b = [cv2.imread(outs["port"])], [cv2.imread(outs["jax"])]
        assert a[0].shape == (38, 32, 3)
    else:
        a = _png_frames(os.path.splitext(outs["port"])[0])
        b = _png_frames(os.path.splitext(outs["jax"])[0])
        assert len(a) == (12 if kind == "video" else 4)
    _assert_pngs_close(a, b)


def test_chunked_equals_unchunked_on_batch_boundaries(runners):
    """tests/test_cli.py's streaming invariant on the port: chunks cut at
    batch boundaries (5 / 10 of 12 frames, batch 5) give the unchunked
    output, each batch seeing the same 4n+1 padding and seeded noise."""
    _, t_runner = runners
    frames = np.random.default_rng(3).uniform(0, 1, (12, 20, 24, 3)).astype(
        np.float32)
    kw = dict(resolution=32, seed=1, batch_size=5, color_correction="wavelet")
    full, _ = cli.process_frames(t_runner, frames, EMB, **kw)
    parts = [cli.process_frames(t_runner, frames[a:b], EMB, **kw)[0]
             for a, b in ((0, 5), (5, 10), (10, 12))]
    np.testing.assert_allclose(np.concatenate(parts), full, rtol=1e-4,
                               atol=1e-4)


@pytest.fixture
def port_runner_cli(runners, monkeypatch):
    """The port's CLI on the tiny runner with the test embeddings."""
    _, t_runner = runners
    monkeypatch.setattr(cli, "make_runner",
                        lambda device, seed, dit, vae, **kw: t_runner)
    monkeypatch.setattr(cli, "load_text_embeddings",
                        lambda dirs, debug=None, txt_dim=None,
                        allow_zero=False: EMB)


def test_npy_stream_equals_whole_run(tmp_path, port_runner_cli):
    """The smoke's phase 3b check at the tiny size: 9 frames in chunks of
    5 with overlap 2 (batch 5) against one chunk: the second chunk's
    batches start where the whole run's second and third do (frames 3 and
    6), and the seam's Hann blend of the held tail with the new head is
    the pipeline's blend of the same two batches, so every frame is equal,
    the seam's two (3, 4) too, under a colour method local to each pixel
    (wavelet; lab matches histograms over each decoded batch, which the
    blend changes); skip 2 and cap 5 equal the 5 frames given directly."""
    frames = np.random.default_rng(8).uniform(0, 1, (9, 24, 20, 3)).astype(
        np.float32)
    np.save(tmp_path / "in.npy", frames)
    np.save(tmp_path / "mid.npy", frames[2:7])
    base = [str(tmp_path / "in.npy"), "--device", "cpu", "--resolution",
            "32", "--temporal_overlap", "2", "--color_correction", "wavelet"]
    whole = np.load(cli.main(base + ["--output", str(tmp_path / "w.npy")]))
    dbg = tdebug.Debug()
    chunked = np.load(cli.main(base + ["--output", str(tmp_path / "c.npy"),
                                       "--chunk_size", "5"], debug=dbg))
    assert whole.shape == chunked.shape == (9, 38, 32, 3)
    np.testing.assert_array_equal(chunked, whole)
    assert [lbl for lbl, _ in dbg.checkpoints
            if lbl.startswith("chunk")] == ["chunk_written[3]",
                                            "chunk_written[9]"]
    capped = np.load(cli.main(base + ["--output", str(tmp_path / "s.npy"),
                                      "--skip_first_frames", "2",
                                      "--load_cap", "5"]))
    direct = np.load(cli.main([str(tmp_path / "mid.npy"), *base[1:],
                               "--output", str(tmp_path / "d.npy")]))
    np.testing.assert_array_equal(capped, direct)


# --------------------------------------------------------------- parity


def test_psnr_matches_jax():
    rng = np.random.default_rng(1)
    a = rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.02, a.shape), 0, 1).astype(np.float32)
    assert tparity.psnr(a, b) == jparity.psnr(a, b)
    assert tparity.psnr(a, a) == jparity.psnr(a, a) == float("inf")
    assert tparity.psnr(a * 0, a * 0 + 0.1) == pytest.approx(20.0, abs=1e-6)


def test_compare_to_capture_matches_jax(tmp_path):
    pytest.importorskip("cv2")
    rng = np.random.default_rng(2)
    cap = rng.uniform(0, 1, (1, 8, 10, 3)).astype(np.float32)
    np.save(tmp_path / "c.npy", cap)
    out = np.clip(cap + rng.normal(0, 0.01, cap.shape), 0, 1).astype(
        np.float32)
    for path in (str(tmp_path / "c.npy"),):
        for min_psnr in (None, 20.0, 90.0):
            assert tparity.compare_to_capture(out, path, min_psnr) == \
                jparity.compare_to_capture(out, path, min_psnr)
    mismatch = tparity.compare_to_capture(out[:, :4], str(tmp_path / "c.npy"))
    assert mismatch == jparity.compare_to_capture(out[:, :4],
                                                  str(tmp_path / "c.npy"))
    assert mismatch["parity"] == "shape_mismatch"
    tvio.write_image(str(tmp_path / "c.png"), cap[0])
    assert tparity.compare_to_capture(out, str(tmp_path / "c.png"), 30.0) == \
        jparity.compare_to_capture(out, str(tmp_path / "c.png"), 30.0)


def test_convert_embeddings_matches_jax(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    torch.save(torch.randn(1, 5, 8), src / "pos_emb.pt")
    torch.save(torch.randn(6, 8).bfloat16(), src / "neg_emb.pt")
    shapes = tparity.convert_embeddings(str(src), str(tmp_path / "t"))
    assert shapes == jparity.convert_embeddings(str(src), str(tmp_path / "j"))
    assert shapes == {"pos_emb": (5, 8), "neg_emb": (6, 8)}
    for name in ("pos_emb", "neg_emb"):
        np.testing.assert_array_equal(
            np.load(tmp_path / "t" / f"{name}.npy"),
            np.load(tmp_path / "j" / f"{name}.npy"))
        a = str(tmp_path / f"t_{name}.safetensors")
        b = str(tmp_path / f"j_{name}.safetensors")
        ta = tparity.convert_embedding_file(str(src / f"{name}.pt"), a)
        jparity.convert_embedding_file(str(src / f"{name}.pt"), b)
        # each package reads the other's file
        np.testing.assert_array_equal(tte._load_one(a), jte._load_one(b))
        np.testing.assert_array_equal(jte._load_one(a), ta)
    with pytest.raises(ValueError):
        tparity.convert_embedding_file(str(src / "pos_emb.pt"),
                                       str(tmp_path / "x.bin"))
    with pytest.raises(FileNotFoundError):
        tparity.convert_embeddings(str(tmp_path / "t"), str(tmp_path / "u"))


def test_cli_convert_embeddings(tmp_path, capsys):
    src = tmp_path / "src"
    src.mkdir()
    torch.save(torch.randn(1, 5, 8), src / "pos_emb.pt")
    torch.save(torch.randn(1, 6, 8), src / "neg_emb.pt")
    assert cli.main(["--convert_embeddings", str(src),
                     str(tmp_path / "dst")]) is None
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["converted"] == {"pos_emb": [5, 8], "neg_emb": [6, 8]}
    assert np.load(tmp_path / "dst" / "pos_emb.npy").shape == (5, 8)


def test_parity_check_exits_below_min_psnr(tmp_path, standin_clis, capsys):
    """--parity_check scores the output against the capture in one JSON
    line; below --parity_min_psnr the CLI exits 1."""
    frames = np.random.default_rng(4).uniform(0, 1, (3, 6, 8, 3)).astype(
        np.float32)
    np.save(tmp_path / "in.npy", frames)
    out = _standin(frames, 0)
    cap = np.clip(out + 0.01, 0, 1).astype(np.float32)
    np.save(tmp_path / "cap.npy", cap)
    score = tparity.psnr(out, cap)
    argv = [str(tmp_path / "in.npy"), "--device", "cpu", "--parity_check",
            "--parity_ref", str(tmp_path / "cap.npy")]
    capsys.readouterr()
    cli.main(argv + ["--parity_min_psnr", str(score - 1)])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["parity"] == "ok" and report["passed"] is True
    assert report["psnr_db"] == round(score, 2)
    with pytest.raises(SystemExit) as ei:
        cli.main(argv + ["--parity_min_psnr", str(score + 1)])
    assert ei.value.code == 1
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["passed"] is False
    cli.main([str(tmp_path / "in.npy"), "--device", "cpu", "--parity_check"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["parity"] == "no_capture"


# ----------------------------------------------------------- embeddings


def test_allow_zero_embeddings_as_jax(tmp_path, monkeypatch, capsys):
    """Without any embedding a published-width model raises in both; with
    allow_zero both give zeros of the published lengths and warn through
    their Debug, forced."""
    monkeypatch.setattr(tte, "ASSET_DIRS", (str(tmp_path / "none"),))
    monkeypatch.setattr(jte, "ASSETS_DIR", str(tmp_path / "none"))
    with pytest.raises(FileNotFoundError):
        tte.load_text_embeddings([str(tmp_path)])
    with pytest.raises(FileNotFoundError):
        jte.load_text_embeddings([str(tmp_path)])
    capsys.readouterr()
    t = tte.load_text_embeddings([str(tmp_path)], tdebug.Debug(),
                                 allow_zero=True)
    t_log = capsys.readouterr().out
    j = jte.load_text_embeddings([str(tmp_path)], jdebug.Debug(),
                                 allow_zero=True)
    j_log = capsys.readouterr().out
    for k in ("pos", "neg"):
        np.testing.assert_array_equal(t[k], j[k])
    assert t["pos"].shape == (58, 5120) and not t["pos"].any()
    assert "text embeddings not found; using zeros" in t_log
    assert _strip(t_log) == _strip(j_log)
    # a custom width gets zeros without the flag, in both
    for k, v in tte.load_text_embeddings([str(tmp_path)], txt_dim=16).items():
        np.testing.assert_array_equal(
            v, jte.load_text_embeddings([str(tmp_path)], txt_dim=16)[k])


# ------------------------------------------------------- attention mode


def test_attention_mode_aliases_as_jax():
    try:
        for mode in ("flash", "xla", "sdpa", "flash_attn"):
            jattn.set_attention_mode(mode)
            assert tattn.resolve_attention_mode(mode) == jattn._DEFAULT_MODE
    finally:
        jattn.set_attention_mode("flash")
    with pytest.raises(ValueError, match="attention mode"):
        tattn.resolve_attention_mode("fast")


def _dit_pair(family):
    jcfg = jc.small_test_config(family=family)
    params = random_params(lambda k: jn.init_dit_params(
        k, jcfg, dtype=jnp.float32), 7)
    model = tn.NaDiT(tc.small_test_config(family=family), dtype=torch.float32)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return jcfg, params, model


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("uniform", [False, True], ids=["grouped", "uniform"])
@pytest.mark.parametrize("family", ["dit_3b", "dit_7b"])
def test_xla_lane_forward_matches_jax(family, uniform, monkeypatch):
    """The tiny 3B and 7B forwards with attention_mode "xla" (and its alias
    "sdpa") against JAX's forward in its xla mode on the same tree, on
    both window plans; the lane calls SDPA and never the K1 / K9
    wrappers."""
    jcfg, params, model = _dit_pair(family)
    shape, txt_len = (3, 16, 22), 7
    rng = np.random.default_rng(42)
    vid = rng.standard_normal((1, *shape, jcfg.vid_in_channels),
                              dtype=np.float32)
    txt = rng.standard_normal((1, txt_len, jcfg.txt_in_dim), dtype=np.float32)
    ts = np.asarray([500.0], np.float32)
    plan = jn.build_dit_plan(jcfg, shape, txt_len, uniform=uniform)
    jattn.set_attention_mode("xla")
    try:
        ref = np.asarray(jax.jit(lambda p, v, x, t: jn.nadit_forward(
            p, jcfg, v, x, t, plan))(params, jnp.asarray(vid),
                                     jnp.asarray(txt), jnp.asarray(ts)))
    finally:
        jattn.set_attention_mode("flash")
    calls = {"sdpa": 0}
    sdpa = tattn.F.scaled_dot_product_attention

    def count(*a, **kw):
        calls["sdpa"] += 1
        return sdpa(*a, **kw)

    def refuse(*a, **kw):
        raise AssertionError("a kernel wrapper in the xla lane")

    monkeypatch.setattr(tattn.F, "scaled_dot_product_attention", count)
    monkeypatch.setattr(tn, "packed_window_attention_grad", refuse)
    monkeypatch.setattr(tn, "packed_window_attention_plain", refuse)
    from seedvr2_tpu_torch.ops import flash_attention as tfa

    monkeypatch.setattr(tfa, "flash_windowed_attention", refuse)
    monkeypatch.setattr(tfa, "flash_windowed_attention_plain", refuse)
    dplan = tn.upload_plan(tn.build_dit_plan(model.cfg, shape, txt_len,
                                             uniform=uniform), model.cfg,
                           "cpu")
    with torch.no_grad():
        outs = [tn.nadit_forward(model, torch.from_numpy(vid),
                                 torch.from_numpy(txt), torch.from_numpy(ts),
                                 dplan, attention_mode=m).numpy()
                for m in ("xla", "sdpa")]
    assert calls["sdpa"] > 0
    np.testing.assert_array_equal(outs[0], outs[1])
    assert outs[0].shape == ref.shape and np.isfinite(outs[0]).all()
    assert _rel_l2(outs[0], ref) < 1e-5


def test_xla_lane_masks_as_jax():
    """The dispatcher's xla mode against JAX's attention on the uniform
    plan's operands: per-window tables, pad keys masked, a window whose
    validity row marks no key NaN as in JAX's composition; and dense with
    a shared table and a kv_len mask."""
    from seedvr2_tpu_torch.ops.gather import RowIndex

    rng = np.random.default_rng(9)
    b, s, h, d, n_u = 4, 40, 2, 16, 3
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for _ in range(3))
    ang = rng.standard_normal((n_u, s, d // 2)).astype(np.float32)
    cos = np.repeat(np.cos(ang), 2, -1)
    sin = np.repeat(np.sin(ang), 2, -1)
    valid = np.ones((n_u, s), bool)
    valid[1, 30:] = False
    valid[2] = False
    ids = np.array([0, 1, 2, 1])
    jattn.set_attention_mode("xla")
    try:
        ref = np.asarray(jattn.attention(
            *map(jnp.asarray, (q, k, v)), rope_cos=cos, rope_sin=sin,
            table_ids=ids, kv_valid=valid))
        dense_ref = np.asarray(jattn.attention(
            *map(jnp.asarray, (q, k, v)), rope_cos=cos[0, :30],
            rope_sin=sin[0, :30], kv_len=25))
    finally:
        jattn.set_attention_mode("flash")
    t = [torch.from_numpy(x) for x in (q, k, v)]
    out = tattn.attention(*t, rope_cos=torch.from_numpy(cos),
                          rope_sin=torch.from_numpy(sin),
                          table_ids=RowIndex(ids, "cpu"),
                          kv_valid=torch.from_numpy(valid), mode="xla").numpy()
    assert np.isnan(out[2]).all() and np.isnan(ref[2]).all()
    live = [0, 1, 3]
    assert _rel_l2(out[live], ref[live]) < 1e-5
    dense = tattn.attention(*t, rope_cos=torch.from_numpy(cos[0, :30]),
                            rope_sin=torch.from_numpy(sin[0, :30]),
                            kv_len=25, mode="sdpa").numpy()
    assert _rel_l2(dense, dense_ref) < 1e-5


def _configure(d, **kw):
    from seedvr2_tpu_torch.core import model_manager as tmm

    return tmm.configure_runner(DIT_NAME, VAE_NAME, base_cache_dir=str(d),
                                device="cpu", compute_dtype=torch.float32,
                                dit_cache=True, vae_cache=True, **kw)


def test_configure_runner_keys_cache_on_attention_mode(tiny_checkpoints):  # noqa: F811
    """The mode is part of the runner cache's key (JAX
    model_manager.py:313-318): another mode is another runner on the same
    cached DiT and VAE; an alias resolves to its mode's runner; the runner
    hands its mode to the forwards (the same output to fp32 noise on the
    CPU, where the flash wrappers run their plain versions)."""
    cache = model_cache.get_global_cache()
    cache.clear()
    try:
        flash = _configure(tiny_checkpoints)
        xla = _configure(tiny_checkpoints, attention_mode="xla")
        assert xla is not flash and xla.dit is flash.dit
        assert xla.vae is flash.vae
        assert _configure(tiny_checkpoints, attention_mode="sdpa") is xla
        assert _configure(tiny_checkpoints,
                          attention_mode="flash_attn") is flash
        assert (flash.attention_mode, xla.attention_mode) == ("flash", "xla")
        assert cache.stats() == {"dit": 1, "vae": 1, "runners": 2}
        images = np.random.default_rng(1).uniform(0, 1, (1, 24, 20, 3)).astype(
            np.float32)
        # without colour correction: lab's rank swaps would amplify the
        # lanes' fp32 noise (tests/test_torch_pipeline.py)
        a, _ = cli.process_frames(flash, images, EMB, resolution=32,
                                  color_correction="none")
        b, _ = cli.process_frames(xla, images, EMB, resolution=32,
                                  color_correction="none")
        assert np.abs(a - b).max() < 1e-4
    finally:
        cache.clear()


def test_runner_from_args_passes_mode_and_flags(monkeypatch):
    seen = {}

    def configure(dit, vae, **kw):
        seen.update(kw, dit=dit, vae=vae)
        return types.SimpleNamespace(attention_mode=kw["attention_mode"])

    monkeypatch.setattr(cli, "configure_runner", configure)
    args = cli.parse_arguments(
        ["x.npy", "--device", "cpu", "--attention_mode", "sdpa",
         "--dit_model", "random", "--cache_dit", "--blocks_to_swap", "3",
         "--quant", "q8"])
    cli.runner_from_args(args, tdebug.Debug())
    assert (seen["dit"], seen["vae"]) == (None, cli.DEFAULT_VAE)
    assert (seen["attention_mode"], seen["dit_cache"], seen["vae_cache"],
            seen["quant"], seen["block_swap_config"]) == (
        "sdpa", True, False, "q8", {"blocks_to_swap": 3})
    assert seen["device"] == torch.device("cpu")


# ---------------------------------------------------------------- debug


def _strip(text):
    """Log lines without their times and numbers."""
    return [re.sub(r"[-+]?\d+(\.\d+)?", "#", ln) for ln in text.splitlines()]


def _drive(dbg):
    dbg.checkpoint("a")
    dbg.start_timer("phase1_encoding")
    dbg.start_timer("inner")
    dbg.end_timer("inner", "inner step")
    dbg.end_timer("phase1_encoding", "Phase 1: VAE encoding complete",
                  show_breakdown=True)
    with dbg.timer("phase2_upscaling", "Phase 2: DiT upscaling complete"):
        pass
    dbg.checkpoint("b")
    dbg.log("hello", category="video", force=True)
    dbg.summary({"total_swaps": 2, "block_swaps": 2, "block_avg_ms": 1.5,
                 "measured_transfer_ms": 3.0})


def test_debug_log_text_matches_jax(capsys):
    """The same calls log the same lines (times and numbers aside):
    timers with their breakdown, checkpoint deltas, the summary's phase
    shares and BlockSwap line."""
    _drive(tdebug.Debug(enabled=True))
    t_log = capsys.readouterr().out
    _drive(jdebug.Debug(enabled=True))
    j_log = capsys.readouterr().out
    # JAX's CPU backend reports its device memory (HBM 0/0), the port on
    # the CPU has no device: compare the rest
    j_lines = [re.sub(r"HBM #(/#GB \(peak #GB\)|GB), ", "", ln)
               for ln in _strip(j_log)]
    assert _strip(t_log) == j_lines
    assert "checkpoint[b] (delta RAM" in t_log and "RSS" in t_log
    assert "blockswap: 2 swaps" in t_log and "phase1_encoding:" in t_log
    _drive(tdebug.Debug(enabled=False))
    quiet = capsys.readouterr().out.splitlines()
    assert len(quiet) == 1 and quiet[0].endswith("[video] hello")


def test_debug_memory_without_psutil(monkeypatch):
    """Without psutil the RSS comes from /proc/self/statm and RAM from
    /proc/meminfo, close to psutil's values."""
    with_ps = tdebug.Debug().memory_state()
    monkeypatch.setattr(tdebug, "psutil", None)
    dbg = tdebug.Debug()
    a = dbg.checkpoint("one")
    b = dbg.checkpoint("two")
    assert set(a) == set(with_ps) == {"ram_used_gb", "ram_total_gb",
                                      "rss_gb"}
    assert abs(a["rss_gb"] - with_ps["rss_gb"]) < 0.2 * with_ps["rss_gb"]
    assert a["ram_total_gb"] == pytest.approx(with_ps["ram_total_gb"],
                                              rel=1e-3)
    assert [lbl for lbl, _ in dbg.checkpoints] == ["one", "two"]
    assert b["rss_gb"] > 0


def test_process_frames_with_debug_profiles_each_phase(runners, tmp_path):
    """With a Debug, process_frames writes a chrome trace per phase into
    profile_dir/<phase>, checkpoints after each phase and times them, and
    returns the output it returns without one."""
    _, t_runner = runners
    images = np.random.default_rng(2).uniform(0, 1, (1, 24, 20, 3)).astype(
        np.float32)
    dbg = tdebug.Debug(profile_dir=str(tmp_path))
    out, timings = cli.process_frames(t_runner, images, EMB, resolution=32,
                                      debug=dbg)
    ref, _ = cli.process_frames(t_runner, images, EMB, resolution=32)
    np.testing.assert_array_equal(out, ref)
    phases = ["phase1_encode", "phase2_upscale", "phase3_decode",
              "phase4_postprocess"]
    for name, path in zip(phases, dbg.traces):
        assert os.path.dirname(path) == str(tmp_path / name)
        with open(path) as f:
            assert "traceEvents" in json.load(f)
    assert len(dbg.traces) == 4
    assert [lbl for lbl, _ in dbg.checkpoints] == [
        "pre_phase1", "post_phase1", "post_phase2", "post_phase3",
        "post_phase4"]
    assert dbg.elapsed("phase2_upscaling") >= timings["dit"] > 0


# --------------------------------------------------------------- doctor


def test_doctor_sections_and_exit_3_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lines = []
    rc = tdoctor.run_doctor(model_dir=str(tmp_path), echo=lines.append)
    out = "\n".join(lines)
    assert rc == 3
    for needle in ("seedvr2 doctor", "torch ", "numpy ", "opencv",
                   "host library (g++)", "CUDA kernel library",
                   "memory-probe cache", "model search dirs",
                   f"{cli.DEFAULT_DIT}: NOT FOUND",
                   "(packaged published embeddings)",
                   "backend UNAVAILABLE: no CUDA device"):
        assert needle in out, needle
    with pytest.raises(SystemExit) as ei:
        cli.main(["--doctor", "--model_dir", str(tmp_path)])
    assert ei.value.code == 3


# ----------------------------------------------------------------- YAML

YAML_3B = """\
dit:
  model:
    __object__:
      path: models.dit.nadit
      name: NaDiT
      args: as_params
    vid_in_channels: 33
    vid_out_channels: 16
    vid_dim: 96
    txt_in_dim: 40
    head_dim: 32
    heads: ${eval:'${.vid_dim} // ${.head_dim}'}
    expand_ratio: 4
    norm: fusedrms
    norm_eps: 1.0e-05
    qk_bias: False
    qk_norm: ${.norm}
    patch_size: [1, 2, 2]
    num_layers: 4
    mm_layers: ${eval:'${.num_layers} // 2'}
    mlp_type: swiglu
    window: ${eval:'${.num_layers} * [(4,3,3)]'}
    window_method: ${eval:'${.num_layers} // 2 * ["720pwin_by_size_bysize", "720pswin_by_size_bysize"]'}
    rope_type: mmrope3d
    rope_dim: ${eval:'${.head_dim}'}
    vid_out_norm: fusedrms
"""

YAML_7B = """\
dit:
  model:
    __object__:
      path: models.dit_7b.nadit
      name: NaDiT
    vid_in_channels: 33
    vid_out_channels: 16
    vid_dim: ${eval:'24 * ${.head_dim}'}
    txt_in_dim: 5120
    heads: 24
    head_dim: 128
    norm_eps: 1e-5
    num_layers: ${eval:'6 * 6'}
    mlp_type: normal
    shared_qkv: False
    shared_mlp: False
    window: ${eval:'${.num_layers} * [(4,3,3)]'}
"""

YAML_VAE = """\
__object__:
  path: models.video_vae_v3.modules.attn_video_vae
  name: VideoAutoencoderKLWrapper
in_channels: 3
out_channels: 3
latent_channels: 16
block_out_channels: [32, 64, 128, 128]
layers_per_block: 2
norm_num_groups: 16
temporal_scale_num: 2
spatial_downsample_factor: 8
temporal_downsample_factor: 4
slicing_sample_min_size: 4
"""


@pytest.mark.parametrize("name,text", [("3b", YAML_3B), ("7b", YAML_7B),
                                       ("vae", YAML_VAE)])
def test_yaml_configs_match_jax(tmp_path, name, text):
    """OmegaConf-format YAMLs with ${.x} and ${eval:'...'} parse field for
    field equal to JAX's parser."""
    pytest.importorskip("yaml")
    path = str(tmp_path / f"{name}.yaml")
    with open(path, "w") as f:
        f.write(text)
    fn = "vae_config_from_yaml" if name == "vae" else "dit_config_from_yaml"
    out = getattr(tyaml, fn)(path)
    ref = getattr(jyaml, fn)(path)
    assert dataclasses.asdict(out) == dataclasses.asdict(ref)
    if name == "3b":
        assert (out.heads, out.mm_layers, out.num_layers) == (3, 2, 4)
        assert out.window == (4, 3, 3) and out.family == "dit_3b"
    if name == "7b":
        assert (out.family, out.vid_dim, out.num_layers) == ("dit_7b", 3072,
                                                            36)


def test_yaml_heterogeneous_windows_refused(tmp_path):
    pytest.importorskip("yaml")
    path = tmp_path / "bad.yaml"
    path.write_text(YAML_3B.replace("${.num_layers} * [(4,3,3)]",
                                    "[(4,3,3), (2,2,2), (4,3,3), (4,3,3)]"))
    with pytest.raises(ValueError, match="heterogeneous"):
        tyaml.dit_config_from_yaml(str(path))
