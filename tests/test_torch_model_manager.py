"""core/model_manager.py, core/model_cache.py and utils/constants.py against
the JAX package's, on the CPU in fp32 with tiny checkpoints: the memory
planner over a grid of limits, the model search path, configure_runner
(the four phases against JAX's runner, the cache, forced and planned
streaming, phase offload), and the CLI's memory flags and embedding
search. The card's limit is monkeypatched in both packages (the CPU has
none), so every plan runs here; tests/test_torch_cuda.py and chip_smoke.py
run them on the card."""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import inference_cli
from seedvr2_tpu.core import model_manager as jmm
from seedvr2_tpu.core import pipeline as jp
from seedvr2_tpu.core.export import save_checkpoint
from seedvr2_tpu.models.dit.nadit import init_dit_params
from seedvr2_tpu.models.vae.pipeline_vae import init_vae_params
from seedvr2_tpu.utils import constants as jconst
from seedvr2_tpu_torch import cli
from seedvr2_tpu_torch.core import model_cache
from seedvr2_tpu_torch.core import model_manager as tmm
from seedvr2_tpu_torch.core.runner import VAETiling
from seedvr2_tpu_torch.ops import offload
from seedvr2_tpu_torch.utils import constants as tconst

from .test_integration_cli import _tiny_dit_cfg, _tiny_vae_cfg
from .test_torch_dit import random_params
from .test_torch_offload import port_dit

DIT_NAME, VAE_NAME = "tiny_3b_fp32.safetensors", "tiny_vae_fp32.safetensors"


@pytest.fixture(scope="module")
def tiny_checkpoints(tmp_path_factory):
    """Tiny DiT + VAE safetensors of tests/test_integration_cli.py's
    configs (seeded numpy values, nothing compiled), and text
    embeddings."""
    d = tmp_path_factory.mktemp("models")
    save_checkpoint(random_params(lambda k: init_dit_params(
        k, _tiny_dit_cfg(), dtype=jnp.float32), 7),
        str(d / DIT_NAME), dtype=np.float32)
    save_checkpoint(random_params(lambda k: init_vae_params(
        k, _tiny_vae_cfg(), dtype=jnp.float32), 8),
        str(d / VAE_NAME), dtype=np.float32)
    rng = np.random.default_rng(9)
    np.save(d / "pos_emb.npy", rng.standard_normal((7, 16)).astype(np.float32))
    np.save(d / "neg_emb.npy", rng.standard_normal((9, 16)).astype(np.float32))
    return d


@pytest.fixture(autouse=True)
def empty_caches():
    model_cache.get_global_cache().clear()
    jmm.get_global_cache().clear()
    yield
    model_cache.get_global_cache().clear()
    jmm.get_global_cache().clear()


def _limit(monkeypatch, limit):
    """The card's limit in both packages' planners."""
    monkeypatch.setattr(tmm, "_device_limit", lambda device: limit)
    monkeypatch.setattr(jmm, "_hbm_bytes_limit", lambda: limit)


@pytest.mark.parametrize("lane", ["fp32", "w8a8", "q8"])
def test_plan_block_streaming_matches_jax(lane, monkeypatch):
    """_plan_block_streaming and _per_chip_dit_bytes equal JAX's over a
    grid of card limits (from far above the model to below one block) and
    blocks_to_swap, on each lane's bytes; so do the phase-offload verdicts
    configure_runner draws from them."""
    jtree, model = port_dit(lane)
    nbytes = tmm._tree_bytes(model)
    assert nbytes == jmm._tree_bytes(jtree)
    for ways in (1, 2):
        assert (tmm._per_chip_dit_bytes(model, ways)
                == jmm._per_chip_dit_bytes(jtree, ways))
    from seedvr2_tpu.utils.debug import NULL_DEBUG

    for frac in (None, 0.05, 0.2, 0.31, 0.5, 0.69, 0.7, 0.71, 0.9, 1.5, 4.0):
        limit = None if frac is None else int(nbytes / frac)
        _limit(monkeypatch, limit)
        for swap in (0, 1, 2, 3, 7):
            assert tmm._plan_block_streaming(model, swap, "cuda") == \
                jmm._plan_block_streaming(jtree, model.cfg, swap, NULL_DEBUG)
        if limit is not None:
            assert (nbytes > tmm._PHASE_OFFLOAD_FRACTION * limit) == (
                jmm._per_chip_dit_bytes(jtree, 1)
                > jmm._PHASE_OFFLOAD_FRACTION * limit)
    assert (tmm._AUTO_SWAP_FRACTION, tmm._PHASE_OFFLOAD_FRACTION) == (
        jmm._AUTO_SWAP_FRACTION, jmm._PHASE_OFFLOAD_FRACTION)


def test_find_model_path_matches_jax(tmp_path, monkeypatch):
    """find_model_path and candidate_model_dirs equal JAX's on a temporary
    tree: $SEEDVR2_MODEL_PATHS first, then the base dir, then a ComfyUI
    root's models/SEEDVR2 and its extra_model_paths.yaml (when yaml is
    installed); file names match case-insensitively; a missing name is
    None in both."""
    env_a, env_b, base = (tmp_path / n for n in ("env_a", "env_b", "base"))
    comfy = tmp_path / "comfy"
    extra = tmp_path / "extra"
    for d in (env_a, env_b, base, comfy / "models" / "SEEDVR2", extra):
        d.mkdir(parents=True)
    (env_b / "Both.safetensors").write_bytes(b"x")
    (base / "both.safetensors").write_bytes(b"x")
    (base / "Base_Only.GGUF").write_bytes(b"x")
    (comfy / "models" / "SEEDVR2" / "comfy.pth").write_bytes(b"x")
    (extra / "extra.safetensors").write_bytes(b"x")
    (comfy / "extra_model_paths.yaml").write_text(
        f"mine:\n  base_path: {tmp_path}\n  SeedVR2: |\n    extra\n")
    monkeypatch.setenv("SEEDVR2_MODEL_PATHS", f"{env_a}{os.pathsep}{env_b}")
    monkeypatch.setenv("COMFYUI_PATH", str(comfy))
    abs_file = str(base / "both.safetensors")
    names = ("both.safetensors", "BOTH.SAFETENSORS", "base_only.gguf",
             "comfy.pth", "extra.safetensors", "missing.safetensors",
             abs_file)
    for base_dir in (str(base), None):
        assert tconst.candidate_model_dirs(base_dir) == \
            jconst.candidate_model_dirs(base_dir)
        for name in names:
            assert tconst.find_model_path(name, base_dir) == \
                jconst.find_model_path(name, base_dir), (name, base_dir)
    assert tconst.find_model_path("both.safetensors", str(base)) == str(
        env_b / "Both.safetensors")
    assert tconst.find_model_path("base_only.gguf", str(base)) == str(
        base / "Base_Only.GGUF")
    assert tconst.find_model_path("missing.safetensors", str(base)) is None


def _configure(d, **kw):
    return tmm.configure_runner(DIT_NAME, VAE_NAME, base_cache_dir=str(d),
                                device="cpu", compute_dtype=torch.float32,
                                **kw)


def _jax_configure(d, **kw):
    return jmm.configure_runner(dit_model=DIT_NAME, vae_model=VAE_NAME,
                                base_cache_dir=str(d),
                                compute_dtype=jnp.float32, **kw)


def _request(seed=3):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (5, 24, 20, 3)).astype(np.float32)
    emb = {"pos": rng.standard_normal((7, 16)).astype(np.float32),
           "neg": rng.standard_normal((9, 16)).astype(np.float32)}
    noise = [rng.standard_normal((2, 6, 4, 4)).astype(np.float32)]
    return images, emb, noise


def _port_phases(runner, images, emb, noise):
    return cli.process_frames(runner, images, emb, resolution=32, seed=1,
                              batch_size=5, color_correction="none",
                              noise_override=noise)


def _jax_phases(runner, images, emb, noise):
    ctx = jp.setup_generation_context()
    ctx = jp.encode_all_batches(runner, ctx, images, batch_size=5,
                                resolution=32, color_correction="none",
                                seed=1)
    ctx["text_embeds"] = emb
    ctx = jp.upscale_all_batches(runner, ctx, seed=1, noise_override=noise)
    ctx = jp.decode_all_batches(runner, ctx)
    ctx = jp.postprocess_all_batches(ctx, color_correction="none",
                                     batch_size=5)
    return ctx["final_video"]


def test_configure_runner_unmocked_matches_jax(tiny_checkpoints):
    """configure_runner loads the files JAX's configure_runner loads, sniffs
    the same configs and gives JAX's result through the four phases (the
    tolerance of tests/test_torch_pipeline.py's default path); the tiny
    model on the CPU streams nothing and stays resident."""
    runner = _configure(tiny_checkpoints)
    jr = _jax_configure(tiny_checkpoints)
    assert runner.dit_cfg.vid_dim == 24 and runner.dit_cfg.num_layers == 2
    assert runner.vae.cfg.block_out_channels == (8, 8, 16, 16)
    assert runner.streamed_dit is None and not runner.phase_offload
    assert jr.streamed_dit is None
    images, emb, noise = _request()
    out, _ = _port_phases(runner, images, emb, noise)
    ref = _jax_phases(jr, images, emb, noise)
    assert out.shape == ref.shape == (5, 38, 32, 3)
    assert np.abs(out - ref).max() < 1e-4


def test_configure_runner_cache_reuses_runner(tiny_checkpoints, monkeypatch):
    """With --cache_dit --cache_vae a second call returns the same runner
    without reading either file again; another tiling makes a new runner on
    the cached DiT and VAE (no reads); without the flags every call
    reads."""
    reads = {"dit": 0, "vae": 0}
    read_dit, read_vae = tmm.read_dit_model, tmm.load_vae_checkpoint

    def count(kind, fn):
        def call(*a, **k):
            reads[kind] += 1
            return fn(*a, **k)
        return call

    monkeypatch.setattr(tmm, "read_dit_model", count("dit", read_dit))
    monkeypatch.setattr(tmm, "load_vae_checkpoint", count("vae", read_vae))
    first = _configure(tiny_checkpoints, dit_cache=True, vae_cache=True)
    again = _configure(tiny_checkpoints, dit_cache=True, vae_cache=True)
    assert again is first and reads == {"dit": 1, "vae": 1}
    tiled = _configure(tiny_checkpoints, dit_cache=True, vae_cache=True,
                       tiling=VAETiling(decode_tiled=True))
    assert tiled is not first and reads == {"dit": 1, "vae": 1}
    assert tiled.dit is first.dit and tiled.vae is first.vae
    assert model_cache.get_global_cache().stats() == {
        "dit": 1, "vae": 1, "runners": 2}
    # without the flags the models are read again (the runner cache is
    # consulted first, as in JAX, so it is emptied here)
    model_cache.get_global_cache().clear("runner")
    _configure(tiny_checkpoints)
    assert reads == {"dit": 2, "vae": 2}


def test_configure_runner_dit_cache_follows_the_plan(tiny_checkpoints,
                                                     monkeypatch):
    """A cached DiT is reused only where the plan it was placed for still
    holds: the same card reuses it, a card that calls for another plan
    (here streaming after phase offload) loads it again."""
    reads = []
    read_dit = tmm.read_dit_model
    monkeypatch.setattr(tmm, "read_dit_model",
                        lambda *a, **k: reads.append(1) or read_dit(*a, **k))
    nbytes = tmm._tree_bytes(_configure(tiny_checkpoints).dit)
    reads.clear()
    _limit(monkeypatch, int(nbytes / 0.5))
    first = _configure(tiny_checkpoints, dit_cache=True)
    same = _configure(tiny_checkpoints, dit_cache=True,
                      tiling=VAETiling(decode_tiled=True))
    assert first.phase_offload and same.dit is first.dit and len(reads) == 1
    _limit(monkeypatch, int(nbytes / 0.8))
    streamed = _configure(tiny_checkpoints, dit_cache=True)
    assert streamed.streamed_dit is not None and len(reads) == 2
    assert streamed.dit is not first.dit


@pytest.mark.parametrize("quant", ["none", "w8a8"])
def test_configure_runner_blockswap_engages(tiny_checkpoints, quant):
    """An explicit blocks_to_swap wires StreamedNaDiT into the product path
    (test_integration_cli.py's test of the same name): keep = layers -
    swapped, the runner serves the streamed model, and its four phases equal
    the resident runner's bit for bit; JAX's configure_runner keeps the same
    number. The w8a8 conversion runs a block at a time and its joined
    gate / up weights stay one storage through the packing."""
    kw = dict(quant=quant, min_dim=8, align=8)
    regular = _configure(tiny_checkpoints, **kw)
    swapped = _configure(tiny_checkpoints,
                         block_swap_config={"blocks_to_swap": 1}, **kw)
    jswapped = _jax_configure(tiny_checkpoints,
                              block_swap_config={"blocks_to_swap": 1})
    assert swapped.streamed_dit is not None
    assert swapped.streamed_dit.keep_blocks == jswapped.streamed_dit.keep_blocks
    assert swapped.streamed_dit.keep_blocks == 1  # 2 layers - 1 swapped
    images, emb, noise = _request(4)
    ref, _ = _port_phases(regular, images, emb, noise)
    out, timings = _port_phases(swapped, images, emb, noise)
    assert np.array_equal(out, ref)
    assert swapped.streamed_dit.stats.summary()["block_swaps"] >= 1
    assert "dit_swap_stall" in timings
    if quant == "w8a8":
        assert (tmm._tree_bytes(swapped.dit) == tmm._tree_bytes(regular.dit))


@pytest.mark.parametrize("frac,plan", [(0.5, "offload"), (0.8, "stream")])
def test_configure_runner_plans_by_card_memory(tiny_checkpoints, monkeypatch,
                                               frac, plan):
    """With the card's limit monkeypatched so that the DiT takes `frac` of
    it, configure_runner picks JAX's plan (phase offload between 30 % and
    70 %, streaming with the planner's keep above) and the runner's four
    phases equal the resident runner's bit for bit; random weights drawn
    for the host take the same values as those drawn where they serve."""
    regular = _configure(tiny_checkpoints)
    nbytes = tmm._tree_bytes(regular.dit)
    _limit(monkeypatch, int(nbytes / frac))
    runner = _configure(tiny_checkpoints)
    jr = _jax_configure(tiny_checkpoints)
    assert runner.phase_offload == (plan == "offload") == bool(
        getattr(jr, "phase_offload", False))
    if plan == "stream":
        assert runner.streamed_dit.keep_blocks == jr.streamed_dit.keep_blocks
    images, emb, noise = _request(5)
    ref, _ = _port_phases(regular, images, emb, noise)
    out, _ = _port_phases(runner, images, emb, noise)
    assert np.array_equal(out, ref)
    small = dict(dit_cfg=regular.dit_cfg, vae_cfg=regular.vae.cfg, seed=3,
                 device="cpu", compute_dtype=torch.float32)
    drawn = tmm.configure_runner(**small)
    monkeypatch.setattr(tmm, "_device_limit", lambda device: None)
    direct = tmm.configure_runner(**small)
    for a, b in zip(drawn.dit.state_dict().values(),
                    direct.dit.state_dict().values()):
        assert torch.equal(a, b)


def test_configure_runner_missing_file_names_dirs(tiny_checkpoints,
                                                  tmp_path):
    with pytest.raises(FileNotFoundError, match=str(tmp_path)):
        tmm.configure_runner("absent.safetensors", VAE_NAME,
                             base_cache_dir=str(tmp_path), device="cpu")


@pytest.mark.parametrize("quant", ["w8a8", "q8", "q4"])
def test_quantize_dit_by_block_equals_whole(quant):
    """The host DiT's conversion a part at a time (every block, then the IO
    modules, a top-level linear included) equals quantize_dit on the whole
    model, tensor for tensor, with the joined gate / up kept joined."""
    from seedvr2_tpu_torch.core.loader import quantize_dit

    _, a = port_dit("fp32")
    _, b = port_dit("fp32")
    quantize_dit(a, quant, False, 8 if quant == "w8a8" else 16, 8)
    tmm.quantize_dit_by_block(b, quant, False, "cpu",
                              8 if quant == "w8a8" else 16, 8)
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert type(a.txt_in) is type(b.txt_in)
    assert tmm._tree_bytes(a) == tmm._tree_bytes(b)


def test_cli_memory_flags_match_jax(monkeypatch):
    """--blocks_to_swap, --swap_io_components, --cache_dit, --cache_vae and
    --model_dir parse as JAX's parse_arguments does, with its defaults."""
    monkeypatch.setattr(sys, "argv", ["inference_cli.py", "in.png"])
    jargs = inference_cli.parse_arguments()
    args = cli.parse_arguments(["in.npy"])
    names = ("blocks_to_swap", "swap_io_components", "cache_dit",
             "cache_vae", "model_dir")
    assert {n: getattr(args, n) for n in names} == {
        n: getattr(jargs, n) for n in names} == dict(
        blocks_to_swap=0, swap_io_components=False, cache_dit=False,
        cache_vae=False, model_dir="./models")
    flags = ["--blocks_to_swap", "12", "--swap_io_components", "--cache_dit",
             "--cache_vae", "--model_dir", "/m"]
    monkeypatch.setattr(sys, "argv", ["inference_cli.py", "in.png", *flags])
    jargs = inference_cli.parse_arguments()
    args = cli.parse_arguments(["in.npy", *flags])
    assert {n: getattr(args, n) for n in names} == {
        n: getattr(jargs, n) for n in names}


def test_cli_searches_model_dir_then_package_dir(tmp_path, monkeypatch,
                                                capsys):
    """cli.main hands --model_dir and the memory flags to make_runner, and
    reads the text embeddings from the model dir, then the package's own
    directory (the JAX CLI's model dir, then its own directory), the
    packaged assets last; the BlockSwap summary is printed when streaming
    engaged."""
    _, model = port_dit("fp32")
    seen = {}

    def make_runner(device, seed, dit_model, vae_model, **kw):
        seen.update(kw)
        streamed = offload.StreamedNaDiT(model, keep_blocks=2, device="cpu")
        return tmm.VideoDiffusionRunner(None, None, tmm.RunnerConfig(
            dit=model.cfg), compute_dtype=torch.float32,
            streamed_dit=streamed)

    def load(dirs, debug=None, txt_dim=None, allow_zero=False):
        seen["dirs"] = list(dirs)
        return {"pos": np.ones((7, txt_dim), np.float32),
                "neg": np.ones((9, txt_dim), np.float32)}

    def process(runner, frames, embeds, **kw):
        runner.streamed_dit.stats.record(1.0)
        return frames, {}

    monkeypatch.setattr(cli, "make_runner", make_runner)
    monkeypatch.setattr(cli, "load_text_embeddings", load)
    monkeypatch.setattr(cli, "process_frames", process)
    path = tmp_path / "in.npy"
    np.save(path, np.zeros((1, 8, 8, 3), np.float32))
    cli.main([str(path), "--device", "cpu", "--model_dir", str(tmp_path),
              "--blocks_to_swap", "1", "--cache_dit"])
    assert "BlockSwap (keep 2/3 blocks on the card)" in \
        capsys.readouterr().err
    assert seen["dirs"] == [str(tmp_path), os.path.dirname(cli.__file__)]
    assert (seen["model_dir"], seen["blocks_to_swap"], seen["dit_cache"],
            seen["vae_cache"]) == (str(tmp_path), 1, True, False)
    # the real search: a model dir's file wins over the packaged ones
    from seedvr2_tpu_torch.utils.text_embeds import load_text_embeddings

    np.save(tmp_path / "pos_emb.npy", np.full((3, 16), 2.0, np.float32))
    emb = load_text_embeddings(seen["dirs"], txt_dim=16)
    assert emb["pos"].shape == (3, 16) and (emb["pos"] == 2.0).all()
