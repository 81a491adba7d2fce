"""seedvr2_tpu_torch.interfaces (the four SeedVR2 nodes and the workflow
runner) against the JAX package's seedvr2_tpu.interfaces, on the CPU:

 - the loader nodes' config dicts key for key and value for value, their
   ValueError checks, `_node_tile`, NODE_CLASS_MAPPINGS and
   `available_models` on a temporary model directory;
 - a node request (SeedVR2VideoUpscaler.execute) of both packages on
   tests/test_torch_model_manager.py's tiny checkpoints, fp32 in both
   (configure_runner's compute dtype set to fp32 in each nodes module), the
   port on device "cpu": 7 frames with 2 prepended, batches of 5 with
   overlap 2 (three batches), the same numpy noise fed through each
   package's upscale_all_batches(noise_override=...). The frames agree
   within 1e-4, the bound tests/test_torch_pipeline.py holds the whole
   slice to without a histogram colour method; the progress values are
   equal, monotone and end at 1.0;
 - the device strings: "cpu", a card without a GPU (raises), a DiT and a
   VAE on different devices (ValueError), the `random` model name;
 - the workflow runner: each shipped examples/workflows/*.json with the
   upscaler stood in (as tests/test_components.py's
   test_workflow_file_execution does) yields the same kwargs in both
   packages, but the loaders' default device; one whole tiny workflow runs
   through both packages with its model names pointed at the tiny
   checkpoints; an unknown node type raises as in JAX;
 - the two example modules (seedvr2_tpu_torch/examples/).

Nothing is downloaded: every name resolves to a local file, and the
registry's download URL points at a closed local port in both packages."""

import copy
import functools
import glob
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import seedvr2_tpu.interfaces as jif
from seedvr2_tpu.core import model_manager as jmm
from seedvr2_tpu.core import pipeline as jp
from seedvr2_tpu.interfaces import nodes as jnodes
from seedvr2_tpu.interfaces import workflow as jwf
from seedvr2_tpu.utils import downloads as jdl
import seedvr2_tpu_torch.interfaces as tif
from seedvr2_tpu_torch.core import model_cache
from seedvr2_tpu_torch.core import pipeline as tp
from seedvr2_tpu_torch.interfaces import nodes as tnodes
from seedvr2_tpu_torch.interfaces import workflow as twf
from seedvr2_tpu_torch.utils import downloads as tdl

from .test_torch_model_manager import DIT_NAME, VAE_NAME, tiny_checkpoints  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKFLOWS = sorted(glob.glob(os.path.join(ROOT, "examples", "workflows",
                                          "*.json")))


@pytest.fixture(autouse=True)
def fp32_no_network(monkeypatch):
    """Both packages' nodes build fp32 runners; no download leaves the
    machine; the model caches start and end empty."""
    monkeypatch.setattr(jnodes, "configure_runner", functools.partial(
        jmm.configure_runner, compute_dtype=jnp.float32))
    monkeypatch.setattr(tnodes, "configure_runner", functools.partial(
        tnodes.configure_runner, compute_dtype=torch.float32))
    for dl in (tdl, jdl):
        monkeypatch.setattr(dl, "HUGGINGFACE_BASE_URL",
                            "http://127.0.0.1:9/{repo}/{filename}")
    model_cache.get_global_cache().clear()
    jmm.get_global_cache().clear()
    yield
    model_cache.get_global_cache().clear()
    jmm.get_global_cache().clear()


# ------------------------------------------------------------ config dicts

DIT_CASES = [
    {},
    dict(model="m.safetensors", device="cuda:0", offload_device="cpu",
         cache_model=True, blocks_to_swap=4),
    dict(model="x.gguf", device="cuda:0", offload_device="cpu",
         swap_io_components=True, attention_mode="sdpa", quant="q4k",
         torch_compile_args={"backend": "inductor"}),
    dict(quant="w8a8", attention_mode="xla", device="cpu"),
]
DIT_ERRORS = [dict(blocks_to_swap=2, offload_device="none"),
              dict(blocks_to_swap=2, device="cpu", offload_device="cpu"),
              dict(swap_io_components=True),
              dict(cache_model=True)]
VAE_CASES = [
    {},
    dict(model="v.safetensors", encode_tiled=True, device="cpu"),
    dict(decode_tiled=True, decode_tile_size=1024, decode_tile_overlap=128,
         encode_tile_size=0, tile_debug="decode", tile_mode="ref",
         offload_device="cpu", cache_model=True, device="cuda:0"),
]
COMPILE_CASES = [{}, dict(backend="cudagraphs", mode="max-autotune",
                          fullgraph=True, dynamic=True,
                          dynamo_cache_size_limit=8,
                          dynamo_recompile_limit=16)]


def _without_device(d):
    return {k: v for k, v in d.items() if k != "device"}


@pytest.mark.parametrize("node,cases", [
    ("SeedVR2LoadDiTModel", DIT_CASES), ("SeedVR2LoadVAEModel", VAE_CASES),
    ("SeedVR2TorchCompileSettings", COMPILE_CASES)])
def test_node_dicts_match_jax(node, cases):
    """The same arguments give JAX's dict, key for key and value for value;
    where the device is left at its default, the port's is "cuda:0" where
    JAX's is "tpu:0", and every other entry is equal."""
    tcls, jcls = getattr(tnodes, node), getattr(jnodes, node)
    for kw in cases:
        t, j = tcls.execute(**kw), jcls.execute(**kw)
        assert list(t) == list(j)
        if "device" in j and "device" not in kw:
            assert (t["device"], j["device"]) == ("cuda:0", "tpu:0")
            t, j = _without_device(t), _without_device(j)
        assert t == j


@pytest.mark.parametrize("kw", DIT_ERRORS)
def test_dit_node_refusals_match_jax(kw):
    """BlockSwap without an offload device (or onto the node's own device)
    and cache_model without an offload device raise ValueError in both."""
    for cls in (tnodes.SeedVR2LoadDiTModel, jnodes.SeedVR2LoadDiTModel):
        with pytest.raises(ValueError) as e:
            cls.execute(**kw)
        assert "offload_device" in str(e.value)
    with pytest.raises(ValueError, match="cache_model"):
        tnodes.SeedVR2LoadVAEModel.execute(cache_model=True)
    with pytest.raises(ValueError, match="cache_model"):
        jnodes.SeedVR2LoadVAEModel.execute(cache_model=True)


def test_node_tile_and_mappings_match_jax():
    for v in (0, "auto", 64, 512, 1024, "768", 512.0):
        assert tnodes._node_tile(v) == jnodes._node_tile(v), v
    assert tnodes._node_tile(0) == "auto"
    assert tnodes._node_tile(512) == (512, 512)
    assert list(tif.NODE_CLASS_MAPPINGS) == list(jif.NODE_CLASS_MAPPINGS)
    for name, cls in tif.NODE_CLASS_MAPPINGS.items():
        assert cls is getattr(tnodes, name)
        assert cls.__module__ == "seedvr2_tpu_torch.interfaces.nodes"
    assert tif.comfy_entrypoint() is tif.NODE_CLASS_MAPPINGS
    assert tnodes.SeedVR2VideoUpscaler.PHASE_WEIGHTS == \
        jnodes.SeedVR2VideoUpscaler.PHASE_WEIGHTS


def test_available_models_match_jax(tmp_path):
    for name in ("mine_fp16.safetensors", "seedvr2_ema_3b_fp16.safetensors",
                 "q.gguf", "old.pth", "notes.txt", "vae_custom.safetensors"):
        (tmp_path / name).write_bytes(b"x")
    for node in ("SeedVR2LoadDiTModel", "SeedVR2LoadVAEModel"):
        tcls, jcls = getattr(tnodes, node), getattr(jnodes, node)
        for d in (None, str(tmp_path), str(tmp_path / "absent")):
            assert tcls.available_models(d) == jcls.available_models(d)
    assert "q.gguf" in tnodes.SeedVR2LoadDiTModel.available_models(
        str(tmp_path))


# ------------------------------------------------------------ node request

def _noise(n_batches, seed=21, latent_frames=2):
    """Per-batch noise of the tiny models' latent at 32 px from 24x20
    frames: 5 frames (or a padded shorter batch) encode to 2 latent frames,
    one frame to 1."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((latent_frames, 6, 4, 4)).astype(np.float32)
            for _ in range(n_batches)]


def _inject(monkeypatch, noise):
    """Each package's phase 2 takes the given per-batch noise."""
    for mod in (jp, tp):
        monkeypatch.setattr(mod, "upscale_all_batches", functools.partial(
            mod.upscale_all_batches, noise_override=noise))


def _request(node_mod, d, device, progress, **kw):
    dit = node_mod.SeedVR2LoadDiTModel.execute(model=DIT_NAME, **device)
    vae = node_mod.SeedVR2LoadVAEModel.execute(model=VAE_NAME, **device)
    return node_mod.SeedVR2VideoUpscaler.execute(
        dit=dit, vae=vae, model_dir=str(d), progress_callback=progress.append,
        **kw)


def test_node_request_matches_jax(tiny_checkpoints, monkeypatch):  # noqa: F811
    """7 frames of 24x20, 2 prepended, to 32 px in batches of 5 with
    overlap 2 and wavelet colour (three batches): the port's node on the
    CPU against JAX's, within 1e-4, with equal progress reports."""
    images = np.random.default_rng(3).uniform(0, 1, (7, 24, 20, 3)).astype(
        np.float32)
    _inject(monkeypatch, _noise(3))
    kw = dict(image=images, seed=5, resolution=32, batch_size=5,
              temporal_overlap=2, prepend_frames=2)
    t_prog, j_prog = [], []
    out = _request(tnodes, tiny_checkpoints, {"device": "cpu"}, t_prog, **kw)
    ref = _request(jnodes, tiny_checkpoints, {}, j_prog, **kw)
    assert out.shape == ref.shape == (7, 38, 32, 3)
    assert np.abs(out - ref).max() < 1e-4
    assert np.allclose(t_prog, j_prog, rtol=0, atol=1e-12)
    assert len(t_prog) == 3 + 3 + 3 + 3
    assert all(b >= a for a, b in zip(t_prog, t_prog[1:]))
    assert t_prog[-1] == pytest.approx(1.0)


def test_node_devices(tiny_checkpoints, monkeypatch):  # noqa: F811
    """A DiT and a VAE dict on different devices raise ValueError; a card
    on a host without a GPU raises (no CPU fallback); `cuda` is the
    current card; `random` draws the runner's weights from the request's
    seed (no file is looked for)."""
    up = tnodes.SeedVR2VideoUpscaler
    img = np.zeros((1, 8, 8, 3), np.float32)

    def dicts(dit_dev, vae_dev, model=DIT_NAME):
        return (tnodes.SeedVR2LoadDiTModel.execute(model=model,
                                                   device=dit_dev),
                tnodes.SeedVR2LoadVAEModel.execute(model=VAE_NAME,
                                                   device=vae_dev))

    dit, vae = dicts("cpu", "cuda:0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        up.execute(image=img, dit=dit, vae=vae, seed=1,
                   model_dir=str(tiny_checkpoints))
    for a, b in (("cpu", "cuda:1"), ("cuda:0", "cuda:1"), ("cuda", "cuda:1")):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
        with pytest.raises(ValueError, match="one device"):
            up.execute(image=img, dit=dicts(a, b)[0], vae=dicts(a, b)[1],
                       seed=1, model_dir=str(tiny_checkpoints))
    assert tnodes._runner_device(*dicts("cuda", "cuda:0")) == torch.device(
        "cuda", 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="'cuda\\[:N\\]' or 'cpu'"):
        tnodes._runner_device(*dicts("meta", "meta"))
    seen = []
    monkeypatch.setattr(tnodes, "configure_runner",
                        lambda **kw: seen.append(kw) or 1 / 0)
    with pytest.raises(ZeroDivisionError):
        up.execute(image=img, dit=dicts("cpu", "cpu", "random")[0],
                   vae=dicts("cpu", "cpu")[1], seed=7, model_dir="m")
    assert seen[0]["dit_model"] is None and seen[0]["seed"] == 7
    assert seen[0]["vae_model"] == VAE_NAME
    assert seen[0]["device"] == torch.device("cpu")


# ------------------------------------------------------------ workflows

@pytest.mark.parametrize("path", WORKFLOWS,
                         ids=[os.path.basename(p) for p in WORKFLOWS])
def test_workflow_file_kwargs_match_jax(path, monkeypatch):
    """Each shipped workflow, with the upscaler stood in: the same kwargs
    reach it in both packages (the loaders' default device apart)."""
    calls = {}

    def stand_in(tag):
        def execute(cls, **kw):
            calls[tag] = kw
            return kw["image"] * 2
        return classmethod(execute)

    monkeypatch.setattr(tnodes.SeedVR2VideoUpscaler, "execute",
                        stand_in("port"))
    monkeypatch.setattr(jnodes.SeedVR2VideoUpscaler, "execute",
                        stand_in("jax"))
    img = np.ones((2, 8, 8, 3), np.float32)
    outs = {"port": twf.run_workflow_file(path, {"image": img}),
            "jax": jwf.run_workflow_file(path, {"image": img})}
    assert list(outs["port"]) == list(outs["jax"]) == ["dit", "vae", "up"]
    assert np.array_equal(outs["port"]["up"], img * 2)
    t, j = calls["port"], calls["jax"]
    assert list(t) == list(j)
    for k in ("dit", "vae"):
        assert (t[k]["device"], j[k]["device"]) == ("cuda:0", "tpu:0")
        assert _without_device(t[k]) == _without_device(j[k])
    assert {k: v for k, v in t.items() if k not in ("dit", "vae")} == \
        {k: v for k, v in j.items() if k not in ("dit", "vae")}
    assert t["dit"]["model"] == "seedvr2_ema_3b_fp16.safetensors"


def test_whole_workflow_matches_jax(tiny_checkpoints, monkeypatch):  # noqa: F811
    """examples/workflows/simple_image.json, its models pointed at the tiny
    checkpoints and its resolution at 32 px in memory only (the port's
    loaders on the CPU): both packages' run_workflow give the same frame,
    within 1e-4, from the same injected noise."""
    with open(os.path.join(ROOT, "examples", "workflows",
                           "simple_image.json")) as f:
        wf = json.load(f)
    params = {n["id"]: n["params"] for n in wf["nodes"]}
    params["dit"]["model"], params["vae"]["model"] = DIT_NAME, VAE_NAME
    params["up"].update(resolution=32, model_dir=str(tiny_checkpoints))
    port_wf = copy.deepcopy(wf)
    for n in port_wf["nodes"]:
        if n["id"] in ("dit", "vae"):
            n["params"]["device"] = "cpu"
    _inject(monkeypatch, _noise(1, seed=4, latent_frames=1))
    img = np.random.default_rng(2).uniform(0, 1, (1, 24, 20, 3)).astype(
        np.float32)
    out = twf.run_workflow(port_wf, {"image": img})["up"]
    ref = jwf.run_workflow(wf, {"image": img})["up"]
    assert out.shape == ref.shape == (1, 38, 32, 3)
    assert np.abs(out - ref).max() < 1e-4


def test_unknown_node_type_raises_as_jax():
    wf = {"nodes": [{"id": "x", "type": "SeedVR2Nope", "params": {}}]}
    for run in (twf.run_workflow, jwf.run_workflow):
        with pytest.raises(ValueError, match="unknown node type: SeedVR2Nope"):
            run(wf)
    with pytest.raises(KeyError):
        twf.run_workflow({"nodes": [{"id": "up", "type": "SeedVR2LoadDiTModel",
                                     "inputs": {"model": "__input__"}}]})


def test_examples_drive_the_port(monkeypatch, capsys):
    """The two example modules: upscale_image.main reads an image, builds
    the loader dicts and calls the upscaler node (stood in here) with the
    JAX example's arguments, then writes the first frame; the streaming
    example's command is the port CLI's and parses with its flags."""
    from seedvr2_tpu_torch import cli
    from seedvr2_tpu_torch.examples import upscale_image as ex_image
    from seedvr2_tpu_torch.examples import upscale_video_streaming as ex_video

    frames = np.full((1, 4, 6, 3), 0.5, np.float32)
    calls = {}
    monkeypatch.setattr(ex_image.video_io, "read_image", lambda p: frames)
    monkeypatch.setattr(ex_image.video_io, "write_image",
                        lambda p, f: calls.update(written=(p, f.shape)))

    def execute(cls, **kw):
        calls.update(kw)
        return kw["image"]

    monkeypatch.setattr(tnodes.SeedVR2VideoUpscaler, "execute",
                        classmethod(execute))
    ex_image.main("in.png", "out.png", 720)
    assert calls["dit"] == tnodes.SeedVR2LoadDiTModel.execute(
        model="seedvr2_ema_3b_fp16.safetensors", attention_mode="flash")
    assert calls["vae"]["model"] == "ema_vae_fp16.safetensors"
    assert (calls["seed"], calls["resolution"], calls["color_correction"],
            calls["written"]) == (42, 720, "lab", ("out.png", (4, 6, 3)))
    assert ex_video.CMD[1:3] == ["-m", "seedvr2_tpu_torch.cli"]
    args = cli.parse_arguments(ex_video.CMD[3:])
    assert (args.chunk_size, args.batch_size, args.temporal_overlap,
            args.vae_decode_tiled, args.cache_dit, args.cache_vae) == (
        125, 21, 4, True, True, True)
    capsys.readouterr()
