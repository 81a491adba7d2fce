"""The plain reference against the program's CPU path at tiny sizes: the
NaDiT (3B and 7B wiring, bf16-free float32 and the w8a8 lane), the VAE
(untiled and over the uniform tiles), the transforms and the LAB colour fix,
and a whole request through `cli.process_frames`."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import weights
from benchmark.reference import color, dit as ref_dit, geometry, \
    pipeline as ref_pipeline, vae as ref_vae
from benchmark.reference.params import StateParams
from seedvr2_tpu_torch import cli
from seedvr2_tpu_torch.core.configs import VAEConfig, small_test_config
from seedvr2_tpu_torch.core.runner import VAETiling
from seedvr2_tpu_torch.models.dit.nadit import (NaDiT, build_dit_plan,
                                                nadit_forward, upload_plan)
from seedvr2_tpu_torch.models.vae.model import VideoAutoencoder
from seedvr2_tpu_torch.models.vae.pipeline_vae import VideoVAE
from seedvr2_tpu_torch.ops.int8_matmul import quantize_dit_w8a8
from seedvr2_tpu_torch.utils import color_fix, transforms

TINY_VAE = VAEConfig(block_out_channels=(8, 16, 32, 32), norm_num_groups=4)


def _dit_dict(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _state(spec, seed, dtype=torch.float32):
    return weights.draw(spec, torch.Generator().manual_seed(seed), dtype)


def _port_dit(cfg, state):
    model = NaDiT(cfg, dtype=torch.float32)
    model.load_state_dict(state, strict=True)
    return model


@pytest.mark.parametrize("family", ["dit_3b", "dit_7b"])
def test_dit_spec_matches_the_program(family):
    cfg = small_test_config(family, num_layers=3)
    with torch.device("meta"):
        model = NaDiT(cfg)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {k: s for k, s, _ in weights.dit_spec(_dit_dict(cfg))}
    assert got == want


def test_vae_spec_matches_the_program():
    with torch.device("meta"):
        model = VideoAutoencoder(TINY_VAE)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    vae = dataclasses.asdict(TINY_VAE)
    assert {k: s for k, s, _ in weights.vae_spec(vae)} == want


@pytest.mark.parametrize("family,quant", [("dit_3b", "none"),
                                          ("dit_7b", "none"),
                                          ("dit_7b", "w8a8")])
def test_nadit_matches_the_program(family, quant):
    # a grid of several plain and shifted windows
    cfg = small_test_config(family, num_layers=3)
    d = _dit_dict(cfg)
    state = _state(weights.dit_spec(d), 1)
    g = torch.Generator().manual_seed(2)
    vid = torch.randn((2, 48, 80, cfg.vid_in_channels), generator=g)
    txt = torch.randn((7, cfg.txt_in_dim), generator=g)
    model = _port_dit(cfg, state)
    if quant == "w8a8":
        quantize_dit_w8a8(model, min_dim=32, align=32)
    plan = upload_plan(build_dit_plan(cfg, (2, 48, 80), 7), cfg, "cpu")
    want = nadit_forward(model, vid[None], txt[None],
                         torch.tensor([1000.0]), plan, use_kernels=False)[0]
    rule = ref_dit.w8a8_converts
    try:
        if quant == "w8a8":  # the tiny model's layers convert at 32
            ref_dit.w8a8_converts = lambda k, n: min(k, n) >= 32 \
                and k % 32 == 0 and n % 32 == 0
        got = ref_dit.nadit(d, state, vid, txt, 1000.0, quant)
    finally:
        ref_dit.w8a8_converts = rule
    # relative L2: in the int8 lane a rounding step that the two sides' last
    # float bits put on either side of a level moves that product by one
    # step of its row's scale
    err = (got - want).norm() / want.norm()
    assert err < (1e-3 if quant == "w8a8" else 1e-5), float(err)


def _port_vae(state):
    model = VideoAutoencoder(TINY_VAE, dtype=torch.float32)
    model.load_state_dict(state, strict=True)
    return VideoVAE(model, torch.float32)


@pytest.mark.parametrize("frames", [1, 5, 9])
def test_vae_matches_the_program(frames):
    vae = dataclasses.asdict(TINY_VAE)
    state = _state(weights.vae_spec(vae), 3)
    port = _port_vae(state)
    x = torch.rand((frames, 32, 48, 3),
                   generator=torch.Generator().manual_seed(4)) * 2 - 1
    lat = port.encode(x[None])[0]
    got = ref_vae.encode(vae, StateParams(state), x)
    assert torch.allclose(got, lat, atol=1e-4, rtol=1e-4)
    want = port.decode(lat[None])[0]
    got = ref_vae.decode(vae, StateParams(state), lat)
    assert got.shape == want.shape
    assert torch.allclose(got, want, atol=1e-4, rtol=1e-4)


def test_tiled_vae_matches_the_program():
    vae = dataclasses.asdict(TINY_VAE)
    state = _state(weights.vae_spec(vae), 5)
    port = _port_vae(state)
    p = StateParams(state)
    x = torch.rand((1, 64, 112, 3),
                   generator=torch.Generator().manual_seed(6)) * 2 - 1
    kw = dict(tile_size=(48, 64), tile_overlap=(16, 16))
    lat = port.encode(x[None], tiled=True, **kw)[0]
    got = ref_vae.encode_tiled(vae, p, x, (48, 64), (16, 16))
    assert torch.allclose(got, lat, atol=1e-4, rtol=1e-4)
    want = port.decode(lat[None], tiled=True, **kw)[0]
    got = ref_vae.decode_tiled(vae, p, lat, (48, 64), (16, 16))
    assert torch.allclose(got, want, atol=1e-4, rtol=1e-4)


def test_transforms_and_colour_match_the_program():
    g = torch.Generator().manual_seed(7)
    frames = torch.rand((3, 27, 41, 3), generator=g)
    want = transforms.prepare_video(frames, 48)
    got = ref_pipeline.prepare(frames, 48)
    assert torch.allclose(got, want, atol=1e-6)
    assert geometry.target_dims(27, 41, 48) == transforms.compute_target_dims(
        27, 41, 48)
    content = torch.rand((3, 40, 56, 3), generator=g) * 2 - 1
    style = torch.rand((3, 40, 56, 3), generator=g) * 2 - 1
    assert torch.allclose(color.lab_color_transfer(content, style),
                          color_fix.lab_color_transfer(content, style),
                          atol=1e-5)


def test_request_matches_process_frames(monkeypatch):
    """A whole request: the program on the CPU in float32 against the
    reference, on the same weights, frames, noise and text."""
    dcfg = small_test_config("dit_3b", num_layers=2)
    monkeypatch.setattr(cli, "VAE_V3", TINY_VAE)
    d, vae = _dit_dict(dcfg), dataclasses.asdict(TINY_VAE)
    runner = cli.make_runner(torch.device("cpu"), seed=0, dit_cfg=dcfg)
    dit_state = _state(weights.dit_spec(d), 8, torch.bfloat16)
    vae_state = _state(weights.vae_spec(vae), 9, torch.bfloat16)
    runner.dit.load_state_dict(dit_state)
    runner.vae.model.load_state_dict(vae_state)
    rng = np.random.default_rng(10)
    frames = rng.random((5, 24, 40, 3), dtype=np.float32)
    noise = torch.randn((2, 6, 10, 16), generator=torch.Generator()
                        .manual_seed(11)).bfloat16().float()
    txt = torch.randn((5, dcfg.txt_in_dim), generator=torch.Generator()
                      .manual_seed(12)).bfloat16().float()
    out, _ = cli.process_frames(runner, frames, {"pos": txt, "neg": txt},
                                resolution=48, seed=0,
                                noise_override=[noise])
    cfg = {"dit": d, "vae": vae, "lane": {
        "vae_tiling": dataclasses.asdict(VAETiling()),
        "color_correction": "lab"}}
    ref = ref_pipeline.request(cfg, {"resolution": 48, "batch_size": 5},
                               dit_state, vae_state, frames, noise, txt)
    assert ref.shape == out.shape
    err = np.abs(ref.numpy() - out)
    print("request err", err.mean(), err.max())
    assert err.mean() < 0.02 and err.max() < 0.5, (err.mean(), err.max())
