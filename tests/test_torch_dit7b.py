"""The port's 7B NaDiT against the JAX package's on the CPU in fp32: a tiny
`small_test_config(family="dit_7b")` tree with seeded numpy values, carried
across by the weight bridge. The 7B's structure (vid and txt weights in
every block, unshared qk norms, the plain gelu-tanh MLP with biases, rope3d
on the video rows only, no output norm, the upscaler's `emb_scale`), its
forward on the grouped and the uniform window plans, and its q8, q4 and
w8a8 conversions and forwards, and the whole 4-phase slice with a tiny 7B
DiT (dense and w8a8), at the tolerances the 3B tests use (1e-4:
tests/test_torch_dit.py, test_torch_quant.py, test_torch_loader.py,
test_torch_pipeline.py).
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from seedvr2_tpu.core.configs import DIT_7B as JDIT_7B
from seedvr2_tpu.core.configs import small_test_config as j_small
from seedvr2_tpu.models.dit import nadit as jn
from seedvr2_tpu.ops import int8_matmul as jim
from seedvr2_tpu.ops import quant_matmul as jqm
from seedvr2_tpu_torch.core import configs as tc
from seedvr2_tpu_torch.core.weights import state_dict_from_jax
from seedvr2_tpu_torch.models.dit import nadit as tn
from seedvr2_tpu_torch.ops import int8_matmul as tim
from seedvr2_tpu_torch.ops import layers as tl
from seedvr2_tpu_torch.ops import quant_matmul as tqm

from .test_torch_dit import assert_bridge_matches_export, random_params

TOL = dict(rtol=1e-4, atol=1e-4)
MIN_DIM, ALIGN = 64, 32
TXT_LEN = 7


def _cfgs(**kw):
    return (dataclasses.replace(tc.small_test_config(family="dit_7b"), **kw),
            dataclasses.replace(j_small(family="dit_7b"), **kw))


def _params(jcfg, seed=0):
    return random_params(lambda k: jn.init_dit_params(
        k, jcfg, dtype=jnp.float32), seed)


def _model(cfg, tree):
    model = tn.NaDiT(cfg, dtype=torch.float32)
    model.load_state_dict(state_dict_from_jax(tree), strict=True)
    return model


@pytest.fixture(scope="module")
def pair():
    cfg, jcfg = _cfgs()
    params = _params(jcfg, 17)
    return cfg, jcfg, params, _model(cfg, params)


def _inputs(cfg, shape, seed=42):
    rng = np.random.default_rng(seed)
    vid = rng.standard_normal((1, *shape, cfg.vid_in_channels),
                              dtype=np.float32)
    txt = rng.standard_normal((1, TXT_LEN, cfg.txt_in_dim), dtype=np.float32)
    return vid, txt


def _forwards(model, jcfg, tree, shape, uniform=False, downscale=None):
    """(port, JAX) forward outputs on the same seeded input."""
    cfg = model.cfg
    vid, txt = _inputs(cfg, shape)
    plan = jn.build_dit_plan(jcfg, shape, TXT_LEN, uniform=uniform)
    ds = None if downscale is None else jnp.asarray([downscale])
    ref = np.asarray(jax.jit(lambda p, v, x, t: jn.nadit_forward(
        p, jcfg, v, x, t, plan, downscale=ds))(
            tree, jnp.asarray(vid), jnp.asarray(txt), jnp.asarray([500.0])))
    dplan = tn.upload_plan(tn.build_dit_plan(cfg, shape, TXT_LEN,
                                             uniform=uniform), cfg, "cpu")
    with torch.no_grad():
        out = tn.nadit_forward(
            model, torch.from_numpy(vid), torch.from_numpy(txt),
            torch.tensor([500.0]), dplan,
            downscale=None if downscale is None else torch.tensor(
                [downscale])).numpy()
    assert out.shape == (1, *shape, cfg.vid_out_channels)
    assert np.isfinite(out).all()
    return out, ref


# ------------------------------------------------------------ structure


def test_7b_state_dict_equals_export(pair):
    """The bridge carries a 7B tree onto the port's NaDiT key for key and
    bit for bit (seedvr2_tpu.core.export.to_torch_state_dict); the keys
    show the 7B's structure."""
    cfg, _, params, _ = pair
    module = tn.NaDiT(cfg, dtype=torch.float32)
    assert_bridge_matches_export(params, module)
    keys = module.state_dict().keys()
    assert not any(".all." in k for k in keys)
    assert not any(k.startswith("vid_out_norm") or "vid_out_ada" in k
                   for k in keys)
    last = cfg.num_layers - 1
    assert f"blocks.{last}.mlp.txt.proj_in.bias" in keys
    assert "blocks.0.attn.norm_q.txt.weight" in keys
    assert not any("proj_in_gate" in k for k in keys)


def test_7b_qk_norms_unshared_with_shared_qkv():
    """A 7B config with shared qkv (shared_qkv=True) keeps vid and txt qk
    norms, as the JAX tree does (the 3B's norms follow its qkv)."""
    cfg, jcfg = _cfgs(shared_qkv=True)
    params = _params(jcfg, 3)
    assert_bridge_matches_export(params, tn.NaDiT(cfg, dtype=torch.float32))
    attn = tn.NaDiT(cfg, device="meta").blocks[0].attn
    assert set(attn.proj_qkv) == {"all"}
    assert set(attn.norm_q) == set(attn.norm_k) == {"vid", "txt"}


def test_init_dit_7b_keys_and_distributions():
    """init_dit of the 7B (with the upscaler) has the JAX init's keys and
    shapes, and its new modules JAX's distributions: the MLP's weights and
    biases and emb_scale's U(+-1/sqrt(fan_in))."""
    cfg, jcfg = _cfgs(vid_dim=128, head_dim=64, upscaler=True)
    gen = torch.Generator().manual_seed(0)
    model = tn.init_dit(cfg, "cpu", torch.float32, generator=gen)
    shapes = jax.eval_shape(lambda k: jn.init_dit_params(
        k, jcfg, dtype=jnp.float32), jax.random.PRNGKey(0))
    ref = state_dict_from_jax(jax.tree_util.tree_map(
        lambda x: np.zeros(x.shape, np.float32), shapes))
    sd = model.state_dict()
    assert sd.keys() == ref.keys()
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(ref[k].shape), k
    for name in ("blocks.0.mlp.vid.proj_in", "blocks.1.mlp.txt.proj_out",
                 "emb_scale.proj_hid"):
        lin = model.get_submodule(name)
        bound = 1 / np.sqrt(lin.in_features)
        for p in (lin.weight, lin.bias):
            assert p.abs().max() <= bound
            assert abs(p.std().item() - bound / np.sqrt(3)) < 0.15 * bound
    assert torch.all(sd["blocks.0.attn.norm_k.txt.weight"] == 1)


@pytest.mark.parametrize("shape", [(2, 5, 7), (16,)])
def test_gelu_tanh_matches_jax(shape):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32) * 4
    np.testing.assert_allclose(
        tl.gelu_tanh(torch.from_numpy(x)).numpy(),
        np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=True)),
        rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ forwards


@pytest.mark.parametrize("shape", [(3, 8, 10), (1, 6, 6), (5, 12, 8)])
def test_7b_forward_matches_jax(pair, shape):
    """The grouped plan (the runner's): K1 and K2's plain versions here,
    text rows un-roped."""
    _, jcfg, params, model = pair
    out, ref = _forwards(model, jcfg, params, shape)
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("shape", [(3, 8, 10), (5, 12, 8)])
def test_7b_uniform_forward_matches_jax(pair, shape):
    """The uniform window plan (K9's plain version), against JAX's uniform
    forward and the port's grouped one."""
    _, jcfg, params, model = pair
    out, ref = _forwards(model, jcfg, params, shape, uniform=True)
    np.testing.assert_allclose(out, ref, **TOL)
    grouped, _ = _forwards(model, jcfg, params, shape)
    np.testing.assert_allclose(out, grouped, **TOL)


def test_7b_upscaler_forward_matches_jax():
    """cfg.upscaler: emb_scale's embedding of a downscale factor is added
    to the time embedding; without a downscale (what the runner passes)
    emb_scale is not used."""
    cfg, jcfg = _cfgs(upscaler=True)
    params = _params(jcfg, 19)
    model = _model(cfg, params)
    assert model.emb_scale is not None
    out, ref = _forwards(model, jcfg, params, (3, 8, 10), downscale=2.0)
    np.testing.assert_allclose(out, ref, **TOL)
    plain, plain_ref = _forwards(model, jcfg, params, (3, 8, 10))
    np.testing.assert_allclose(plain, plain_ref, **TOL)
    assert np.abs(out - plain).max() > 1e-3


# ------------------------------------------------------------ lanes


def _convert(kind, model, params):
    """(port model converted in place, JAX tree) for a lane."""
    if kind == "q8":
        return (tqm.quantize_dit_q8(model, MIN_DIM),
                jqm.quantize_dit_params(params, min_dim=MIN_DIM))
    if kind == "q4":
        return (tqm.quantize_dit_affine4(model, MIN_DIM),
                jqm.quantize_dit_params_affine4(params, min_dim=MIN_DIM))
    return (tim.quantize_dit_w8a8(model, MIN_DIM, ALIGN),
            jim.quantize_dit_params_w8a8(params, min_dim=MIN_DIM,
                                         align=ALIGN))


LANE_CLS = {"q8": tqm.Q8Linear, "q4": tqm.AffineLinear,
            "w8a8": tim.W8A8Linear}


@pytest.mark.parametrize("kind", ["q8", "q4", "w8a8"])
def test_7b_conversion_matches_jax(pair, kind):
    """Each lane converts exactly the linears JAX converts, the biased MLP
    linears among them, with equal integers and tables; the w8a8 7B has no
    gate/up pair to join, and its MLP runs each linear on its own."""
    cfg, _, params, _ = pair
    conv, jtree = _convert(kind, _model(cfg, params), params)
    bridged = state_dict_from_jax(jtree)
    sd = conv.state_dict()
    assert sd.keys() == bridged.keys()
    for k, v in bridged.items():
        assert sd[k].dtype == v.dtype, k
        np.testing.assert_array_equal(sd[k].numpy(), v.numpy(), err_msg=k)
    mlp = conv.blocks[0].mlp["vid"]
    assert isinstance(mlp.proj_in, LANE_CLS[kind])
    assert isinstance(mlp.proj_out, LANE_CLS[kind])
    assert mlp.proj_in.bias is not None and mlp.proj_out.bias is not None
    assert not any(hasattr(m, "gate_up_w8a8") for m in conv.modules())


@pytest.mark.parametrize("kind", ["q8", "q4", "w8a8"])
def test_7b_lane_forward_matches_jax(pair, kind):
    """The converted 7B's forward against JAX's converted forward (K3-K4
    or K6/K7 plain versions here; w8a8's MLP proj_in takes K4's fused
    quantize, its proj_out a plain per-row quantize, as JAX's)."""
    cfg, jcfg, params, _ = pair
    conv, jtree = _convert(kind, _model(cfg, params), params)
    conv.load_state_dict(state_dict_from_jax(jtree), strict=True)
    out, ref = _forwards(conv, jcfg, jtree, (3, 8, 10))
    np.testing.assert_allclose(out, ref, **TOL)


def test_7b_plans_cover_every_full_width_product():
    """Every linear of the full-width 7B that the lanes convert, at the
    token counts the served requests give (the time embedding's row, the
    58 text rows, the 720p clip's 7200, the 1080p image's 8160 and clip's
    16320), gets tiles the kernels take: K3's plan_qx and K6/K7's
    plan_tiles, K = 12288 among them."""
    with torch.device("meta"):
        model = tn.NaDiT(tc.DIT_7B, dtype=torch.bfloat16)
    shapes = {(m.out_features, m.in_features) for m in model.modules()
              if isinstance(m, nn.Linear)
              and min(m.in_features, m.out_features) >= 1024}
    assert {(9216, 3072), (3072, 3072), (12288, 3072),
            (3072, 12288)} <= shapes
    for m in (1, 58, 7200, 8160, 16320):
        swap, bt = tim.plan_qx(m)
        assert (bt in (8, 64) and m <= bt) if swap else (bt == 256 and m > 64)
        for n, k in shapes:
            assert k % 256 == 0 and n % 256 == 0  # w8a8's align: all convert
            tb, splits = tqm.plan_tiles(m, n, k)
            groups = k // 32
            assert groups % splits == 0
            assert splits == 1 or (groups // splits >= tqm.MIN_SPLIT_GROUPS
                                   and (groups // splits)
                                   % tqm.STAGE_GROUPS == 0)
            if m >= 7200:
                assert (tb, splits) == (128, 1)
    assert tc.DIT_7B == dataclasses.replace(
        tc.DIT_7B, **{f.name: getattr(JDIT_7B, f.name)
                      for f in dataclasses.fields(JDIT_7B)})


# ------------------------------------------------------------ the slice

SLICE_7B = dict(family="dit_7b", vid_in_channels=9, vid_out_channels=4,
                vid_dim=48, txt_in_dim=16, heads=2, head_dim=24,
                expand_ratio=4, patch_size=(1, 2, 2), num_layers=2,
                mm_layers=0, mlp_type="normal", window=(2, 2, 2),
                rope_type="rope3d_window", rope_dim=12, vid_out_norm=False)


@pytest.mark.parametrize("quant", ["none", "w8a8"])
def test_7b_slice_matches_jax_pipeline(quant):
    """The whole 4-phase slice (cli.process_frames) with a tiny 7B DiT,
    dense and w8a8, against the JAX pipeline on the same weights and noise
    (tests/test_torch_pipeline.py's tiny VAE and frames); the runner's plan
    and text projection come from the 7B's config. Without colour
    correction, within 1e-4 as the 3B slice."""
    from seedvr2_tpu.core import runner as jr
    from seedvr2_tpu.core.configs import DiTConfig as JDiTConfig
    from seedvr2_tpu.core.configs import RunnerConfig as JRunnerConfig
    from seedvr2_tpu.core.configs import VAEConfig as JVAEConfig
    from seedvr2_tpu.models.vae.pipeline_vae import VideoVAE as JVAE
    from seedvr2_tpu.models.vae.pipeline_vae import init_vae_params
    from seedvr2_tpu_torch import cli
    from seedvr2_tpu_torch.core.runner import VideoDiffusionRunner as TRunner
    from seedvr2_tpu_torch.models.vae.model import VideoAutoencoder
    from seedvr2_tpu_torch.models.vae.pipeline_vae import VideoVAE as TVAE

    from .test_torch_pipeline import VAE_KW, _jax_pipeline

    jv_cfg, jd_cfg = JVAEConfig(**VAE_KW), JDiTConfig(**SLICE_7B)
    tv_cfg, td_cfg = tc.VAEConfig(**VAE_KW), tc.DiTConfig(**SLICE_7B)
    vae_p = random_params(lambda k: init_vae_params(k, jv_cfg,
                                                    dtype=jnp.float32), 2)
    dit_p = _params(jd_cfg, 5)
    dit = _model(td_cfg, dit_p)
    if quant == "w8a8":
        dit_p = jim.quantize_dit_params_w8a8(dit_p, min_dim=8, align=8)
        dit = tim.quantize_dit_w8a8(dit, 8, 8)
        dit.load_state_dict(state_dict_from_jax(dit_p), strict=True)
        assert isinstance(dit.blocks[0].mlp["vid"].proj_in, tim.W8A8Linear)
    j_runner = jr.VideoDiffusionRunner(
        dit_p, jd_cfg, JVAE(vae_p, jv_cfg, dtype=jnp.float32),
        JRunnerConfig(dit=jd_cfg, vae=jv_cfg), compute_dtype=jnp.float32)
    vae = VideoAutoencoder(tv_cfg, dtype=torch.float32)
    vae.load_state_dict(state_dict_from_jax(vae_p), strict=True)
    t_runner = TRunner(dit, TVAE(vae, torch.float32),
                       tc.RunnerConfig(dit=td_cfg, vae=tv_cfg),
                       compute_dtype=torch.float32)
    assert t_runner.dit_cfg.family == "dit_7b"
    rng = np.random.default_rng(7)
    images = rng.uniform(0, 1, (5, 24, 20, 3)).astype(np.float32)
    emb = {"pos": rng.standard_normal((7, 16)).astype(np.float32),
           "neg": rng.standard_normal((9, 16)).astype(np.float32)}
    noise = [rng.standard_normal((2, 6, 4, 4)).astype(np.float32)]
    ref = _jax_pipeline(j_runner, images, emb, noise, "none", 0)
    out, _ = cli.process_frames(t_runner, images, emb, resolution=32, seed=1,
                                batch_size=5, color_correction="none",
                                noise_override=noise)
    assert out.shape == ref.shape == (5, 38, 32, 3)
    assert np.abs(out - ref).max() < 1e-4
