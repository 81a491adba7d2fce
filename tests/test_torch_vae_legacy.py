"""The legacy VAE family (video_vae.py layout) against the JAX package on the
CPU in fp32: time_receptive_field "half" (resnet conv2 (1, 3, 3)), no
mid-block attention, 1x1x1 quant_conv / post_quant_conv around the latent.

A tiny legacy tree from JAX's init_vae_params is carried across by
state_dict_from_jax; the port is held to the JAX VideoVAE: the weight
bridge against export.to_torch_state_dict (bit for bit), the loader's
sniffing and 2D inflation against JAX's (equal configs and weights),
encode / decode in one slice and sliced and a tiled decode (fp32 convs
summed in other orders: test_torch_vae's TOL, 1e-4), the int8 lane layer
by layer (JAX's Pallas kernel in interpret mode, the port's plain K11:
one-step flips, relative L2 <= 2e-3 a layer) and the fused-norm lane (the
port's plain K12 against JAX's unfused path, TOL). The depth-1 convs take
neither K11 nor K12, as JAX's dispatch has it."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seedvr2_tpu.core import export as jexport
from seedvr2_tpu.core import loader as jloader
from seedvr2_tpu.core import model_manager as jmm
from seedvr2_tpu.core.configs import VAEConfig as JVAEConfig
from seedvr2_tpu.models.vae import pipeline_vae as jv
from seedvr2_tpu_torch.core import configs as tc
from seedvr2_tpu_torch.core import loader as tl
from seedvr2_tpu_torch.core.weights import state_dict_from_jax
from seedvr2_tpu_torch.models.vae import model as tm
from seedvr2_tpu_torch.models.vae import pipeline_vae as tv
from seedvr2_tpu_torch.ops import fused_norm as tfn
from seedvr2_tpu_torch.ops import int8_conv as tic

from .test_torch_dit import assert_bridge_matches_export, random_params
from .test_torch_loader import assert_state_equal
from .test_torch_vae import TINY, TOL
from .test_torch_vae_quant import Q_VAE

LEGACY = dict(time_receptive_field="half", mid_attention=False,
              use_quant_conv=True, use_post_quant_conv=True)


def _jcfg(kw, **extra):
    return JVAEConfig(**kw, **LEGACY, **extra)


def _tcfg(kw, **extra):
    return tc.VAEConfig(**kw, **LEGACY, **extra)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def params():
    return random_params(lambda k: jv.init_vae_params(
        k, _jcfg(TINY), dtype=jnp.float32), seed=31)


def _port(params, kw, **extra):
    model = tm.VideoAutoencoder(_tcfg(kw, **extra), dtype=torch.float32)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return tv.VideoVAE(model, torch.float32)


def test_legacy_modules_and_weight_bridge(params):
    """The legacy tree carries across bit for bit onto a module with the
    legacy structure: every resnet conv2 one frame deep, no attentions,
    both quant convs 1x1x1."""
    model = tm.VideoAutoencoder(_tcfg(TINY), dtype=torch.float32)
    assert_bridge_matches_export(params, model)
    sd = model.state_dict()
    assert not any(".attentions." in k for k in sd)
    conv2 = [v for k, v in sd.items() if k.endswith("conv2.weight")]
    assert conv2 and all(v.shape[2:] == (1, 3, 3) for v in conv2)
    assert sd["quant_conv.weight"].shape == (8, 8, 1, 1, 1)
    assert sd["post_quant_conv.weight"].shape == (4, 4, 1, 1, 1)
    # the same shapes as the port's own random legacy tree
    ours = tv.init_vae_params(_tcfg(TINY), "cpu", torch.float32)
    assert {k: v.shape for k, v in ours.state_dict().items()} == {
        k: v.shape for k, v in sd.items()}


def test_unknown_receptive_field_refused():
    with pytest.raises(ValueError, match="time_receptive_field"):
        tm.VideoAutoencoder(tc.VAEConfig(**TINY, time_receptive_field="x"),
                            device="meta")


@pytest.mark.parametrize("two_d", [False, True], ids=["3d", "2d_convs"])
def test_legacy_checkpoint_loads_as_in_jax(params, tmp_path, two_d):
    """A legacy-layout .safetensors: the port's sniffed config equals JAX's
    sniff_vae_config (through its load_vae_checkpoint) and the weights are
    equal. Stored 2D, conv2's depth is not in the file, so the base
    config's "full" stands (JAX's rule) and conv2 inflates to 3 deep; the
    quant convs inflate to 1x1x1."""
    import safetensors.numpy

    state = jexport.to_torch_state_dict(params, dtype=np.float32)
    if two_d:
        state = {k: np.ascontiguousarray(v[:, :, -1]) if v.ndim == 5 else v
                 for k, v in state.items()}
    path = str(tmp_path / "legacy_vae.safetensors")
    safetensors.numpy.save_file(state, path)
    jparams, jcfg = jmm.load_vae_checkpoint(path, dtype=jnp.float32)
    model = tl.load_vae_checkpoint(path, "cpu", torch.float32)
    assert dataclasses.asdict(model.cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tl.sniff_vae_config(
        {k: _t(v) for k, v in state.items()}, tc.VAE_V3)) == \
        dataclasses.asdict(jloader.sniff_vae_config(state, JVAEConfig()))
    assert_state_equal(model, jparams)
    cfg = model.cfg
    assert not cfg.mid_attention and cfg.use_quant_conv
    assert cfg.use_post_quant_conv
    assert cfg.time_receptive_field == ("full" if two_d else "half")
    assert model.quant_conv.weight.shape == (8, 8, 1, 1, 1)


def test_legacy_template_and_inflation_equal(params):
    """vae_template_shapes of the legacy config equals JAX's, and a 2D-stored
    legacy state inflates to the same tensors in tail mode."""
    for trf in ("half", "full"):
        cfg_t = dataclasses.replace(_tcfg(TINY), time_receptive_field=trf)
        cfg_j = dataclasses.replace(_jcfg(TINY), time_receptive_field=trf)
        assert tl.vae_template_shapes(cfg_t) == \
            jloader.vae_template_shapes(cfg_j)
    two_d = {k: np.ascontiguousarray(v[:, :, -1]) if v.ndim == 5 else v
             for k, v in jexport.to_torch_state_dict(
                 params, dtype=np.float32).items()}
    ours = tl.inflate_vae_2d_convs(two_d, _tcfg(TINY))
    ref = jloader.inflate_vae_2d_convs(two_d, _jcfg(TINY), mode="tail")
    assert ours.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(np.asarray(ours[k]), ref[k], err_msg=k)
    assert ours["encoder.down_blocks.0.resnets.0.conv2.weight"].shape[2] == 1
    assert ours["quant_conv.weight"].shape == (8, 8, 1, 1, 1)


# 5 frames: one slice; 9: a first slice of 5 then a 4-frame slice carrying
# the causal tails (the quant convs carry none)
@pytest.mark.parametrize("frames", [5, 9])
def test_legacy_encode_decode_match_jax(params, frames):
    jvae = jv.VideoVAE(params, _jcfg(TINY), dtype=jnp.float32)
    tvae = _port(params, TINY)
    x = np.random.default_rng(frames).uniform(
        -1, 1, (1, frames, 32, 24, 3)).astype(np.float32)
    z_ref = np.asarray(jvae.encode(jnp.asarray(x)))
    z = tvae.encode(_t(x))
    assert z.shape == (1, (frames - 1) // 4 + 1, 4, 3, 4)
    np.testing.assert_allclose(z.numpy(), z_ref, **TOL)
    y_ref = np.asarray(jvae.decode(jnp.asarray(z_ref)))
    y = tvae.decode(_t(z_ref))
    assert y.shape == (1, frames, 32, 24, 3)
    np.testing.assert_allclose(y.numpy(), y_ref, **TOL)


def test_legacy_quant_convs_are_applied(params):
    """The quant convs are on the path: zeroing post_quant_conv changes the
    decode, and quant_conv's bias moves the latent by exactly itself."""
    tvae = _port(params, TINY)
    x = _t(np.random.default_rng(1).uniform(-1, 1, (1, 1, 16, 16, 3)).astype(
        np.float32))
    z = tvae.encode(x)
    with torch.no_grad():
        tvae.model.quant_conv.bias[:4] += 1.0
    np.testing.assert_allclose(tvae.encode(x).numpy(), z.numpy() + 1.0,
                               rtol=1e-6, atol=1e-6)
    y = tvae.decode(z)
    with torch.no_grad():
        tvae.model.post_quant_conv.weight.zero_()
    assert not torch.allclose(tvae.decode(z), y, atol=1e-3)


def test_legacy_tiled_decode_matches_jax(params):
    """A uniform 2 x 2 tiled decode (latent 6 x 5, 24 px tiles, 8 px
    overlap) equals JAX's, tiles included."""
    jvae = jv.VideoVAE(params, _jcfg(TINY), dtype=jnp.float32)
    tvae = _port(params, TINY)
    kw = dict(tiled=True, tile_size=(24, 24), tile_overlap=(8, 8),
              tile_mode="uniform")
    z = np.random.default_rng(7).standard_normal((1, 2, 6, 5, 4)).astype(
        np.float32)
    y_ref = np.asarray(jvae.decode(jnp.asarray(z), **kw))
    y = tvae.decode(_t(z), **kw)
    assert y.shape == (1, 5, 48, 40, 3)
    np.testing.assert_allclose(y.numpy(), y_ref, **TOL)
    assert tvae.last_decode_tiles == jvae.last_decode_tiles
    assert len(tvae.last_decode_tiles) > 1


@pytest.fixture(scope="module")
def q_params():
    return random_params(lambda k: jv.init_vae_params(
        k, _jcfg(Q_VAE), dtype=jnp.float32), seed=32)


def test_int8_served_convs_skip_depth_one(q_params):
    """On a legacy model the int8 lane serves the decoder's resnet conv1s
    only: every conv2 is one frame deep. The same convs JAX's VideoVAE
    quantizes among its resnet convs."""
    tvae = _port(q_params, Q_VAE, conv_quant="int8")
    served = dict(tv.int8_served_convs(tvae.model))
    assert served and all(p.endswith(".conv1") for p in served)
    n_res = sum(1 for k in tvae.model.state_dict()
                if k.startswith("decoder.") and k.endswith("conv2.weight"))
    assert len(served) == n_res  # one conv1 for each depth-1 conv2
    jvae = jv.VideoVAE(q_params, _jcfg(Q_VAE, conv_quant="int8"),
                       dtype=jnp.float32)

    def quantized(node, path=""):
        if isinstance(node, dict):
            if "wq" in node:
                yield path
            for k, v in node.items():
                yield from quantized(v, f"{path}.{k}" if path else k)

    ref = {p for p in quantized({"decoder": jvae.params["decoder"]})
           if ".resnets." in p}
    assert set(served) == ref
    assert all(hasattr(c, "wq") for c in served.values())


def test_legacy_int8_decode_matches_jax(q_params, monkeypatch):
    """The int8 decode of 3 latent frames (two slices, the second with
    carried heads) through the plain K11, held layer by layer: every int8
    norm -> SiLU -> conv the port runs, fed to JAX's norm_silu_conv (its
    Pallas kernel in interpret mode) with the same input and the same
    carried head, gives the same output to relative L2 <= 2e-3 (the
    group-norm moments are summed in another order, which moves a few
    y / scale across a .5 boundary: one-step flips, observed <= 1.02e-3).
    The whole decode is not compared with JAX's: on these random weights a
    1e-6 relative change of z moves either package's own int8 decode by
    0.025-0.066 relative L2, so whole-decode distances say nothing. K11's
    plain version runs once a served conv1 a slice, never on a (1, 3, 3)
    conv."""
    from seedvr2_tpu.models.vae import model as jm

    z = np.random.default_rng(3).standard_normal((1, 3, 4, 6, 4)).astype(
        np.float32)
    jparams = jv.VideoVAE(q_params, _jcfg(Q_VAE, conv_quant="int8"),
                          dtype=jnp.float32).params
    tvae = _port(q_params, Q_VAE, conv_quant="int8")
    tvae.lowering = dataclasses.replace(tvae.lowering, use_kernels=False)
    launches, calls = [], []
    plain, lane = tic.int8_conv3d_plain, tm._int8_norm_silu_conv
    monkeypatch.setattr(tic, "int8_conv3d_plain", lambda *a, **k: (
        launches.append(1), plain(*a, **k))[1])

    def recorded(norm, conv, path, x, state, new_state, use_kernels):
        head = None if state is None else state.get(path)
        out = lane(norm, conv, path, x, state, new_state, use_kernels)
        calls.append((path, conv.weight.shape[2], x, head, out))
        return out

    monkeypatch.setattr(tm, "_int8_norm_silu_conv", recorded)
    out = tvae.decode(_t(z))
    assert out.shape == (1, 9, 32, 48, 3) and torch.isfinite(out).all()
    n_served = len(dict(tv.int8_served_convs(tvae.model)))
    # two slices: latent frames 0-1, then 2
    assert len(launches) == len(calls) == 2 * n_served
    assert {kt for _, kt, *_ in calls} == {3}
    assert sum(head is not None for *_, head, _ in calls) == n_served

    def nthwc(a):
        return jnp.asarray(a.permute(0, 2, 3, 4, 1).float().numpy())

    @jax.jit
    def jax_layer(norm, conv, x, head):
        """JAX's norm_silu_conv on one layer's parameters (jitted: one
        compile a shape, not one an op)."""
        return jm.norm_silu_conv({"n": norm, "c": conv}, "n", "c", x,
                                 None if head is None else {"c": head},
                                 None, Q_VAE["norm_num_groups"], "int8")

    def node(path):
        out = jparams
        for part in path.split("."):
            out = out[part]
        return out

    for path, _, x, head, got in calls:
        ref = np.asarray(jax_layer(
            node(path.replace("conv1", "norm1")), node(path), nthwc(x),
            None if head is None else nthwc(head)), np.float32)
        got = got.permute(0, 2, 3, 4, 1).float().numpy()
        assert got.shape == ref.shape, path
        rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
        assert rel <= 2e-3, (path, head is not None, rel)


def test_legacy_fused_norm_matches_jax(params, monkeypatch):
    """SEEDVR2_FUSED_NORM=1: a first slice's 3-deep convs take the plain
    K12, the (1, 3, 3) conv2s the unfused path; encode and decode of 9
    frames against JAX's within TOL."""
    monkeypatch.setenv("SEEDVR2_FUSED_NORM", "1")
    tvae = _port(params, TINY)
    monkeypatch.delenv("SEEDVR2_FUSED_NORM")
    assert tvae.lowering.fused_norm
    calls = []
    plain = tfn.norm_silu_head_ncdhw
    monkeypatch.setattr(tfn, "norm_silu_head_ncdhw",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    kt3 = []
    real = tm.causal_conv3d
    monkeypatch.setattr(tm, "causal_conv3d", lambda conv, path, *a, **k: (
        k.get("pre_extended") and kt3.append(conv.weight.shape[2]),
        real(conv, path, *a, **k))[1])
    jvae = jv.VideoVAE(params, _jcfg(TINY), dtype=jnp.float32)
    x = np.random.default_rng(9).uniform(-1, 1, (1, 9, 32, 24, 3)).astype(
        np.float32)
    z_ref = np.asarray(jvae.encode(jnp.asarray(x)))
    np.testing.assert_allclose(tvae.encode(_t(x)).numpy(), z_ref, **TOL)
    y_ref = np.asarray(jvae.decode(jnp.asarray(z_ref)))
    np.testing.assert_allclose(tvae.decode(_t(z_ref)).numpy(), y_ref, **TOL)
    assert calls and len(kt3) == len(calls) and set(kt3) == {3}


@pytest.mark.parametrize("lane", ["int8", "fused"])
def test_depth_one_conv_takes_plain_path(lane, monkeypatch):
    """norm_silu_conv on a (1, 3, 3) conv under either lane: neither K11 nor
    K12 (both made to raise), and the result is the plain composition with
    no temporal pad (causal_conv3d derives it from kt = 1), carried state
    or not."""
    def boom(*a, **k):
        raise AssertionError("a depth-1 conv reached a kernel")

    for fn in ("int8_conv3d_ncdhw", "int8_conv3d_plain"):
        monkeypatch.setattr(tic, fn, boom)
    for fn in ("norm_silu_head_ncdhw", "norm_silu_head_plain"):
        monkeypatch.setattr(tfn, fn, boom)
    torch.manual_seed(0)
    norm = torch.nn.GroupNorm(32, 128)
    conv = torch.nn.Conv3d(128, 128, (1, 3, 3))
    x = torch.randn(1, 128, 3, 4, 6)
    low = tm.Lowering(fused_norm=lane == "fused")
    cq = "int8" if lane == "int8" else "none"
    # a later slice's state holds other convs' tails, never a depth-1 one's
    for state in (None, {"q": torch.randn(1, 128, 2, 4, 6)}):
        new = {}
        with torch.no_grad():
            out = tm.norm_silu_conv(norm, conv, "p", x, state, new, cq, low)
            ref = torch.nn.functional.conv3d(
                torch.nn.functional.silu(tm.frame_group_norm(norm, x)),
                conv.weight, conv.bias, padding=(0, 1, 1))
        assert out.shape == x.shape and new == {}
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
