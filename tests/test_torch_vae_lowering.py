"""The VAE's three lowering switches in the port (models/vae `Lowering`,
read from the environment once when a VideoVAE is built) against the same
switches in the JAX package, on the CPU in fp32 with the tiny VAE of
tests/test_torch_vae.py:

 - SEEDVR2_UPSAMPLE_CONVT=0: the decoder upsample as a 1x1x1 conv (a
   matmul) plus the pixel shuffle instead of one transposed conv;
 - SEEDVR2_HEAD_CORRECTION=1: the causal head as a correction conv over
   the (kt - 1) head frames instead of a concat;
 - SEEDVR2_CONV_IM2COL=1: convs with kt*kh*kw*ci <= 128 as a tap-major
   patch matmul.

Each switch is set alone on both sides (the JAX side by its module global,
as tests/test_vae_parity.py does; its VideoVAE snapshots the globals when
it is built) and encode and decode, the sliced paths that carry causal
tails included, are held to JAX's within test_torch_vae's TOL, and to the
port's default lowering within 2e-5, JAX's own bound between its forms.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seedvr2_tpu.core.configs import VAEConfig as JVAEConfig
from seedvr2_tpu.models.vae import model as jm
from seedvr2_tpu.models.vae import pipeline_vae as jv
from seedvr2_tpu_torch.core import configs as tc
from seedvr2_tpu_torch.core.weights import state_dict_from_jax
from seedvr2_tpu_torch.models.vae import model as tm
from seedvr2_tpu_torch.models.vae import pipeline_vae as tv
from seedvr2_tpu_torch.ops import fused_norm as tfn

from .test_torch_dit import random_params
from .test_torch_vae import TINY, TOL
from .test_torch_vae_quant import Q_VAE

# JAX's bound between two lowerings of the same fp32 VAE
# (tests/test_vae_parity.py: the convt upsample and the head correction)
FORM_TOL = dict(rtol=2e-5, atol=2e-5)
# each switch: (port Lowering field and value, JAX global and value, env)
SWITCHES = {
    "pixel_shuffle": (("upsample_convt", False), ("_UPSAMPLE_CONVT", False),
                      ("SEEDVR2_UPSAMPLE_CONVT", "0")),
    "head_correction": (("head_correction", True), ("_HEAD_CORRECTION", True),
                        ("SEEDVR2_HEAD_CORRECTION", "1")),
    "im2col": (("im2col_max_k", 128), ("_IM2COL_MAX_K", 128),
               ("SEEDVR2_CONV_IM2COL", "1")),
}
ENV = [env for *_, (env, _) in SWITCHES.values()] + ["SEEDVR2_FUSED_NORM"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    """No switch leaks in from the environment the tests run in."""
    for env in ENV:
        monkeypatch.delenv(env, raising=False)


@pytest.fixture(scope="module")
def params():
    return random_params(lambda k: jv.init_vae_params(
        k, JVAEConfig(**TINY), dtype=jnp.float32), seed=1)


def _port_vae(params, cfg_kw=TINY, lowering=None, **cfg_extra):
    model = tm.VideoAutoencoder(tc.VAEConfig(**cfg_kw, **cfg_extra),
                                dtype=torch.float32)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    vae = tv.VideoVAE(model, torch.float32)
    if lowering is not None:
        vae.lowering = lowering
    return vae


def _jax_vae(params, monkeypatch, switch=None, cfg_kw=TINY, **cfg_extra):
    """The JAX VideoVAE built under `switch` (its globals pinned at
    construction), the globals restored after."""
    with monkeypatch.context() as m:
        if switch is not None:
            name, value = SWITCHES[switch][1]
            m.setattr(jm, name, value)
        return jv.VideoVAE(params, JVAEConfig(**cfg_kw, **cfg_extra),
                           dtype=jnp.float32)


def _lowering(switch, **kw):
    field, value = SWITCHES[switch][0]
    return dataclasses.replace(tm.Lowering(**kw), **{field: value})


def _clip(frames, seed):
    return np.random.default_rng(seed).uniform(
        -1, 1, (1, frames, 32, 24, 3)).astype(np.float32)


# 5 frames: one slice; 9 frames: a first slice of 5 then 4 carrying the
# causal tails (latents 2 + 1), the head correction's state-carried heads
@pytest.mark.parametrize("frames", [5, 9])
@pytest.mark.parametrize("switch", list(SWITCHES))
def test_switch_matches_jax(params, monkeypatch, switch, frames):
    jvae = _jax_vae(params, monkeypatch, switch)
    tvae = _port_vae(params, lowering=_lowering(switch))
    x = _clip(frames, frames)
    z_ref = np.asarray(jvae.encode(jnp.asarray(x)))
    z = tvae.encode(_t(x))
    np.testing.assert_allclose(z.numpy(), z_ref, **TOL)
    y_ref = np.asarray(jvae.decode(jnp.asarray(z_ref)))
    y = tvae.decode(_t(z_ref))
    assert y.shape == (1, frames, 32, 24, 3)
    np.testing.assert_allclose(y.numpy(), y_ref, **TOL)


@pytest.mark.parametrize("switch", list(SWITCHES))
def test_switch_matches_default_lowering(params, switch):
    """Each switch against the port's default on the same weights and the
    sliced 9-frame clip: the same function in another form."""
    x = _t(_clip(9, 4))
    default = _port_vae(params)
    assert default.lowering == tm.Lowering()
    switched = _port_vae(params, lowering=_lowering(switch))
    z = default.encode(x)
    np.testing.assert_allclose(switched.encode(x).numpy(), z.numpy(),
                               **FORM_TOL)
    np.testing.assert_allclose(switched.decode(z).numpy(),
                               default.decode(z).numpy(), **FORM_TOL)


@pytest.mark.parametrize("temporal", [False, True])
def test_pixel_shuffle_upsample_matches_jax_shuffle(params, temporal):
    """The NCDHW matmul + shuffle lands channel ((xi*sr + yi)*tr + z)*C + c
    at the output pixel JAX's einsum + `_pixel_shuffle_3d` puts it, and
    agrees with the transposed-conv form."""
    rng = np.random.default_rng(5)
    tr = 2 if temporal else 1
    ci, c = 6, 5
    w = rng.standard_normal((ci, 4 * tr * c)).astype(np.float32)
    b = rng.standard_normal(4 * tr * c).astype(np.float32)
    x = rng.standard_normal((1, 3, 4, 7, ci)).astype(np.float32)
    ref = jm._pixel_shuffle_3d(
        jnp.einsum("bthwc,co->bthwo", jnp.asarray(x), jnp.asarray(w))
        + jnp.asarray(b), 2, tr)
    conv = torch.nn.Conv3d(ci, 4 * tr * c, 1)
    with torch.no_grad():
        conv.weight.copy_(_t(w.T).reshape(4 * tr * c, ci, 1, 1, 1))
        conv.bias.copy_(_t(b))
        xt = _t(x).permute(0, 4, 1, 2, 3)
        out = tm._upsample_pixel_shuffle(conv, xt, 2, tr)
        convt = tm._upsample_conv_transpose(conv, xt, 2, tr)
    np.testing.assert_allclose(out.permute(0, 2, 3, 4, 1).numpy(),
                               np.asarray(ref), **TOL)
    np.testing.assert_allclose(out.numpy(), convt.numpy(), **FORM_TOL)


@pytest.mark.parametrize("s_pad", [((1, 1), (1, 1)), ((0, 1), (1, 0))])
def test_im2col_conv_matches_jax(s_pad):
    """`_conv3d_im2col` against JAX's on the same taps, symmetric and
    uneven spatial pads."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, 4, 5, 6, 3)).astype(np.float32)  # NDHWC
    w = rng.standard_normal((3, 3, 3, 3, 7)).astype(np.float32)  # DHWIO
    ref = jm._conv3d_im2col(jnp.asarray(x), jnp.asarray(w), s_pad)
    out = tm._conv3d_im2col(_t(x).permute(0, 4, 1, 2, 3),
                            _t(w).permute(4, 3, 0, 1, 2), s_pad)
    np.testing.assert_allclose(out.permute(0, 2, 3, 4, 1).numpy(),
                               np.asarray(ref), **TOL)


def test_switches_read_once_at_construction(params, monkeypatch):
    """The environment is read when VideoVAE is built, with JAX's defaults
    and string tests ("1" turns a switch on, any other value off, the
    default-on upsample switch included); changing it afterwards changes
    nothing, bit for bit."""
    z = _t(np.random.default_rng(8).standard_normal((1, 3, 4, 3, 4)).astype(
        np.float32))
    base = _port_vae(params)
    assert base.lowering == tm.Lowering(fused_norm=False, use_kernels=True,
                                        upsample_convt=True,
                                        head_correction=False,
                                        im2col_max_k=0)
    for env, value in (("SEEDVR2_UPSAMPLE_CONVT", "0"),
                       ("SEEDVR2_HEAD_CORRECTION", "1"),
                       ("SEEDVR2_CONV_IM2COL", "1")):
        monkeypatch.setenv(env, value)
    built = _port_vae(params)
    assert built.lowering == tm.Lowering(upsample_convt=False,
                                         head_correction=True,
                                         im2col_max_k=128)
    for env in ENV:
        monkeypatch.setenv(env, "true")  # not "1": JAX reads it as off
    assert _port_vae(params).lowering == tm.Lowering(upsample_convt=False)
    before = built.decode(z)
    for env in ENV:
        monkeypatch.delenv(env)
    np.testing.assert_array_equal(built.decode(z).numpy(), before.numpy())
    assert built.lowering.im2col_max_k == 128


@pytest.mark.parametrize("frames", [5, 9])
def test_head_correction_under_fused_norm(params, monkeypatch, frames):
    """SEEDVR2_FUSED_NORM=1 with the head correction: the first slice's
    fused norm hands its conv a pre-extended input, which the correction
    must leave alone, while the other causal convs take it. Against JAX's
    head-correction VAE (unfused) and the port's fused VAE without it."""
    monkeypatch.setenv("SEEDVR2_FUSED_NORM", "1")
    monkeypatch.setenv("SEEDVR2_HEAD_CORRECTION", "1")
    both = _port_vae(params)
    monkeypatch.delenv("SEEDVR2_HEAD_CORRECTION")
    fused = _port_vae(params)
    assert both.lowering == tm.Lowering(fused_norm=True, head_correction=True)
    calls = []
    plain = tfn.norm_silu_head_ncdhw
    monkeypatch.setattr(tfn, "norm_silu_head_ncdhw",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    jvae = _jax_vae(params, monkeypatch, "head_correction")
    x = _clip(frames, 10 + frames)
    z_ref = np.asarray(jvae.encode(jnp.asarray(x)))
    z = both.encode(_t(x))
    np.testing.assert_allclose(z.numpy(), z_ref, **TOL)
    np.testing.assert_allclose(z.numpy(), fused.encode(_t(x)).numpy(),
                               **FORM_TOL)
    y = both.decode(_t(z_ref))
    np.testing.assert_allclose(y.numpy(),
                               np.asarray(jvae.decode(jnp.asarray(z_ref))),
                               **TOL)
    np.testing.assert_allclose(y.numpy(), fused.decode(_t(z_ref)).numpy(),
                               **FORM_TOL)
    assert calls


def test_head_correction_under_int8_vae(monkeypatch):
    """--vae_quant int8 with the head correction (plain K11): the int8
    convs take a pre-extended, quantized input and never the correction;
    the decoder's conv_in, upsample convs and conv_out take it. Held to
    JAX's int8 VAE built under the same switch as test_torch_vae_quant.py's
    test_int8_decode_matches_jax holds the int8 decode to JAX's: each layer
    agrees to fp32 noise, but on this random-weight VAE every int8
    quantization turns such differences into one-step flips, so the limit
    is the quantization-noise class, 0.075, and the port must lie closer to
    JAX's int8 decode than to the float decode. The port's int8 decode
    without the switch is held the same way; every int8 conv still runs."""
    q_params = random_params(lambda k: jv.init_vae_params(
        k, JVAEConfig(**Q_VAE), dtype=jnp.float32), seed=21)
    zn = np.random.default_rng(3).standard_normal((1, 3, 4, 6, 4)).astype(
        np.float32)
    z = _t(zn)
    monkeypatch.setenv("SEEDVR2_HEAD_CORRECTION", "1")
    hc = _port_vae(q_params, Q_VAE, conv_quant="int8")
    monkeypatch.delenv("SEEDVR2_HEAD_CORRECTION")
    base = _port_vae(q_params, Q_VAE, conv_quant="int8")
    assert hc.lowering.head_correction and not base.lowering.head_correction
    jref = torch.from_numpy(np.asarray(_jax_vae(
        q_params, monkeypatch, "head_correction", Q_VAE,
        conv_quant="int8").decode(jnp.asarray(zn)), np.float32))
    from seedvr2_tpu_torch.ops import int8_conv as tic

    calls = []
    plain = tic.int8_conv3d_plain
    monkeypatch.setattr(tic, "int8_conv3d_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    out = hc.decode(z)
    n_hc = len(calls)
    ref = base.decode(z)
    assert n_hc > 0 and len(calls) == 2 * n_hc
    assert torch.isfinite(out).all()
    assert out.shape == jref.shape == (1, 9, 32, 48, 3)
    flt = _port_vae(q_params, Q_VAE).decode(z)

    def rel(a, b):
        return (torch.linalg.norm(a - b) / torch.linalg.norm(b)).item()

    assert rel(out, jref) < 0.075 and rel(out, jref) < rel(out, flt), (
        rel(out, jref), rel(out, flt))
    assert rel(out, ref) < 0.075 and rel(out, ref) < rel(out, flt), (
        rel(out, ref), rel(out, flt))
