"""The VAE's opt-in lanes against the JAX package on the CPU: --vae_quant
int8 (the conv weight quantizer, norm_silu_quantize, the plain version of
K11 int8_conv3d, int8_causal_conv3d, the whole int8 decode, the weights
VideoVAE stores, the CLI route and a whole pipeline run) and
SEEDVR2_FUSED_NORM=1 (the plain version of K12 norm_silu_head, the
fused-norm encode and decode). Inputs come from seeded numpy; the JAX side
runs its Pallas kernels in interpret mode, the port its plain versions."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seedvr2_tpu.core import pipeline as jp
from seedvr2_tpu.core.configs import DiTConfig as JDiTConfig
from seedvr2_tpu.core.configs import RunnerConfig as JRunnerConfig
from seedvr2_tpu.core.configs import VAEConfig as JVAEConfig
from seedvr2_tpu.core.runner import VideoDiffusionRunner as JRunner
from seedvr2_tpu.models.dit.nadit import init_dit_params
from seedvr2_tpu.models.vae import pipeline_vae as jv
from seedvr2_tpu.ops import fused_norm as jfn
from seedvr2_tpu.ops import int8_conv as jic
from seedvr2_tpu_torch import cli
from seedvr2_tpu_torch.core import configs as tc
from seedvr2_tpu_torch.core.runner import VAETiling
from seedvr2_tpu_torch.core.runner import VideoDiffusionRunner as TRunner
from seedvr2_tpu_torch.core.weights import state_dict_from_jax
from seedvr2_tpu_torch.models.dit.nadit import NaDiT
from seedvr2_tpu_torch.models.vae import model as tm
from seedvr2_tpu_torch.models.vae import pipeline_vae as tv
from seedvr2_tpu_torch.ops import fused_norm as tfn
from seedvr2_tpu_torch.ops import int8_conv as tic

from .test_torch_dit import random_params
from .test_torch_pipeline import DIT_KW, _jax_pipeline
from .test_torch_vae import TINY, TOL

# the int8 path needs channel dims that are multiples of 128: the 128-channel
# tiny VAE of tests/test_int8_conv.py
Q_VAE = dict(block_out_channels=(128, 128, 128, 128), layers_per_block=1,
             latent_channels=4, norm_num_groups=32)
# the pipeline run's VAE: int8 convs in the decoder's two low-resolution up
# blocks and its mid block, float convs (not viable at 64 channels) after
P_VAE = dict(Q_VAE, block_out_channels=(64, 64, 128, 128))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def bf16_ulps(out: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """|out - ref| in bf16 ulps of ref (8 significant bits; the ulp of 0 is
    taken at the smallest normal)."""
    mag = np.maximum(np.abs(ref.astype(np.float64)), 2.0 ** -126)
    return np.abs(out.astype(np.float64) - ref) / 2.0 ** (
        np.floor(np.log2(mag)) - 7)


@pytest.fixture(scope="module")
def q_params():
    return random_params(lambda k: jv.init_vae_params(
        k, JVAEConfig(**Q_VAE), dtype=jnp.float32), seed=21)


def _port_vae(params, cfg_kw, **cfg_extra):
    model = tm.VideoAutoencoder(tc.VAEConfig(**cfg_kw, **cfg_extra),
                                dtype=torch.float32)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return tv.VideoVAE(model, torch.float32)


# ------------------------------------------------------------ quantizers


@pytest.mark.parametrize("ci,co,scale", [(16, 24, 1.0), (128, 8, 1e-3)])
def test_quantize_conv_weight_bit_equal(ci, co, scale):
    """Per-output-channel int8 weights and scales equal JAX's bit for bit,
    an all-zero output channel (scale 0, quants 0) included."""
    rng = np.random.default_rng(ci + co)
    w = (rng.standard_normal((3, 3, 3, ci, co)) * scale).astype(np.float32)
    w[..., 5] = 0.0
    jq, js = jic.quantize_conv_weight(jnp.asarray(w))
    tq, ts = tic.quantize_conv_weight(_t(w))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[5] == 0 and not tq[..., 5].any()
    # the kernel layout is a permutation of the same quants
    wk = tic.kernel_weight(tq)
    assert wk.shape == (co, 27 * ci)
    np.testing.assert_array_equal(
        wk.view(co, 27, ci).permute(1, 2, 0).numpy(), np.asarray(jq))


def test_int8_conv_viable_agrees():
    for ci in (64, 128, 256, 384, 512):
        for co in (3, 128, 256, 500, 512):
            for w in (1, 2, 3, 160, 1280):
                assert tic.int8_conv_viable(ci, co, w) == \
                    jic.int8_conv_viable(ci, co, w), (ci, co, w)


# 2 frames with a carried head (ACTIVE), 3 without (first slice), and the
# one-frame tails whose missing frame comes from the head or frame 0
@pytest.mark.parametrize("t,carried", [(3, False), (2, True), (1, False),
                                       (1, True)])
def test_norm_silu_quantize_matches_jax(t, carried):
    """x_ext equal in >= 99.9 % of entries and within 1 everywhere: the
    fp32 moments are summed in another order, which can move y / scale
    across a .5 rounding boundary. The scale within rtol 1e-6 (the same
    sums); the bf16-free fp32 tail within fp32 tolerance."""
    rng = np.random.default_rng(10 + t + carried)
    T, H, W, C, G = t, 6, 10, 16, 4
    x = (rng.standard_normal((1, T, H, W, C)) * 2.0).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, (C,)).astype(np.float32)
    beta = (rng.standard_normal((C,)) * 0.2).astype(np.float32)
    head = ((rng.standard_normal((1, 2, H, W, C)) * 3.0).astype(np.float32)
            if carried else None)
    jx, js, jt = jic.norm_silu_quantize(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), G,
        head=None if head is None else jnp.asarray(head))
    tx, ts, tt = tic.norm_silu_quantize(
        _t(x), _t(gamma), _t(beta), G, head=None if head is None else _t(head))
    jx = np.asarray(jx).astype(np.int32)
    assert tx.shape == jx.shape == (T + 2, H + 2, 32, C)
    diff = np.abs(tx.numpy().astype(np.int32) - jx)
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    assert tt.shape == (1, 2, H, W, C) and tt.dtype == torch.float32
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-5,
                               atol=1e-6)


# ------------------------------------------------------------ K11 (plain)


@pytest.mark.parametrize("T,H,Wp,C,Co", [
    (3, 8, 32, 8, 16),        # Wp = 32: one sublane tile, Co != C
    (2, 5, 64, 32, 48),       # odd H, two tiles of width
    (1, 4, 288, 512, 512)])   # C = 512 at W = 286: JAX's column split
def test_int8_conv3d_plain_matches_interpret_kernel(T, H, Wp, C, Co):
    """The plain K11 against the Pallas kernel in interpret mode on the same
    int8 operands: within one bf16 ulp everywhere (both take exact int32
    sums and scale them by xs[t] * ws[co] in fp32 before one rounding)."""
    rng = np.random.default_rng(T * H + C)
    x_ext = rng.integers(-127, 128, (T + 2, H + 2, Wp, C)).astype(np.int8)
    wq = rng.integers(-127, 128, (27, C, Co)).astype(np.int8)
    xs = rng.uniform(0.01, 0.1, (T,)).astype(np.float32)
    ws = rng.uniform(0.01, 0.1, (Co,)).astype(np.float32)
    ref = np.asarray(jic.int8_conv3d(
        jnp.asarray(x_ext), jnp.asarray(wq), jnp.asarray(xs), jnp.asarray(ws),
        hb=4 if H % 4 == 0 else 1, cob=min(128, Co), interpret=True),
        np.float32)
    out = tic.int8_conv3d(_t(x_ext), _t(wq), _t(xs), _t(ws))
    assert out.shape == ref.shape == (T, H, Wp - 2, Co)
    assert out.dtype == torch.bfloat16
    assert bf16_ulps(out.float().numpy(), ref).max() <= 1


# the (Ci, Co, T, H, W) of every int8 conv of the 720p clip's decode (latent
# 2 x 90 x 160, untiled), as chip_smoke.py's K11_SHAPES
K11_SHAPES = ((512, 512, 2, 90, 160), (512, 512, 3, 180, 320),
              (512, 256, 5, 360, 640), (256, 256, 5, 360, 640),
              (256, 128, 5, 720, 1280), (128, 128, 5, 720, 1280))


def _decode_shapes(th, tw):
    """The int8 convs' (Ci, Co, T, H, W) for a 2-frame latent tile of th x
    tw: the decoder's four stages at 1x, 2x, 4x and 8x the latent size."""
    return ((512, 512, 2, th, tw), (512, 512, 3, 2 * th, 2 * tw),
            (512, 256, 5, 4 * th, 4 * tw), (256, 256, 5, 4 * th, 4 * tw),
            (256, 128, 5, 8 * th, 8 * tw), (128, 128, 5, 8 * th, 8 * tw))


def test_k11_plan_covers_served_shapes():
    """plan_conv over every K11 shape of the 720p clip's decode and of the
    throughput preset's tiled 1080p clip decode (latent 2 x 136 x 240, its
    tiles as the VAE plans them): the tiles cover every output position of
    a frame and no tile lies wholly past it, the channel tiles cover Co
    exactly, the grid stays within 2^31 blocks, and no shape idles a third
    of the positions it computes, nor more than 128-pixel tiles along w
    would where W % 128 != 0 (they idle 37.5 % at W = 160)."""
    assert _decode_shapes(90, 160) == K11_SHAPES
    sf, size, ov = 8, 1088, 48  # cli.THROUGHPUT_PRESET's decode tiles
    ys, th, xs, tw = tv._plan_grid(136, 240, (size // sf) ** 2, ov // sf,
                                   ov // sf, cost="aspect")
    shapes = set(K11_SHAPES) | set(_decode_shapes(th, tw))
    assert len(shapes) == 12
    for ci, co, t, h, w in shapes:
        wp = -(-(w + 2) // tic.SUBLANE) * tic.SUBLANE
        pix, cot, busy = tic.plan_conv(t, h, wp, w, co)
        assert (pix - 1) * tic.PIX_TILE < h * wp <= pix * tic.PIX_TILE
        assert (cot - 1) * tic.CO_TILE < co <= cot * tic.CO_TILE
        assert t * pix * cot < 2 ** 31
        assert busy == h * w * co / (pix * tic.PIX_TILE * cot * tic.CO_TILE)
        assert busy > 2 / 3
        if w % 128:  # where 128-pixel tiles along w leave a ragged tile
            assert busy >= w / (-(-w // 128) * 128)


@pytest.mark.parametrize("t,h,w,c,co", [(1, 5, 20, 16, 8), (2, 3, 45, 32, 24),
                                        (1, 9, 62, 16, 16)])
def test_k11_position_tiles_match_plain(t, h, w, c, co):
    """The index arithmetic of K11's tiles, in numpy: a tile of PIX_TILE
    positions p = h * Wp + w of a frame reads, for window row (dt, dh),
    the x_ext rows p + dh * Wp + dw of frame t + dt (three dw taps of one
    strip; rows past the frame are zero) and stores the positions with h <
    H and w < W_out. Assembled over all tiles, the exact sums equal the
    plain version's."""
    rng = np.random.default_rng(t * h * w + c)
    wp = -(-(w + 2) // tic.SUBLANE) * tic.SUBLANE
    x_ext = rng.integers(-127, 128, (t + 2, h + 2, wp, c)).astype(np.int64)
    wq = rng.integers(-127, 128, (27, c, co)).astype(np.int64)
    pix, _, _ = tic.plan_conv(t, h, wp, w, co)
    rows = x_ext.reshape(t + 2, (h + 2) * wp, c)
    rows = np.concatenate([rows, np.zeros((t + 2, 2 * wp + 2 + pix
                                           * tic.PIX_TILE, c), np.int64)], 1)
    acc = np.zeros((t, h, w, co), np.int64)
    for f in range(t):
        for tile in range(pix):
            p0 = tile * tic.PIX_TILE
            s = np.zeros((tic.PIX_TILE, co), np.int64)
            for tap in range(27):
                dt, dh, dw = tap // 9, tap // 3 % 3, tap % 3
                r0 = p0 + dh * wp + dw
                s += rows[f + dt, r0:r0 + tic.PIX_TILE] @ wq[tap]
            p = p0 + np.arange(tic.PIX_TILE)
            keep = (p // wp < h) & (p % wp < w)
            acc[f, p[keep] // wp, p[keep] % wp] = s[keep]
    xs = np.ones(t, np.float32)
    ws = np.ones(co, np.float32)
    ref = tic.int8_conv3d_plain(
        _t(x_ext.astype(np.int8)), tic.kernel_weight(_t(wq.astype(np.int8))),
        _t(xs), _t(ws), w_out=w)
    np.testing.assert_array_equal(
        torch.from_numpy(acc.astype(np.float32)).permute(3, 0, 1, 2)
        .to(torch.bfloat16).float().numpy(), ref.float().numpy())


@pytest.mark.parametrize("carried", [False, True])
def test_int8_causal_conv3d_matches_jax(carried):
    """The drop-in int8 causal conv, with and without a carried head: the
    same quantized operands and epilogue, so within one bf16 ulp."""
    rng = np.random.default_rng(30 + carried)
    T, H, W, C, Co = 3, 8, 16, 8, 8
    x = rng.standard_normal((1, T, H, W, C)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, C, Co)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((Co,)) * 0.01).astype(np.float32)
    head = (rng.standard_normal((1, 2, H, W, C)).astype(np.float32)
            if carried else None)
    ref = np.asarray(jic.int8_causal_conv3d(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), hb=4, interpret=True,
        head=None if head is None else jnp.asarray(head)), np.float32)
    out = tic.int8_causal_conv3d(_t(x), _t(w), _t(b),
                                 head=None if head is None else _t(head))
    assert out.shape == ref.shape == (1, T, H, W, Co)
    assert bf16_ulps(out.float().numpy(), ref).max() <= 1


# ------------------------------------------------------------ K12 (plain)


@pytest.mark.parametrize("shape", [(2, 3, 12, 16, 8), (1, 2, 7, 16, 8)],
                         ids=["even_h", "odd_h"])
def test_norm_silu_head_matches_jax(shape):
    """The plain K12 against the Pallas kernel in interpret mode, and the
    unfused reference against JAX's, in fp32 (the storage rounding is then
    exact): within 2e-5, the bound the JAX package holds its kernel to its
    reference with. The head frames equal the processed frame 0 exactly."""
    rng = np.random.default_rng(shape[2])
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal((shape[-1],)).astype(np.float32)
    b = rng.standard_normal((shape[-1],)).astype(np.float32)
    args = (jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    jk = np.asarray(jfn.norm_silu_head(*args, groups=4, head_frames=2,
                                       interpret=True))
    jr = np.asarray(jfn.norm_silu_head_reference(*args, groups=4,
                                                 head_frames=2))
    out = tfn.norm_silu_head(_t(x), _t(w), _t(b), 4).numpy()
    ref = tfn.norm_silu_head_reference(_t(x), _t(w), _t(b), 4).numpy()
    B, T = shape[:2]
    assert out.shape == ref.shape == jk.shape == (B, T + 2) + shape[2:]
    np.testing.assert_allclose(out, jk, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(ref, jr, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)
    for f in (0, 1):
        np.testing.assert_array_equal(out[:, f], out[:, 2])


def test_norm_silu_head_bf16_rounds_before_silu():
    """In bf16 the plain K12 rounds y = x * A + B to bf16 before the SiLU,
    as the JAX kernel does: against the interpret-mode kernel on the same
    bf16 input within one bf16 ulp (the moments are fp32 sums in another
    order, which can move y across a bf16 rounding boundary)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 3, 8, 16, 32)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, (32,)).astype(np.float32)
    b = (rng.standard_normal((32,)) * 0.2).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    jk = np.asarray(jfn.norm_silu_head(xb, jnp.asarray(w), jnp.asarray(b),
                                       groups=8, interpret=True), np.float32)
    out = tfn.norm_silu_head(_t(x).to(torch.bfloat16), _t(w), _t(b), 8)
    assert out.dtype == torch.bfloat16
    ulps = bf16_ulps(out.float().numpy(), jk)
    assert ulps.max() <= 1 and (ulps == 0).mean() >= 0.999


# ------------------------------------------------------------ whole VAE


def test_int8_decode_matches_jax(q_params):
    """The whole int8 decode of 3 latent frames (the second slice carries
    an int8 head) on the 128-channel tiny VAE. Each layer agrees with JAX's
    on the same input to fp32 noise, but the group-norm moments are summed
    in another order, which moves some y / scale across a .5 boundary: a
    one-step flip of an int8 input, and every later quantization turns the
    differences it receives into more flips (on this random-weight VAE the
    relative L2 goes 3e-5, 3e-3, 3.5e-2 over the up blocks). So the limit is
    the quantization-noise class, 0.075, and the port must lie closer to
    JAX's int8 decode than to the float decode (observed 0.053 against
    0.090; the port's float decode, equal to JAX's to fp32 noise as
    test_torch_vae.py holds it)."""
    cfg = JVAEConfig(**Q_VAE)
    z = np.random.default_rng(3).standard_normal((1, 3, 4, 6, 4)).astype(
        np.float32)
    ref_q = np.asarray(jv.VideoVAE(q_params, dataclasses.replace(
        cfg, conv_quant="int8"), dtype=jnp.float32).decode(jnp.asarray(z)),
        np.float32)
    ref_f = _port_vae(q_params, Q_VAE).decode(_t(z)).numpy()
    out = _port_vae(q_params, Q_VAE, conv_quant="int8").decode(_t(z)).numpy()
    assert out.shape == ref_q.shape == (1, 9, 32, 48, 3)
    to_q = np.linalg.norm(out - ref_q) / np.linalg.norm(ref_q)
    to_f = np.linalg.norm(out - ref_f) / np.linalg.norm(ref_f)
    gap = np.linalg.norm(ref_q - ref_f) / np.linalg.norm(ref_f)
    assert to_q < 0.075 and to_q < to_f, (to_q, to_f, gap)


def test_int8_decode_matches_jax_layer_by_layer(q_params, monkeypatch):
    """The int8 decode of the same 3 latent frames held layer by layer, as
    tests/test_torch_vae_legacy.py holds the legacy family's: every int8
    norm -> SiLU -> conv the port runs (its plain K11), fed to JAX's
    norm_silu_conv (its Pallas kernel in interpret mode) with the same
    input and the same carried head, gives the same output to relative L2
    <= 2e-3 (the moments summed in another order move a few y / scale
    across a .5 boundary: one-step flips). Every served conv (conv1 and
    conv2 of the decoder's 3-deep resnets) runs once a slice, the second
    slice's with carried heads."""
    import jax

    from seedvr2_tpu.models.vae import model as jm

    z = np.random.default_rng(3).standard_normal((1, 3, 4, 6, 4)).astype(
        np.float32)
    jparams = jv.VideoVAE(q_params, dataclasses.replace(
        JVAEConfig(**Q_VAE), conv_quant="int8"), dtype=jnp.float32).params
    tvae = _port_vae(q_params, Q_VAE, conv_quant="int8")
    tvae.lowering = dataclasses.replace(tvae.lowering, use_kernels=False)
    launches, calls = [], []
    plain, lane = tic.int8_conv3d_plain, tm._int8_norm_silu_conv
    monkeypatch.setattr(tic, "int8_conv3d_plain", lambda *a, **k: (
        launches.append(1), plain(*a, **k))[1])

    def recorded(norm, conv, path, x, state, new_state, use_kernels):
        head = None if state is None else state.get(path)
        out = lane(norm, conv, path, x, state, new_state, use_kernels)
        calls.append((path, x, head, out))
        return out

    monkeypatch.setattr(tm, "_int8_norm_silu_conv", recorded)
    out = tvae.decode(_t(z))
    assert out.shape == (1, 9, 32, 48, 3) and torch.isfinite(out).all()
    served = [p for p, _ in tv.int8_served_convs(tvae.model)]
    assert {p.rsplit(".", 1)[1] for p in served} == {"conv1", "conv2"}
    # two slices: latent frames 0-1, then 2
    assert len(launches) == len(calls) == 2 * len(served)
    assert [c[0] for c in calls] == served * 2
    assert sum(head is not None for _, _, head, _ in calls) == len(served)

    def nthwc(a):
        return jnp.asarray(a.permute(0, 2, 3, 4, 1).float().numpy())

    @jax.jit
    def jax_layer(norm, conv, x, head):
        """JAX's norm_silu_conv on one layer's parameters."""
        return jm.norm_silu_conv({"n": norm, "c": conv}, "n", "c", x,
                                 None if head is None else {"c": head},
                                 None, Q_VAE["norm_num_groups"], "int8")

    def node(path):
        out = jparams
        for part in path.split("."):
            out = out[part]
        return out

    for path, x, head, got in calls:
        norm = path[:-len("conv1")] + "norm" + path[-1]
        ref = np.asarray(jax_layer(node(norm), node(path), nthwc(x),
                                   None if head is None else nthwc(head)),
                         np.float32)
        got = got.permute(0, 2, 3, 4, 1).float().numpy()
        assert got.shape == ref.shape, path
        rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
        assert rel <= 2e-3, (path, head is not None, rel)


@pytest.mark.parametrize("frames", [5, 9])
def test_fused_norm_vae_matches_jax(monkeypatch, frames):
    """SEEDVR2_FUSED_NORM=1 at VideoVAE construction: the first slice's
    norm -> SiLU -> conv take the plain K12, later slices the unfused path;
    encode and decode against JAX's unfused ones within test_torch_vae's
    fp32 TOL (the folded affine rounds in another order)."""
    params = random_params(lambda k: jv.init_vae_params(
        k, JVAEConfig(**TINY), dtype=jnp.float32), seed=1)
    monkeypatch.setenv("SEEDVR2_FUSED_NORM", "1")
    tvae = _port_vae(params, TINY)
    monkeypatch.delenv("SEEDVR2_FUSED_NORM")
    assert tvae.lowering.fused_norm
    assert not tv.VideoVAE(tvae.model, torch.float32).lowering.fused_norm
    calls = []
    plain = tfn.norm_silu_head_ncdhw
    monkeypatch.setattr(tfn, "norm_silu_head_ncdhw",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    jvae = jv.VideoVAE(params, JVAEConfig(**TINY), dtype=jnp.float32)
    x = np.random.default_rng(frames).uniform(
        -1, 1, (1, frames, 32, 24, 3)).astype(np.float32)
    z_ref = np.asarray(jvae.encode(jnp.asarray(x)))
    z = tvae.encode(_t(x))
    np.testing.assert_allclose(z.numpy(), z_ref, **TOL)
    n_enc = len(calls)
    y_ref = np.asarray(jvae.decode(jnp.asarray(z_ref)))
    y = tvae.decode(_t(z_ref))
    np.testing.assert_allclose(y.numpy(), y_ref, **TOL)
    assert n_enc > 0 and len(calls) > n_enc


def test_int8_weights_equal_jax(q_params):
    """The int8 weights VideoVAE stores for every conv the int8 path serves
    equal the JAX VideoVAE's attached wq / ws (the port's in K11's
    (Co, 27 * C) layout), and they stay out of the state dict."""
    jvae = jv.VideoVAE(q_params, JVAEConfig(**Q_VAE, conv_quant="int8"),
                       dtype=jnp.float32)
    tvae = _port_vae(q_params, Q_VAE, conv_quant="int8")
    served = dict(tv.int8_served_convs(tvae.model))
    # the mid block's two resnets and three up blocks of two, two convs each
    assert len(served) == 2 * 2 + 4 * 2 * 2
    for path, conv in served.items():
        node = jvae.params
        for part in path.split("."):
            node = node[part]
        np.testing.assert_array_equal(
            conv.wq.numpy(), tic.kernel_weight(_t(node["wq"])).numpy())
        np.testing.assert_array_equal(conv.ws.numpy(), np.asarray(node["ws"]))
    sd = tvae.model.state_dict()
    assert not any(k.endswith((".wq", ".ws")) for k in sd)
    tvae.model.load_state_dict(sd, strict=True)


def test_vae_refuses_legacy_switches():
    """The legacy family's switches build, each alone and with conv_quant
    on (tests/test_torch_vae_legacy.py holds them against JAX); what stays
    refused is a time_receptive_field other than "full" / "half" and an
    unknown conv_quant, each a ValueError."""
    for kw in (dict(mid_attention=False), dict(use_quant_conv=True),
               dict(use_post_quant_conv=True),
               dict(time_receptive_field="half"),
               dict(mid_attention=False, conv_quant="int8")):
        tm.VideoAutoencoder(tc.VAEConfig(**TINY, **kw), device="meta")
    with pytest.raises(ValueError, match="time_receptive_field"):
        tm.VideoAutoencoder(tc.VAEConfig(**TINY,
                                         time_receptive_field="quarter"),
                            device="meta")
    with pytest.raises(ValueError, match="conv_quant"):
        tm.VideoAutoencoder(tc.VAEConfig(**TINY, conv_quant="int4"),
                            device="meta")


# ------------------------------------------------------------ CLI route


def test_cli_vae_quant_flag_and_runner(monkeypatch, tmp_path, q_params):
    """--vae_quant parses (default none, the throughput preset leaves it);
    make_runner(vae_quant="int8") builds an int8 VAE from random weights and
    from a loaded file (tiny configs in place of the 3B / VAE_V3)."""
    import safetensors.torch

    path = str(tmp_path / "in.npy")
    assert cli.parse_arguments([path]).vae_quant == "none"
    assert cli.parse_arguments([path, "--preset", "throughput"]).vae_quant \
        == "none"
    assert cli.parse_arguments([path, "--vae_quant", "int8"]).vae_quant == \
        "int8"
    with pytest.raises(SystemExit):
        cli.parse_arguments([path, "--vae_quant", "int4"])
    monkeypatch.setattr(cli, "DIT_3B", tc.small_test_config())
    monkeypatch.setattr(cli, "VAE_V3", tc.VAEConfig(**Q_VAE))
    vae_file = str(tmp_path / "vae.safetensors")
    safetensors.torch.save_file(
        {k: v.contiguous() for k, v in state_dict_from_jax(q_params).items()},
        vae_file)
    for vae_model in (None, vae_file):
        runner = cli.make_runner("cpu", seed=0, vae_model=vae_model,
                                 vae_quant="int8")
        assert runner.vae.cfg.conv_quant == "int8"
        assert runner.config.vae.conv_quant == "int8"
        convs = dict(tv.int8_served_convs(runner.vae.model))
        assert convs and all(c.wq.dtype == torch.int8 for c in convs.values())
    assert cli.make_runner("cpu", seed=0).vae.cfg.conv_quant == "none"


def test_int8_slice_matches_jax_pipeline():
    """The whole 4-phase slice with the int8 VAE against the JAX runner
    whose VAE has conv_quant="int8", shared weights and noise, no colour
    correction. The int8 convs carry the quantization flips of
    test_int8_decode_matches_jax, over fewer layers here (P_VAE): relative
    L2 to the JAX int8 slice below 1e-3 (observed 1.2e-5), and closer to it
    than to the slice with the float VAE (observed 0.023; the port's,
    which test_torch_pipeline.py holds to JAX's)."""
    jd_cfg = JDiTConfig(**DIT_KW)
    dit_p = random_params(lambda k: init_dit_params(k, jd_cfg,
                                                    dtype=jnp.float32), 3)
    vae_p = random_params(lambda k: jv.init_vae_params(
        k, JVAEConfig(**P_VAE), dtype=jnp.float32), seed=22)

    jv_cfg = JVAEConfig(**P_VAE, conv_quant="int8")
    j_runner = JRunner(dit_p, jd_cfg, jv.VideoVAE(vae_p, jv_cfg,
                                                  dtype=jnp.float32),
                       JRunnerConfig(dit=jd_cfg, vae=jv_cfg),
                       compute_dtype=jnp.float32)
    td_cfg = tc.DiTConfig(**DIT_KW)
    dit = NaDiT(td_cfg, dtype=torch.float32)
    dit.load_state_dict(state_dict_from_jax(dit_p), strict=True)

    def t_runner(**quant):
        tvae = _port_vae(vae_p, P_VAE, **quant)
        return TRunner(dit, tvae, tc.RunnerConfig(dit=td_cfg, vae=tvae.cfg),
                       compute_dtype=torch.float32)
    rng = np.random.default_rng(7)
    images = rng.uniform(0, 1, (5, 24, 20, 3)).astype(np.float32)
    emb = {"pos": rng.standard_normal((7, 16)).astype(np.float32),
           "neg": rng.standard_normal((9, 16)).astype(np.float32)}
    noise = [rng.standard_normal((2, 6, 4, 4)).astype(np.float32)]
    ref = _jax_pipeline(j_runner, images, emb, noise, "none", 0)
    runner = t_runner(conv_quant="int8")
    assert len(dict(tv.int8_served_convs(runner.vae.model))) == 2 * 2 + 8
    out, ref_f = (cli.process_frames(
        r, images, emb, resolution=32, seed=1, batch_size=5,
        color_correction="none", noise_override=noise)[0]
        for r in (runner, t_runner()))
    assert out.shape == ref.shape == (5, 38, 32, 3)
    to_q = np.linalg.norm(out - ref) / np.linalg.norm(ref)
    to_f = np.linalg.norm(out - ref_f) / np.linalg.norm(ref_f)
    assert to_q < 1e-3 and to_q < to_f, (to_q, to_f)


def test_oom_retry_keeps_int8_vae_per_tile(monkeypatch, q_params):
    """The runner's out-of-memory retry on an int8 VAE: the untiled decode
    fails, the retry decodes tiles of batch 1 through the same VideoVAE, so
    every tile's served convs still take the int8 path."""
    tvae = _port_vae(q_params, Q_VAE, conv_quant="int8")
    conv_calls, decode_calls = [], []
    real_conv, real_decode = tic.int8_conv3d_ncdhw, tvae.decode

    def conv(x_ext, *a):
        conv_calls.append(x_ext.shape)
        return real_conv(x_ext, *a)

    def decode(z, tiled=False, **kw):
        decode_calls.append((z.shape[0], tiled))
        if not tiled:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (stub)")
        return real_decode(z, tiled=tiled, **kw)

    monkeypatch.setattr(tic, "int8_conv3d_ncdhw", conv)
    monkeypatch.setattr(tvae, "decode", decode)
    monkeypatch.setattr(TRunner, "_MIN_TILE", 16)
    runner = TRunner(NaDiT(tc.small_test_config(), dtype=torch.float32), tvae,
                     tc.RunnerConfig(vae=tvae.cfg),
                     tiling=VAETiling(decode_tile_size=(40, 40),
                                      decode_tile_overlap=(16, 16)))
    z = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 4, 8, 4)).astype(np.float32))
    out = runner.vae_decode([z])[0]
    assert decode_calls == [(1, False), (1, True)]
    assert runner.tiling.decode_tiled
    assert out.shape == (5, 32, 64, 3) and torch.isfinite(out).all()
    n_tiles = len(tvae.last_decode_tiles)
    served = len(dict(tv.int8_served_convs(tvae.model)))
    assert n_tiles > 1 and len(conv_calls) == n_tiles * served
