"""The port's w8a8 lane against the JAX package on the CPU: the plain
versions of kernels K3 (int8 GEMM), K4 (rms_norm + ada + quantize) and K5
(silu*up + quantize), the quantization helpers, the w8a8 linears, the DiT
conversion, and a whole w8a8 NaDiT forward.

Tolerances, with their reasons:
 - K3 is exact: int32 (here float64) sums of int8 products are exact, and
   the epilogue multiplies in the same order as the JAX kernel.
 - K4/K5: scales within rtol 1e-6; q equal in >= 99.9 % of entries and
   never off by more than 1. The producers' row sums (mean of squares) and
   rsqrt are evaluated in another order than XLA's, which can move a value
   across a .5 rounding boundary of y / scale.
"""

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from seedvr2_tpu.core.configs import small_test_config as j_small
from seedvr2_tpu.models.dit import nadit as jn
from seedvr2_tpu.ops import fused_quant as jfq
from seedvr2_tpu.ops import int8_matmul as jim
from seedvr2_tpu_torch.core.configs import small_test_config
from seedvr2_tpu_torch.core.weights import state_dict_from_jax
from seedvr2_tpu_torch.models.dit import nadit as tn
from seedvr2_tpu_torch.ops import fused_quant as tfq
from seedvr2_tpu_torch.ops import int8_matmul as tim
from seedvr2_tpu_torch.ops.layers import linear, mlp_forward

from .test_torch_dit import random_params

# min_dim / align lowered so the tiny config has both converted linears
# (qkv, attn out, mlp, time-embedding hid/out) and dense ones (vid_in with
# 132 inputs, txt_in with 48)
MIN_DIM, ALIGN = 64, 32


def _assert_q_close(q, q_ref, s, s_ref):
    np.testing.assert_allclose(s, s_ref, rtol=1e-6, atol=0)
    diff = np.abs(q.astype(np.int32) - q_ref.astype(np.int32))
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.999


# ------------------------------------------------------------------- K3


@pytest.mark.parametrize("m,k,n", [(64, 512, 256), (130, 256, 512),
                                   (1, 256, 256), (58, 512, 256)])
def test_int8_matmul_plain_exact(m, k, n):
    """Shapes of tests/test_w8a8.py plus M = 1 (time embedding) and a
    ragged M = 58 (text rows): the port's plain K3 equals the JAX Pallas
    kernel in interpret mode and the JAX CPU emulation bit for bit, in fp32
    and in bf16 output."""
    rng = np.random.default_rng(m + k + n)
    xq = rng.integers(-127, 128, (m, k)).astype(np.int8)
    wq = rng.integers(-127, 128, (k, n)).astype(np.int8)
    xs = (rng.random(m) * 0.1).astype(np.float32)
    ws = (rng.random(n) * 0.05).astype(np.float32)
    args = [jnp.asarray(a) for a in (xq, wq, xs, ws)]
    kernel = np.asarray(jim.int8_matmul(*args, out_dtype=jnp.float32,
                                        block_m=64, block_n=256, block_k=256,
                                        interpret=True))
    emul = np.asarray(jim.int8_matmul(*args, out_dtype=jnp.float32))
    t = [torch.from_numpy(a) for a in (xq, wq.T.copy(), xs, ws)]
    ours = tim.int8_matmul(*t, out_dtype=torch.float32).numpy()
    np.testing.assert_array_equal(ours, kernel)
    np.testing.assert_array_equal(ours, emul)
    ref = (xq.astype(np.int64) @ wq.astype(np.int64)).astype(np.float32)
    np.testing.assert_array_equal(ours, ref * xs[:, None] * ws[None, :])
    bf = tim.int8_matmul(*t).float().numpy()
    np.testing.assert_array_equal(bf, np.asarray(jim.int8_matmul(*args).astype(
        jnp.float32)))


def test_k3_plan_covers_every_3b_w8a8_shape():
    """K3 and K10 share one s8 GEMM and its tile plan (plan_qx). Every
    linear that quantize_dit_w8a8 converts in the 3B DiT (and the joint
    gate+up), at every token count K3 meets on the served requests (the
    time embedding's 1 row, the 58 text rows, the 720p clip, the 1080p
    image and clip, the 4K image), gets tiles the kernel takes: K % 32 ==
    0 and N % 8 == 0, swapped tiles of 8 or 64 tokens holding all M rows,
    else 128 x 256 tiles, a grid within 2^31 blocks."""
    from seedvr2_tpu_torch.core.configs import DIT_3B

    with torch.device("meta"):
        model = tn.NaDiT(DIT_3B, dtype=torch.bfloat16)
    shapes = {(mod.out_features, mod.in_features)
              for mod in model.modules() if isinstance(mod, nn.Linear)
              and min(mod.in_features, mod.out_features) >= 1024
              and mod.in_features % 256 == 0 and mod.out_features % 256 == 0}
    shapes.add((2 * 6912, DIT_3B.vid_dim))  # fuse_gate_up's joint weight
    assert (7680, 2560) in shapes and (2560, 6912) in shapes
    for m in (1, 8, 9, 58, 64, 65, 7200, 8160, 16320, 32400):
        swap, bt = tim.plan_qx(m)
        for n, k in shapes:
            assert k % 32 == 0 and n % 8 == 0
            if swap:
                assert bt in (8, 64) and m <= bt and m <= 64
                blocks = -(-n // 128)
            else:
                assert bt == 256 and m > 64
                blocks = -(-m // 128) * -(-n // 256)
            assert blocks < 2 ** 31


def test_quantize_helpers_equal():
    """Activation and weight quantization: int8 values and scales equal to
    the JAX package's (the port's weight is the (N, K) transpose)."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 100, 256)) * 2).astype(np.float32)
    q, s = tim.quantize_activations(torch.from_numpy(x))
    jq, js = jim.quantize_activations(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    w = (rng.standard_normal((256, 128)) * 0.1).astype(np.float32)
    wq, wsc = tim.quantize_weight_w8a8(torch.from_numpy(w.T.copy()))
    jwq, jws = jim.quantize_weight_w8a8(w)
    np.testing.assert_array_equal(wq.numpy(), jwq.T)
    np.testing.assert_array_equal(wsc.numpy(), jws)


# ------------------------------------------------------------ K4 and K5


@pytest.mark.parametrize("interpret", [False, True], ids=["fallback", "kernel"])
@pytest.mark.parametrize("k", [256, 512])
def test_rms_ada_quantize_plain_matches_jax(interpret, k):
    """L = 64, K % 256 == 0: the JAX Pallas body runs in interpret mode."""
    rng = np.random.default_rng(k)
    b, l = 2, 64
    x = (rng.standard_normal((b, l, k)) * 1.7).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, (b, k)).astype(np.float32)
    shift = (rng.standard_normal((b, k)) * 0.3).astype(np.float32)
    ref = jfq.rms_ada_quantize(jnp.asarray(x), jnp.asarray(scale),
                               jnp.asarray(shift), eps=1e-5,
                               interpret=interpret)
    out = tfq.rms_ada_quantize(torch.from_numpy(x), torch.from_numpy(scale),
                               torch.from_numpy(shift), eps=1e-5)
    assert isinstance(out, tfq.PreQuantized)
    assert out.q.dtype == torch.int8 and out.q.shape == (b, l, k)
    assert out.s.shape == (b, l) and out.dtype == torch.float32
    _assert_q_close(out.q.numpy(), np.asarray(ref.q), out.s.numpy(),
                    np.asarray(ref.s))


@pytest.mark.parametrize("interpret", [False, True], ids=["fallback", "kernel"])
@pytest.mark.parametrize("k", [256, 512])
def test_silu_mul_quantize_plain_matches_jax(interpret, k):
    """g and u as the two halves of one gate+up product (strided views, as
    the w8a8 mlp hands them over)."""
    rng = np.random.default_rng(k + 1)
    b, l = 2, 64
    gu = (rng.standard_normal((b, l, 2 * k)) * 2).astype(np.float32)
    g, u = gu[..., :k], gu[..., k:]
    ref = jfq.silu_mul_quantize(jnp.asarray(g), jnp.asarray(u),
                                interpret=interpret)
    t = torch.from_numpy(gu)
    out = tfq.silu_mul_quantize(t[..., :k], t[..., k:])
    assert out.q.shape == (b, l, k) and out.s.shape == (b, l)
    _assert_q_close(out.q.numpy(), np.asarray(ref.q), out.s.numpy(),
                    np.asarray(ref.s))


# ------------------------------------------------------- w8a8 linears


def _w8a8_pair(rng, k, n, bias):
    w = rng.standard_normal((k, n)).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32) if bias else None
    lin = nn.Linear(k, n, bias=bias)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T.copy()))
        if bias:
            lin.bias.copy_(torch.from_numpy(b))
    jq, js = jim.quantize_weight_w8a8(w)
    p = {"w8a8": jnp.asarray(jq), "ws": jnp.asarray(js)}
    if bias:
        p["b"] = jnp.asarray(b)
    return tim.W8A8Linear.from_linear(lin), p


@pytest.mark.parametrize("bias", [False, True])
def test_prequantized_through_linear_and_double_linear(bias):
    """Mirrors tests/test_fused_quant.py: a PreQuantized input through
    linear and w8a8_double_linear agrees with the float-input w8a8 path, and
    both agree with the JAX package's w8a8 linears (exact: same int8
    operands, same epilogue order). A dense layer refuses a PreQuantized."""
    from seedvr2_tpu.ops.layers import linear as jlinear

    rng = np.random.default_rng(3)
    b, l, k, n = 1, 64, 256, 128
    x = rng.standard_normal((b, l, k)).astype(np.float32)
    xt = torch.from_numpy(x)
    l1, p1 = _w8a8_pair(rng, k, n, bias)
    l2, p2 = _w8a8_pair(rng, k, n, bias)
    xq, xs = tim.quantize_activations(xt)
    pre = tfq.PreQuantized(xq, xs, torch.float32)

    np.testing.assert_array_equal(linear(pre, l1).numpy(),
                                  linear(xt, l1).numpy())
    np.testing.assert_array_equal(linear(xt, l1).numpy(),
                                  np.asarray(jlinear(jnp.asarray(x), p1)))
    with pytest.raises(ValueError, match="not joined"):
        tim.w8a8_double_linear(pre, l1, l2)
    tim.fuse_gate_up(l1, l2)
    a_pre, b_pre = tim.w8a8_double_linear(pre, l1, l2)
    a_ref, b_ref = tim.w8a8_double_linear(xt, l1, l2)
    ja, jb = jim.w8a8_double_linear(jnp.asarray(x), p1, p2)
    for ours, plain, ref in ((a_pre, a_ref, ja), (b_pre, b_ref, jb)):
        np.testing.assert_array_equal(ours.numpy(), plain.numpy())
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    dense = nn.Linear(k, n)
    with pytest.raises(TypeError):
        linear(pre, dense)


def test_w8a8_mlp_forward_matches_jax():
    """The swiglu mlp in w8a8: gate+up as one GEMM, silu*up through the
    fused quantize, proj_out int8; against the JAX mlp_forward."""
    from seedvr2_tpu.ops.layers import mlp_forward as jmlp

    rng = np.random.default_rng(4)
    k, h = 128, 256
    gate, pg = _w8a8_pair(rng, k, h, False)
    up, pu = _w8a8_pair(rng, k, h, False)
    out, po = _w8a8_pair(rng, h, k, False)
    mlp = nn.Module()
    mlp.proj_in_gate, mlp.proj_in, mlp.proj_out = gate, up, out
    tim.fuse_gate_up(gate, up)
    x = rng.standard_normal((2, 40, k)).astype(np.float32)
    ours = mlp_forward(torch.from_numpy(x), mlp, "swiglu").numpy()
    ref = np.asarray(jmlp(jnp.asarray(x), {"proj_in_gate": pg,
                                           "proj_in": pu, "proj_out": po},
                          "swiglu"))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ conversion


@pytest.fixture(scope="module")
def w8a8_pair():
    params = random_params(lambda key: jn.init_dit_params(
        key, j_small(), dtype=jnp.float32), 5)
    model = tn.NaDiT(small_test_config(), dtype=torch.float32)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    qparams = jim.quantize_dit_params_w8a8(params, min_dim=MIN_DIM,
                                           align=ALIGN)
    return params, qparams, model


def test_quantize_dit_w8a8_matches_jax(w8a8_pair):
    """The port's conversion picks exactly the linears the JAX rule picks,
    with int8 weights equal to quantize_weight_w8a8's and equal scales; the
    weight bridge maps the JAX w8a8 tree onto the converted modules' keys,
    int8 kept exact, and the swiglu gate/up pairs share one joint weight."""
    _, qparams, model = w8a8_pair
    conv = tim.quantize_dit_w8a8(model_copy(model), MIN_DIM, ALIGN)
    bridged = state_dict_from_jax(qparams)
    sd = conv.state_dict()
    assert sd.keys() == bridged.keys()
    converted = {k[:-len(".w8a8")] for k in sd if k.endswith(".w8a8")}
    expect = {k[:-len(".w8a8")] for k in bridged if k.endswith(".w8a8")}
    assert converted == expect and converted
    assert "vid_in.proj" not in converted and "txt_in" not in converted
    for k, v in bridged.items():
        assert sd[k].dtype == v.dtype, k
        np.testing.assert_array_equal(sd[k].numpy(), v.numpy())
    mlp = conv.blocks[0].mlp["vid"]
    assert mlp.proj_in_gate.gate_up_w8a8.shape[0] == 2 * mlp.proj_in.out_features
    assert mlp.proj_in.w8a8.data_ptr() == (mlp.proj_in_gate.gate_up_w8a8
                                           .data_ptr()
                                           + mlp.proj_in_gate.w8a8.numel())


def model_copy(model):
    out = tn.NaDiT(model.cfg, dtype=torch.float32)
    out.load_state_dict(model.state_dict(), strict=True)
    return out


@pytest.mark.parametrize("shape", [(3, 8, 10), (1, 6, 6)])
def test_w8a8_nadit_forward_matches_jax(w8a8_pair, shape):
    """Whole w8a8 NaDiT in fp32, the JAX-quantized tree loaded through the
    weight bridge, against the JAX forward of the same tree (K3 emulation
    and the K4/K5 fallbacks on the JAX side). Bound 1e-4 as for the dense
    forward (tests/test_torch_dit.py): a K4/K5 +-1 flip would move an
    output by about one int8 step of its row's scale, and none occurs at
    this size (observed max difference 4.8e-7 on outputs of ~2)."""
    _, qparams, model = w8a8_pair
    cfg = small_test_config()
    qmodel = tim.quantize_dit_w8a8(model_copy(model), MIN_DIM, ALIGN)
    qmodel.load_state_dict(state_dict_from_jax(qparams), strict=True)
    T, H, W = shape
    txt_len = 7
    rng = np.random.default_rng(42)
    vid = rng.standard_normal((1, T, H, W, cfg.vid_in_channels),
                              dtype=np.float32)
    txt = rng.standard_normal((1, txt_len, cfg.txt_in_dim), dtype=np.float32)
    plan = jn.build_dit_plan(j_small(), shape, txt_len)
    ref = np.asarray(jax.jit(lambda p, v, x, t: jn.nadit_forward(
        p, j_small(), v, x, t, plan))(qparams, jnp.asarray(vid),
                                      jnp.asarray(txt), jnp.asarray([500.0])))
    dplan = tn.upload_plan(tn.build_dit_plan(cfg, shape, txt_len), cfg, "cpu")
    args = (torch.from_numpy(vid), torch.from_numpy(txt),
            torch.tensor([500.0]), dplan)
    with torch.no_grad():
        out = tn.nadit_forward(qmodel, *args).numpy()
        plain = tn.nadit_forward(qmodel, *args, use_kernels=False).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(out, plain)  # CPU: wrappers run plain
