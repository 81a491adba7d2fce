"""The port's quantised-checkpoint lanes against the JAX package on the CPU:
the quantizers (bit-equal), the plain versions of kernels K6 (Q8_0
dequantizing GEMM) and K7 (affine) against the JAX Pallas kernels in
interpret mode, the quantised linears, the PTQ conversions, the weight
bridge for Q8_0 and affine trees, and a layers.linear / _norm_mod routing
check.

Tolerances, with their reasons:
 - quantizers: exact. Both sides take the reciprocal of the scale and round
   half to even in fp32.
 - K6/K7 plain versions against the interpret-mode kernels: fp32 atol 1e-4,
   rtol 1e-5. The same fp32 products are summed in another order (the
   Pallas kernel per K block, the plain version in one matmul).
"""

import numpy as np
import pytest
import torch
from torch import nn

import jax.numpy as jnp

from seedvr2_tpu.core.configs import small_test_config as j_small
from seedvr2_tpu.models.dit import nadit as jn
from seedvr2_tpu.ops import quant_matmul as jqm
from seedvr2_tpu_torch.core.configs import small_test_config
from seedvr2_tpu_torch.core.weights import state_dict_from_jax
from seedvr2_tpu_torch.models.dit import nadit as tn
from seedvr2_tpu_torch.ops import quant_matmul as tqm
from seedvr2_tpu_torch.ops.layers import linear

from .test_torch_dit import random_params

# lowered so the tiny config (width 64) has converted and dense linears
MIN_DIM = 64


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------- quantizers


@pytest.mark.parametrize("k,n,scale", [(256, 96, 1.0), (64, 40, 1e-3),
                                       (1024, 32, 30.0)])
def test_quantizers_bit_equal(k, n, scale):
    """quantize_q8 and quantize_affine4 on the (N, K) transpose give the JAX
    quantizers' int8 values and fp32 tables bit for bit, with a zero group
    and a constant group (scale 0: inv 0, q 0) in the weight."""
    rng = np.random.default_rng(k + n)
    w = (rng.standard_normal((k, n)) * scale).astype(np.float32)
    w[:32, 0] = 0.0
    w[32:64, 1] = 0.25
    jq, js = jqm.quantize_q8(jnp.asarray(w))
    q, s = tqm.quantize_q8(_t(w.T))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq).T)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js).T)
    np.testing.assert_array_equal(
        tqm.dequantize_q8(q, s).numpy(),
        np.asarray(jqm.dequantize_q8(jq, js)).T)
    jqa, jsa, jma = jqm.quantize_affine4(jnp.asarray(w))
    qa, sa, ma = tqm.quantize_affine4(_t(w.T))
    assert qa.dtype == torch.int8 and 0 <= qa.min() and qa.max() <= 15
    np.testing.assert_array_equal(qa.numpy(), np.asarray(jqa).T)
    np.testing.assert_array_equal(sa.numpy(), np.asarray(jsa).T)
    np.testing.assert_array_equal(ma.numpy(), np.asarray(jma).T)


# ------------------------------------------------------------- K6 and K7


def _q8_operands(rng, m, k, n):
    x = rng.standard_normal((m, k)).astype(np.float32)
    q = rng.integers(-127, 128, (k, n)).astype(np.int8)
    s = rng.uniform(0.001, 0.05, (k // 32, n)).astype(np.float32)
    return x, q, s


@pytest.mark.parametrize("m,k,n", [(48, 128, 96), (1, 256, 64),
                                   (58, 160, 32)])
def test_quant_matmul_q8_plain_matches_pallas(m, k, n):
    """K6's plain version against the JAX Pallas kernel in interpret mode at
    small blocks (as tests/test_quant_matmul.py runs it) and against the
    JAX non-TPU emulation; M = 1 (time embedding) and a ragged M = 58 (text
    rows) included."""
    rng = np.random.default_rng(m * k + n)
    x, q, s = _q8_operands(rng, m, k, n)
    kernel = np.asarray(jqm.quant_matmul_q8(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(s), block_m=16,
        block_n=32, block_k=64, interpret=True))
    emul = np.asarray(jqm.quant_matmul_q8(jnp.asarray(x), jnp.asarray(q),
                                          jnp.asarray(s)))
    ours = tqm.quant_matmul_q8(_t(x), _t(q.T), _t(s.T))
    assert ours.shape == (m, n) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), kernel, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(ours.numpy(), emul, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("m,k,n,qmax", [(48, 128, 96, 15), (1, 256, 64, 31),
                                        (58, 160, 32, 15)])
def test_quant_matmul_affine_plain_matches_pallas(m, k, n, qmax):
    """K7's plain version (w = q*s - m) against the interpret-mode Pallas
    kernel, which takes the min term as group_sums(x) @ m; quants in
    [0, 15] (Q4_K, PTQ q4) and [0, 31] (Q5_K)."""
    rng = np.random.default_rng(m * k + n + qmax)
    x = rng.standard_normal((m, k)).astype(np.float32)
    q = rng.integers(0, qmax + 1, (k, n)).astype(np.int8)
    s = rng.uniform(0.01, 0.1, (k // 32, n)).astype(np.float32)
    mn = rng.uniform(0.0, 0.5, (k // 32, n)).astype(np.float32)
    args = [jnp.asarray(a) for a in (x, q, s, mn)]
    kernel = np.asarray(jqm.quant_matmul_affine(
        *args, block_m=16, block_n=32, block_k=64, interpret=True))
    ours = tqm.quant_matmul_affine(_t(x), _t(q.T), _t(s.T), _t(mn.T))
    np.testing.assert_allclose(ours.numpy(), kernel, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(
        ours.numpy(), np.asarray(jqm.quant_matmul_affine(*args)),
        atol=1e-4, rtol=1e-5)


def test_wrappers_refuse_bad_shapes():
    x = torch.zeros(4, 48)
    with pytest.raises(ValueError, match="do not match"):
        tqm.quant_matmul_q8(x, torch.zeros(8, 48, dtype=torch.int8),
                            torch.zeros(8, 1))
    with pytest.raises(ValueError):
        tqm.quant_matmul_affine(torch.zeros(4, 64),
                                torch.zeros(8, 64, dtype=torch.int8),
                                torch.zeros(8, 2), torch.zeros(8, 3))


# ----------------------------------------------------------------- linears


@pytest.mark.parametrize("kind", ["q8", "affine"])
@pytest.mark.parametrize("bias", [False, True])
def test_quant_linears_match_jax(kind, bias):
    """quant_linear / affine_quant_linear with and without bias, through
    layers.linear (the product rounded to x's dtype, then the bias), against
    the JAX layers.linear on the same quantised tree."""
    from seedvr2_tpu.ops.layers import linear as jlinear

    rng = np.random.default_rng(7 + bias)
    k, n = 128, 96
    w = rng.standard_normal((k, n)).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    lin = nn.Linear(k, n, bias=bias)
    with torch.no_grad():
        lin.weight.copy_(_t(w.T))
        if bias:
            lin.bias.copy_(_t(b))
    if kind == "q8":
        jq, js = jqm.quantize_q8(jnp.asarray(w))
        p = {"q8": jq, "scales": js}
        layer = tqm.Q8Linear.from_linear(lin)
    else:
        jq, js, jm = jqm.quantize_affine4(jnp.asarray(w))
        p = {"qa": jq, "s": js, "m": jm}
        layer = tqm.AffineLinear.from_linear(lin)
    if bias:
        p["b"] = jnp.asarray(b)
    assert (layer.in_features, layer.out_features) == (k, n)
    x = rng.standard_normal((2, 7, k)).astype(np.float32)
    ours = linear(_t(x), layer)
    plain = linear(_t(x), layer, use_kernels=False)
    ref = np.asarray(jlinear(jnp.asarray(x), p))
    assert ours.shape == (2, 7, n)
    np.testing.assert_array_equal(ours.numpy(), plain.numpy())
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4, rtol=1e-5)
    # the state dict carries the JAX tree's leaf names
    assert set(layer.state_dict()) == set(
        ("q8", "scales") if kind == "q8" else ("qa", "s", "m")) | (
        {"bias"} if bias else set())


# -------------------------------------------------------------- conversion


@pytest.fixture(scope="module")
def dit_pair():
    params = random_params(lambda key: jn.init_dit_params(
        key, j_small(), dtype=jnp.float32), 9)
    return params


def _model(params):
    model = tn.NaDiT(small_test_config(), dtype=torch.float32)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model


@pytest.mark.parametrize("kind", ["q8", "affine4"])
def test_dit_conversion_matches_jax(dit_pair, kind):
    """quantize_dit_q8 / quantize_dit_affine4 pick exactly the linears
    quantize_dit_params{,_affine4} pick (min(K, N) >= min_dim, K % 32 == 0,
    no N alignment), with equal quants and tables; the weight bridge maps
    the JAX tree onto the converted modules' keys (transposed, int8 exact,
    tables fp32), and the converted model loads it strictly."""
    params = dit_pair
    if kind == "q8":
        jtree = jqm.quantize_dit_params(params, min_dim=MIN_DIM)
        conv = tqm.quantize_dit_q8(_model(params), MIN_DIM)
        cls, leaf = tqm.Q8Linear, "q8"
    else:
        jtree = jqm.quantize_dit_params_affine4(params, min_dim=MIN_DIM)
        conv = tqm.quantize_dit_affine4(_model(params), MIN_DIM)
        cls, leaf = tqm.AffineLinear, "qa"
    bridged = state_dict_from_jax(jtree)
    sd = conv.state_dict()
    assert sd.keys() == bridged.keys()
    converted = {k[:-len(leaf) - 1] for k in sd if k.endswith("." + leaf)}
    assert converted == {n for n, m in conv.named_modules()
                         if isinstance(m, cls)}
    assert "vid_in.proj" not in converted and "txt_in" not in converted
    assert "blocks.0.attn.proj_qkv.vid" in converted
    for k, v in bridged.items():
        assert sd[k].dtype == v.dtype, k
        np.testing.assert_array_equal(sd[k].numpy(), v.numpy())
    conv.load_state_dict(bridged, strict=True)


def test_norm_mod_takes_plain_path_for_quantised_consumers():
    """The fused rms_norm + ada + quantize producer (K4) is for w8a8
    consumers only: a Q8 or affine consumer gets the float norm_mod output,
    as in the JAX package (nadit.py:373-377)."""
    from seedvr2_tpu_torch.ops.fused_quant import PreQuantized

    cfg = small_test_config()
    model = tn.NaDiT(cfg, dtype=torch.float32)
    for p in model.parameters():
        nn.init.normal_(p, 0.0, 0.1)
    ada = model.blocks[0].ada["vid"]
    x = torch.randn(1, 5, cfg.vid_dim)
    sa, ss = torch.randn(1, cfg.vid_dim), torch.randn(1, cfg.vid_dim)
    ref = tn._norm_mod(x, sa, ss, ada, "attn", 1e-5)
    lin = model.blocks[0].attn.proj_qkv["vid"]
    for consumer in (tqm.Q8Linear.from_linear(lin),
                     tqm.AffineLinear.from_linear(lin)):
        out = tn._norm_mod(x, sa, ss, ada, "attn", 1e-5, consumer)
        assert not isinstance(out, PreQuantized)
        torch.testing.assert_close(out, ref, rtol=0, atol=0)
