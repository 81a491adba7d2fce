"""The plain version of the K1/K8/K9 pre-pass (`norm_rope_plain`: q and k
RMS-normed (K1), roped (K9: each window row by the table its id picks) and
scaled, rounded to the operands' dtype) against the JAX package on the CPU,
alone and as the input of attention in the exp2 domain, the way the Hopper
attention step consumes it (q-hat carries scale*log2e, so softmax2(q-hat
k-hat^T) = softmax(q k^T * scale)). The pre-pass kernel itself runs only on
a GPU: tests/test_torch_cuda.py and chip_smoke.py hold it to this plain
version on the card."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seedvr2_tpu.models.dit import rope as jr
from seedvr2_tpu.ops import attention as jattn
from seedvr2_tpu.ops import flash_attention as jfa
from seedvr2_tpu_torch.ops import flash_attention as tfa
from seedvr2_tpu_torch.ops.attention import attention_xla

_LOG2E = 1.4426950408889634


def _table(rng, s, d):
    ang = rng.standard_normal((s, d // 2)).astype(np.float32)
    return np.repeat(np.cos(ang), 2, axis=1), np.repeat(np.sin(ang), 2, axis=1)


def _jax_norm_rope(x, cos, sin, eps, mult):
    """The JAX package's own composition: packed_attention's fp32 RMS norm
    and rope (ops/attention.py) when eps is given, else apply_rope_ext with
    the shared table padded by identity rows as its dense attention does;
    then times mult, rounded to x's dtype."""
    z = jnp.asarray(x).astype(jnp.float32)
    if eps is not None:
        z = z * jax.lax.rsqrt(jnp.mean(z * z, axis=-1, keepdims=True) + eps)
    if cos is not None:
        s = z.shape[-3]
        cos = jnp.pad(jnp.asarray(cos), ((0, s - cos.shape[0]), (0, 0)),
                      constant_values=1.0)
        sin = jnp.pad(jnp.asarray(sin), ((0, s - sin.shape[0]), (0, 0)))
        z = jr.apply_rope_ext(z, cos, sin)
    return np.asarray((z * mult).astype(jnp.asarray(x).dtype))


def _exp2_attention(q_hat, k_hat, v, kv_len):
    """softmax2(q-hat k-hat^T) v over the first kv_len keys: q-hat already
    carries scale*log2e, and 2^x = e^(x ln 2)."""
    s = k_hat.shape[-3]
    bias = None
    if kv_len < s:
        col = torch.arange(s)
        bias = torch.where(col < kv_len, 0.0, float("-inf"))[None, None, :]
    return attention_xla(q_hat, k_hat, v, scale=math.log(2.0), bias=bias)


@pytest.mark.parametrize("eps,rows,mult", [
    (1e-5, 96, 64 ** -0.5 * _LOG2E),   # K1's q side: norm, full table
    (1e-5, 96, 1.0),                   # K1's k side
    (None, 60, 64 ** -0.5 * _LOG2E),   # K8's q: table shorter than S
    (None, None, 0.3)],                # K8 without a table: scale only
    ids=["k1_q", "k1_k", "k8_short_table", "k8_no_table"])
def test_norm_rope_plain_matches_jax_fp32(eps, rows, mult):
    """fp32 end to end on both sides, the same operation order: 1e-5."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 96, 3, 64)).astype(np.float32)
    cos = sin = None
    if rows is not None:
        cos, sin = _table(rng, rows, 64)
    out = tfa.norm_rope_plain(
        torch.from_numpy(x), None if cos is None else torch.from_numpy(cos),
        None if sin is None else torch.from_numpy(sin), eps, mult)
    ref = _jax_norm_rope(x, cos, sin, eps, mult)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def _packed_case(rng, s, h, d, dtype=np.float32):
    qkv = rng.standard_normal((2, s, 3 * h * d)).astype(dtype)
    return qkv, [*_table(rng, s, d), *_table(rng, s, d)]


def _k1_from_prepass(qkv, h, d, tabs, eps, kv_len):
    """K1's composition as the kernels run it: the pre-pass's scaled
    q-hat and k-hat, then attention in the exp2 domain."""
    b, s, _ = qkv.shape
    x = qkv.reshape(b, s, 3, h, d)
    cq, sq, ck, sk = tabs
    q_hat = tfa.norm_rope_plain(x[:, :, 0], cq, sq, eps, d ** -0.5 * _LOG2E)
    k_hat = tfa.norm_rope_plain(x[:, :, 1], ck, sk, eps)
    out = _exp2_attention(q_hat, k_hat, x[:, :, 2], kv_len)
    return out.reshape(b, s, h * d)


@pytest.mark.parametrize("s,kv_len", [(128, 128), (128, 93), (256, 200)])
def test_prepass_attention_matches_jax_packed_xla_fp32(s, kv_len):
    """Through ops/attention.packed_attention in xla mode, as
    test_k1_plain_matches_jax_fp32 does: fp32, 1e-5."""
    rng = np.random.default_rng(s + kv_len)
    h, d, eps = 2, 64, 1e-5
    qkv, tabs = _packed_case(rng, s, h, d)
    out = _k1_from_prepass(torch.from_numpy(qkv), h, d,
                           [torch.from_numpy(t) for t in tabs], eps, kv_len)
    jattn.set_attention_mode("xla")
    try:
        ref = np.asarray(jattn.packed_attention(
            jnp.asarray(qkv), h, d, *tabs, eps, kv_len=kv_len))
    finally:
        jattn.set_attention_mode("flash")
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kv_len", [128, 100])
def test_prepass_attention_matches_pallas_interpret_bf16(kv_len):
    """bf16 q-hat and k-hat, rounded after the scale as the kernel rounds
    them, against the Pallas kernel in interpret mode at the JAX package's
    kernel tolerance (tests/test_flash_attention.py)."""
    rng = np.random.default_rng(kv_len)
    h, d, eps = 2, 128, 1e-6
    qkv, tabs = _packed_case(rng, 128, h, d)
    ref = np.asarray(jfa.flash_packed_attention(
        jnp.asarray(qkv, jnp.bfloat16), h, d, *tabs, eps, kv_len=kv_len,
        interpret=True).astype(jnp.float32))
    out = _k1_from_prepass(torch.from_numpy(qkv).to(torch.bfloat16), h, d,
                           [torch.from_numpy(t) for t in tabs], eps, kv_len)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("rows,kv_len", [(60, 90), (100, 77)])
def test_prepass_dense_attention_matches_jax_fp32(rows, kv_len):
    """K8's form: no norm, one shared table (rows past it unrotated), q-hat
    scaled, against the JAX package's dense `attention` (XLA branch)."""
    rng = np.random.default_rng(rows)
    q, k, v = (rng.standard_normal((2, 100, 2, 16)).astype(np.float32)
               for _ in range(3))
    cos, sin = _table(rng, rows, 16)
    tc, ts = torch.from_numpy(cos), torch.from_numpy(sin)
    q_hat = tfa.norm_rope_plain(torch.from_numpy(q), tc, ts, None,
                                16 ** -0.5 * _LOG2E)
    k_hat = tfa.norm_rope_plain(torch.from_numpy(k), tc, ts)
    out = _exp2_attention(q_hat, k_hat, torch.from_numpy(v), kv_len)
    ref = np.asarray(jattn.attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), rope_cos=cos,
        rope_sin=sin, kv_len=kv_len))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_attention_prepass_routes_cpu_to_plain():
    """On the CPU the pre-pass wrapper is its plain version, strided q and k
    columns of the packed operand included; no kernel for other devices."""
    rng = np.random.default_rng(3)
    qkv, tabs = _packed_case(rng, 64, 2, 64)
    qkv = torch.from_numpy(qkv).to(torch.bfloat16)
    tabs = [torch.from_numpy(t) for t in tabs]
    x = qkv.view(2, 64, 3, 2, 64)
    q_hat, k_hat = tfa.attention_prepass(x[:, :, 0], x[:, :, 1], *tabs, 1e-5,
                                         0.5)
    assert torch.equal(q_hat, tfa.norm_rope_plain(x[:, :, 0], *tabs[:2],
                                                  1e-5, 0.5))
    assert torch.equal(k_hat, tfa.norm_rope_plain(x[:, :, 1], *tabs[2:],
                                                  1e-5))
    meta = x.to("meta")
    with pytest.raises(RuntimeError):
        tfa.attention_prepass(meta[:, :, 0], meta[:, :, 1], *tabs, 1e-5, 0.5)


def _windows_case(rng, b=5, s=100, h=2, d=16, n_u=3):
    """B window rows of (S, H, D), nU (S, D) tables, every id used, and a
    key validity row per id (id 0 its first 70 keys invalid, id 1 its
    middle 30)."""
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for _ in range(3))
    ang = rng.standard_normal((n_u, s, d // 2)).astype(np.float32)
    cos = np.repeat(np.cos(ang), 2, axis=-1)
    sin = np.repeat(np.sin(ang), 2, axis=-1)
    ids = np.array([2, 0, 1, 1, 0][:b], np.int32)
    valid = np.ones((n_u, s), bool)
    valid[0, :70] = False
    valid[1, 40:70] = False
    return q, k, v, cos, sin, ids, valid


@pytest.mark.parametrize("mult", [16 ** -0.5 * _LOG2E, 1.0],
                         ids=["k9_q", "k9_k"])
def test_norm_rope_plain_with_window_ids_matches_jax_fp32(mult):
    """K9's pre-pass: each batch row roped by the (S, D) table its id picks,
    against the JAX package's composition on the gathered tables
    (ops/attention.py `attention` with table_ids: apply_rope_ext(x,
    cos[ids], sin[ids])), times mult. fp32, the same operation order:
    1e-5."""
    rng = np.random.default_rng(21)
    x, _, _, cos, sin, ids, _ = _windows_case(rng)
    out = tfa.norm_rope_plain(torch.from_numpy(x), torch.from_numpy(cos),
                              torch.from_numpy(sin), None, mult,
                              torch.from_numpy(ids))
    ref = np.asarray(jr.apply_rope_ext(jnp.asarray(x), jnp.asarray(cos)[ids],
                                       jnp.asarray(sin)[ids]) * mult)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def _k9_from_prepass(q, k, v, cos, sin, ids, valid):
    """K9's composition as the kernels run it: the pre-pass's q-hat (times
    scale*log2e) and k-hat, each row by its id's table, then attention in
    the exp2 domain over the keys its id's validity row marks."""
    d = q.shape[-1]
    ids_t = torch.from_numpy(ids)
    q_hat = tfa.norm_rope_plain(q, cos, sin, None, d ** -0.5 * _LOG2E, ids_t)
    k_hat = tfa.norm_rope_plain(k, cos, sin, ids=ids_t)
    bias = torch.where(valid[ids_t.long()], 0.0, float("-inf"))
    return attention_xla(q_hat, k_hat, v, scale=math.log(2.0),
                         bias=bias[:, None, None, :])


def test_window_prepass_attention_matches_jax_fp32():
    """Through the JAX package's `attention` with table_ids and kv_valid
    (XLA branch): fp32, 1e-5."""
    rng = np.random.default_rng(22)
    q, k, v, cos, sin, ids, valid = _windows_case(rng)
    out = _k9_from_prepass(*(torch.from_numpy(a) for a in
                             (q, k, v, cos, sin)), ids,
                           torch.from_numpy(valid))
    ref = np.asarray(jattn.attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), rope_cos=cos,
        rope_sin=sin, table_ids=ids, kv_valid=valid))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_window_prepass_attention_matches_pallas_interpret_bf16():
    """bf16 q-hat and k-hat against `flash_windowed_attention`
    (`_fa_rope_mask_kernel`) in interpret mode, at the JAX package's kernel
    tolerance."""
    rng = np.random.default_rng(23)
    q, k, v, cos, sin, ids, valid = _windows_case(rng, s=128, d=128)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    ref = np.asarray(jfa.flash_windowed_attention(
        jq, jk, jv, None, cos, sin, ids, valid,
        interpret=True).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    out = _k9_from_prepass(tq, tk, tv, torch.from_numpy(cos),
                           torch.from_numpy(sin), ids,
                           torch.from_numpy(valid))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=2e-2, rtol=2e-2)


def test_attention_prepass_with_window_ids_routes_cpu_to_plain():
    """The pre-pass wrapper with window ids is its plain version on the CPU;
    ids need tables."""
    from seedvr2_tpu_torch.ops.gather import RowIndex

    rng = np.random.default_rng(24)
    q, k, _, cos, sin, ids, _ = _windows_case(rng)
    tq, tk, tc, ts = (torch.from_numpy(a) for a in (q, k, cos, sin))
    index = RowIndex(ids, "cpu")
    q_hat, k_hat = tfa.attention_prepass(tq, tk, tc, ts, tc, ts, None, 0.5,
                                         index)
    ids_t = torch.from_numpy(ids)
    assert torch.equal(q_hat, tfa.norm_rope_plain(tq, tc, ts, None, 0.5,
                                                  ids_t))
    assert torch.equal(k_hat, tfa.norm_rope_plain(tk, tc, ts, ids=ids_t))
    meta = tq.to("meta")
    with pytest.raises(ValueError):
        tfa.attention_prepass(meta, meta, None, None, None, None, None, 0.5,
                              index)
