"""The plain versions of the port's two kernels against the JAX package, and
the wrappers' routing. The CUDA kernels themselves run only on a GPU:
tests/test_torch_cuda.py (marked `cuda`) and chip_smoke.py hold them to
their plain versions on the card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seedvr2_tpu.core.configs import DIT_3B
from seedvr2_tpu.models.dit.nadit import build_dit_plan
from seedvr2_tpu.ops import attention as jattn
from seedvr2_tpu.ops import flash_attention as jfa
from seedvr2_tpu_torch.ops import flash_attention as tfa
from seedvr2_tpu_torch.ops import gather as tg


def _tables(rng, s, d):
    out = []
    for _ in range(2):
        ang = rng.standard_normal((s, d // 2)).astype(np.float32)
        out += [np.repeat(np.cos(ang), 2, axis=1),
                np.repeat(np.sin(ang), 2, axis=1)]
    return out  # cos_q, sin_q, cos_k, sin_k


def _jax_xla(qkv, h, d, tabs, eps, kv_len):
    jattn.set_attention_mode("xla")
    try:
        return np.asarray(jattn.packed_attention(
            jnp.asarray(qkv), h, d, *tabs, eps, kv_len=kv_len))
    finally:
        jattn.set_attention_mode("flash")


@pytest.mark.parametrize("s,kv_len", [(128, 128), (128, 93), (256, 200)])
def test_k1_plain_matches_jax_fp32(s, kv_len):
    """fp32 end to end on both sides, same operation order: 1e-5."""
    rng = np.random.default_rng(s + kv_len)
    b, h, d, eps = 3, 2, 64, 1e-5
    qkv = rng.standard_normal((b, s, 3 * h * d)).astype(np.float32)
    tabs = _tables(rng, s, d)
    out = tfa.packed_window_attention(
        torch.from_numpy(qkv), h, d, *map(torch.from_numpy, tabs), eps,
        kv_len)
    ref = _jax_xla(qkv, h, d, tabs, eps, kv_len)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kv_len", [128, 100])
def test_k1_plain_matches_pallas_interpret_bf16(kv_len):
    """bf16 operands against the Pallas kernel run in interpret mode, at the
    JAX package's own kernel tolerance (tests/test_flash_attention.py): the
    two round q/k/p to bf16 at different points."""
    rng = np.random.default_rng(kv_len)
    b, s, h, d, eps = 1, 128, 2, 128, 1e-6
    qkv = rng.standard_normal((b, s, 3 * h * d)).astype(np.float32)
    tabs = _tables(rng, s, d)
    ref = np.asarray(jfa.flash_packed_attention(
        jnp.asarray(qkv, jnp.bfloat16), h, d, *tabs, eps, kv_len=kv_len,
        interpret=True).astype(jnp.float32))
    out = tfa.packed_window_attention(
        torch.from_numpy(qkv).to(torch.bfloat16), h, d,
        *map(torch.from_numpy, tabs), eps, kv_len)
    np.testing.assert_allclose(out.float().numpy(), ref, atol=2e-2, rtol=2e-2)


def test_k2_plain_matches_take_on_real_transitions():
    plan = build_dit_plan(DIT_3B, (2, 18, 32), 58)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, plan.seq_len, 40)).astype(np.float32)
    for key, idx in plan.transitions.items():
        out = tg.gather_rows(torch.from_numpy(x), tg.RowIndex(idx, "cpu"))
        np.testing.assert_array_equal(
            out.numpy(), np.asarray(jnp.take(jnp.asarray(x),
                                             jnp.asarray(idx), axis=-2)))


def test_wrappers_route_cpu_to_plain_and_refuse_other_devices():
    rng = np.random.default_rng(1)
    h, d, s = 2, 64, 128
    qkv = torch.from_numpy(rng.standard_normal((1, s, 3 * h * d))
                           .astype(np.float32))
    tabs = [torch.from_numpy(t) for t in _tables(rng, s, d)]
    n1, n2 = tfa.packed_window_attention.launches, tg.gather_rows.launches
    out = tfa.packed_window_attention(qkv, h, d, *tabs, 1e-5, 100)
    plain = tfa.packed_window_attention_plain(qkv, h, d, *tabs, 1e-5, 100)
    assert torch.equal(out, plain)
    tg.gather_rows(qkv, tg.RowIndex(np.arange(s)[::-1], "cpu"))
    # the counters count kernel launches only
    assert (tfa.packed_window_attention.launches,
            tg.gather_rows.launches) == (n1, n2)
    meta = qkv.to("meta")
    with pytest.raises(RuntimeError):
        tfa.packed_window_attention(meta, h, d, *tabs, 1e-5, 100)
    with pytest.raises(RuntimeError):
        tg.gather_rows(meta, tg.RowIndex(np.arange(s), "meta"))
    with pytest.raises(IndexError):
        tg.gather_rows(qkv, tg.RowIndex(np.array([0, s]), "cpu"))
    with pytest.raises(ValueError):
        tg.RowIndex(np.array([-1, 2]), "cpu")
