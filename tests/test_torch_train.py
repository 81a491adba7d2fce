"""The port's trainer (seedvr2_tpu_torch/parallel/train.py) and the gradients
of its kernels K1, K2 and K9 against the JAX package, on the CPU, on the
grouped and the uniform window plans.

The JAX side differentiates its jnp compositions (it has no backward
kernel); the port's autograd Functions run their plain backward versions
here. Inputs are seeded numpy, JAX's noise and timesteps are drawn from a
JAX key and handed to the port. Tolerances, with their reasons:

 - fp32 (the gradient math): 1e-5 relative L2 per tensor, the same
   arithmetic summed in other orders;
 - JAX's own bf16 train_step against the port's: 1e-2 relative on the
   losses and 3e-2 relative L2 over every Adam first moment after one step
   (both are 0.1 * grad): the two frameworks round the bf16 products and
   sums at other places (JAX's own bf16 gradients lie 0.73 % from its fp32
   ones overall on this config, 2.6 % on the worst leaf);
 - AdamW against optax.adamw on the same gradients: 1e-6 relative L2.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from seedvr2_tpu.core import diffusion as jdiff
from seedvr2_tpu.core import export as jexport
from seedvr2_tpu.core.configs import DiTConfig as JDiTConfig
from seedvr2_tpu.core.configs import DIT_3B as J_DIT_3B
from seedvr2_tpu.models.dit import nadit as jn
from seedvr2_tpu.ops import attention as jattn
from seedvr2_tpu.ops import gather as jgather
from seedvr2_tpu.parallel import mesh as jmesh
from seedvr2_tpu.parallel import train as jtrain
from seedvr2_tpu_torch.core import weights as tw
from seedvr2_tpu_torch.core.configs import DIT_3B, DiTConfig
from seedvr2_tpu_torch.core.diffusion import logitnormal_timesteps
from seedvr2_tpu_torch.core.loader import load_dit_checkpoint
from seedvr2_tpu_torch.models.dit import nadit as tn
from seedvr2_tpu_torch.ops import flash_attention as tfa
from seedvr2_tpu_torch.ops import gather as tgather
from seedvr2_tpu_torch.parallel import mesh as tmesh
from seedvr2_tpu_torch.parallel import train as ttrain

from .test_torch_dit import random_params

# tests/test_components.py's tiny config
TINY = dict(family="dit_3b", vid_in_channels=9, vid_out_channels=4,
            vid_dim=24, txt_in_dim=16, heads=2, head_dim=12,
            patch_size=(1, 2, 2), num_layers=2, mm_layers=1,
            mlp_type="swiglu", window=(2, 2, 2), rope_type="mmrope3d",
            rope_dim=12, vid_out_norm=True)
SHAPE, TXT_LEN, BATCH = (1, 4, 4), 5, 2
FP32_REL = 1e-5
BF16_LOSS_REL, BF16_MU_REL = 1e-2, 3e-2
ADAMW_REL = 1e-6


def rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _np(t):
    return t.detach().float().numpy()


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = JDiTConfig(**TINY), DiTConfig(**TINY)
    params = random_params(lambda k: jn.init_dit_params(
        k, jcfg, dtype=jnp.float32), 7)
    rng = np.random.default_rng(3)
    t, h, w = SHAPE
    batch = {
        "latent": rng.standard_normal((BATCH, t, h, w, 4), np.float32),
        "cond": rng.standard_normal((BATCH, t, h, w, 5), np.float32),
        "txt": rng.standard_normal((BATCH, TXT_LEN, 16), np.float32)}
    return jcfg, tcfg, params, batch


def port_model(tcfg, params):
    model = tn.NaDiT(tcfg, dtype=torch.float32)
    model.load_state_dict(tw.state_dict_from_jax(params), strict=True)
    return model


def tbatch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def jax_draws(key, batch, T=1000.0):
    """JAX's loss_fn draws from one step's key: (noise, t) as numpy."""
    k_noise, k_t = jax.random.split(key)
    x0 = batch["latent"]
    noise = jax.random.normal(k_noise, x0.shape, jnp.float32)
    t = jdiff.logitnormal_timesteps(k_t, (x0.shape[0],), T=T)
    return np.array(noise), np.array(t)


def grads_by_name(jgrads):
    """A JAX tree (gradients, moments) under the port's names and layouts
    (fp32)."""
    return {k: v.numpy() for k, v in tw.state_dict_from_jax(jgrads).items()}


# ------------------------------------------------------------ K1 and K2


def _k1_inputs(seed, b=3, s=16, h=2, d=12, kv=11):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, s, 3 * h * d)).astype(np.float32)
    ang = rng.standard_normal((4, s, d // 2))
    w = 1 + 0.2 * rng.standard_normal((4, s, d))
    tabs = [np.repeat(np.cos(ang[i]), 2, -1) * w[i] if i % 2 == 0
            else np.repeat(np.sin(ang[i]), 2, -1) * w[i] for i in range(4)]
    dout = rng.standard_normal((b, s, h * d)).astype(np.float32)
    dout[:, kv:] = 0.0  # the lane pad rows, which the caller discards
    return qkv, [t.astype(np.float32) for t in tabs], dout, (h, d, kv)


@pytest.mark.parametrize("kv", [11, 16])
def test_k1_backward_plain_matches_jax_vjp(kv):
    """d qkv and the four table gradients of the plain backward against
    jax.vjp of packed_attention's jnp branch, fp32, kv_len < S and = S."""
    qkv, tabs, dout, (h, d, _) = _k1_inputs(kv, kv=kv)
    eps = 1e-5

    def f(x, cq, sq, ck, sk):
        return jattn.packed_attention(x, h, d, cq, sq, ck, sk, eps, kv)

    out, vjp = jax.vjp(f, jnp.asarray(qkv), *map(jnp.asarray, tabs))
    ref = vjp(jnp.asarray(dout))
    t_qkv = torch.from_numpy(qkv)
    t_tabs = [torch.from_numpy(t) for t in tabs]
    t_out = tfa.packed_window_attention_plain(t_qkv, h, d, *t_tabs, eps, kv)
    np.testing.assert_allclose(_np(t_out), np.asarray(out), rtol=1e-5,
                               atol=1e-6)
    got = tfa.packed_window_attention_backward_plain(
        t_qkv, h, d, *t_tabs, eps, kv, t_out, torch.from_numpy(dout))
    assert len(got) == 5
    for name, g, r in zip(("qkv", "cos_q", "sin_q", "cos_k", "sin_k"), got,
                          ref):
        assert rel_l2(_np(g), r) <= FP32_REL, name
    if kv < 16:  # every row at or past kv_len gets zero gradient
        assert not got[0][:, kv:].any()
        assert all(not t[kv:].any() for t in got[1:])


def _jax_scores(qkv, tabs, h, d, eps, kv):
    """The JAX composition's scores (ops/attention.py packed_attention's jnp
    branch: its fp32 RMS norm and rope, then q k^T * d**-0.5), keys at or
    past kv_len at -inf: (B, H, S, S)."""
    from seedvr2_tpu.models.dit.rope import rotate_half_full

    b, s, _ = qkv.shape
    x = jnp.asarray(qkv).reshape(b, s, 3, h, d)

    def norm_rope(z, cos, sin):
        z = z * jax.lax.rsqrt(jnp.mean(z * z, axis=-1, keepdims=True) + eps)
        return (z * jnp.asarray(cos)[:, None, :]
                + rotate_half_full(z) * jnp.asarray(sin)[:, None, :])

    q = norm_rope(x[:, :, 0], tabs[0], tabs[1])
    k = norm_rope(x[:, :, 1], tabs[2], tabs[3])
    sc = jnp.einsum("bqhd,bkhd->bhqk", q, k) * d ** -0.5
    return jnp.where(jnp.arange(s) < kv, sc, -jnp.inf)


@pytest.mark.parametrize("kv", [11, 16])
def test_k1_lse_plain_matches_jax_logsumexp(kv):
    """The plain version of K1's training launch: its output is K1's, its
    lse each row's jax.nn.logsumexp of the JAX composition's scores over
    the keys below kv_len, in the log2 domain (times log2e), fp32."""
    qkv, tabs, _, (h, d, _) = _k1_inputs(kv + 40, kv=kv)
    t_qkv = torch.from_numpy(qkv)
    t_tabs = [torch.from_numpy(t) for t in tabs]
    out, lse = tfa.packed_window_attention_lse_plain(t_qkv, h, d, *t_tabs,
                                                     1e-5, kv)
    assert lse.dtype == torch.float32 and lse.shape == (3, h, 16)
    assert torch.equal(out, tfa.packed_window_attention_plain(
        t_qkv, h, d, *t_tabs, 1e-5, kv))
    ref = jax.nn.logsumexp(_jax_scores(qkv, tabs, h, d, 1e-5, kv), axis=-1)
    assert rel_l2(_np(lse), np.asarray(ref) * tfa._LOG2E) <= FP32_REL


@pytest.mark.parametrize("kv", [11, 16])
def test_k1_dq_plain_from_the_forward_lse_as_before(kv):
    """attention_backward_dq_plain fed the forward's lse gives the dq and
    delta of the earlier form, which swept the keys for the rows' lse
    itself (re-formed here), within fp32 summation order; that lse and the
    forward's agree."""
    qkv, tabs, dout, (h, d, _) = _k1_inputs(kv + 20, kv=kv)
    t_qkv = torch.from_numpy(qkv)
    t_tabs = [torch.from_numpy(t) for t in tabs]
    out, lse = tfa.packed_window_attention_lse_plain(t_qkv, h, d, *t_tabs,
                                                     1e-5, kv)
    x = t_qkv.reshape(3, 16, 3, h, d)
    qh = tfa.norm_rope_plain(x[:, :, 0], t_tabs[0], t_tabs[1], 1e-5,
                             d ** -0.5 * tfa._LOG2E)
    kh = tfa.norm_rope_plain(x[:, :, 1], t_tabs[2], t_tabs[3], 1e-5)
    v, g = x[:, :, 2], torch.from_numpy(dout)
    dq, delta = tfa.attention_backward_dq_plain(qh, kh, v, out, g, lse, kv)
    # the earlier form: its own lse sweep, then P, dS and dq
    sc = torch.einsum("bqhd,bkhd->bhqk", qh, kh)
    sc[..., kv:] = float("-inf")
    m = sc.amax(dim=-1, keepdim=True)
    own = m + torch.log2(torch.exp2(sc - m).sum(dim=-1, keepdim=True))
    do = g.reshape(3, 16, h, d).clone()
    do[:, kv:] = 0.0
    ref_delta = (do * out.reshape(3, 16, h, d)).sum(-1).transpose(1, 2)
    ds = torch.exp2(sc - own) * (torch.einsum("bqhd,bkhd->bhqk", do, v)
                                 - ref_delta[..., None])
    ref = torch.einsum("bhqk,bkhd->bqhd", ds, kh)
    assert rel_l2(_np(own[..., 0]), _np(lse)) <= FP32_REL
    assert rel_l2(_np(dq), _np(ref)) <= FP32_REL
    assert rel_l2(_np(delta), _np(ref_delta)) <= FP32_REL


def _bwd_groups(case):
    """(B, S, H, kv_len) of every K1 call of a case: each window group of
    the training plan (the 3B at 1 x 64 x 64, batch 2), the record shape,
    the 1080p clip plan's largest group (n = 32), and the 7B's 24 heads on
    the training plan and the record shape."""
    if case == "record":
        return [(12, 512, 20, 463)]
    if case == "heads24":
        return [(12, 512, 24, 463)] + [(b, s, 24, kv) for b, s, _, kv in
                                       _bwd_groups("train")]
    latent, batch = {"train": ((1, 64, 64), 2),
                     "clip1080": ((2, 136, 240), 1)}[case]
    plan = tn.build_dit_plan(DIT_3B, latent, 58)
    out = []
    for lp in plan.layer_plans.values():
        for g in lp.groups:
            n, wlen = g.idx.shape
            skv = wlen + 58
            out.append((batch * n, skv + (-skv) % tn._LANE, DIT_3B.heads,
                        skv))
    if case == "clip1080":
        out = [max(out, key=lambda c: c[0] * c[1] ** 2)]
    return out


@pytest.mark.parametrize("case", ["train", "record", "clip1080", "heads24"])
def test_k1_backward_plan_covers_every_row_once(case):
    """The dq and dk/dv kernels' tile plan: per (b, h) the dq blocks of wg
    warpgroups of 64 rows cover each of the S q rows exactly once, the
    dk/dv blocks each key row and column panel exactly once, no block lies
    wholly past S (the kernels' entry refuses such a grid), and the small
    training groups (B = 2, S = 128)
    take one warpgroup a block, so that their live rows spread over more
    blocks than 128-row blocks would give."""
    groups = _bwd_groups(case)
    assert len(groups) == {"train": 13, "record": 1, "clip1080": 1,
                           "heads24": 14}[case]
    for b, s, h, kv in groups:
        wg, blocks, kv_blocks = tfa.backward_plan(b, s, h, kv)
        assert wg in (1, 2) and (blocks - 1) * wg * 64 < s
        assert (kv_blocks - 1) * 64 < s
        # dq: block x's warpgroup w owns q rows 64 (x wg + w) .. + 63
        seen = np.zeros(s, np.int64)
        for x in range(blocks):
            for w in range(wg):
                r0 = 64 * (x * wg + w)
                seen[r0:r0 + 64] += 1
        assert (seen == 1).all(), (b, s, h, kv)
        # dk/dv: block x owns keys 64 x .. + 63, its warpgroups split D
        # into 64-column panels
        seen = np.zeros((s, 2), np.int64)
        for x in range(kv_blocks):
            for w in range(128 // 64):
                seen[64 * x:64 * x + 64, w] += 1
        assert (seen == 1).all(), (b, s, h, kv)
        if b * h * -(-kv // 128) < tfa.H100_SMS:
            assert wg == 1
        if (b, s) == (12, 512) or b == 32:
            assert wg == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_function_matches_autograd_through_plain(dtype):
    """The autograd Function (forward: K1's plain version, backward: the
    plain backward) against torch autograd through the plain forward:
    within 1e-5 in fp32; in bf16 within a bf16-class 2e-2 (the backward
    keeps q-hat and k-hat in fp32, the forward rounds q and k)."""
    qkv, tabs, dout, (h, d, kv) = _k1_inputs(5)
    tol = FP32_REL if dtype == torch.float32 else 2e-2

    def leaves():
        return [torch.from_numpy(qkv).to(dtype).requires_grad_()] + [
            torch.from_numpy(t).requires_grad_() for t in tabs]

    ref_in, fn_in = leaves(), leaves()
    g_out = torch.from_numpy(dout).to(dtype)
    ref = torch.autograd.grad(tfa.packed_window_attention_plain(
        ref_in[0], h, d, *ref_in[1:], 1e-5, kv), ref_in, g_out)
    out = tfa.packed_window_attention_grad(fn_in[0], h, d, *fn_in[1:], 1e-5,
                                           kv)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, fn_in, g_out)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and rel_l2(_np(g), _np(r)) <= tol


def _k9_inputs(seed, b=3, s=140, h=2, d=16):
    """K9's operands (q, k, v, cos, sin, ids, valid, cotangent) as numpy:
    window id 0 has pad slots first (its first key tile partly valid) and a
    64-key tile of no valid key (keys 64-127), id 1 pad slots in the
    middle; the pad query rows, which the DiT crops, get zero cotangent."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((b, s, h, d)).astype(np.float32)
                  for _ in range(4))
    ang = rng.standard_normal((2, s, d // 2))
    cos = np.repeat(np.cos(ang), 2, -1).astype(np.float32)
    sin = np.repeat(np.sin(ang), 2, -1).astype(np.float32)
    valid = np.ones((2, s), bool)
    valid[0, :10] = False
    valid[0, 64:128] = False
    valid[1, 100:120] = False
    ids = np.array([0, 1, 0], np.int32)
    g[~valid[ids]] = 0.0
    return q, k, v, cos, sin, ids, valid, g


def _k9_torch(q, k, v, cos, sin, ids, valid, grad=False):
    """The port's K9 arguments after (q, k, v)'s scale: (q, k, v), (None,
    cos, sin, RowIndex, valid)."""
    qkv = [torch.from_numpy(x).requires_grad_(grad) for x in (q, k, v)]
    return qkv, (None, torch.from_numpy(cos), torch.from_numpy(sin),
                 tgather.RowIndex(ids, "cpu"), torch.from_numpy(valid))


def test_k9_function_matches_jax_vjp():
    """K9's autograd Function on the CPU (its training launch's and its
    backward's plain versions) against jax.vjp of JAX's attention with
    table_ids and kv_valid (use_flash False), fp32: output and dq, dk, dv
    within 1e-5; masked keys get no dk / dv."""
    q, k, v, cos, sin, ids, valid, g = _k9_inputs(21)

    def f(q, k, v):
        return jattn.attention(q, k, v, use_flash=False, rope_cos=cos,
                               rope_sin=sin, table_ids=ids, kv_valid=valid)

    out, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(g))
    leaves, args = _k9_torch(q, k, v, cos, sin, ids, valid, grad=True)
    t_out = tfa.flash_windowed_attention_grad(*leaves, *args)
    assert t_out.grad_fn is not None
    np.testing.assert_allclose(_np(t_out), np.asarray(out), rtol=1e-5,
                               atol=1e-6)
    got = torch.autograd.grad(t_out, leaves, torch.from_numpy(g))
    for name, a, r in zip("qkv", got, ref):
        assert rel_l2(_np(a), r) <= FP32_REL, name
    masked = ~valid[ids]
    assert not _np(got[1])[masked].any() and not _np(got[2])[masked].any()


def test_k9_lse_plain_matches_jax_logsumexp():
    """The plain version of K9's training launch: its output is K9's, its
    lse each row's jax.nn.logsumexp of JAX's masked scores (apply_rope_ext
    by the window's table, q k^T * d**-0.5, invalid keys at -inf), in the
    log2 domain (times log2e), fp32."""
    from seedvr2_tpu.models.dit.rope import apply_rope_ext

    q, k, v, cos, sin, ids, valid, _ = _k9_inputs(22)
    (tq, tk, tv), args = _k9_torch(q, k, v, cos, sin, ids, valid)
    out, lse = tfa.flash_windowed_attention_lse_plain(tq, tk, tv, *args)
    assert lse.dtype == torch.float32 and lse.shape == (3, 2, 140)
    assert torch.equal(out, tfa.flash_windowed_attention_plain(tq, tk, tv,
                                                               *args))
    jq = apply_rope_ext(jnp.asarray(q), cos[ids], sin[ids])
    jk = apply_rope_ext(jnp.asarray(k), cos[ids], sin[ids])
    sc = jnp.einsum("bqhd,bkhd->bhqk", jq, jk) * 16 ** -0.5
    sc = jnp.where(jnp.asarray(valid[ids])[:, None, None, :], sc, -jnp.inf)
    ref = jax.nn.logsumexp(sc, axis=-1)
    assert rel_l2(_np(lse), np.asarray(ref) * tfa._LOG2E) <= FP32_REL


def test_k9_backward_parts_compose_to_the_whole():
    """K9's three backward parts as the card runs them (the pre-pass's q-hat
    / k-hat, the forward's lse, dq and delta, dk and dv through their CPU
    routes, the rope backward by window id in fp32) against the whole
    plain backward, fp32 within 1e-5; a key tile of no valid key and every
    masked key get zero dk / dv."""
    q, k, v, cos, sin, ids, valid, g = _k9_inputs(23)
    (tq, tk, tv), (_, tc, ts, index, tvalid) = _k9_torch(q, k, v, cos, sin,
                                                         ids, valid)
    tg = torch.from_numpy(g)
    out, lse = tfa.flash_windowed_attention_lse(tq, tk, tv, None, tc, ts,
                                                index, tvalid)
    qh, kh = tfa.attention_prepass(tq, tk, tc, ts, tc, ts, None,
                                   16 ** -0.5 * tfa._LOG2E, index)
    dq, delta = tfa.windowed_backward_dq(qh, kh, tv, out, tg, lse, tvalid,
                                         index)
    dk, dv = tfa.windowed_backward_dkdv(qh, kh, tv, tg, lse, delta, tvalid,
                                        index)
    assert not dk[:, 64:128][0].any() and not dv[0, 64:128].any()
    dqr, dkr = tfa.windowed_rope_backward_plain(dq, dk, tc, ts, index,
                                                16 ** -0.5, tfa._LN2,
                                                torch.float32)
    whole = tfa.flash_windowed_attention_backward(tq, tk, tv, None, tc, ts,
                                                  index, tvalid, out, tg,
                                                  lse)
    for name, a, r in zip("qkv", (dqr, dkr, dv), whole):
        assert rel_l2(_np(a), _np(r)) <= FP32_REL, name
    masked = ~valid[ids]
    assert not _np(dkr)[masked].any() and not _np(dv)[masked].any()


def test_kernel_wrappers_refuse_grad_inputs():
    """A raw kernel wrapper handed an input that needs a gradient while
    grad mode is on raises, on every device; under no_grad it serves. K9's
    grad entry refuses tables that need a gradient (they are the plan's
    constants)."""
    qkv, tabs, _, (h, d, kv) = _k1_inputs(1)
    x = torch.from_numpy(qkv).requires_grad_()
    t_tabs = [torch.from_numpy(t) for t in tabs]
    with pytest.raises(RuntimeError, match="needs a gradient"):
        tfa.packed_window_attention(x, h, d, *t_tabs, 1e-5, kv)
    q = x.reshape(3, 16, 3, h, d)[:, :, 0]
    with pytest.raises(RuntimeError, match="needs a gradient"):
        tfa.attention_prepass(q, q, *t_tabs, 1e-5)
    index = tgather.RowIndex(np.arange(16)[::-1].copy(), "cpu")
    with pytest.raises(RuntimeError, match="needs a gradient"):
        tgather.gather_rows(x, index)
    (tq, tk, tv), args = _k9_torch(*_k9_inputs(2)[:7], grad=True)
    for fn in (tfa.flash_windowed_attention,
               tfa.flash_windowed_attention_lse):
        with pytest.raises(RuntimeError, match="needs a gradient"):
            fn(tq, tk, tv, *args)
    tables = [t.clone().requires_grad_() for t in args[1:3]]
    with pytest.raises(RuntimeError, match="plan's constants"):
        tfa.flash_windowed_attention_grad(tq, tk, tv, None, *tables,
                                          *args[3:])
    with torch.no_grad():
        tfa.packed_window_attention(x, h, d, *t_tabs, 1e-5, kv)
        tgather.gather_rows(x, index)
        tfa.flash_windowed_attention(tq, tk, tv, *args)


def test_k2_gradient_matches_jax_vjp_bit_equal():
    """The gather's gradient (K2 on the inverse index) equals jax.vjp of
    JAX's gather_rows bit for bit, on every transition of a real plan; each
    transition's inverse is the opposite transition."""
    cfg = DiTConfig(**TINY)
    plan = tn.build_dit_plan(cfg, (3, 8, 10), TXT_LEN)
    rng = np.random.default_rng(0)
    for (a, b), idx in plan.transitions.items():
        index = tgather.RowIndex(idx, "cpu")
        np.testing.assert_array_equal(index.inverse.numpy,
                                      plan.transitions[(b, a)])
        x = rng.standard_normal((2, len(idx), 6)).astype(np.float32)
        g = rng.standard_normal((2, len(idx), 6)).astype(np.float32)
        _, vjp = jax.vjp(lambda v: jgather.gather_rows(v, idx),
                         jnp.asarray(x))
        ref = np.asarray(vjp(jnp.asarray(g))[0])
        tx = torch.from_numpy(x).requires_grad_()
        out = tgather.gather_rows_grad(tx, index)
        (got,) = torch.autograd.grad(out, tx, torch.from_numpy(g))
        np.testing.assert_array_equal(got.numpy(), ref)


def test_k2_backward_refuses_a_non_permutation():
    index = tgather.RowIndex(np.array([0, 2, 2, 1]), "cpu")
    with pytest.raises(ValueError, match="not a permutation"):
        index.inverse
    x = torch.zeros(1, 4, 3, requires_grad=True)
    out = tgather.gather_rows_grad(x, index)
    with pytest.raises(ValueError, match="not a permutation"):
        out.sum().backward()
    short = tgather.RowIndex(np.array([1, 0]), "cpu")
    out = tgather.gather_rows_grad(x, short)
    with pytest.raises(ValueError, match="no permutation"):
        out.sum().backward()


# ------------------------------------------------------------- the loss


def test_logitnormal_timesteps():
    g = torch.Generator().manual_seed(0)
    t = logitnormal_timesteps(g, (4096,), T=1000.0)
    assert t.dtype == torch.float32 and t.shape == (4096,)
    assert 0 < float(t.min()) and float(t.max()) < 1000.0
    # sigmoid(N(0, 1)) has median 0.5; loc shifts it
    assert abs(float(t.median()) - 500.0) < 25.0
    g = torch.Generator().manual_seed(0)
    z = torch.randn((4,), generator=g)
    g = torch.Generator().manual_seed(0)
    np.testing.assert_allclose(
        logitnormal_timesteps(g, (4,), 10.0, 0.5, 2.0).numpy(),
        (torch.sigmoid(z * 2.0 + 0.5) * 10.0).numpy(), rtol=1e-6)


PLANS = pytest.mark.parametrize("uniform", [False, True],
                                ids=["grouped", "uniform"])


@PLANS
def test_flow_loss_and_every_gradient_match_jax_fp32(setup, uniform):
    """The fp32 loss and every parameter's gradient against
    jax.value_and_grad of the same loss from JAX's nadit_forward,
    LerpSchedule and logitnormal_timesteps (noise and t from a JAX key),
    on the grouped and on the uniform window plan (K9 and its gradient; a
    900-slot window of 4 video tokens: pad keys and pad query rows):
    within 1e-5 per leaf."""
    jcfg, tcfg, params, batch = setup
    noise, t = jax_draws(jax.random.PRNGKey(11), batch)
    plan = jn.build_dit_plan(jcfg, SHAPE, TXT_LEN, uniform=uniform)
    sched = jdiff.LerpSchedule(1000.0)

    def loss(p):
        x0 = jnp.asarray(batch["latent"])
        x_t = sched.forward(x0, noise, jnp.asarray(t)[:, None, None, None,
                                                         None])
        vid_in = jnp.concatenate([x_t, jnp.asarray(batch["cond"])], -1)
        pred = jn.nadit_forward(p, jcfg, vid_in, jnp.asarray(batch["txt"]),
                                jnp.asarray(t), plan)
        return jnp.mean((pred - (noise - x0)) ** 2)

    j_loss, j_grads = jax.jit(jax.value_and_grad(loss))(params)
    model = port_model(tcfg, params)
    t_loss = ttrain.flow_loss(model, tbatch(batch), torch.from_numpy(noise),
                              torch.from_numpy(t),
                              tn.build_dit_plan(tcfg, SHAPE, TXT_LEN,
                                                uniform=uniform),
                              dtype=torch.float32)
    t_loss.backward()
    assert abs(t_loss.item() - float(j_loss)) <= FP32_REL * float(j_loss)
    ref = grads_by_name(j_grads)
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(ref)
    bad = {k: rel_l2(_np(got[k]), ref[k]) for k in ref
           if got[k] is None or rel_l2(_np(got[k]), ref[k]) > FP32_REL}
    assert not bad, bad


@pytest.mark.parametrize("family", ["dit_3b", "dit_7b"])
def test_unreached_parameters_step_on_jax_zero_gradient(family):
    """A last block with its own text weights (the 3B cut to its
    mm_layers, the 7B): what only its discarded text output feeds gets no
    gradient in the port and exactly zero in JAX; train_step takes those
    (unreached_by_design) as zero and every other gradient as JAX's, in
    fp32 within 1e-5 per leaf."""
    if family == "dit_3b":
        kw = dict(TINY, mm_layers=TINY["num_layers"])
        jcfg, tcfg = JDiTConfig(**kw), DiTConfig(**kw)
    else:
        from seedvr2_tpu.core.configs import small_test_config as j_small

        from seedvr2_tpu_torch.core.configs import small_test_config

        jcfg = j_small(family="dit_7b")
        tcfg = small_test_config(family="dit_7b")
    params = random_params(lambda k: jn.init_dit_params(
        k, jcfg, dtype=jnp.float32), 9)
    rng = np.random.default_rng(4)
    out = tcfg.vid_out_channels
    batch = {
        "latent": rng.standard_normal((BATCH, *SHAPE, out), np.float32),
        "cond": rng.standard_normal(
            (BATCH, *SHAPE, tcfg.vid_in_channels - out), np.float32),
        "txt": rng.standard_normal((BATCH, TXT_LEN, tcfg.txt_in_dim),
                                   np.float32)}
    noise, t = jax_draws(jax.random.PRNGKey(12), batch)
    plan = jn.build_dit_plan(jcfg, SHAPE, TXT_LEN)
    sched = jdiff.LerpSchedule(1000.0)

    def loss(p):
        x0 = jnp.asarray(batch["latent"])
        x_t = sched.forward(x0, noise, jnp.asarray(t)[:, None, None, None,
                                                         None])
        vid_in = jnp.concatenate([x_t, jnp.asarray(batch["cond"])], -1)
        pred = jn.nadit_forward(p, jcfg, vid_in, jnp.asarray(batch["txt"]),
                                jnp.asarray(t), plan)
        return jnp.mean((pred - (noise - x0)) ** 2)

    ref = grads_by_name(jax.jit(jax.grad(loss))(params))
    model = port_model(tcfg, params)
    ttrain.flow_loss(model, tbatch(batch), torch.from_numpy(noise),
                     torch.from_numpy(t), tn.build_dit_plan(tcfg, SHAPE,
                                                            TXT_LEN),
                     dtype=torch.float32).backward()
    none = {k for k, p in model.named_parameters() if p.grad is None}
    assert none and all(ttrain.unreached_by_design(tcfg, k) for k in none)
    # the text queries' norm weight reaches only the text output too: a
    # gradient of zeros on both sides (the port's from K1's table gradients)
    zero = {k for k, p in model.named_parameters()
            if p.grad is None or not p.grad.any()}
    assert {k for k, g in ref.items() if not g.any()} == zero
    init_state, step = ttrain.make_train_step(
        tcfg, tn.build_dit_plan(tcfg, SHAPE, TXT_LEN), device="cpu",
        dtype=torch.float32)
    state, _ = step(init_state(port_model(tcfg, params)), tbatch(batch),
                    noise=torch.from_numpy(noise), t=torch.from_numpy(t))
    mu = {k: _np(v) / (1.0 - ttrain.B1) for k, v in
          state.opt_state["mu"].items()}
    bad = {k: rel_l2(mu[k], ref[k]) for k in ref if k not in none
           and rel_l2(mu[k], ref[k]) > FP32_REL}
    assert not bad, bad
    assert all(not mu[k].any() for k in zero)


def test_uniform_plan_gradients_match_grouped_fp32(setup):
    """The port's two plans compute one function: the fp32 loss and every
    gradient on the uniform plan (K9's Function) against the grouped plan
    (K1's and K2's) on the same parameters and draws, within 1e-5 per
    leaf (the same products summed over other windows' layouts)."""
    _, tcfg, params, batch = setup
    noise, t = jax_draws(jax.random.PRNGKey(13), batch)
    losses, grads = [], []
    for uniform in (False, True):
        model = port_model(tcfg, params)
        loss = ttrain.flow_loss(model, tbatch(batch), torch.from_numpy(noise),
                                torch.from_numpy(t),
                                tn.build_dit_plan(tcfg, SHAPE, TXT_LEN,
                                                  uniform=uniform),
                                dtype=torch.float32)
        loss.backward()
        losses.append(loss.item())
        grads.append({k: p.grad for k, p in model.named_parameters()})
    assert abs(losses[1] - losses[0]) <= FP32_REL * losses[0]
    assert {k for k, g in grads[0].items() if g is None} == {
        k for k, g in grads[1].items() if g is None}
    bad = {k: rel_l2(_np(grads[1][k]), _np(g)) for k, g in grads[0].items()
           if g is not None and rel_l2(_np(grads[1][k]), _np(g)) > FP32_REL}
    assert not bad, bad


def test_training_path_refusals(setup):
    """A quantised tree and fp16 weights are refused; both window plans
    are taken."""
    _, tcfg, params, batch = setup
    model = port_model(tcfg, params)
    args = (tbatch(batch), torch.zeros(BATCH, *SHAPE, 4),
            torch.full((BATCH,), 500.0))
    ttrain.make_train_step(tcfg, tn.build_dit_plan(
        tcfg, SHAPE, TXT_LEN, uniform=True), device="cpu")
    from seedvr2_tpu_torch.ops.quant_matmul import quantize_dit_q8

    quantize_dit_q8(model, 8)
    with pytest.raises(ValueError, match="quantised serving linear"):
        ttrain.flow_loss(model, *args, tn.build_dit_plan(tcfg, SHAPE,
                                                         TXT_LEN))
    half = port_model(tcfg, params).half()
    with pytest.raises(ValueError, match="only bf16 / fp32"):
        ttrain.flow_loss(half, *args, tn.build_dit_plan(tcfg, SHAPE,
                                                        TXT_LEN))


def test_train_step_raises_on_a_cut_graph(setup, monkeypatch):
    """A K1 output without autograd history (a raw kernel call on the
    training path) leaves the parameters upstream of it without a gradient:
    train_step raises instead of stepping them on weight decay alone."""
    _, tcfg, params, batch = setup
    plain = tn.packed_window_attention_plain
    monkeypatch.setattr(tn, "packed_window_attention_grad",
                        lambda qkv, *a, **kw: plain(qkv.detach(), *a, **kw))
    init_state, step = ttrain.make_train_step(
        tcfg, tn.build_dit_plan(tcfg, SHAPE, TXT_LEN), device="cpu",
        dtype=torch.float32)
    state = init_state(port_model(tcfg, params))
    before = {k: v.clone() for k, v in state.params.items()}
    with pytest.raises(RuntimeError, match="no gradient for .*proj_qkv"):
        step(state, tbatch(batch), noise=torch.zeros(BATCH, *SHAPE, 4),
             t=torch.full((BATCH,), 500.0))
    assert state.step == 0
    assert all(torch.equal(before[k], v) for k, v in state.params.items())


# ---------------------------------------------------------------- steps


def _jax_steps(jcfg, params, batch, n, keys, uniform=False):
    """n steps of JAX's real make_train_step (bf16, optax) on a one-device
    mesh, on the grouped or the uniform window plan: (states after each
    step, losses)."""
    plan = jn.build_dit_plan(jcfg, SHAPE, TXT_LEN, uniform=uniform)
    mesh = jmesh.make_mesh(1)
    with mesh:
        init_state, step = jtrain.make_train_step(jcfg, plan, mesh)
        state = init_state(params)
        states, losses = [], []
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        for i in range(n):
            state, loss = step(state, jb, keys[i])
            states.append(jax.device_get(state))
            losses.append(float(loss))
    return states, losses


@pytest.fixture(scope="module")
def jax_runs(setup):
    """Three steps of JAX's train_step from the setup's parameters on
    either plan, each run once: run(uniform) -> (keys, states after each
    step, losses)."""
    jcfg, _, params, batch = setup
    keys = [jax.random.PRNGKey(100 + i) for i in range(3)]
    runs = {}

    def run(uniform):
        if uniform not in runs:
            runs[uniform] = (keys, *_jax_steps(jcfg, params, batch, 3, keys,
                                               uniform))
        return runs[uniform]

    return run


@pytest.fixture(scope="module")
def jax_run(jax_runs):
    """The grouped plan's run of jax_runs."""
    return jax_runs(False)


def _port_steps(tcfg, state_or_model, batch, draws, dtype=torch.bfloat16,
                uniform=False, attention_mode="flash"):
    init_state, step = ttrain.make_train_step(
        tcfg, tn.build_dit_plan(tcfg, SHAPE, TXT_LEN, uniform=uniform),
        device="cpu", dtype=dtype, attention_mode=attention_mode)
    state = init_state(state_or_model)
    losses, mus = [], []
    for noise, t in draws:
        state, loss = step(state, tbatch(batch),
                           noise=torch.from_numpy(noise),
                           t=torch.from_numpy(t))
        losses.append(loss.item())
        mus.append({k: v.clone() for k, v in state.opt_state["mu"].items()})
    return state, losses, mus


@PLANS
def test_three_steps_against_jax_train_step(setup, jax_runs, uniform):
    """Three steps of JAX's own bf16 train_step and the port's, fed the
    same draws, on the grouped and on the uniform window plan: losses
    within 1e-2, the first moment after step 1 (0.1 * grad on both sides)
    within 3e-2 relative L2 overall, steps equal."""
    _, tcfg, params, batch = setup
    keys, j_states, j_losses = jax_runs(uniform)
    draws = [jax_draws(k, batch) for k in keys]
    state, losses, mus = _port_steps(tcfg, port_model(tcfg, params), batch,
                                     draws, uniform=uniform)
    for got, ref in zip(losses, j_losses):
        assert abs(got - ref) <= BF16_LOSS_REL * abs(ref), (losses, j_losses)
    ref_mu = grads_by_name(j_states[0].opt_state[0].mu)
    names = sorted(ref_mu)
    got = np.concatenate([mus[0][k].numpy().ravel() for k in names])
    ref = np.concatenate([ref_mu[k].ravel() for k in names])
    assert rel_l2(got, ref) <= BF16_MU_REL
    assert state.step == int(j_states[-1].step) == 3


class _JnpFp32:
    """jax.numpy with bfloat16 read as float32: JAX's make_train_step, whose
    loss_fn casts the DiT's inputs to jnp.bfloat16, then computes in fp32
    on fp32 parameters."""

    def __getattr__(self, name):
        return jnp.float32 if name == "bfloat16" else getattr(jnp, name)


@PLANS
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_xla_mode_steps_against_jax_xla_train_step(setup, monkeypatch,
                                                   uniform, dtype):
    """Training under the "xla" attention mode (the SDPA lane, which
    autograd carries; K2's Function still on the grouped plan): three
    steps of the port's make_train_step(..., attention_mode="xla") against
    JAX's make_train_step traced after set_attention_mode("xla") ("flash"
    restored after), fed the same draws, on both plans. fp32 (JAX's step
    with its bf16 input cast read as fp32): losses, every leaf's first
    moment after step 1 (0.1 * grad) and every parameter after step 3
    within FP32_REL. bf16: as test_three_steps_against_jax_train_step.
    On the CPU JAX's "xla" and "flash" modes both run its jnp composition.
    No window of these plans is empty (each holds the text keys and at
    least one video token), so the NaN that JAX's attention_xla gives a
    row with no key to attend, and the port's SDPA lane copies, does not
    arise in training."""
    jcfg, tcfg, params, batch = setup
    plan = tn.build_dit_plan(tcfg, SHAPE, TXT_LEN, uniform=True)
    assert all(u.valid.any(axis=-1).all() for u in plan.uniform.values())
    if dtype == "fp32":
        monkeypatch.setattr(jtrain, "jnp", _JnpFp32())
    keys = [jax.random.PRNGKey(200 + i) for i in range(3)]
    jattn.set_attention_mode("xla")
    try:
        j_states, j_losses = _jax_steps(jcfg, params, batch, 3, keys,
                                        uniform)
    finally:
        jattn.set_attention_mode("flash")
    draws = [jax_draws(k, batch) for k in keys]
    t_dtype = torch.float32 if dtype == "fp32" else torch.bfloat16
    state, losses, mus = _port_steps(tcfg, port_model(tcfg, params), batch,
                                     draws, t_dtype, uniform, "sdpa")
    assert state.step == int(j_states[-1].step) == 3
    ref_mu = grads_by_name(j_states[0].opt_state[0].mu)
    if dtype == "bf16":
        for got, ref in zip(losses, j_losses):
            assert abs(got - ref) <= BF16_LOSS_REL * abs(ref)
        names = sorted(ref_mu)
        got = np.concatenate([mus[0][k].numpy().ravel() for k in names])
        ref = np.concatenate([ref_mu[k].ravel() for k in names])
        assert rel_l2(got, ref) <= BF16_MU_REL
        return
    for got, ref in zip(losses, j_losses):
        assert abs(got - ref) <= FP32_REL * abs(ref), (losses, j_losses)
    bad = {k: rel_l2(_np(mus[0][k]), r) for k, r in ref_mu.items()
           if rel_l2(_np(mus[0][k]), r) > FP32_REL}
    assert not bad, bad
    ref_p = grads_by_name(j_states[-1].params)
    bad = {k: rel_l2(_np(state.params[k]), r) for k, r in ref_p.items()
           if rel_l2(_np(state.params[k]), r) > FP32_REL}
    assert not bad, bad


def test_adamw_matches_optax():
    """adamw_ against optax.adamw(lr, weight_decay=0.01) on the same
    gradients, three steps: within 1e-6."""
    rng = np.random.default_rng(2)
    p0 = rng.standard_normal((7, 5)).astype(np.float32)
    grads = [rng.standard_normal((7, 5)).astype(np.float32) * 10 ** -i
             for i in range(3)]
    tx = optax.adamw(3e-3, weight_decay=0.01)
    jp = jnp.asarray(p0)
    opt = tx.init(jp)
    p, mu, nu = (torch.from_numpy(p0.copy()), torch.zeros(7, 5),
                 torch.zeros(7, 5))
    for i, g in enumerate(grads):
        upd, opt = tx.update(jnp.asarray(g), opt, jp)
        jp = optax.apply_updates(jp, upd)
        ttrain.adamw_(p, mu, nu, torch.from_numpy(g), i + 1, 3e-3)
        assert rel_l2(p.numpy(), np.asarray(jp)) <= ADAMW_REL
        assert rel_l2(mu.numpy(), np.asarray(opt[0].mu)) <= ADAMW_REL
        assert rel_l2(nu.numpy(), np.asarray(opt[0].nu)) <= ADAMW_REL


def test_carried_across_state_continues_as_jax(setup, jax_run):
    """Two JAX steps, the state carried across by train_state_from_jax,
    then one more step on each side: the loss within 1e-2 and the
    parameters within bf16-class 3e-2 relative L2 of JAX's."""
    _, tcfg, _, batch = setup
    keys, j_states, j_losses = jax_run
    carried = tw.train_state_from_jax(j_states[1])
    assert carried.step == 2 and set(carried.params) == set(
        carried.opt_state["mu"])
    state, losses, _ = _port_steps(tcfg, carried, batch,
                                   [jax_draws(keys[2], batch)])
    assert abs(losses[0] - j_losses[2]) <= BF16_LOSS_REL * abs(j_losses[2])
    ref = {k: v.numpy() for k, v in tw.state_dict_from_jax(
        j_states[2].params).items()}
    names = sorted(ref)
    got = np.concatenate([state.params[k].numpy().ravel() for k in names])
    want = np.concatenate([ref[k].ravel() for k in names])
    assert rel_l2(got, want) <= BF16_MU_REL
    assert state.step == 3
    with pytest.raises(ValueError, match="count"):
        tw.train_state_from_jax(j_states[1]._replace(step=np.int32(5)))


# --------------------------------------------------------- the sharding


def _jax_leaves(tree):
    """{dotted JAX path: leaf}"""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    out = {}
    for path, leaf in flat:
        key = ".".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[key] = leaf
    return out


def _port_name(key):
    parts = key.split(".")
    if parts[-1] == "w":
        parts[-1] = "weight"
    elif parts[-1] == "b":
        parts[-1] = "bias"
    return ".".join(parts)


@pytest.mark.parametrize("shape", [(1, 2, 1), (1, 1, 2), (2, 2, 2)])
@pytest.mark.parametrize("tree", ["tiny", "3b"])
def test_param_sharding_matches_jax(shape, tree):
    """Every leaf's spec, mapped through the layout transposes, equals
    JAX's param_sharding on the same mesh shape (the 3B's on abstract
    shapes: nothing is allocated)."""
    jcfg = JDiTConfig(**TINY) if tree == "tiny" else J_DIT_3B
    tcfg = DiTConfig(**TINY) if tree == "tiny" else DIT_3B
    shapes = jax.eval_shape(lambda k: jn.init_dit_params(
        k, jcfg, dtype=jnp.float32), jax.random.PRNGKey(0))
    mesh = jmesh.make_mesh(int(np.prod(shape)), shape=shape)
    tm = tmesh.Mesh(("dp", "fsdp", "tp"),
                    dict(zip(("dp", "fsdp", "tp"), shape)),
                    tuple(range(int(np.prod(shape)))))
    with torch.device("meta"):
        port = dict(tn.NaDiT(tcfg, dtype=torch.float32).named_parameters())
    leaves = _jax_leaves(shapes)
    assert {_port_name(k) for k in leaves} == set(port)
    for key, leaf in leaves.items():
        spec = tuple(jmesh.param_sharding(mesh, leaf).spec)
        spec = spec + (None,) * (leaf.ndim - len(spec))
        name = _port_name(key)
        want = spec[::-1] if leaf.ndim == 2 else spec
        got = tmesh.param_sharding(tm, tuple(port[name].shape))
        assert got == want, (name, got, want)


def test_param_sharding_conv_layouts():
    """5-D and 4-D convs follow state_dict_from_jax's transposes."""
    m = tmesh.Mesh(("dp", "fsdp", "tp"), {"dp": 1, "fsdp": 2, "tp": 2},
                   (0, 1, 2, 3))
    jm = jmesh.make_mesh(4, shape=(1, 2, 2))
    for jshape, perm in (((2, 3, 3, 4, 6), (4, 3, 0, 1, 2)),
                         ((4, 3, 6, 8), (3, 2, 0, 1)),
                         ((3, 3, 6, 8), (3, 2, 0, 1))):
        jspec = tuple(jmesh.param_sharding(
            jm, jax.ShapeDtypeStruct(jshape, jnp.float32)).spec)
        jspec = jspec + (None,) * (len(jshape) - len(jspec))
        tshape = tuple(jshape[i] for i in perm)
        assert tmesh.param_sharding(m, tshape) == tuple(jspec[i]
                                                        for i in perm)


def test_shard_params_pieces():
    m = tmesh.Mesh(("dp", "fsdp", "tp"), {"dp": 1, "fsdp": 2, "tp": 2},
                   (0, 1, 2, 3), rank=3)
    w = torch.arange(24.0).reshape(4, 6)
    b = torch.ones(4)
    piece = {k: tmesh.shard(m, v, tmesh.param_sharding(m, v.shape))
             for k, v in (("w", w), ("b", b))}
    # rank 3: fsdp index 1 (columns 3..5), tp index 1 (rows 2..3)
    assert torch.equal(piece["w"], w[2:4, 3:6])
    assert torch.equal(piece["b"], b)
    assert tmesh.batch_sharding(m, 3) == ("dp", None, None)


def test_train_sharding_reads_the_local_shapes():
    """The trainer's layout cuts over tp the dim in which the rank's local
    shape shrank, over fsdp the dim tp leaves whole (torch dim 1, else
    dim 0) where fsdp divides it; at tp 1 it is param_sharding."""
    m = tmesh.Mesh(("dp", "fsdp", "tp"), {"dp": 1, "fsdp": 2, "tp": 2},
                   (0, 1, 2, 3), rank=3)
    assert tmesh.train_sharding(m, (12, 8), (6, 8)) == ("tp", "fsdp")
    assert tmesh.train_sharding(m, (8, 12), (8, 6)) == ("fsdp", "tp")
    assert tmesh.train_sharding(m, (8, 12), (8, 12)) == (None, "fsdp")
    assert tmesh.train_sharding(m, (12,), (6,)) == ("tp",)
    assert tmesh.train_sharding(m, (8, 7), (8, 7)) == (None, None)
    m1 = tmesh.Mesh(("dp", "fsdp", "tp"), {"dp": 2, "fsdp": 2, "tp": 1},
                    (0, 1, 2, 3), rank=1)
    for shape in ((12, 8), (8, 7), (12,)):
        assert tmesh.train_sharding(m1, shape, shape) == \
            tmesh.param_sharding(m1, shape)


def test_make_mesh_defaults_to_jax_axes():
    one = tmesh.make_mesh()
    assert one.axis_names == ("dp", "fsdp", "tp") == tuple(
        jmesh.make_mesh(1).axis_names)
    assert one.shape == {"dp": 1, "fsdp": 1, "tp": 1}


# ---------------------------------------------------------- checkpoints


def test_save_checkpoint_equals_to_torch_state_dict(setup, tmp_path):
    """The port's save_checkpoint (of a model and of a training state)
    holds JAX's to_torch_state_dict tensor for tensor (fp16), and the port's
    loader reads it back."""
    _, tcfg, params, _ = setup
    ref = jexport.to_torch_state_dict(jax.device_get(params))
    model = port_model(tcfg, params)
    init_state, _ = ttrain.make_train_step(
        tcfg, tn.build_dit_plan(tcfg, SHAPE, TXT_LEN), device="cpu")
    for what, obj in (("model", model), ("state", init_state(model))):
        path = str(tmp_path / f"{what}.safetensors")
        tw.save_checkpoint(obj, path)
        got = tw.read_safetensors(path)
        assert set(got) == set(ref)
        for k, v in ref.items():
            assert got[k].dtype == torch.float16
            np.testing.assert_array_equal(got[k].numpy(), v)
    loaded = load_dit_checkpoint(path, "cpu", torch.float32)
    for k, v in loaded.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), ref[k].astype(np.float32))


def test_train_state_checkpoint_roundtrip(setup, tmp_path):
    """The counterpart of tests/test_components.py's: save and restore the
    training state (after a step, so the moments are not zero), every
    tensor and the step equal, and the restored state steps on bit-equal
    to the one that never stopped."""
    _, tcfg, params, batch = setup
    init_state, step = ttrain.make_train_step(
        tcfg, tn.build_dit_plan(tcfg, SHAPE, TXT_LEN), device="cpu",
        dtype=torch.float32)
    state = init_state(port_model(tcfg, params))
    g = torch.Generator().manual_seed(3)
    state, _ = step(state, tbatch(batch), g)
    path = str(tmp_path / "state.safetensors")
    ttrain.save_train_state(state, path)
    back = ttrain.restore_train_state(path, state)
    assert back.step == state.step == 1
    for a, b in ((state.params, back.params),
                 (state.opt_state["mu"], back.opt_state["mu"]),
                 (state.opt_state["nu"], back.opt_state["nu"])):
        assert all(torch.equal(a[k], b[k]) for k in a)
    g1, g2 = (torch.Generator().manual_seed(4) for _ in range(2))
    state, l1 = step(state, tbatch(batch), g1)
    back, l2 = step(back, tbatch(batch), g2)
    assert torch.equal(l1, l2)
    assert all(torch.equal(state.params[k], back.params[k])
               for k in state.params)
