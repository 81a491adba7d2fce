"""The port's CUDA kernels against their plain versions, on a GPU.

Marked `cuda`: they skip where torch sees no CUDA device (the CPU test
runs). This file imports no JAX, so it also runs on a GPU machine that has
none:

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda

chip_smoke.py makes the same checks at the main path's shapes."""

import dataclasses

import numpy as np
import pytest
import torch

from seedvr2_tpu_torch.ops import flash_attention as tfa
from seedvr2_tpu_torch.ops import fused_norm as tfn
from seedvr2_tpu_torch.ops import fused_quant as tfq
from seedvr2_tpu_torch.ops import gather as tg
from seedvr2_tpu_torch.ops import int8_conv as tic
from seedvr2_tpu_torch.ops import int8_matmul as tim
from seedvr2_tpu_torch.ops import quant_matmul as tqm
from seedvr2_tpu_torch.ops import upsample as tup


def _tables(rng, s, d, device):
    out = []
    for _ in range(2):
        ang = rng.standard_normal((s, d // 2)).astype(np.float32)
        out += [np.repeat(np.cos(ang), 2, axis=1),
                np.repeat(np.sin(ang), 2, axis=1)]
    return [torch.from_numpy(t).to(device) for t in out]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc; chip_smoke.py runs the "
                    "kernels against their plain versions on the card")
    # the plain versions take fp32 products: keep them out of TF32
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


@pytest.mark.cuda
@pytest.mark.parametrize("s,kv_len", [(128, 91), (512, 463), (896, 896)])
def test_k1_kernel_matches_plain_on_gpu(cuda_device, s, kv_len):
    gen = torch.Generator(cuda_device).manual_seed(s)
    h, d = 20, 128
    qkv = torch.randn(2, s, 3 * h * d, generator=gen,
                      device=cuda_device).to(torch.bfloat16)
    tabs = _tables(np.random.default_rng(s), s, d, cuda_device)
    out = tfa.packed_window_attention(qkv, h, d, *tabs, 1e-5, kv_len)
    ref = tfa.packed_window_attention_plain(qkv, h, d, *tabs, 1e-5, kv_len)
    # bf16 outputs rounded at other points: the JAX package's kernel bound
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)


# K1's edges: short, record and long windows, kv_len at 1, one row short
# of a key tile, one tile, S - 37 and S
_K1_EDGES = [(s, kv) for s in (128, 512, 3712)
             for kv in (1, 63, 64, s - 37, s)]


@pytest.mark.cuda
@pytest.mark.parametrize("s,kv_len", _K1_EDGES,
                         ids=[f"S{s}-kv{kv}" for s, kv in _K1_EDGES])
def test_k1_kernel_edges_on_gpu(cuda_device, s, kv_len):
    """Key tiles wholly past kv_len skipped, the partial one masked, q
    tiles of 128 rows over S = 128 .. 3712: finite, within the JAX
    package's kernel bound of the plain version."""
    gen = torch.Generator(cuda_device).manual_seed(s + kv_len)
    h, d = 4, 128
    qkv = torch.randn(2, s, 3 * h * d, generator=gen,
                      device=cuda_device).to(torch.bfloat16)
    tabs = _tables(np.random.default_rng(s + kv_len), s, d, cuda_device)
    before = tfa.packed_window_attention.launches
    out = tfa.packed_window_attention(qkv, h, d, *tabs, 1e-5, kv_len)
    assert tfa.packed_window_attention.launches == before + 1
    ref = tfa.packed_window_attention_plain(qkv, h, d, *tabs, 1e-5, kv_len)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("s,kv_len", [(256, 200), (192, 64)])
def test_k1_kernel_head_dim_64_on_gpu(cuda_device, s, kv_len):
    """D = 64: one 64-column box a tile, wgmma N = 64 for P v."""
    gen = torch.Generator(cuda_device).manual_seed(s)
    h, d = 3, 64
    qkv = torch.randn(2, s, 3 * h * d, generator=gen,
                      device=cuda_device).to(torch.bfloat16)
    tabs = _tables(np.random.default_rng(s), s, d, cuda_device)
    out = tfa.packed_window_attention(qkv, h, d, *tabs, 1e-5, kv_len)
    ref = tfa.packed_window_attention_plain(qkv, h, d, *tabs, 1e-5, kv_len)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("d,rows", [(128, None), (64, None), (128, 300),
                                    (128, "windows"), (64, "windows")],
                         ids=["k1_d128", "k1_d64", "k8_short_table",
                              "k9_d128", "k9_d64"])
def test_attention_prepass_kernel_matches_plain_on_gpu(cuda_device, d, rows):
    """The pre-pass alone: K1's form (strided q and k columns of the packed
    operand, qk-norm, one table a side), K8's (no norm, one table shorter
    than S for both sides) and K9's (no norm, each batch row roped by the
    (S, D) table its id picks of three). The same fp32 arithmetic in
    another order, so one bf16 rounding may land one ulp (<= 2^-7 of the
    value) apart."""
    gen = torch.Generator(cuda_device).manual_seed(d)
    b, s, h = 2, 463, 3
    ids = None
    if rows == "windows":
        b = 5
        ids = tg.RowIndex(np.array([2, 0, 1, 1, 2]), cuda_device)
    qkv = torch.randn(b, s, 3 * h * d, generator=gen,
                      device=cuda_device).to(torch.bfloat16)
    x = qkv.view(b, s, 3, h, d)
    q, k = x[:, :, 0], x[:, :, 1]
    if rows is None:
        cq, sq, ck, sk = _tables(np.random.default_rng(d), s, d, cuda_device)
        eps = 1e-5
    elif ids is not None:
        ang = torch.randn(3, s, d // 2, generator=gen, device=cuda_device)
        cq = torch.cos(ang).repeat_interleave(2, -1).contiguous()
        sq = torch.sin(ang).repeat_interleave(2, -1).contiguous()
        ck, sk, eps = cq, sq, None
    else:
        cq, sq = _tables(np.random.default_rng(d), rows, d, cuda_device)[:2]
        ck, sk, eps = cq, sq, None
    q_hat, k_hat = tfa.attention_prepass(q, k, cq, sq, ck, sk, eps, 0.127,
                                         ids)
    id_t = None if ids is None else ids.tensor
    for hat, ref in ((q_hat, tfa.norm_rope_plain(q, cq, sq, eps, 0.127,
                                                 id_t)),
                     (k_hat, tfa.norm_rope_plain(k, ck, sk, eps,
                                                 ids=id_t))):
        assert hat.is_contiguous() and hat.shape == (b, s, h, d)
        torch.testing.assert_close(hat.float(), ref.float(), atol=1e-6,
                                   rtol=2.0 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [2560, 30])
def test_k2_kernel_matches_plain_on_gpu(cuda_device, width):
    gen = torch.Generator(cuda_device).manual_seed(width)
    x = torch.randn(2, 300, width, generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    index = tg.RowIndex(np.random.default_rng(0).integers(0, 300, 250),
                        cuda_device)
    assert torch.equal(tg.gather_rows(x, index), tg.gather_rows_plain(x, index))


def _rel(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


# K1's backward: kv_len at 1, one row short of a key tile, one tile, a
# partial last tile, the record shape, a whole window, training-plan groups
# with a q tile wholly past kv_len and with the smallest kv_len (S = 128
# kv_len = 62, one warpgroup a block); D = 64 and 128; the 3B's 20 heads,
# a few, and the 7B's 24
_K1_BWD = [(128, 1, 128, 4), (128, 63, 64, 4), (128, 64, 128, 4),
           (192, 191, 128, 4), (512, 463, 128, 20), (256, 256, 64, 4),
           (384, 298, 128, 4), (128, 62, 128, 20), (512, 463, 128, 24)]
# dq-hat and dk-hat against their fp32 plain versions: dS is rounded to
# bf16 where it becomes a tensor-core operand (chip_smoke.py's
# BWD_DQDK_REL)
DQDK_REL = 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("s,kv_len,d,h", _K1_BWD,
                         ids=[f"S{s}-kv{kv}-D{d}-H{h}"
                              for s, kv, d, h in _K1_BWD])
def test_k1_backward_parts_on_gpu(cuda_device, s, kv_len, d, h):
    """Each part of K1's backward against its plain version on the same
    inputs, lse from K1's training launch (chip_smoke.py's BWD bounds:
    delta 1e-5 relative L2, dv and the pre-pass's bf16 outputs 1e-3, the
    tables 1e-5, dq-hat and dk-hat DQDK_REL), the whole against its plain
    version (bf16-class 2e-2), rows at or past kv_len zero (delta's too),
    reruns bit-equal."""
    gen = torch.Generator(cuda_device).manual_seed(s + kv_len + d)
    b, eps = 3, 1e-5
    tabs = _tables(np.random.default_rng(s), s, d, cuda_device)
    qkv = torch.randn(b, s, 3 * h * d, generator=gen,
                      device=cuda_device).to(torch.bfloat16)
    qkv[:, kv_len:] = 0
    out, lse = tfa.packed_window_attention_lse(qkv, h, d, *tabs, eps, kv_len)
    dout = torch.randn(b, s, h * d, generator=gen,
                       device=cuda_device).to(torch.bfloat16)
    x = qkv.view(b, s, 3, h, d)
    qh, kh = tfa.attention_prepass(x[:, :, 0], x[:, :, 1], *tabs, eps,
                                   d ** -0.5 * tfa._LOG2E)
    v = x[:, :, 2]
    dq, delta = tfa.attention_backward_dq(qh, kh, v, out, dout, lse, kv_len)
    dk, dv = tfa.attention_backward_dkdv(qh, kh, v, dout, lse, delta, kv_len)
    pre = tfa.prepass_backward(x[:, :, 0], x[:, :, 1], *tabs, eps, dq, dk,
                               d ** -0.5, tfa._LN2)
    whole = tfa.packed_window_attention_backward(qkv, h, d, *tabs, eps,
                                                 kv_len, out, dout, lse)
    again = tfa.packed_window_attention_backward(qkv, h, d, *tabs, eps,
                                                 kv_len, out, dout, lse)
    torch.cuda.synchronize()
    p_dq, p_delta = tfa.attention_backward_dq_plain(qh, kh, v, out, dout,
                                                    lse, kv_len)
    p_dk, p_dv = tfa.attention_backward_dkdv_plain(qh, kh, v, dout, lse,
                                                   delta, kv_len)
    p_pre = tfa.prepass_backward_plain(x[:, :, 0], x[:, :, 1], *tabs, eps,
                                       dq, dk, d ** -0.5, tfa._LN2)
    p_whole = tfa.packed_window_attention_backward_plain(
        qkv, h, d, *tabs, eps, kv_len, out, dout)
    assert _rel(delta, p_delta) <= 1e-5
    assert _rel(dv, p_dv) <= 1e-3
    assert all(torch.isfinite(t).all() for t in whole)
    if kv_len == 1:
        # one key: P = 1 and O = v_0, so dS = dO v_0 - delta = 0, and dq,
        # dk, the pre-pass's outputs and the table gradients vanish; each
        # side keeps only the rounding residue of that difference (~1e-5)
        for t in (dq, p_dq, dk, p_dk, *pre[:2], *p_pre[:2], *pre[2],
                  *p_pre[2], *whole[1:], *p_whole[1:]):
            assert t.abs().max().item() <= 1e-3
        w, pw = (t.view(b, s, 3, h * d) for t in (whole[0], p_whole[0]))
        assert w[:, :, :2].abs().max().item() <= 1e-3
        assert _rel(w[:, :, 2], pw[:, :, 2]) <= 1e-3
    else:
        assert _rel(dq, p_dq) <= DQDK_REL and _rel(dk, p_dk) <= DQDK_REL
        assert _rel(pre[0], p_pre[0]) <= 1e-3
        assert _rel(pre[1], p_pre[1]) <= 1e-3
        for t, r in zip(pre[2], p_pre[2]):
            assert _rel(t, r) <= 1e-5
        for t, r in zip(whole, p_whole):
            assert _rel(t, r) <= 2e-2
    assert all(torch.equal(t, r) for t, r in zip(whole, again))
    assert not whole[0][:, kv_len:].any()
    assert all(not t[kv_len:].any() for t in whole[1:])


_K1_LSE = [(128, 62, 128, 20), (512, 463, 128, 20), (512, 512, 64, 24),
           (192, 1, 128, 4), (384, 298, 128, 24)]


@pytest.mark.cuda
@pytest.mark.parametrize("s,kv_len,d,h", _K1_LSE,
                         ids=[f"S{s}-kv{kv}-D{d}-H{h}"
                              for s, kv, d, h in _K1_LSE])
def test_k1_lse_launch_on_gpu(cuda_device, s, kv_len, d, h):
    """K1's training launch: its lse (every row below S) within 1e-5
    relative L2 of the plain version's (the same bf16 q-hat and k-hat,
    fp32 sums in another order), and its output bit-equal to the serving
    launch's on the same inputs."""
    gen = torch.Generator(cuda_device).manual_seed(s + kv_len + h)
    tabs = _tables(np.random.default_rng(h), s, d, cuda_device)
    qkv = torch.randn(2, s, 3 * h * d, generator=gen,
                      device=cuda_device).to(torch.bfloat16)
    qkv[:, kv_len:] = 0
    before = (tfa.packed_window_attention.launches,
              tfa.packed_window_attention.launches_lse)
    out, lse = tfa.packed_window_attention_lse(qkv, h, d, *tabs, 1e-5, kv_len)
    served = tfa.packed_window_attention(qkv, h, d, *tabs, 1e-5, kv_len)
    torch.cuda.synchronize()
    _, p_lse = tfa.packed_window_attention_lse_plain(qkv, h, d, *tabs, 1e-5,
                                                     kv_len)
    assert lse.shape == (2, h, s) and torch.isfinite(lse).all()
    assert _rel(lse, p_lse) <= 1e-5
    assert torch.equal(out, served)
    assert (tfa.packed_window_attention.launches,
            tfa.packed_window_attention.launches_lse) == (before[0] + 2,
                                                          before[1] + 1)


@pytest.mark.cuda
def test_k1_k2_functions_on_gpu(cuda_device):
    """K1's and K2's autograd Functions on the card: outputs with a
    grad_fn, gradients within the bf16 class of torch autograd through the
    plain versions (K2's bit-equal to index_select's), counted launches;
    the raw wrappers refuse an input that needs a gradient."""
    gen = torch.Generator(cuda_device).manual_seed(3)
    b, s, h, d, kv = 2, 256, 4, 128, 200
    tabs = [t.requires_grad_() for t in
            _tables(np.random.default_rng(3), s, d, cuda_device)]
    qkv = torch.randn(b, s, 3 * h * d, generator=gen,
                      device=cuda_device).to(torch.bfloat16).requires_grad_()
    dout = torch.randn(b, s, h * d, generator=gen,
                       device=cuda_device).to(torch.bfloat16)
    dout[:, kv:] = 0
    with pytest.raises(RuntimeError, match="needs a gradient"):
        tfa.packed_window_attention(qkv, h, d, *tabs, 1e-5, kv)
    before = (tfa.attention_backward_dkdv.launches,
              tfa.packed_window_attention.launches_lse)
    out = tfa.packed_window_attention_grad(qkv, h, d, *tabs, 1e-5, kv)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (qkv, *tabs), dout)
    ref = torch.autograd.grad(tfa.packed_window_attention_plain(
        qkv, h, d, *tabs, 1e-5, kv), (qkv, *tabs), dout)
    assert (tfa.attention_backward_dkdv.launches,
            tfa.packed_window_attention.launches_lse) == (before[0] + 1,
                                                          before[1] + 1)
    for g, r in zip(got, ref):
        assert _rel(g, r) <= 2e-2
    index = tg.RowIndex(np.random.default_rng(1).permutation(300),
                        cuda_device)
    x = torch.randn(2, 300, 2560, generator=gen, device=cuda_device).to(
        torch.bfloat16).requires_grad_()
    g = torch.randn(2, 300, 2560, generator=gen, device=cuda_device).to(
        torch.bfloat16)
    with pytest.raises(RuntimeError, match="needs a gradient"):
        tg.gather_rows(x, index)
    before = tg.GatherRows.launches
    (got,) = torch.autograd.grad(tg.gather_rows_grad(x, index), x, g)
    (ref,) = torch.autograd.grad(torch.index_select(
        x, 1, index.tensor.long()), x, g)
    assert torch.equal(got, ref) and tg.GatherRows.launches == before + 1


@pytest.mark.cuda
def test_train_steps_on_gpu(cuda_device):
    """Two bf16 AdamW steps of a small 3B-layout DiT (D = 64 heads, which
    K1 takes) through the kernels against the same steps through the plain
    versions: losses within 1e-2 relative, every first moment finite and
    nonzero."""
    from seedvr2_tpu_torch.core.configs import small_test_config
    from seedvr2_tpu_torch.models.dit import nadit
    from seedvr2_tpu_torch.parallel import train

    cfg = small_test_config(vid_dim=128, heads=2, head_dim=64)
    plan = nadit.build_dit_plan(cfg, (1, 16, 16), 7)
    gen = torch.Generator(cuda_device).manual_seed(0)
    model = nadit.init_dit(cfg, cuda_device, torch.float32, gen)
    batch = {"latent": torch.randn(2, 1, 16, 16, 16, device=cuda_device),
             "cond": torch.randn(2, 1, 16, 16, 17, device=cuda_device),
             "txt": torch.randn(2, 7, cfg.txt_in_dim, device=cuda_device)}
    losses = {}
    for uk in (True, False):
        init_state, step = train.make_train_step(cfg, plan, None,
                                                 device=cuda_device,
                                                 use_kernels=uk)
        state = init_state(model)
        losses[uk] = []
        for i in range(2):
            state, loss = step(state, batch,
                               torch.Generator(cuda_device).manual_seed(i))
            losses[uk].append(loss.item())
        assert all(torch.isfinite(m).all() and m.abs().sum() > 0
                   for m in state.opt_state["mu"].values())
    for a, r in zip(losses[True], losses[False]):
        assert abs(a - r) <= 1e-2 * abs(r)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [(1, 2560, 2560), (58, 2560, 5120),
                                   (300, 384, 96), (7200, 13824, 2560),
                                   (1, 384, 96), (8, 2568, 96),
                                   (9, 384, 5120), (64, 384, 96),
                                   (65, 2568, 5120), (300, 2568, 96)])
def test_k3_kernel_exact_on_gpu(cuda_device, m, n, k):
    """int8 GEMM: exact int32 sums and the same epilogue order, so equal to
    the plain version bit for bit: M = 1, 8 (tiles of 8 tokens), 9, 58, 64
    (of 64), 65, 300, 7200 (128 x 256 tiles, ragged M); N = 384 and 2568
    (a part of a 256-row tile); K = 96 (K % 128 != 0), 2560, 5120. An
    operand TMA cannot load (K % 32 != 0, or not 16-byte aligned) is
    refused."""
    gen = torch.Generator(cuda_device).manual_seed(m)
    xq = torch.randint(-127, 128, (m, k), generator=gen, device=cuda_device,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (n, k), generator=gen, device=cuda_device,
                       dtype=torch.int8)
    xs = torch.rand(m, generator=gen, device=cuda_device) * 0.01
    ws = torch.rand(n, generator=gen, device=cuda_device) * 0.01
    out = tim.int8_matmul(xq, wq, xs, ws)
    assert torch.equal(out, tim.int8_matmul_plain(xq, wq, xs, ws))
    with pytest.raises(ValueError):
        tim.int8_matmul(xq[:, :k - 16].contiguous(), wq[:, :k - 16]
                        .contiguous(), xs, ws)
    shifted = torch.empty(m * k + 8, dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError):  # contiguous, 8 bytes off alignment
        tim.int8_matmul(shifted[8:].view(m, k), wq, xs, ws)


def _q_close(out, ref):
    """K4/K5 against their plain versions: scales within rtol 1e-6, q within
    1 everywhere and equal in >= 99.9 % of entries (row sums and rsqrt in
    another order move a few values across a .5 boundary)."""
    torch.testing.assert_close(out.s, ref.s, rtol=1e-6, atol=0)
    diff = (out.q.int() - ref.q.int()).abs()
    assert diff.max().item() <= 1
    assert (diff == 0).float().mean().item() >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,k", [(1, 7200, 2560), (1, 58, 2560),
                                   (2, 33, 64), (1, 16320, 2560),
                                   (2, 58, 3072), (1, 1, 2560)])
def test_k4_kernel_matches_plain_on_gpu(cuda_device, b, l, k):
    gen = torch.Generator(cuda_device).manual_seed(l)
    x = torch.randn(b, l, k, generator=gen, device=cuda_device).to(
        torch.bfloat16)
    scale = 1 + 0.1 * torch.randn(b, k, generator=gen, device=cuda_device)
    shift = 0.1 * torch.randn(b, k, generator=gen, device=cuda_device)
    _q_close(tfq.rms_ada_quantize(x, scale, shift, 1e-5),
             tfq.rms_ada_quantize_plain(x, scale, shift, 1e-5))


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,k", [(1, 7200, 6912), (1, 58, 6912),
                                   (2, 33, 64)])
def test_k5_kernel_matches_plain_on_gpu(cuda_device, b, l, k):
    gen = torch.Generator(cuda_device).manual_seed(l)
    gu = torch.randn(b, l, 2 * k, generator=gen, device=cuda_device).to(
        torch.bfloat16)
    g, u = gu[..., :k], gu[..., k:]
    _q_close(tfq.silu_mul_quantize(g, u), tfq.silu_mul_quantize_plain(g, u))


@pytest.mark.cuda
def test_w8a8_dit_with_kernels_matches_plain_on_gpu(cuda_device):
    """The 2-layer width-256 NaDiT converted to w8a8 (min_dim 256): K1-K5
    against their plain versions, bounded as the dense model below."""
    from seedvr2_tpu_torch.core.configs import small_test_config
    from seedvr2_tpu_torch.models.dit import nadit

    cfg = small_test_config(vid_dim=256, heads=2, head_dim=128)
    gen = torch.Generator(cuda_device).manual_seed(0)
    model = tim.quantize_dit_w8a8(
        nadit.init_dit(cfg, cuda_device, torch.bfloat16, generator=gen), 256)
    shape, txt_len = (2, 18, 32), 58
    dplan = nadit.upload_plan(nadit.build_dit_plan(cfg, shape, txt_len), cfg,
                              cuda_device)
    vid = torch.randn(1, *shape, cfg.vid_in_channels, generator=gen,
                      device=cuda_device).to(torch.bfloat16)
    txt = torch.randn(1, txt_len, cfg.txt_in_dim, generator=gen,
                      device=cuda_device).to(torch.bfloat16)
    t = torch.full((1,), 1000.0, device=cuda_device)
    before = (tim.int8_matmul.launches, tfq.rms_ada_quantize.launches,
              tfq.silu_mul_quantize.launches)
    with torch.no_grad():
        k = nadit.nadit_forward(model, vid, txt, t, dplan).float()
        after = (tim.int8_matmul.launches, tfq.rms_ada_quantize.launches,
                 tfq.silu_mul_quantize.launches)
        p = nadit.nadit_forward(model, vid, txt, t, dplan,
                                use_kernels=False).float()
    assert all(a > b for a, b in zip(after, before))
    assert torch.isfinite(k).all()
    assert ((k - p).norm() / p.norm()).item() < 2e-2


@pytest.mark.cuda
def test_dit_with_kernels_matches_plain_on_gpu(cuda_device):
    """A 2-layer, width-256 NaDiT in bf16 (head dim 128, as in 3B): the
    forward with K1 and K2 against the forward with their plain versions.
    Bound: a bf16-class relative L2 error, as chip_smoke.py uses for the
    full 32-layer model."""
    from seedvr2_tpu_torch.core.configs import small_test_config
    from seedvr2_tpu_torch.models.dit import nadit

    cfg = small_test_config(vid_dim=256, heads=2, head_dim=128)
    gen = torch.Generator(cuda_device).manual_seed(0)
    model = nadit.init_dit(cfg, cuda_device, torch.bfloat16, generator=gen)
    shape, txt_len = (2, 18, 32), 58
    dplan = nadit.upload_plan(nadit.build_dit_plan(cfg, shape, txt_len), cfg,
                              cuda_device)
    vid = torch.randn(1, *shape, cfg.vid_in_channels, generator=gen,
                      device=cuda_device).to(torch.bfloat16)
    txt = torch.randn(1, txt_len, cfg.txt_in_dim, generator=gen,
                      device=cuda_device).to(torch.bfloat16)
    t = torch.full((1,), 1000.0, device=cuda_device)
    with torch.no_grad():
        k = nadit.nadit_forward(model, vid, txt, t, dplan).float()
        p = nadit.nadit_forward(model, vid, txt, t, dplan,
                                use_kernels=False).float()
    assert torch.isfinite(k).all()
    assert ((k - p).norm() / p.norm()).item() < 2e-2


def bf16_ulps(out, ref):
    """|out - ref| in bf16 ulps of ref, the ulp taken at max(|ref|,
    rms(ref) / 256): below that floor the two fp32 sums' order-of-summation
    difference (~ sqrt(K) * 2^-24 * rms) can exceed the element's own ulp."""
    ref32, out32 = ref.float(), out.float()
    floor = ref32.pow(2).mean().sqrt() / 256
    _, e = torch.frexp(torch.maximum(ref32.abs(), floor))
    return (out32 - ref32).abs() / torch.ldexp(torch.ones_like(ref32), e - 8)


def _q8_case(gen, m, n, k, device):
    x = torch.randn(m, k, generator=gen, device=device).to(torch.bfloat16)
    q = torch.randint(-127, 128, (n, k), generator=gen, device=device,
                      dtype=torch.int8)
    s = torch.rand(n, k // 32, generator=gen, device=device) * 0.02 / 127
    return x, q, s


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [(1, 15360, 2560), (58, 2560, 5120),
                                   (300, 384, 96), (7200, 7680, 2560)])
def test_k6_kernel_matches_plain_on_gpu(cuda_device, m, n, k):
    """Q8_0 dequantizing GEMM: both round one fp32 sum to bf16, so within one
    bf16 ulp of the plain version everywhere (ragged M, K % 64 == 32)."""
    gen = torch.Generator(cuda_device).manual_seed(m + n)
    x, q, s = _q8_case(gen, m, n, k, cuda_device)
    before = tqm.quant_matmul_q8.launches
    out = tqm.quant_matmul_q8(x, q, s)
    assert tqm.quant_matmul_q8.launches == before + 1
    ref = tqm.quant_matmul_q8_plain(x, q, s)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    assert bf16_ulps(out, ref).max().item() <= 1
    with pytest.raises(ValueError):
        tqm.quant_matmul_q8(x.float(), q, s)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k,top", [(1, 2560, 2560, 15),
                                       (58, 2560, 6912, 31),
                                       (7200, 6912, 2560, 15)])
def test_k7_kernel_matches_plain_on_gpu(cuda_device, m, n, k, top):
    """Affine dequantizing GEMM: the min term as group sums @ m cancels
    against the q*s term as in the JAX kernel: within one ulp in >= 99.9 %
    of the elements, relative L2 <= 1e-3."""
    gen = torch.Generator(cuda_device).manual_seed(m + k)
    x = torch.randn(m, k, generator=gen, device=cuda_device).to(
        torch.bfloat16)
    q = torch.randint(0, top + 1, (n, k), generator=gen, device=cuda_device,
                      dtype=torch.int8)
    s = torch.rand(n, k // 32, generator=gen, device=cuda_device) * 0.04 / top
    mn = torch.rand(n, k // 32, generator=gen, device=cuda_device) * 0.02
    out = tqm.quant_matmul_affine(x, q, s, mn)
    ref = tqm.quant_matmul_affine_plain(x, q, s, mn)
    assert torch.isfinite(out).all()
    assert (bf16_ulps(out, ref) <= 1).float().mean().item() >= 0.999
    rel = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
    assert rel <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["q8", "q4"])
def test_quantised_dit_with_kernels_matches_plain_on_gpu(cuda_device, quant):
    """The 2-layer width-256 NaDiT converted to q8 (K6) or q4 (K7) at
    min_dim 256: kernels against their plain versions, bounded as the dense
    model."""
    from seedvr2_tpu_torch.core.configs import small_test_config
    from seedvr2_tpu_torch.models.dit import nadit

    cfg = small_test_config(vid_dim=256, heads=2, head_dim=128)
    gen = torch.Generator(cuda_device).manual_seed(0)
    convert = {"q8": tqm.quantize_dit_q8, "q4": tqm.quantize_dit_affine4}
    model = convert[quant](nadit.init_dit(cfg, cuda_device, torch.bfloat16,
                                          generator=gen), 256)
    shape, txt_len = (2, 18, 32), 58
    dplan = nadit.upload_plan(nadit.build_dit_plan(cfg, shape, txt_len), cfg,
                              cuda_device)
    vid = torch.randn(1, *shape, cfg.vid_in_channels, generator=gen,
                      device=cuda_device).to(torch.bfloat16)
    txt = torch.randn(1, txt_len, cfg.txt_in_dim, generator=gen,
                      device=cuda_device).to(torch.bfloat16)
    t = torch.full((1,), 1000.0, device=cuda_device)
    wrapper = {"q8": tqm.quant_matmul_q8, "q4": tqm.quant_matmul_affine}
    before = wrapper[quant].launches
    with torch.no_grad():
        k = nadit.nadit_forward(model, vid, txt, t, dplan).float()
        assert wrapper[quant].launches > before
        p = nadit.nadit_forward(model, vid, txt, t, dplan,
                                use_kernels=False).float()
    assert torch.isfinite(k).all()
    assert ((k - p).norm() / p.norm()).item() < 2e-2


# the edges of K6/K7's Hopper design: token widths 8 / 64 / 128 and their
# ragged edges (M), ragged and tiny N (a 128-row weight tile cut short), K
# not a multiple of the 128-deep stage (96) and the DiT's K; each N and
# each K once, at every M. The epilogue's routes: TMA stores clipped at N
# (136: one warpgroup's box wholly past N; 4: the fp32 workspace of a
# split K) and the threads' own stores where rows are not 16-byte
# multiples (2, 130).
EDGE_M = (1, 8, 57, 58, 64, 65, 129)
EDGE_NK = ((2, 96), (130, 6912), (2560, 5120), (7680, 2560), (136, 96),
           (4, 2560))


def _affine_case(gen, m, n, k, top, device):
    x = torch.randn(m, k, generator=gen, device=device).to(torch.bfloat16)
    q = torch.randint(0, top + 1, (n, k), generator=gen, device=device,
                      dtype=torch.int8)
    s = torch.rand(n, k // 32, generator=gen, device=device) * 0.04 / top
    mn = torch.rand(n, k // 32, generator=gen, device=device) * 0.02
    return x, q, s, mn


def _assert_k7_close(out, ref):
    """K7's limits (see test_k7_kernel_matches_plain_on_gpu)."""
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    assert (bf16_ulps(out, ref) <= 1).float().mean().item() >= 0.999
    rel = ((out.float() - ref.float()).norm()
           / ref.float().norm().clamp_min(1e-30)).item()
    assert rel <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", EDGE_NK)
@pytest.mark.parametrize("m", EDGE_M)
def test_k6_kernel_edges_on_gpu(cuda_device, m, n, k):
    """K6 within one bf16 ulp of its plain version at the design's edges,
    the split-K path (small M) included."""
    gen = torch.Generator(cuda_device).manual_seed(m * 7 + n + k)
    x, q, s = _q8_case(gen, m, n, k, cuda_device)
    out = tqm.quant_matmul_q8(x, q, s)
    ref = tqm.quant_matmul_q8_plain(x, q, s)
    assert out.shape == (m, n) and torch.isfinite(out).all()
    assert bf16_ulps(out, ref).max().item() <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", EDGE_NK)
@pytest.mark.parametrize("m", EDGE_M)
def test_k7_kernel_edges_on_gpu(cuda_device, m, n, k):
    """K7 against its plain version at the design's edges (Q5_K quants)."""
    gen = torch.Generator(cuda_device).manual_seed(m * 11 + n + k)
    x, q, s, mn = _affine_case(gen, m, n, k, 31, cuda_device)
    _assert_k7_close(tqm.quant_matmul_affine(x, q, s, mn),
                     tqm.quant_matmul_affine_plain(x, q, s, mn))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 58, 300])
def test_k6_k7_extreme_quants_on_gpu(cuda_device, m):
    """Quants at their extremes (K6 all +127, all -127 and alternating; K7
    all 0 and all 31) and zero scales: the widening is exact there too."""
    n, k = 384, 2560
    gen = torch.Generator(cuda_device).manual_seed(m)
    x = torch.randn(m, k, generator=gen, device=cuda_device).to(
        torch.bfloat16)
    s = torch.rand(n, k // 32, generator=gen, device=cuda_device) * 1e-3
    sign = torch.ones(n, k, device=cuda_device)
    sign[:, 1::2] = -1
    for q in (torch.full((n, k), 127, dtype=torch.int8, device=cuda_device),
              torch.full((n, k), -127, dtype=torch.int8, device=cuda_device),
              (sign * 127).to(torch.int8)):
        out = tqm.quant_matmul_q8(x, q, s)
        assert bf16_ulps(out, tqm.quant_matmul_q8_plain(x, q, s)).max() <= 1
    zero = torch.zeros_like(s)
    assert torch.equal(tqm.quant_matmul_q8(x, q, zero),
                       torch.zeros(m, n, dtype=torch.bfloat16,
                                   device=cuda_device))
    mn = torch.rand(n, k // 32, generator=gen, device=cuda_device) * 0.02
    for top in (0, 31):
        q = torch.full((n, k), top, dtype=torch.int8, device=cuda_device)
        for ss in (s, zero):
            _assert_k7_close(tqm.quant_matmul_affine(x, q, ss, mn),
                             tqm.quant_matmul_affine_plain(x, q, ss, mn))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k", [(1, 96), (58, 2560), (1000, 6912)])
def test_group_sums_kernel_matches_plain_on_gpu(cuda_device, m, k):
    """K7's pre-pass: 31 fp32 additions per group in another order than the
    plain version's, so both lie within 31 * 2^-24 * sum|x| of the exact
    group sum (float64); the kernel's bf16 hi + lo planes hold its fp32 sum
    within a further 2^-17 of the sum."""
    gen = torch.Generator(cuda_device).manual_seed(m + k)
    x = torch.randn(m, k, generator=gen, device=cuda_device).to(
        torch.bfloat16)
    xg = tqm.group_sums(x)
    exact = x.double().reshape(m, k // 32, 32).sum(-1)
    bound = 31 * 2.0 ** -24 * x.double().abs().reshape(m, k // 32, 32).sum(-1)
    assert xg.shape == (m, k // 32)
    plain = tqm.group_sums_plain(x).double()
    assert ((plain - exact).abs() <= bound).all()
    assert ((xg.double() - exact).abs()
            <= bound + 2.0 ** -17 * exact.abs()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(6, 96), (2560, 6912)])
def test_min_planes_kernel_matches_plain_on_gpu(cuda_device, n, k):
    """K7's pre-pass on the min table: bit-equal to its plain version, alone
    and in one launch with the group sums (as K7 makes it), where the
    group sums come out as alone."""
    gen = torch.Generator(cuda_device).manual_seed(n + k)
    m = torch.rand(n, k // 32, generator=gen, device=cuda_device) * 0.02
    x = torch.randn(37, k, generator=gen, device=cuda_device).to(
        torch.bfloat16)
    for rows in (x[:0], x):
        xg, mnp = tqm.k7_prepass(rows, m)
        assert torch.equal(mnp[:, :, :k // 32], tqm.min_planes_plain(m))
        assert not mnp[:, :, k // 32:].any()
    assert torch.equal((xg[0].float() + xg[1].float())[:, :k // 32],
                       tqm.group_sums(x))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 58, 300])
def test_k7_kernel_takes_long_k_on_gpu(cuda_device, m):
    """K7's min term streams through the ring a 64-group panel at a time,
    so K has no limit of its own: K = 16384 (512 groups, 8 panels)."""
    gen = torch.Generator(cuda_device).manual_seed(m)
    x, q, s, mn = _affine_case(gen, m, 256, 16384, 15, cuda_device)
    _assert_k7_close(tqm.quant_matmul_affine(x, q, s, mn),
                     tqm.quant_matmul_affine_plain(x, q, s, mn))


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [(1, 2560, 2560), (58, 2560, 6912)])
def test_split_k_is_deterministic_on_gpu(cuda_device, m, n, k):
    """The split-K path (planned for these shapes) gives bit-equal results
    on two runs, and its reduction is bit-equal to its plain version."""
    bt, splits = tqm.plan_tiles(m, n, k)
    assert splits > 1
    gen = torch.Generator(cuda_device).manual_seed(k)
    x, q, s = _q8_case(gen, m, n, k, cuda_device)
    assert torch.equal(tqm.quant_matmul_q8(x, q, s),
                       tqm.quant_matmul_q8(x, q, s))
    x, q, s, mn = _affine_case(gen, m, n, k, 15, cuda_device)
    assert torch.equal(tqm.quant_matmul_affine(x, q, s, mn),
                       tqm.quant_matmul_affine(x, q, s, mn))
    ws = torch.randn(splits, m, n, generator=gen, device=cuda_device)
    assert torch.equal(tqm.split_reduce(ws), tqm.split_reduce_plain(ws))


@pytest.mark.cuda
@pytest.mark.parametrize("t,h,w,c,co", [
    (2, 6, 45, 128, 128),     # odd W: output rows not 16-byte multiples
    (1, 3, 300, 256, 128),    # tiles spanning rows of h, Co < C
    (3, 4, 130, 128, 256),    # two channel tiles
    (1, 2, 20, 32, 48),       # C one 64-byte chunk short, Co ragged
    (2, 4, 160, 512, 512),    # a slice of the 90 x 160 stage
    (3, 4, 320, 512, 512),    # a slice of the 180 x 320 stage
    (1, 3, 64, 128, 384)])    # three channel tiles
def test_k11_kernel_matches_plain_on_gpu(cuda_device, t, h, w, c, co):
    """int8 implicit-GEMM conv: exact int32 sums and the same fp32
    epilogue, so equal to the plain version bit for bit, through the VAE's
    NCDHW call (with the bias; 16-byte stores along w, or one element a
    thread where W_out * 2 % 16 != 0: W = 45, 20) and the JAX-layout one."""
    gen = torch.Generator(cuda_device).manual_seed(t * h * w + co)
    wp = -(-(w + 2) // 32) * 32
    x_ext = torch.randint(-127, 128, (t + 2, h + 2, wp, c), generator=gen,
                          device=cuda_device, dtype=torch.int8)
    wq = torch.randint(-127, 128, (27, c, co), generator=gen,
                       device=cuda_device, dtype=torch.int8)
    xs = torch.rand(t, generator=gen, device=cuda_device) * 0.01
    ws = torch.rand(co, generator=gen, device=cuda_device) * 0.01
    bias = torch.randn(co, generator=gen, device=cuda_device).to(
        torch.bfloat16)
    wk = tic.kernel_weight(wq)
    before = tic.int8_conv3d.launches
    out = tic.int8_conv3d_ncdhw(x_ext, wk, xs, ws, bias, w)
    assert tic.int8_conv3d.launches == before + 1
    ref = tic.int8_conv3d_plain(x_ext, wk, xs, ws, bias, w)[None]
    assert out.shape == ref.shape == (1, co, t, h, w)
    assert torch.equal(out, ref)
    out = tic.int8_conv3d(x_ext, wq, xs, ws)
    ref = tic.int8_conv3d_plain(x_ext, wk, xs, ws).permute(1, 2, 3, 0)
    assert out.shape == (t, h, wp - 2, co) and torch.equal(out, ref)
    with pytest.raises(ValueError):
        tic.int8_conv3d_ncdhw(x_ext, wk, xs.double(), ws, bias, w)


def k12_moments_fp64(x, w, b, groups, eps):
    """K12's (A, Bc) from fp64 moments of the bf16 x: the truth the moments
    kernel and the plain `_fold` are measured against."""
    bb, c, t, h, wd = x.shape
    xr = x.double().reshape(bb, groups, c // groups, t, h * wd)
    mean = xr.mean(dim=(2, 4))[:, :, None]
    var = (xr * xr).mean(dim=(2, 4))[:, :, None] - mean * mean
    inv = torch.rsqrt(var.clamp_min(0) + eps)
    w64 = w.double().view(1, groups, -1, 1)
    a = inv * w64
    bc = b.double().view(1, groups, -1, 1) - mean * inv * w64
    return a.reshape(bb, c, t), bc.reshape(bb, c, t)


def k12_moments_error(got, fold, truth):
    """(max |got - truth|, its limit): twice `_fold`'s own distance from the
    fp64 truth plus 4 fp32 ulps of the truth's largest magnitude (the sums
    run in another order than torch's, so A and Bc move by fp32 ulps)."""
    err = (got.double() - truth).abs().max().item()
    ref = (fold.double() - truth).abs().max().item()
    _, e = torch.frexp(truth.abs().max().float())
    return err, 2 * ref + 4 * 2.0 ** (e.item() - 24)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,shift", [((1, 128, 3, 10, 16), 0.0),
                                         ((2, 64, 2, 7, 9), 0.0),
                                         ((2, 64, 3, 30, 40), 3.0)],
                         ids=["vector", "scalar", "shifted"])
def test_k12_kernel_matches_plain_on_gpu(cuda_device, shape, shift):
    """Fused norm + SiLU + head, its two kernels held apart and together:
    the apply kernel on the plain `_fold`'s (A, Bc) within one bf16 ulp of
    its plain version (sigmoid's expf may differ from torch's by an fp32
    ulp), its head frames equal to frame 0; the moments kernel's (A, Bc) no
    farther from fp64 moments than `k12_moments_error` allows; the whole
    K12 against the plain version: >= 99.9 % of elements within one ulp,
    none beyond 8, relative L2 <= 1e-3 (the moments' fp32 ulps move some y
    across a bf16 rounding boundary, up to ~4 ulps of silu(y) in its
    negative lobe), head frames exact. H*W a multiple of 8 (16-byte path)
    and not (scalar path); x = 3 + randn makes mean^2 cancel."""
    gen = torch.Generator(cuda_device).manual_seed(shape[1])
    x = (shift + torch.randn(shape, generator=gen, device=cuda_device)).to(
        torch.bfloat16)
    w = 1 + 0.1 * torch.randn(shape[1], generator=gen, device=cuda_device)
    b = 0.1 * torch.randn(shape[1], generator=gen, device=cuda_device)
    a, bc = tfn._fold(x, w, b, 32, 1e-6)
    out = tfn.norm_silu_apply(x, a, bc, 2)
    assert bf16_ulps(out, tfn.norm_silu_apply_plain(x, a, bc, 2)).max() <= 1
    for f in (0, 1):
        assert torch.equal(out[:, :, f], out[:, :, 2])

    truth = k12_moments_fp64(x, w, b, 32, 1e-6)
    for got, fold, want in zip(tfn.norm_moments(x, w, b, 32), (a, bc),
                               truth):
        err, limit = k12_moments_error(got, fold, want)
        assert err <= limit, (err, limit)

    before = tfn.norm_silu_head.launches
    out = tfn.norm_silu_head_ncdhw(x, w, b, 32)
    assert tfn.norm_silu_head.launches == before + 1
    ref = tfn.norm_silu_head_plain(x, w, b, 32)
    assert out.shape == ref.shape == (shape[0], shape[1], shape[2] + 2,
                                      *shape[3:])
    ulps = bf16_ulps(out, ref)
    assert (ulps <= 1).float().mean().item() >= 0.999
    assert ulps.max().item() <= 8
    rel = (out.float() - ref.float()).norm() / ref.float().norm()
    assert rel.item() <= 1e-3
    for f in (0, 1):
        assert torch.equal(out[:, :, f], out[:, :, 2])
    pub = tfn.norm_silu_head(x.permute(0, 2, 3, 4, 1), w, b, 32)
    assert torch.equal(pub, out.permute(0, 2, 3, 4, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 128, 3, 10, 16), (2, 64, 2, 7, 9),
                                   (1, 256, 2, 190, 180)],
                         ids=["vector", "scalar", "pieces"])
def test_k12_kernel_is_deterministic_on_gpu(cuda_device, shape):
    """The moments kernel sums its partials in piece order whichever block
    of a group finishes last: two runs are bit-identical (two pieces a
    plane in the last case); bf16 weights take the same path."""
    gen = torch.Generator(cuda_device).manual_seed(7)
    x = torch.randn(shape, generator=gen, device=cuda_device).to(
        torch.bfloat16)
    w = 1 + 0.1 * torch.randn(shape[1], generator=gen, device=cuda_device)
    b = 0.1 * torch.randn(shape[1], generator=gen, device=cuda_device)
    first = tfn.norm_silu_head_ncdhw(x, w, b, 32)
    assert torch.equal(first, tfn.norm_silu_head_ncdhw(x, w, b, 32))
    wb, bb = w.to(torch.bfloat16), b.to(torch.bfloat16)
    ka, kbc = tfn.norm_moments(x, wb, bb, 32)
    ra, rbc = tfn.norm_moments(x, wb.float(), bb.float(), 32)
    assert torch.equal(ka, ra) and torch.equal(kbc, rbc)
    with pytest.raises(ValueError):
        tfn.norm_silu_head_ncdhw(x, w.double(), b.double(), 32)


@pytest.mark.cuda
def test_vae_lanes_with_kernels_match_plain_on_gpu(cuda_device, monkeypatch):
    """A 128-channel VAE in bf16: the int8 decode (K11) and the fused-norm
    encode and decode (K12) with kernels against the same lowering with the
    plain versions: K11 is exact, K12 within an ulp, so bf16-class. The
    decoder's upsample takes its kernel on both sides (use_kernels off
    would give it the transposed conv, rounded elsewhere, whose flips the
    int8 levels spread), so only K11 and K12 differ."""
    from seedvr2_tpu_torch.core.configs import VAEConfig
    from seedvr2_tpu_torch.models.vae import model as tm
    from seedvr2_tpu_torch.models.vae.model import Lowering
    from seedvr2_tpu_torch.models.vae.pipeline_vae import (VideoVAE,
                                                           init_vae_params)

    cfg = VAEConfig(block_out_channels=(128, 128, 128, 128),
                    layers_per_block=1, latent_channels=4, conv_quant="int8")
    gen = torch.Generator(cuda_device).manual_seed(0)
    vae = VideoVAE(init_vae_params(cfg, cuda_device, generator=gen))
    z = torch.randn(1, 3, 8, 12, 4, generator=gen, device=cuda_device)
    x = torch.rand(1, 5, 32, 48, 3, generator=gen, device=cuda_device) * 2 - 1

    def run(lowering):
        vae.lowering = lowering
        return vae.decode(z).float(), vae.encode(x).float()

    monkeypatch.setattr(tm, "_upsample_kernel", lambda x, lowering: True)
    before = (tic.int8_conv3d.launches, tfn.norm_silu_head.launches)
    dec_k, enc_k = run(Lowering(fused_norm=True))
    assert tic.int8_conv3d.launches > before[0]
    assert tfn.norm_silu_head.launches > before[1]
    dec_p, enc_p = run(Lowering(fused_norm=True, use_kernels=False))
    for a, b in ((dec_k, dec_p), (enc_k, enc_p)):
        assert torch.isfinite(a).all()
        assert ((a - b).norm() / b.norm()).item() < 2e-2


# the decoder's upsamplers (Ci, C, T, H, W, tr): the 1080p clip's three
# (3B cell, 135 x 240 latent, 2 frames) and a 7B 568 x 1920 decode tile's
# three (T = 1: a still)
UPSAMPLE_SHAPES = [(512, 512, 2, 135, 240, 2), (512, 512, 3, 270, 480, 2),
                   (256, 256, 5, 540, 960, 1), (512, 512, 1, 71, 240, 2),
                   (512, 512, 1, 142, 480, 2), (256, 256, 1, 284, 960, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("first", [True, False], ids=["first", "later"])
@pytest.mark.parametrize("ci,c,t,h,w,tr", UPSAMPLE_SHAPES,
                         ids=[f"{s[0]}-{s[2]}x{s[3]}x{s[4]}"
                              for s in UPSAMPLE_SHAPES])
def test_upsample_kernel_matches_plain_on_gpu(cuda_device, ci, c, t, h, w,
                                              tr, first):
    """The upsample kernel against its plain version (fp32 sums and bias,
    rounded once to bf16) on the same bf16 operands, head frames included:
    a first slice (frame 0 repeated, frame 1 dropped at tr = 2) and a later
    one (a carried tail copied in front). Tolerance: both round one fp32
    value to bf16, summed in another order, so a value may land one bf16
    step away (at most 2^-7 of it); the fp32 sums of Ci products of unit
    size differ by far less than 1e-4 (atol, for values near 0)."""
    gen = torch.Generator(cuda_device).manual_seed(ci + t + h)
    x = torch.randn(1, ci, t, h, w, generator=gen, device=cuda_device).to(
        torch.bfloat16)
    wt = (torch.randn(4 * tr * c, ci, generator=gen, device=cuda_device)
          * ci ** -0.5).to(torch.bfloat16)
    bias = (0.1 * torch.randn(4 * tr * c, generator=gen,
                              device=cuda_device)).to(torch.bfloat16)
    drop = first and tr == 2
    head = None if first else torch.randn(
        1, c, 2, 2 * h, 2 * w, generator=gen, device=cuda_device).to(
            torch.bfloat16)
    before = tup.upsample_shuffle.launches
    out = tup.upsample_shuffle(x, wt, bias, tr, drop, 2, head)
    torch.cuda.synchronize()
    assert tup.upsample_shuffle.launches == before + 1
    ref = tup.upsample_shuffle_plain(x, wt, bias, tr, drop, 2, head)
    assert out.shape == ref.shape == (1, c, 2 + t * tr - drop, 2 * h, 2 * w)
    equal = 0
    for f in range(out.shape[2]):  # a frame at a time: 7 GB at 1080p
        a, b = out[:, :, f].float(), ref[:, :, f].float()
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=2 ** -7, atol=1e-4)
        equal += (a == b).sum().item()
    assert equal >= 0.99 * out.numel()


@pytest.mark.cuda
def test_upsample_kernel_shapes_and_refusals_on_gpu(cuda_device):
    """Widths that leave a row inside 4 positions (W % 4 != 0: 4-byte
    pair stores) and frames whose H * W is not a multiple of 8 (x padded
    for TMA), two batch elements, a non-contiguous x: equal to the plain
    version as above. fp32, or channels that are not multiples of 64,
    raise."""
    gen = torch.Generator(cuda_device).manual_seed(3)
    for b, ci, c, t, h, w, tr, drop in ((2, 128, 64, 3, 7, 9, 2, True),
                                        (1, 64, 128, 2, 5, 12, 1, False),
                                        (2, 192, 64, 1, 33, 70, 2, True)):
        x = torch.randn(b, ci, t, h, w + 1, generator=gen,
                        device=cuda_device).to(torch.bfloat16)[..., :w]
        wt = (torch.randn(4 * tr * c, ci, generator=gen, device=cuda_device)
              * ci ** -0.5).to(torch.bfloat16)
        bias = torch.randn(4 * tr * c, generator=gen,
                           device=cuda_device).to(torch.bfloat16)
        out = tup.upsample_shuffle(x, wt, bias, tr, drop, 2)
        ref = tup.upsample_shuffle_plain(x, wt, bias, tr, drop, 2)
        torch.testing.assert_close(out.float(), ref.float(), rtol=2 ** -7,
                                   atol=1e-4)
    x = torch.randn(1, 64, 1, 4, 8, device=cuda_device)
    wt = torch.randn(256, 64, device=cuda_device)
    with pytest.raises(ValueError):
        tup.upsample_shuffle(x, wt, wt[:, 0], 1)
    with pytest.raises(ValueError):
        tup.upsample_shuffle(x.bfloat16()[:, :48], wt[:, :48].bfloat16(),
                             wt[:, 0].bfloat16(), 1)


def _vae_v3(device, seed=0):
    from seedvr2_tpu_torch.core.configs import VAE_V3
    from seedvr2_tpu_torch.models.vae.pipeline_vae import (VideoVAE,
                                                           init_vae_params)

    gen = torch.Generator(device).manual_seed(seed)
    return VideoVAE(init_vae_params(VAE_V3, device, torch.bfloat16,
                                    generator=gen))


@pytest.mark.cuda
def test_upsample_kernel_launches_per_decode_on_gpu(cuda_device):
    """One 3B decode call (VAE_V3, one slice) launches the kernel once an
    upsampler, 3 in all, counted in the request record too. Against the
    plain form (use_kernels off), held as chip_smoke.py holds a VAE
    lowering against the default: within 5e-2 relative L2 (one rounding
    moved, then spread by every later bf16 rounding of a random decoder:
    0.024-0.026 on an H100), and no farther from the fp32 VAE than 1.5x
    the plain form is. An fp32 VAE with the kernels on raises in the
    kernel's wrapper."""
    import copy

    from seedvr2_tpu_torch.models.vae.pipeline_vae import VideoVAE
    from seedvr2_tpu_torch.utils import spans

    vae = _vae_v3(cuda_device)
    z = torch.randn(1, 2, 12, 16, 16, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(1))
    record = {}
    before = tup.upsample_shuffle.launches
    with spans.recording(record):
        out = vae.decode(z)
    assert tup.upsample_shuffle.launches - before == 3
    assert record["upsample_kernel_launches"] == 3
    assert "upsample_kernel_launches 3" in spans.format_record(record)
    vae.lowering = dataclasses.replace(vae.lowering, use_kernels=False)
    plain = vae.decode(z)
    truth = VideoVAE(copy.deepcopy(vae.model).float(), torch.float32)
    # the plain fp32 reference: the kernels take bf16 only
    truth.lowering = dataclasses.replace(truth.lowering, use_kernels=False)
    truth = truth.decode(z)
    assert _rel(out, plain) < 5e-2
    # a tensor the kernel cannot take raises: no silent plain form
    with pytest.raises(ValueError):
        VideoVAE(copy.deepcopy(vae.model).float(), torch.float32).decode(z)
    assert _rel(out, truth) <= 1.5 * _rel(plain, truth)


@pytest.mark.cuda
def test_upsample_kernel_decode_1080p_on_gpu(cuda_device):
    """The 1080p 5-frame clip's decode (VAE_V3, 2 x 135 x 240 latent):
    profiled, no cuDNN dgrad (transposed conv) kernel runs; its peak is no
    higher than the plain matmul + pixel-shuffle form's."""
    from torch.profiler import ProfilerActivity, profile

    vae = _vae_v3(cuda_device)
    z = torch.randn(1, 2, 135, 240, 16, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(2))
    vae.decode(z[:, :, :16, :16])  # libraries' workspaces
    peaks = {}
    for name, lowering in (
            ("kernel", vae.lowering),
            ("plain", dataclasses.replace(vae.lowering, use_kernels=False,
                                          upsample_convt=False))):
        vae.lowering = lowering
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(cuda_device)
        held = torch.cuda.memory_allocated(cuda_device)
        if name == "kernel":
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                out = vae.decode(z)
                torch.cuda.synchronize()
            names = [e.key for e in prof.key_averages()]
            assert any("upsample_shuffle_kernel" in n for n in names), names
            assert not any("dgrad" in n for n in names), names
        else:
            out = vae.decode(z)
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated(cuda_device) - held
        assert out.shape == (1, 5, 1080, 1920, 3)
        del out
    assert peaks["kernel"] <= peaks["plain"], peaks


def _attention_operands(gen, b, sq, h, d, device, sk=None):
    return [torch.randn(b, n, h, d, generator=gen, device=device).to(
        torch.bfloat16) for n in (sq, sk or sq, sk or sq)]


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk,d,rows,kv_len", [
    (463, None, 128, 463, 463),     # a uniform window's length, one table
    (200, None, 64, 150, 170),      # table shorter than S, masked keys
    (100, 300, 128, None, 250)],    # cross-attention without rope
    ids=["rope", "short_table", "cross"])
def test_k8_kernel_matches_plain_on_gpu(cuda_device, sq, sk, d, rows,
                                        kv_len):
    """Dense flash attention at S not a multiple of 64: bf16 outputs
    rounded at other points, the JAX package's kernel bound."""
    gen = torch.Generator(cuda_device).manual_seed(sq + d)
    q, k, v = _attention_operands(gen, 2, sq, 3, d, cuda_device, sk)
    cos = sin = None
    if rows is not None:
        ang = torch.randn(rows, d // 2, generator=gen, device=cuda_device)
        cos = torch.cos(ang).repeat_interleave(2, -1).contiguous()
        sin = torch.sin(ang).repeat_interleave(2, -1).contiguous()
    before = tfa.flash_attention.launches
    out = tfa.flash_attention(q, k, v, None, cos, sin, kv_len)
    assert tfa.flash_attention.launches == before + 1
    ref = tfa.flash_attention_plain(q, k, v, None, cos, sin, kv_len)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)
    with pytest.raises(ValueError):
        tfa.flash_attention(q.float(), k.float(), v.float(), kv_len=kv_len)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk,d,rows,kv_len", [
    (463, None, 128, 463, 400),     # Sq not a multiple of 64, masked keys
    (463, 700, 128, None, 650),     # Sq != Sk without rope
    (463, None, 128, 300, 463),     # rows past table_rows unrotated
    (300, None, 128, None, 1),      # one valid key: 4 of 5 tiles skipped
    (200, 500, 64, None, 64)],      # exactly one key tile, D = 64
    ids=["sq463_table", "sq463_cross", "short_table", "kv1", "kv64_d64"])
def test_k8_kernel_edges_on_gpu(cuda_device, sq, sk, d, rows, kv_len):
    """The Hopper step's edges in K8's dense form: TMA zero fill past S,
    clipped stores past Sq, key tiles wholly past kv_len never loaded."""
    gen = torch.Generator(cuda_device).manual_seed(sq + kv_len)
    q, k, v = _attention_operands(gen, 3, sq, 2, d, cuda_device, sk)
    cos = sin = None
    if rows is not None:
        ang = torch.randn(rows, d // 2, generator=gen, device=cuda_device)
        cos = torch.cos(ang).repeat_interleave(2, -1).contiguous()
        sin = torch.sin(ang).repeat_interleave(2, -1).contiguous()
    before = tfa.flash_attention.launches
    out = tfa.flash_attention(q, k, v, None, cos, sin, kv_len)
    assert tfa.flash_attention.launches == before + 1
    ref = tfa.flash_attention_plain(q, k, v, None, cos, sin, kv_len)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)


def _k9_valid(pattern, s, device):
    """Three windows' key validity (nU = 3, every window's last key valid,
    as the text tail always is):
     - front_back: id 0's first 216 keys invalid (its first three key tiles
       hold no valid key, as a front-clipped shifted window's pad slots come
       first), id 1's last 30, id 2 all valid;
     - text_tail: id 0's only valid keys are its last 58 (the text rows),
       id 1's the last 58 and key 0, id 2 a random 70 %;
     - middle: pads inside the window, not at its ends: id 0 its middle
       half, id 1 every other 16 keys, id 2 the whole second key tile."""
    valid = torch.ones(3, s, dtype=torch.bool)
    if pattern == "front_back":
        valid[0, :min(216, s - 10)] = False
        valid[1, -30:] = False
    elif pattern == "text_tail":
        tail = min(58, s // 2)
        valid[0, :-tail] = False
        valid[1, 1:-tail] = False
        valid[2] = torch.from_numpy(
            np.random.default_rng(s).random(s) < 0.7)
    else:
        valid[0, s // 4:3 * s // 4] = False
        valid[1] = (torch.arange(s) // 16) % 2 == 0
        valid[2, 64:128] = False
    valid[:, -1] = True
    return valid.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["front_back", "text_tail", "middle"])
@pytest.mark.parametrize("s,d", [(463, 128), (75, 64), (463, 64), (75, 128)])
def test_k9_kernel_matches_plain_on_gpu(cuda_device, s, d, pattern):
    """Windowed attention on the Hopper step with its key-tile list, every
    id used: wholly masked key tiles skipped, partly masked ones masked on
    the scores (_k9_valid), S not a multiple of 64, D = 64 and 128; no NaN,
    bf16-class agreement."""
    gen = torch.Generator(cuda_device).manual_seed(s)
    q, k, v = _attention_operands(gen, 6, s, 3, d, cuda_device)
    ang = torch.randn(3, s, d // 2, generator=gen, device=cuda_device)
    cos = torch.cos(ang).repeat_interleave(2, -1).contiguous()
    sin = torch.sin(ang).repeat_interleave(2, -1).contiguous()
    valid = _k9_valid(pattern, s, cuda_device)
    ids = tg.RowIndex(np.array([0, 1, 2, 2, 1, 0]), cuda_device)
    before = tfa.flash_windowed_attention.launches
    out = tfa.flash_windowed_attention(q, k, v, None, cos, sin, ids, valid)
    assert tfa.flash_windowed_attention.launches == before + 1
    ref = tfa.flash_windowed_attention_plain(q, k, v, None, cos, sin, ids,
                                             valid)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)
    with pytest.raises(ValueError):
        tfa.flash_windowed_attention(q, k, v, None, cos, sin, ids,
                                     valid.to(torch.uint8))


@pytest.mark.cuda
def test_k9_kernel_window_without_valid_keys_on_gpu(cuda_device):
    """A window whose validity row marks no key has no live key tile: the
    step walks none and writes zeros, the TPU kernel's 0 / max(0, 1e-30)
    (the plain composition's softmax over only -inf logits is NaN there);
    the other windows of the call are unaffected."""
    gen = torch.Generator(cuda_device).manual_seed(5)
    s, d = 200, 128
    q, k, v = _attention_operands(gen, 3, s, 2, d, cuda_device)
    ang = torch.randn(2, s, d // 2, generator=gen, device=cuda_device)
    cos = torch.cos(ang).repeat_interleave(2, -1).contiguous()
    sin = torch.sin(ang).repeat_interleave(2, -1).contiguous()
    valid = torch.ones(2, s, dtype=torch.bool, device=cuda_device)
    valid[1] = False
    ids = tg.RowIndex(np.array([0, 1, 0]), cuda_device)
    out = tfa.flash_windowed_attention(q, k, v, None, cos, sin, ids, valid)
    ref = tfa.flash_windowed_attention_plain(q, k, v, None, cos, sin, ids,
                                             valid)
    assert torch.equal(out[1], torch.zeros_like(out[1]))
    keep = torch.tensor([0, 2], device=cuda_device)
    torch.testing.assert_close(out[keep].float(), ref[keep].float(),
                               atol=2e-2, rtol=2e-2)


def _k9_train_case(case, device):
    """K9's training-path operands: "record" is the 720p clip's shifted
    layer (32 windows of S = 463, its 9 ids' real tables and validity, H =
    20, D = 128); a _k9_valid pattern is 6 windows of S = 463 or 140 over
    3 ids with random tables (front_back: dead key tiles; middle: a dead
    tile and partly valid ones), H = 4. Returns (q, k, v, cos, sin, ids,
    valid, dout), dout zero at each window's invalid slots (the rows the
    DiT crops)."""
    gen = torch.Generator(device).manual_seed(len(case))
    if case == "record":
        from seedvr2_tpu_torch.core.configs import DIT_3B
        from seedvr2_tpu_torch.models.dit import nadit

        u = nadit.build_dit_plan(DIT_3B, (2, 90, 160), 58,
                                 uniform=True).uniform["shifted_window"]
        cos, sin, valid = (torch.from_numpy(a).to(device)
                           for a in (u.cos, u.sin, u.valid))
        ids, h = u.ids, 20
    else:
        pattern, s = case.split("-")
        s = int(s)
        ang = torch.randn(3, s, 64, generator=gen, device=device)
        cos = torch.cos(ang).repeat_interleave(2, -1).contiguous()
        sin = torch.sin(ang).repeat_interleave(2, -1).contiguous()
        valid = _k9_valid(pattern, s, device)
        ids, h = np.array([0, 1, 2, 2, 1, 0]), 4
    b, s = len(ids), valid.shape[1]
    q, k, v, dout = (torch.randn(b, s, h, 128, generator=gen,
                                 device=device).to(torch.bfloat16)
                     for _ in range(4))
    index = tg.RowIndex(ids, device)
    dout[~valid[index.tensor.long()]] = 0
    return q, k, v, cos, sin, index, valid, dout


_K9_CASES = ["record", "front_back-463", "middle-140"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", _K9_CASES)
def test_k9_lse_launch_on_gpu(cuda_device, case):
    """K9's training launch: its output bit-equal to the serving launch's
    on the same inputs, its lse within 1e-5 relative L2 of the plain
    version's (the same bf16 q-hat and k-hat, fp32 sums in another order),
    both launches counted."""
    q, k, v, cos, sin, ids, valid, _ = _k9_train_case(case, cuda_device)
    before = (tfa.flash_windowed_attention.launches,
              tfa.flash_windowed_attention.launches_lse)
    out, lse = tfa.flash_windowed_attention_lse(q, k, v, None, cos, sin, ids,
                                                valid)
    served = tfa.flash_windowed_attention(q, k, v, None, cos, sin, ids, valid)
    torch.cuda.synchronize()
    _, p_lse = tfa.flash_windowed_attention_lse_plain(q, k, v, None, cos, sin,
                                                      ids, valid)
    assert lse.shape == (q.shape[0], q.shape[2], q.shape[1])
    assert torch.isfinite(lse).all() and _rel(lse, p_lse) <= 1e-5
    assert torch.equal(out, served)
    assert (tfa.flash_windowed_attention.launches,
            tfa.flash_windowed_attention.launches_lse) == (before[0] + 2,
                                                           before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("case", _K9_CASES)
def test_k9_backward_parts_on_gpu(cuda_device, case):
    """Each part of K9's backward against its plain version on the same
    inputs, lse from K9's training launch (chip_smoke.py's BWD bounds, as
    K1's: delta 1e-5, dv and the rope backward's bf16 outputs 1e-3, dq-hat
    and dk-hat DQDK_REL), the whole against its plain version (bf16-class
    2e-2); every masked key's dk and dv zero; reruns bit-equal."""
    q, k, v, cos, sin, ids, valid, dout = _k9_train_case(case, cuda_device)
    d = q.shape[-1]
    out, lse = tfa.flash_windowed_attention_lse(q, k, v, None, cos, sin, ids,
                                                valid)
    qh, kh = tfa.attention_prepass(q, k, cos, sin, cos, sin, None,
                                   d ** -0.5 * tfa._LOG2E, ids)
    counts = [f.launches for f in (tfa.windowed_backward_dq,
                                   tfa.windowed_backward_dkdv,
                                   tfa.windowed_rope_backward)]
    dq, delta = tfa.windowed_backward_dq(qh, kh, v, out, dout, lse, valid,
                                         ids)
    dk, dv = tfa.windowed_backward_dkdv(qh, kh, v, dout, lse, delta, valid,
                                        ids)
    rq, rk = tfa.windowed_rope_backward(dq, dk, cos, sin, ids, d ** -0.5,
                                        tfa._LN2)
    whole = tfa.flash_windowed_attention_backward(q, k, v, None, cos, sin, ids,
                                                  valid, out, dout, lse)
    again = tfa.flash_windowed_attention_backward(q, k, v, None, cos, sin, ids,
                                                  valid, out, dout, lse)
    torch.cuda.synchronize()
    assert [f.launches for f in (tfa.windowed_backward_dq,
                                 tfa.windowed_backward_dkdv,
                                 tfa.windowed_rope_backward)] == [
        c + 3 for c in counts]
    p_dq, p_delta = tfa.windowed_backward_dq_plain(qh, kh, v, out, dout, lse,
                                                   valid, ids)
    p_dk, p_dv = tfa.windowed_backward_dkdv_plain(qh, kh, v, dout, lse, delta,
                                                  valid, ids)
    p_rq, p_rk = tfa.windowed_rope_backward_plain(dq, dk, cos, sin, ids,
                                                  d ** -0.5, tfa._LN2)
    p_whole = tfa.flash_windowed_attention_backward_plain(
        q, k, v, None, cos, sin, ids, valid, out, dout)
    assert _rel(delta, p_delta) <= 1e-5
    assert _rel(dq, p_dq) <= DQDK_REL and _rel(dk, p_dk) <= DQDK_REL
    assert _rel(dv, p_dv) <= 1e-3
    assert _rel(rq, p_rq) <= 1e-3 and _rel(rk, p_rk) <= 1e-3
    for t, r in zip(whole, p_whole):
        assert torch.isfinite(t).all() and _rel(t, r) <= 2e-2
    assert all(torch.equal(t, r) for t, r in zip(whole, again))
    masked = ~valid[ids.tensor.long()]
    assert not dk[masked].any() and not dv[masked].any()
    assert not whole[1][masked].any() and not whole[2][masked].any()


@pytest.mark.cuda
def test_k9_function_on_gpu(cuda_device):
    """K9's autograd Function on the card: an output with a grad_fn from
    the training launch, dq, dk and dv within the bf16 class of torch
    autograd through the plain composition, each backward part launched
    once; the raw wrapper refuses an input that needs a gradient."""
    q, k, v, cos, sin, ids, valid, dout = _k9_train_case("middle-140",
                                                         cuda_device)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    with pytest.raises(RuntimeError, match="needs a gradient"):
        tfa.flash_windowed_attention(q, k, v, None, cos, sin, ids, valid)
    before = (tfa.windowed_backward_dkdv.launches,
              tfa.flash_windowed_attention.launches_lse)
    out = tfa.flash_windowed_attention_grad(q, k, v, None, cos, sin, ids,
                                            valid)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (q, k, v), dout)
    ref = torch.autograd.grad(tfa.flash_windowed_attention_plain(
        q, k, v, None, cos, sin, ids, valid), (q, k, v), dout)
    assert (tfa.windowed_backward_dkdv.launches,
            tfa.flash_windowed_attention.launches_lse) == (before[0] + 1,
                                                           before[1] + 1)
    for g, r in zip(got, ref):
        assert _rel(g, r) <= 2e-2


@pytest.mark.cuda
def test_uniform_train_steps_on_gpu(cuda_device):
    """Two bf16 AdamW steps of a small DiT (D = 64 heads) on the uniform
    window plan through K9 and its backward against the same steps through
    the plain versions: losses within 1e-2 relative, every first moment
    finite and nonzero, no K1 or K2 launch."""
    from seedvr2_tpu_torch.core.configs import small_test_config
    from seedvr2_tpu_torch.models.dit import nadit
    from seedvr2_tpu_torch.parallel import train

    cfg = small_test_config(vid_dim=128, heads=2, head_dim=64)
    plan = nadit.build_dit_plan(cfg, (1, 16, 16), 7, uniform=True)
    gen = torch.Generator(cuda_device).manual_seed(0)
    model = nadit.init_dit(cfg, cuda_device, torch.float32, gen)
    batch = {"latent": torch.randn(2, 1, 16, 16, 16, device=cuda_device),
             "cond": torch.randn(2, 1, 16, 16, 17, device=cuda_device),
             "txt": torch.randn(2, 7, cfg.txt_in_dim, device=cuda_device)}
    losses = {}
    for uk in (True, False):
        init_state, step = train.make_train_step(cfg, plan, None,
                                                 device=cuda_device,
                                                 use_kernels=uk)
        state = init_state(model)
        before = (tfa.packed_window_attention.launches,
                  tfa.windowed_backward_dq.launches)
        losses[uk] = []
        for i in range(2):
            state, loss = step(state, batch,
                               torch.Generator(cuda_device).manual_seed(i))
            losses[uk].append(loss.item())
        dq_launches = tfa.windowed_backward_dq.launches - before[1]
        assert tfa.packed_window_attention.launches == before[0]
        assert dq_launches == (2 * cfg.num_layers if uk else 0)
        assert all(torch.isfinite(m).all() and m.abs().sum() > 0
                   for m in state.opt_state["mu"].values())
    for a, r in zip(losses[True], losses[False]):
        assert abs(a - r) <= 1e-2 * abs(r)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k,x_dtype,out_dtype", [
    (1, 2560, 2560, torch.bfloat16, torch.bfloat16),
    (58, 512, 6912, torch.bfloat16, torch.float32),
    (300, 384, 96, torch.float32, torch.float32),
    (7200, 7680, 2560, torch.bfloat16, torch.bfloat16),
    (16320, 2560, 2560, torch.bfloat16, torch.bfloat16),
    (63, 8, 32, torch.bfloat16, torch.bfloat16),
    (64, 264, 96, torch.float32, torch.bfloat16),
    (65, 2560, 32, torch.bfloat16, torch.float32),
    (58, 7680, 2560, torch.float32, torch.float32),
    (1, 8, 6912, torch.float32, torch.bfloat16),
    (7200, 264, 6912, torch.bfloat16, torch.bfloat16)])
def test_k10_kernel_exact_on_gpu(cuda_device, m, n, k, x_dtype, out_dtype):
    """Quantizing int8 GEMM: the same reciprocal quantization, exact int32
    sums and the same epilogue order, so equal to the plain version bit for
    bit: M = 1, 58, 63, 64 (the swapped tiles of 8 and 64 tokens), 65, 300,
    7200, 16320 (128 x 256 tiles, ragged M); N = 8 and ragged N (264, 384:
    a part of a 256-row tile); K = 32, 96 (K % 128 != 0), 2560, 6912;
    fp32 activations and fp32 output."""
    gen = torch.Generator(cuda_device).manual_seed(m + k)
    x = (3 * torch.randn(m, k, generator=gen, device=cuda_device)).to(x_dtype)
    wq = torch.randint(-127, 128, (n, k), generator=gen, device=cuda_device,
                       dtype=torch.int8)
    ws = torch.rand(n, generator=gen, device=cuda_device) * 0.01
    before = tim.int8_matmul_qx.launches
    out = tim.int8_matmul_qx(x, wq, ws, out_dtype=out_dtype)
    assert tim.int8_matmul_qx.launches == before + 1
    assert out.dtype == out_dtype
    assert torch.equal(out, tim.int8_matmul_qx_plain(x, wq, ws, out_dtype))
    with pytest.raises(ValueError):
        tim.int8_matmul_qx(x.half(), wq, ws)


@pytest.mark.cuda
@pytest.mark.parametrize("w8a8", [False, True], ids=["bf16", "w8a8"])
def test_uniform_dit_with_kernels_matches_plain_on_gpu(cuda_device, w8a8):
    """The 2-layer width-256 NaDiT on the uniform plan: K9 once a block and
    no K1 or K2; kernels against plain versions and against the grouped
    plan, bounded as the dense model above."""
    from seedvr2_tpu_torch.core.configs import small_test_config
    from seedvr2_tpu_torch.models.dit import nadit

    cfg = small_test_config(vid_dim=256, heads=2, head_dim=128)
    gen = torch.Generator(cuda_device).manual_seed(0)
    model = nadit.init_dit(cfg, cuda_device, torch.bfloat16, generator=gen)
    if w8a8:
        model = tim.quantize_dit_w8a8(model, 256)
    shape, txt_len = (2, 18, 32), 58
    plans = {u: nadit.upload_plan(nadit.build_dit_plan(cfg, shape, txt_len,
                                                       uniform=u),
                                  cfg, cuda_device) for u in (True, False)}
    vid = torch.randn(1, *shape, cfg.vid_in_channels, generator=gen,
                      device=cuda_device).to(torch.bfloat16)
    txt = torch.randn(1, txt_len, cfg.txt_in_dim, generator=gen,
                      device=cuda_device).to(torch.bfloat16)
    t = torch.full((1,), 1000.0, device=cuda_device)
    wrappers = (tfa.flash_windowed_attention, tfa.packed_window_attention,
                tg.gather_rows)
    before = [w.launches for w in wrappers]
    with torch.no_grad():
        k = nadit.nadit_forward(model, vid, txt, t, plans[True]).float()
        launched = [w.launches - b for w, b in zip(wrappers, before)]
        p = nadit.nadit_forward(model, vid, txt, t, plans[True],
                                use_kernels=False).float()
        g = nadit.nadit_forward(model, vid, txt, t, plans[False]).float()
    assert launched == [cfg.num_layers, 0, 0]
    assert torch.isfinite(k).all()
    assert ((k - p).norm() / p.norm()).item() < 2e-2
    assert ((k - g).norm() / g.norm()).item() < 2e-2


# ------------------------------------------------------------ 7B widths
# The 7B family's shapes (D = 3072, 24 heads of 128, MLP 3072 -> 12288 with
# bias) on the kernels of its lanes, at the 720p clip's (2 x 90 x 160
# latent, 7200 tokens) and the 1080p clip's (2 x 136 x 240, 16320 tokens)
# plans; the bounds are the 3B cases' above.
LAT_7B = {"720p": (2, 90, 160), "1080p": (2, 136, 240)}


def _plan_7b(latent):
    from seedvr2_tpu_torch.core.configs import DIT_7B
    from seedvr2_tpu_torch.models.dit import nadit

    return DIT_7B, nadit, nadit.build_dit_plan(DIT_7B, latent, 58)


@pytest.mark.cuda
@pytest.mark.parametrize("clip", list(LAT_7B))
def test_k1_kernel_7b_tables_on_gpu(cuda_device, clip):
    """K1 at H = 24 on the 7B's largest window group of the clip's plan:
    its rope3d tables (text rows identity) with qk-norm weights folded in
    as the forward folds them, four windows of the group."""
    cfg, nadit, plan = _plan_7b(LAT_7B[clip])
    dplan = nadit.upload_plan(plan, cfg, cuda_device)
    g = max(dplan.groups["window"], key=lambda g: g.wlen)
    gen = torch.Generator(cuda_device).manual_seed(g.wlen)
    wts = [1 + 0.1 * torch.randn(cfg.head_dim, generator=gen,
                                 device=cuda_device) for _ in range(4)]
    tabs = nadit._fold_norm_tables(g.cos, g.sin, *wts, g.wlen, g.skv)
    h, d = cfg.heads, cfg.head_dim
    qkv = torch.randn(4, g.sk_pad, 3 * h * d, generator=gen,
                      device=cuda_device).to(torch.bfloat16)
    before = tfa.packed_window_attention.launches
    out = tfa.packed_window_attention(qkv, h, d, *tabs, 1e-5, g.skv)
    assert tfa.packed_window_attention.launches == before + 1
    ref = tfa.packed_window_attention_plain(qkv, h, d, *tabs, 1e-5, g.skv)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("clip", list(LAT_7B))
def test_k2_kernel_7b_width_on_gpu(cuda_device, clip):
    """K2 at D = 3072 on the clip plan's window -> shifted transition."""
    cfg, nadit, plan = _plan_7b(LAT_7B[clip])
    idx = plan.transitions[("window", "shifted_window")]
    gen = torch.Generator(cuda_device).manual_seed(len(idx))
    x = torch.randn(1, plan.seq_len, cfg.vid_dim, generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    index = tg.RowIndex(idx, cuda_device)
    assert torch.equal(tg.gather_rows(x, index), tg.gather_rows_plain(x, index))


# the 7B's converted products (N, K) at the token counts of its requests
PRODUCTS_7B = [(16320, 9216, 3072), (16320, 3072, 3072),
               (16320, 12288, 3072), (16320, 3072, 12288),
               (7200, 3072, 12288), (58, 9216, 3072), (58, 3072, 12288),
               (1, 3072, 3072), (1, 18432, 3072)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", PRODUCTS_7B)
def test_k3_kernel_exact_7b_on_gpu(cuda_device, m, n, k):
    gen = torch.Generator(cuda_device).manual_seed(m + n + k)
    xq = torch.randint(-127, 128, (m, k), generator=gen, device=cuda_device,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (n, k), generator=gen, device=cuda_device,
                       dtype=torch.int8)
    xs = torch.rand(m, generator=gen, device=cuda_device) * 0.01
    ws = torch.rand(n, generator=gen, device=cuda_device) * 0.01
    assert torch.equal(tim.int8_matmul(xq, wq, xs, ws),
                       tim.int8_matmul_plain(xq, wq, xs, ws))


@pytest.mark.cuda
@pytest.mark.parametrize("b,l", [(1, 16320), (1, 7200), (1, 58), (1, 1)])
def test_k4_kernel_7b_width_on_gpu(cuda_device, b, l):
    gen = torch.Generator(cuda_device).manual_seed(l)
    x = torch.randn(b, l, 3072, generator=gen, device=cuda_device).to(
        torch.bfloat16)
    scale = 1 + 0.1 * torch.randn(b, 3072, generator=gen, device=cuda_device)
    shift = 0.1 * torch.randn(b, 3072, generator=gen, device=cuda_device)
    _q_close(tfq.rms_ada_quantize(x, scale, shift, 1e-5),
             tfq.rms_ada_quantize_plain(x, scale, shift, 1e-5))


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", PRODUCTS_7B)
def test_k6_kernel_7b_on_gpu(cuda_device, m, n, k):
    gen = torch.Generator(cuda_device).manual_seed(m + n + k)
    x, q, s = _q8_case(gen, m, n, k, cuda_device)
    out = tqm.quant_matmul_q8(x, q, s)
    assert torch.isfinite(out).all()
    assert bf16_ulps(out, tqm.quant_matmul_q8_plain(x, q, s)).max().item() \
        <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", PRODUCTS_7B)
def test_k7_kernel_7b_on_gpu(cuda_device, m, n, k):
    """K = 12288 is K7's longest group-sum pre-pass on a served path."""
    gen = torch.Generator(cuda_device).manual_seed(m + n + k)
    x = torch.randn(m, k, generator=gen, device=cuda_device).to(
        torch.bfloat16)
    q = torch.randint(0, 16, (n, k), generator=gen, device=cuda_device,
                      dtype=torch.int8)
    s = torch.rand(n, k // 32, generator=gen, device=cuda_device) * 0.04 / 15
    mn = torch.rand(n, k // 32, generator=gen, device=cuda_device) * 0.02
    out = tqm.quant_matmul_affine(x, q, s, mn)
    ref = tqm.quant_matmul_affine_plain(x, q, s, mn)
    assert torch.isfinite(out).all()
    assert (bf16_ulps(out, ref) <= 1).float().mean().item() >= 0.999
    rel = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
    assert rel <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("clip", list(LAT_7B))
def test_k9_kernel_7b_uniform_layer_on_gpu(cuda_device, clip):
    """K9 at H = 24 on the 7B's shifted uniform layer of the clip: its
    per-window rope3d tables and key masks, two batch rows of windows."""
    from seedvr2_tpu_torch.core.configs import DIT_7B
    from seedvr2_tpu_torch.models.dit import nadit

    plan = nadit.build_dit_plan(DIT_7B, LAT_7B[clip], 58, uniform=True)
    u = nadit.upload_plan(plan, DIT_7B, cuda_device).uniform["shifted_window"]
    n_w, s = len(u.ids), u.cos.shape[1]
    gen = torch.Generator(cuda_device).manual_seed(s)
    q, k, v = _attention_operands(gen, 2 * n_w, s, DIT_7B.heads,
                                  DIT_7B.head_dim, cuda_device)
    ids = u.batch_ids(2)
    out = tfa.flash_windowed_attention(q, k, v, None, u.cos, u.sin, ids,
                                       u.valid)
    ref = tfa.flash_windowed_attention_plain(q, k, v, None, u.cos, u.sin, ids,
                                             u.valid)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("lane", ["bf16", "w8a8", "q8", "q4"])
def test_7b_dit_with_kernels_matches_plain_on_gpu(cuda_device, lane):
    """A 2-layer width-256 7B-family NaDiT (plain MLP with biases, unshared
    qk norms, rope3d) in each lane: the kernels of the lane launched and
    held to their plain versions as the 3B model above."""
    from seedvr2_tpu_torch.core.configs import small_test_config
    from seedvr2_tpu_torch.models.dit import nadit

    cfg = small_test_config(family="dit_7b", vid_dim=256, heads=2,
                            head_dim=128)
    gen = torch.Generator(cuda_device).manual_seed(1)
    model = nadit.init_dit(cfg, cuda_device, torch.bfloat16, generator=gen)
    convert = {"bf16": lambda m: m,
               "w8a8": lambda m: tim.quantize_dit_w8a8(m, 256),
               "q8": lambda m: tqm.quantize_dit_q8(m, 256),
               "q4": lambda m: tqm.quantize_dit_affine4(m, 256)}
    model = convert[lane](model)
    wrappers = {"bf16": [tfa.packed_window_attention, tg.gather_rows],
                "w8a8": [tim.int8_matmul, tfq.rms_ada_quantize],
                "q8": [tqm.quant_matmul_q8], "q4": [tqm.quant_matmul_affine]}
    shape, txt_len = (2, 18, 32), 58
    dplan = nadit.upload_plan(nadit.build_dit_plan(cfg, shape, txt_len), cfg,
                              cuda_device)
    vid = torch.randn(1, *shape, cfg.vid_in_channels, generator=gen,
                      device=cuda_device).to(torch.bfloat16)
    txt = torch.randn(1, txt_len, cfg.txt_in_dim, generator=gen,
                      device=cuda_device).to(torch.bfloat16)
    t = torch.full((1,), 1000.0, device=cuda_device)
    before = [w.launches for w in wrappers[lane]]
    k5 = tfq.silu_mul_quantize.launches
    with torch.no_grad():
        k = nadit.nadit_forward(model, vid, txt, t, dplan).float()
        assert all(w.launches > b for w, b in zip(wrappers[lane], before))
        assert tfq.silu_mul_quantize.launches == k5  # no gate in a 7B MLP
        p = nadit.nadit_forward(model, vid, txt, t, dplan,
                                use_kernels=False).float()
    assert torch.isfinite(k).all()
    assert ((k - p).norm() / p.norm()).item() < 2e-2


# ------------------------------------------- colour methods and alpha


@pytest.fixture
def cuda_default_tf32():
    """A GPU with TF32 at torch's defaults (cuDNN convolutions may use it,
    matmuls not): the colour and alpha functions must not depend on it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; chip_smoke.py runs the colour "
                    "methods and alpha on the card")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _colour_pair(seed, shape=(5, 48, 64, 3)):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, shape).astype(np.float32)
    b = np.clip(rng.uniform(-1, 1, shape) * 0.8 + 0.1, -1, 1).astype(
        np.float32)
    return torch.from_numpy(a), torch.from_numpy(b)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["lab", "wavelet", "wavelet_adaptive",
                                    "hsv", "adain"])
def test_colour_method_on_gpu_matches_cpu(cuda_default_tf32, method):
    """The same fp32 function on the card and on the CPU. adain and wavelet:
    reductions and fused multiply-adds in another order, within 1e-5. lab:
    a pow that differs by an ulp can swap two ranks (the CPU tests' lab
    allowance). hsv and wavelet_adaptive: a value moved across a hue or CDF
    bin edge takes another mapping: at most 0.1 % of values beyond 1e-4."""
    from seedvr2_tpu_torch.utils import color_fix as tcf

    a, b = _colour_pair(0)
    cpu = tcf.apply_color_correction(method, a, b)
    gpu = tcf.apply_color_correction(method, a.to(cuda_default_tf32),
                                     b.to(cuda_default_tf32)).cpu()
    diff = (gpu - cpu).abs()
    if method in ("adain", "wavelet"):
        assert diff.max().item() <= 1e-5
    elif method == "lab":
        assert diff.max().item() < 1e-2
        assert (diff > 1e-4).float().mean().item() < 1e-3
    else:
        assert (diff > 1e-4).float().mean().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("soft", [False, True])
def test_alpha_on_gpu_matches_cpu(cuda_default_tf32, soft):
    """process_alpha_for_batch on the card against the CPU, binary and
    gradient paths: the same fp32 arithmetic in another order, within 1e-5
    but where a binary-path threshold flips (at most 0.1 % of pixels)."""
    from seedvr2_tpu_torch.core import alpha as ta

    rng = np.random.default_rng(1)
    rgb = torch.from_numpy(rng.uniform(-1, 1, (3, 64, 96, 3)).astype(
        np.float32))
    yy, xx = np.mgrid[:32, :48]
    alpha = ((yy - 16) ** 2 + (xx - 24) ** 2 < 100).astype(np.float32)
    if soft:
        alpha = alpha * 0.5 + xx / 188.0
    alpha = np.repeat(alpha[None, :, :, None], 5, 0).astype(np.float32)
    cpu = ta.process_alpha_for_batch(rgb, alpha)
    gpu = ta.process_alpha_for_batch(rgb.to(cuda_default_tf32), alpha)
    assert gpu.device.type == "cuda"
    diff = (gpu.cpu() - cpu).abs()
    assert (diff > 1e-5).float().mean().item() <= 1e-3


def _legacy_vae(device, conv_quant="none", seed=0):
    """The legacy family (conv2 (1, 3, 3), no mid attention, both quant
    convs) at 128 channels, bf16, random from a seed on the CPU, so the
    card and the CPU hold the same weights."""
    from seedvr2_tpu_torch.core.configs import VAEConfig
    from seedvr2_tpu_torch.models.vae.pipeline_vae import (VideoVAE,
                                                           init_vae_params)

    cfg = VAEConfig(block_out_channels=(128, 128, 128, 128),
                    layers_per_block=1, latent_channels=4,
                    time_receptive_field="half", mid_attention=False,
                    use_quant_conv=True, use_post_quant_conv=True,
                    conv_quant=conv_quant)
    gen = torch.Generator().manual_seed(seed)
    model = init_vae_params(cfg, "cpu", torch.bfloat16, generator=gen)
    return VideoVAE(model.to(device), torch.bfloat16)


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@pytest.mark.cuda
def test_legacy_vae_on_gpu_matches_cpu(cuda_device, monkeypatch):
    """The legacy VAE in bf16 on the card against the same VAE on the CPU:
    default and SEEDVR2_FUSED_NORM=1 (K12 on the card, its plain version on
    the CPU) encode / decode within the bf16 class (relative L2 < 2e-2,
    convs summed in other orders); K12 runs on 3-deep convs only."""
    from seedvr2_tpu_torch.models.vae import model as tm

    gen = torch.Generator().manual_seed(1)
    z = torch.randn(1, 3, 8, 12, 4, generator=gen)
    x = torch.rand(1, 5, 32, 48, 3, generator=gen) * 2 - 1
    for fused in ("0", "1"):
        monkeypatch.setenv("SEEDVR2_FUSED_NORM", fused)
        card, cpu = _legacy_vae(cuda_device), _legacy_vae("cpu")
        kts = []
        real = tm.causal_conv3d
        monkeypatch.setattr(tm, "causal_conv3d", lambda conv, *a, **k: (
            k.get("pre_extended") and kts.append(conv.weight.shape[2]),
            real(conv, *a, **k))[1])
        before = tfn.norm_silu_head.launches
        dec = card.decode(z.to(cuda_device))
        enc = card.encode(x.to(cuda_device))
        launched = tfn.norm_silu_head.launches - before
        assert (launched > 0) == (fused == "1")
        assert set(kts) <= {3} and len(kts) >= launched
        monkeypatch.setattr(tm, "causal_conv3d", real)
        assert _rel(dec.cpu(), cpu.decode(z)) < 2e-2
        assert _rel(enc.cpu(), cpu.encode(x)) < 2e-2


@pytest.mark.cuda
def test_legacy_int8_vae_on_gpu_matches_cpu(cuda_device, monkeypatch):
    """The legacy VAE under --vae_quant int8: K11 serves each decoder
    conv1 once a slice and no (1, 3, 3) conv2; the card's decode with K11
    against its plain versions on the card (K11 exact: bf16 class; the
    upsample kernel on both sides, as in the test above); and
    every int8 layer the card ran, rerun on the CPU (plain K11) on the
    same input and carried head, within relative L2 5e-3 (the group-norm
    moments summed in another order flip a few int8 steps; the whole
    decode amplifies such flips, so it is held layer by layer)."""
    from seedvr2_tpu_torch.models.vae import model as tm
    from seedvr2_tpu_torch.models.vae.pipeline_vae import int8_served_convs

    card, cpu = (_legacy_vae(d, "int8") for d in (cuda_device, "cpu"))
    served = dict(int8_served_convs(card.model))
    assert served and all(p.endswith(".conv1") for p in served)
    calls, lane = [], tm._int8_norm_silu_conv

    def recorded(norm, conv, path, x, state, new_state, use_kernels):
        head = None if state is None else state.get(path)
        out = lane(norm, conv, path, x, state, new_state, use_kernels)
        if use_kernels:
            calls.append((path, x, head, out))
        return out

    monkeypatch.setattr(tm, "_int8_norm_silu_conv", recorded)
    z = torch.randn(1, 3, 8, 12, 4, generator=torch.Generator().manual_seed(
        2)).to(cuda_device)
    before = tic.int8_conv3d.launches
    out = card.decode(z)
    assert tic.int8_conv3d.launches - before == len(calls) == 2 * len(served)
    card.lowering = dataclasses.replace(card.lowering, use_kernels=False)
    monkeypatch.setattr(tm, "_upsample_kernel", lambda x, lowering: True)
    assert torch.isfinite(out).all() and _rel(out, card.decode(z)) < 2e-2
    mods = dict(cpu.model.named_modules())
    for path, x, head, got in calls:
        base = path.rpartition(".")[0]
        ref = lane(mods[f"{base}.norm1"], mods[path], path, x.cpu(),
                   None if head is None else {path: head.cpu()}, None,
                   False)
        assert _rel(got.cpu(), ref) < 5e-3, (path, head is not None)


@pytest.mark.cuda
def test_memory_probe_runs_and_caches_on_gpu(cuda_device, tmp_path,
                                             monkeypatch):
    """One real probe at a small decode tile: positive bytes, the same on
    each rerun with an empty cache, and a call served from the cache file
    without a run. A decode runs first, so the CUDA libraries' lazily
    allocated workspaces exist before any probe; the first probe may still
    count more than the reruns, never less (55.4 MB against 49.6 MB on an
    NVIDIA H100 80GB HBM3: state the libraries keep after it, such as the
    convolution plans its tightly capped second run picks, is the likely
    cause; not measured)."""
    from seedvr2_tpu_torch.utils import memplan

    monkeypatch.setenv("SEEDVR2_MEMPROBE_CACHE", str(tmp_path / "mp.json"))
    memplan.reset_cache_for_tests()
    vae = _legacy_vae(cuda_device)
    vae.decode(torch.zeros(1, 2, 8, 12, 4, device=cuda_device))
    vae.encode(torch.zeros(1, 5, 64, 96, 3, device=cuda_device))
    runs = memplan.probe_runs
    got = []
    for _ in range(3):
        (tmp_path / "mp.json").unlink(missing_ok=True)
        memplan.reset_cache_for_tests()
        got.append(memplan.probe_tile_bytes(vae, "decode", 1, 2, 8, 12))
    assert memplan.probe_runs == runs + 3
    assert got[0] >= got[1] == got[2] > 0, got
    memplan.reset_cache_for_tests()
    assert memplan.probe_tile_bytes(vae, "decode", 1, 2, 8, 12) == got[2]
    assert memplan.probe_runs == runs + 3
    enc = memplan.probe_tile_bytes(vae, "encode", 1, 5, 8, 12)
    assert enc > 0 and memplan.probe_runs == runs + 4
    memplan.reset_cache_for_tests()


# ------------------------------------------------- BlockSwap and offload


@pytest.mark.cuda
@pytest.mark.parametrize("keep", [0, 1])
@pytest.mark.parametrize("lane", ["bf16", "w8a8", "q8"])
def test_streamed_dit_matches_resident_on_gpu(cuda_device, lane, keep):
    """A 3-layer width-256 3B-family NaDiT with its blocks streamed from
    pinned host memory over the copy stream (keep 0: three streamed blocks,
    so successive forwards rotate the slots in both orders; keep 1: two)
    equals the resident forward bit for bit in each of five forwards, on a
    latent whose blocks compute long enough that a copy not fenced behind
    the block still reading its slot would overwrite live weights. The
    lane's kernels launch from the streamed blocks, the block packs are
    page-locked, and the telemetry resolves after the forwards."""
    import copy

    from seedvr2_tpu_torch.core.configs import small_test_config
    from seedvr2_tpu_torch.models.dit import nadit
    from seedvr2_tpu_torch.ops import offload

    cfg = dataclasses.replace(small_test_config(vid_dim=256, heads=2,
                                                head_dim=128),
                              num_layers=3)
    gen = torch.Generator(cuda_device).manual_seed(2)
    model = nadit.init_dit(cfg, cuda_device, torch.bfloat16, generator=gen)
    model = {"bf16": lambda m: m,
             "w8a8": lambda m: tim.quantize_dit_w8a8(m, 256),
             "q8": lambda m: tqm.quantize_dit_q8(m, 256)}[lane](model)
    shape, txt_len = (5, 36, 64), 58
    dplan = nadit.upload_plan(nadit.build_dit_plan(cfg, shape, txt_len), cfg,
                              cuda_device)
    vid = torch.randn(1, *shape, cfg.vid_in_channels, generator=gen,
                      device=cuda_device).to(torch.bfloat16)
    txt = torch.randn(1, txt_len, cfg.txt_in_dim, generator=gen,
                      device=cuda_device).to(torch.bfloat16)
    t = torch.full((1,), 1000.0, device=cuda_device)
    with torch.no_grad():
        ref = nadit.nadit_forward(model, vid, txt, t, dplan)
    streamed = offload.StreamedNaDiT(copy.deepcopy(model), keep_blocks=keep,
                                     device=cuda_device)
    assert all(p.buffer.is_pinned() for p in streamed.host)
    assert all(not t_.is_cuda for blk in streamed.model.blocks[keep:]
               for t_ in list(blk.parameters()) + list(blk.buffers()))
    wrapper = {"bf16": tfa.packed_window_attention, "w8a8": tim.int8_matmul,
               "q8": tqm.quant_matmul_q8}[lane]
    outs = []
    for _ in range(5):
        before = (wrapper.launches, tg.gather_rows.launches)
        outs.append(streamed(vid, txt, t, dplan))
        assert wrapper.launches > before[0]
        assert tg.gather_rows.launches > before[1]
    torch.cuda.synchronize()
    for out in outs:
        assert torch.equal(out, ref)
    stats = streamed.stats.summary()
    assert stats["block_swaps"] == 5 * (3 - keep)
    assert stats["measured_transfer_ms"] > 0
    tr = streamed.stats.transfer()
    assert tr["copies"] == 5 * (3 - keep) and tr["copy_gbps"] > 0


@pytest.mark.cuda
def test_phase_offload_round_trip_on_gpu(cuda_device):
    """Per-phase offload on the card: release_dit() leaves no DiT tensor on
    the device and gives its bytes back; the next inference restores the
    one pinned host copy and reproduces the resident output bit for bit."""
    import copy

    from seedvr2_tpu_torch.core.configs import RunnerConfig, small_test_config
    from seedvr2_tpu_torch.core.runner import VideoDiffusionRunner
    from seedvr2_tpu_torch.models.dit import nadit

    cfg = small_test_config(vid_dim=256, heads=2, head_dim=128)
    gen = torch.Generator(cuda_device).manual_seed(3)
    model = nadit.init_dit(cfg, cuda_device, torch.bfloat16, generator=gen)
    rcfg = RunnerConfig(dit=cfg)
    regular = VideoDiffusionRunner(model, None, rcfg)
    offl = VideoDiffusionRunner(copy.deepcopy(model), None, rcfg,
                                device=cuda_device)
    offl.set_phase_offload()
    tensors = list(offl.dit.parameters()) + list(offl.dit.buffers())
    assert not any(t_.is_cuda for t_ in tensors)
    assert offl._host_dit.packed.buffer.is_pinned()
    noise = torch.randn(2, 36, 64, 16, generator=gen,
                        device=cuda_device).to(torch.bfloat16)
    cond = regular.get_condition(noise, noise)
    txt = torch.randn(58, cfg.txt_in_dim, generator=gen,
                      device=cuda_device)
    args = ([noise], [cond], [txt], [txt])
    ref = regular.inference(*args, cfg_scale=1.0, steps=1)[0]
    for _ in range(2):
        out = offl.inference(*args, cfg_scale=1.0, steps=1)[0]
        assert all(t_.is_cuda for t_ in tensors)
        assert torch.equal(out, ref)
        held = torch.cuda.memory_allocated(cuda_device)
        offl.release_dit()
        assert not any(t_.is_cuda for t_ in tensors)
        freed = held - torch.cuda.memory_allocated(cuda_device)
        assert freed >= offl._host_dit.packed.nbytes
    assert len(offl.restore_seconds) == 2


# ------------------------------------------------------------ CLI surface


@pytest.mark.cuda
@pytest.mark.parametrize("uniform", [False, True], ids=["grouped", "uniform"])
def test_xla_lane_matches_flash_lane_on_gpu(cuda_device, uniform):
    """--attention_mode xla on the card: the 2-layer width-256 NaDiT through
    SDPA against the same model through the kernels (K1 on the grouped
    plan, K9 on the uniform one), bounded as the kernels against their
    plain versions; the xla lane launches no attention kernel and still
    K2's gathers on the grouped plan."""
    from seedvr2_tpu_torch.core.configs import small_test_config
    from seedvr2_tpu_torch.models.dit import nadit

    cfg = small_test_config(vid_dim=256, heads=2, head_dim=128)
    gen = torch.Generator(cuda_device).manual_seed(1)
    model = nadit.init_dit(cfg, cuda_device, torch.bfloat16, generator=gen)
    shape, txt_len = (2, 18, 32), 58
    plan = nadit.upload_plan(nadit.build_dit_plan(cfg, shape, txt_len,
                                                  uniform=uniform),
                             cfg, cuda_device)
    vid = torch.randn(1, *shape, cfg.vid_in_channels, generator=gen,
                      device=cuda_device).to(torch.bfloat16)
    txt = torch.randn(1, txt_len, cfg.txt_in_dim, generator=gen,
                      device=cuda_device).to(torch.bfloat16)
    t = torch.full((1,), 1000.0, device=cuda_device)
    wrappers = (tfa.packed_window_attention, tfa.flash_windowed_attention,
                tg.gather_rows)
    with torch.no_grad():
        flash = nadit.nadit_forward(model, vid, txt, t, plan).float()
        before = [w.launches for w in wrappers]
        xla = nadit.nadit_forward(model, vid, txt, t, plan,
                                  attention_mode="sdpa").float()
        launched = [w.launches - b for w, b in zip(wrappers, before)]
    assert launched[:2] == [0, 0]
    assert (launched[2] > 0) == (not uniform)
    assert torch.isfinite(xla).all()
    assert ((xla - flash).norm() / flash.norm()).item() < 2e-2


@pytest.mark.cuda
def test_debug_memory_state_on_gpu(cuda_device, capsys):
    """Debug reads the card: allocated, peak, reserved and the card's total
    under the hbm_* keys; a checkpoint's device delta is what was
    allocated between two checkpoints."""
    from seedvr2_tpu_torch.utils.debug import Debug

    dbg = Debug(enabled=True)
    a = dbg.checkpoint("before")
    x = torch.empty(256 << 20, dtype=torch.uint8, device=cuda_device)
    b = dbg.checkpoint("after")
    total = torch.cuda.mem_get_info()[1] / 1024 ** 3
    assert {"hbm_used_gb", "hbm_limit_gb", "hbm_peak_gb",
            "hbm_reserved_gb", "rss_gb"} <= set(b)
    assert b["hbm_used_gb"] - a["hbm_used_gb"] == pytest.approx(0.25)
    assert b["hbm_peak_gb"] >= b["hbm_used_gb"]
    assert b["hbm_reserved_gb"] >= b["hbm_used_gb"]
    assert b["hbm_limit_gb"] == pytest.approx(total)
    assert "checkpoint[after] (delta HBM +0.25GB" in capsys.readouterr().out
    del x


@pytest.mark.cuda
def test_memory_limit_of_the_current_device_on_gpu(cuda_device):
    """"cuda" without an index is the current card (configure_runner's
    default device, the CLI's --device cuda)."""
    from seedvr2_tpu_torch.utils import memplan

    here = torch.device("cuda", torch.cuda.current_device())
    assert memplan.memory_limit("cuda") == memplan.memory_limit(here) > 0
    assert memplan.memory_limit(torch.device("cuda")) == \
        memplan.memory_limit(here)


@pytest.mark.cuda
def test_npy_chunk_run_on_gpu(cuda_device, tmp_path, monkeypatch):
    """The CLI's .npy stream on the card: a 9-frame clip in chunks of 5
    with overlap 2 through a small DiT and VAE_V3 (random, bf16) writes
    9 finite frames, launches K1 and K2, and equals the one-chunk run away
    from the seam (frames 3, 4), within a bf16-class bound there (wavelet:
    lab matches histograms over each decoded batch, which the seam's blend
    changes)."""
    from seedvr2_tpu_torch import cli
    from seedvr2_tpu_torch.core.configs import small_test_config

    runner = cli.make_runner(cuda_device, seed=0,
                             dit_cfg=small_test_config(vid_dim=256, heads=2,
                                                       head_dim=128))
    monkeypatch.setattr(cli, "make_runner", lambda *a, **kw: runner)
    frames = np.random.default_rng(0).uniform(0, 1, (9, 64, 96, 3)).astype(
        np.float32)
    np.save(tmp_path / "in.npy", frames)
    base = [str(tmp_path / "in.npy"), "--resolution", "128",
            "--temporal_overlap", "2", "--device", "cuda",
            "--color_correction", "wavelet"]
    whole = np.load(cli.main(base + ["--output", str(tmp_path / "w.npy")]))
    before = [w.launches for w in (tfa.packed_window_attention,
                                   tg.gather_rows)]
    chunked = np.load(cli.main(base + ["--output", str(tmp_path / "c.npy"),
                                       "--chunk_size", "5"]))
    launched = [w.launches - b for w, b in zip(
        (tfa.packed_window_attention, tg.gather_rows), before)]
    assert chunked.shape == whole.shape == (9, 128, 192, 3)
    assert np.isfinite(chunked).all() and min(launched) > 0
    away = [0, 1, 2, 5, 6, 7, 8]
    np.testing.assert_array_equal(chunked[away], whole[away])
    assert np.abs(chunked[3:5] - whole[3:5]).max() < 2e-2


# tensor parallelism's row shards: (K, N) of the 3B attention proj_out (K =
# 2560 / tp), the 3B mlp proj_out (6912 / tp), the 7B attention proj_out
# (3072 / tp) and mlp proj_out (12288 / tp) at tp = 2 and 4, at the text
# rows, the time embedding's and a 1080p latent's tokens (the split-K path
# runs at the small M)
TP_SHARDS = [(1280, 2560), (640, 2560), (3456, 2560), (1728, 2560),
             (1536, 3072), (768, 3072), (6144, 3072), (3072, 3072)]
TP_M = (8, 64, 16320)


def _rel_l2(out, ref):
    return ((out.float() - ref.float()).norm()
            / ref.float().norm().clamp_min(1e-30)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", TP_SHARDS)
@pytest.mark.parametrize("m", TP_M)
def test_k3_fp32_output_exact_on_gpu(cuda_device, m, n, k):
    """K3's fp32 epilogue (the partial a row-sharded w8a8 projection sums
    over the tp ranks): the same exact int32 sums and scale order, stored
    unrounded, so bit-equal to the plain version; its bf16 output is this
    fp32 output rounded once."""
    gen = torch.Generator(cuda_device).manual_seed(m + k)
    xq = torch.randint(-127, 128, (m, k), generator=gen, device=cuda_device,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (n, k), generator=gen, device=cuda_device,
                       dtype=torch.int8)
    xs = torch.rand(m, generator=gen, device=cuda_device) * 0.01
    ws = torch.rand(n, generator=gen, device=cuda_device) * 0.01
    before = tim.int8_matmul.launches_f32
    out = tim.int8_matmul(xq, wq, xs, ws, out_dtype=torch.float32)
    assert tim.int8_matmul.launches_f32 == before + 1
    assert out.dtype == torch.float32
    assert torch.equal(out, tim.int8_matmul_plain(xq, wq, xs, ws,
                                                  torch.float32))
    assert torch.equal(tim.int8_matmul(xq, wq, xs, ws),
                       out.to(torch.bfloat16))
    with pytest.raises(ValueError):
        tim.int8_matmul(xq, wq, xs, ws, out_dtype=torch.float16)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", TP_SHARDS)
@pytest.mark.parametrize("m", TP_M)
def test_k6_k7_fp32_output_on_gpu(cuda_device, m, n, k):
    """K6's and K7's fp32 epilogue (and, where the plan splits K, the fp32
    split-K reduction): the accumulator the bf16 output rounds, stored
    unrounded, so the bf16 output is this one rounded once; against the
    plain fp32 products, the sums' order (K6, relative L2 <= 1e-5) and K7's
    hi / lo min term (<= 1e-4) apart."""
    gen = torch.Generator(cuda_device).manual_seed(m * 3 + k)
    x, q, s = _q8_case(gen, m, n, k, cuda_device)
    before = tqm.quant_matmul_q8.launches_f32
    out = tqm.quant_matmul_q8(x, q, s, out_dtype=torch.float32)
    assert tqm.quant_matmul_q8.launches_f32 == before + 1
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert torch.equal(tqm.quant_matmul_q8(x, q, s), out.to(torch.bfloat16))
    assert _rel_l2(out, tqm.quant_matmul_q8_plain(x, q, s,
                                                  torch.float32)) <= 1e-5
    x, q, s, mn = _affine_case(gen, m, n, k, 15, cuda_device)
    before = tqm.quant_matmul_affine.launches_f32
    out = tqm.quant_matmul_affine(x, q, s, mn, out_dtype=torch.float32)
    assert tqm.quant_matmul_affine.launches_f32 == before + 1
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert torch.equal(tqm.quant_matmul_affine(x, q, s, mn),
                       out.to(torch.bfloat16))
    assert _rel_l2(out, tqm.quant_matmul_affine_plain(
        x, q, s, mn, torch.float32)) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [(8, 2560, 1280), (64, 3072, 6144),
                                   (8, 3072, 3072)])
def test_split_reduce_fp32_on_gpu(cuda_device, m, n, k):
    """At these shard shapes the plan splits K; the reduction into fp32 is
    bit-equal to its plain version and, rounded, to the bf16 one."""
    _, splits = tqm.plan_tiles(m, n, k)
    assert splits > 1
    gen = torch.Generator(cuda_device).manual_seed(n + k)
    ws = torch.randn(splits, m, n, generator=gen, device=cuda_device)
    out = tqm.split_reduce(ws, torch.float32)
    assert out.dtype == torch.float32
    assert torch.equal(out, tqm.split_reduce_plain(ws, torch.float32))
    assert torch.equal(tqm.split_reduce(ws), out.to(torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [(8, 2560, 1280), (3600, 2560, 3456),
                                   (3600, 3072, 6144)])
def test_dense_row_shard_fp32_product_on_gpu(cuda_device, m, n, k):
    """The dense tp lane's row-sharded product: bf16 operands into an fp32
    output on the tensor cores (no fp32 copy of the weight), within the
    sums' order of the fp32 product of the widened operands."""
    from seedvr2_tpu_torch.ops.layers import _matmul_f32

    gen = torch.Generator(cuda_device).manual_seed(m + n)
    x = torch.randn(m, k, generator=gen, device=cuda_device).to(
        torch.bfloat16)
    w = torch.randn(n, k, generator=gen, device=cuda_device).to(
        torch.bfloat16)
    out = _matmul_f32(x[None], w)
    assert out.dtype == torch.float32 and out.shape == (1, m, n)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ref = torch.matmul(x.float(), w.float().t())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert _rel_l2(out[0], ref) <= 1e-5
