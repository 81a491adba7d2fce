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
def test_vae_lanes_with_kernels_match_plain_on_gpu(cuda_device):
    """A 128-channel VAE in bf16: the int8 decode (K11) and the fused-norm
    encode and decode (K12) with kernels against the same lowering with the
    plain versions: K11 is exact, K12 within an ulp, so bf16-class."""
    from seedvr2_tpu_torch.core.configs import VAEConfig
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

    before = (tic.int8_conv3d.launches, tfn.norm_silu_head.launches)
    dec_k, enc_k = run(Lowering(fused_norm=True))
    assert tic.int8_conv3d.launches > before[0]
    assert tfn.norm_silu_head.launches > before[1]
    dec_p, enc_p = run(Lowering(fused_norm=True, use_kernels=False))
    for a, b in ((dec_k, dec_p), (enc_k, enc_p)):
        assert torch.isfinite(a).all()
        assert ((a - b).norm() / b.norm()).item() < 2e-2


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
    against its plain versions on the card (K11 exact: bf16 class); and
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
