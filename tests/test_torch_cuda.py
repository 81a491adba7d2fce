"""The port's CUDA kernels against their plain versions, on a GPU.

Marked `cuda`: they skip where torch sees no CUDA device (the CPU test
runs). This file imports no JAX, so it also runs on a GPU machine that has
none:

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda

chip_smoke.py makes the same checks at the main path's shapes."""

import numpy as np
import pytest
import torch

from seedvr2_tpu_torch.ops import flash_attention as tfa
from seedvr2_tpu_torch.ops import fused_quant as tfq
from seedvr2_tpu_torch.ops import gather as tg
from seedvr2_tpu_torch.ops import int8_matmul as tim


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
                                   (300, 384, 96), (7200, 13824, 2560)])
def test_k3_kernel_exact_on_gpu(cuda_device, m, n, k):
    """int8 GEMM: exact int32 sums and the same epilogue order, so equal to
    the plain version bit for bit (ragged M and K % 64 == 32 included)."""
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
                                   (2, 33, 64)])
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
