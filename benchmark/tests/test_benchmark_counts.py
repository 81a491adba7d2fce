"""The work counts and the metric arithmetic, against values worked out by
hand at small shapes and against the reference's own products."""

import dataclasses
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

from benchmark import stats, trace, weights
from benchmark.counts import dit as dit_counts, peaks, vae as vae_counts
from benchmark.counts.work import Work, linear
from benchmark.reference import dit as ref_dit, vae as ref_vae
from benchmark.reference.params import StateParams
from seedvr2_tpu_torch.core.configs import VAEConfig, small_test_config


def _dit(family="dit_7b", **kw):
    cfg = small_test_config(family, **kw)
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_k3_linear_by_hand():
    w = linear(8, 1024, 2048, "w8a8")
    assert (w.kernel, w.dtype) == ("k3", "int8")
    assert w.ops == 2 * 8 * 1024 * 2048
    # int8 x and w, fp32 scales, bf16 out and bias
    assert w.bytes == 8 * 1024 + 2048 * 1024 + 4 * (8 + 2048) \
        + 2 * 8 * 2048 + 2 * 2048
    small = linear(8, 512, 2048, "w8a8")  # min(K, N) < 1024: stays bf16
    assert (small.kernel, small.dtype) == (None, "bf16")
    assert small.bytes == 2 * (8 * 512 + 2048 * 512) + 2 * 8 * 2048 \
        + 2 * 2048


def test_k1_one_window_by_hand():
    d = _dit()
    # a 1 x 4 x 6 token grid is one window of 24 tokens; 5 text tokens
    w = dit_counts.k1(d, (1, 8, 12), 5, shifted=False)
    s, H, Dh = 29, d["heads"], d["head_dim"]
    assert w.ops == 4 * s * s * H * Dh
    assert w.bytes == s * 4 * H * Dh * 2 + 4 * s * Dh * 4


def test_k1_windows_cover_the_grid():
    d = _dit()
    for shifted in (False, True):
        wins = dit_counts.attention_windows(d, (2, 96, 160), 0, shifted)
        assert sum(n * s for n, s in wins) == 2 * 48 * 80
        assert len(wins) > 1


def test_vae_conv_by_hand():
    w = vae_counts._conv(2, 3, (3, 3, 3), 1, 2, 2)
    assert w.ops == 2 * 2 * 3 * 27 * 4
    assert w.bytes == 2 * (2 * 4 + 3 * 2 * 27 + 3 * 4)


def test_dit_counts_match_the_reference_products(monkeypatch):
    d = _dit("dit_3b", num_layers=3)
    state = weights.draw(weights.dit_spec(d), torch.Generator().manual_seed(0),
                         torch.float32)
    seen = []
    real = ref_dit.linear

    def counting(p, key, x, quant, bias=True):
        out = real(p, key, x, quant, bias)
        seen.append(2.0 * x.shape[0] * x.shape[1] * out.shape[1])
        return out

    monkeypatch.setattr(ref_dit, "linear", counting)
    ref_dit.nadit(d, state, torch.randn(2, 48, 80, 33),
                  torch.randn(7, d["txt_in_dim"]), 1000.0)
    work = dit_counts.dit_request(d, (2, 48, 80), 7, "none")
    assert sum(w.ops for w in work if w.what == "linear") == sum(seen)


def test_vae_counts_match_the_reference_convs(monkeypatch):
    vae = dataclasses.asdict(VAEConfig(block_out_channels=(8, 16, 32, 32),
                                       norm_num_groups=4))
    state = weights.draw(weights.vae_spec(vae),
                         torch.Generator().manual_seed(1), torch.float32)
    seen = []
    real = F.conv3d

    def counting(x, w, b=None, stride=1, *a, **k):
        out = real(x, w, b, stride, *a, **k)
        seen.append(2.0 * out.numel() * w[0].numel())
        return out

    monkeypatch.setattr(ref_vae.F, "conv3d", counting)
    p = StateParams(state)
    lat = ref_vae.encode(vae, p, torch.rand(5, 32, 48, 3) * 2 - 1)
    ref_vae.decode(vae, p, lat)
    work = vae_counts.encode(vae, 5, 32, 48) + vae_counts.decode(vae, 2, 4, 6)
    assert sum(w.ops for w in work if w.what == "conv") == sum(seen)


def test_nearest_rank_p95():
    assert stats.nearest_rank(list(range(1, 21)), 95) == 19
    assert stats.nearest_rank([5.0], 95) == 5.0
    assert stats.nearest_rank(list(range(1, 101))[::-1], 95) == 95
    with pytest.raises(ValueError):
        stats.nearest_rank([], 95)


def test_rate_counts_the_last_request_in_flight():
    # a 10 s window whose last request ran past the deadline to 12.5 s
    run = SimpleNamespace(requests=[{"frames": 5}] * 4, window_s=12.5)
    assert stats.frames_per_s(run) == 20 / 12.5


def test_busy_is_the_union_of_device_intervals():
    busy = trace.merged([(0, 2), (1, 3), (5, 6), (5.5, 5.7)])
    assert busy == [(0, 3), (5, 6)]
    assert sum(b - a for a, b in busy) == 4


def test_mfu_sums_by_type():
    work = [Work("dit", "linear", peaks.PEAK_OPS["bf16"], 0, "bf16", None),
            Work("dit", "linear", peaks.PEAK_OPS["int8"], 0, "int8", "k3")]
    run = SimpleNamespace(work=work, requests=[{}] * 3, window_s=6.0)
    assert stats.mfu(run) == pytest.approx(100.0)


def test_roofline_share_by_kernel_name():
    work = [Work("dit", "linear", peaks.PEAK_OPS["int8"] * 1e-3, 1.0, "int8",
                 "k3")]
    tr = trace.Trace(kernel_s={"void s8_gemm_kernel<1>(CUtensorMap)": 0.004,
                               "ampere_bf16_gemm": 1.0})
    run = SimpleNamespace(work=work, requests=[{}] * 2, trace=tr)
    assert stats.roofline_share(run, "k3") == pytest.approx(50.0)
    assert stats.roofline_share(run, "k1") is None
