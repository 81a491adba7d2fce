"""The port's colour methods (seedvr2_tpu_torch.utils.color_fix) against the
JAX package's on the CPU in fp32, on seeded numpy frames.

Tolerances: adain and wavelet run the same elementwise fp32 arithmetic and
reductions in another order: within 1e-5 max abs. hsv and
wavelet_adaptive add binned decisions: a pixel whose hue lands in the
neighbouring hue bin, or whose saturation lands in the neighbouring CDF bin,
takes another mapping. The hue computation is the same IEEE arithmetic on
both sides, so the test counts the pixels whose hue differs at all and
allows at most 0.1 % of pixels beyond 1e-5 (observed on these frames: no
hue differs, every value within 5e-7). lab keeps the rank-swap allowance of
tests/test_torch_layers.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seedvr2_tpu.utils import color_fix as jcf
from seedvr2_tpu_torch.utils import color_fix as tcf

EXACT = ("adain", "wavelet")
BINNED = ("hsv", "wavelet_adaptive")


def _frames(seed, shape=(5, 48, 64, 3)):
    """Content over the whole cube; style squeezed and shifted, so every
    method moves something. 5 x 48 x 64 puts ~1280 pixels in every hue bin,
    past the 100-pixel gate."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, shape).astype(np.float32)
    b = np.clip(rng.uniform(-1, 1, shape) * 0.8 + 0.1, -1, 1).astype(
        np.float32)
    return a, b


def _both(method, a, b):
    out = tcf.apply_color_correction(method, torch.from_numpy(a),
                                     torch.from_numpy(b)).numpy()
    ref = np.asarray(jcf.apply_color_correction(method, jnp.asarray(a),
                                                jnp.asarray(b)))
    return out, ref


def _hue_flips(x):
    """Share of pixels whose hue differs between the port and JAX."""
    x01 = np.clip((x + 1) * 0.5, 0, 1)
    th = tcf._rgb_to_hsv(torch.from_numpy(x01)).numpy()[..., 0]
    jh = np.asarray(jcf._rgb_to_hsv(jnp.asarray(x01)))[..., 0]
    return float((th != jh).mean())


@pytest.mark.parametrize("method", EXACT + BINNED)
@pytest.mark.parametrize("seed", [0, 1])
def test_method_matches_jax(method, seed):
    a, b = _frames(seed)
    out, ref = _both(method, a, b)
    assert out.shape == ref.shape == a.shape and out.dtype == np.float32
    assert np.abs(out - a).max() > 1e-2  # the method changed something
    diff = np.abs(out - ref)
    if method in EXACT:
        assert diff.max() <= 1e-5
    else:
        flips = max(_hue_flips(a), _hue_flips(b))
        assert flips <= 1e-3
        assert (diff > 1e-5).mean() <= 1e-3


def test_hsv_not_enough_pixels_and_red_wrap():
    """Hues restricted to red (either side of 0 / 1) and green: the red
    pixels sit in bin 0 through its wrap-around half and bin 11 at once,
    and the green bins hold 20-odd pixels, so their gate refuses them
    (the saturation stays the content's). Held as the other binned
    methods."""
    rng = np.random.default_rng(7)
    shape = (2, 24, 32)
    n = int(np.prod(shape))
    hue = np.where(rng.uniform(size=n) < 0.5,
                   rng.uniform(0.96, 1.0, n), rng.uniform(0.0, 0.03, n))
    green = rng.uniform(size=n) < 0.015
    hue = np.where(green, rng.uniform(0.30, 0.36, n), hue)

    def rgb(h, s_lo, s_hi):
        s = rng.uniform(s_lo, s_hi, n)
        v = rng.uniform(0.3, 1.0, n)
        hsv = np.stack([h, s, v], -1).astype(np.float32)
        x = np.asarray(jcf._hsv_to_rgb(jnp.asarray(hsv)))
        return (x * 2 - 1).reshape(*shape, 3).astype(np.float32)

    a, b = rgb(hue, 0.6, 1.0), rgb(hue, 0.1, 0.4)
    out, ref = _both("hsv", a, b)
    diff = np.abs(out - ref)
    assert max(_hue_flips(a), _hue_flips(b)) <= 1e-3
    assert (diff > 1e-5).mean() <= 1e-3
    # the red bins were matched (saturation pulled towards the style's) ...
    sat = tcf._rgb_to_hsv(torch.from_numpy((out + 1) * 0.5)).numpy()[..., 1]
    red = ~green.reshape(shape)
    assert sat[red].mean() < 0.5
    # ... the green ones, below the gate, were not
    sat_a = tcf._rgb_to_hsv(torch.from_numpy((a + 1) * 0.5)).numpy()[..., 1]
    assert 0 < green.sum() <= 100
    np.testing.assert_allclose(sat[~red], sat_a[~red], atol=1e-5)


def test_dispatcher_answers_six_names():
    a, b = _frames(3, (2, 16, 24, 3))
    x, y = torch.from_numpy(a), torch.from_numpy(b)
    assert tcf.METHODS == ("lab", "wavelet", "wavelet_adaptive", "hsv",
                           "adain", "none")
    for method in tcf.METHODS:
        out = tcf.apply_color_correction(method, x, y)
        assert out.shape == x.shape and torch.isfinite(out).all()
        assert (out is x) == (method == "none")
    with pytest.raises(ValueError, match="unknown colour correction"):
        tcf.apply_color_correction("sepia", x, y)


def test_masked_cdf_is_exact_integer_counts():
    """The CDF is the masked values' cumulative count over their total,
    exactly: numpy's fp32 quotient of the same integer counts."""
    rng = np.random.default_rng(5)
    vals = rng.uniform(0, 1, 5000).astype(np.float32)
    mask = rng.uniform(size=5000) < 0.3
    bins = tcf._cdf_bins(torch.from_numpy(vals))
    cdf = tcf._masked_cdf(bins, torch.from_numpy(mask)).numpy()
    counts = np.bincount(bins.numpy()[mask], minlength=1024)
    expect = (np.cumsum(counts).astype(np.float32)
              / np.float32(counts.sum()))
    np.testing.assert_array_equal(cdf, expect)
