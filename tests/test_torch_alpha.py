"""The port's edge-guided alpha upscaling (seedvr2_tpu_torch.core.alpha)
against the JAX package's seedvr2_tpu.core.alpha on the CPU in fp32.

Tolerance: the same fp32 arithmetic in another order (the Sobel taps and
the box sums as shifted adds or pools against XLA's convolutions and
reduce_window): 1e-5 max abs for every function (observed <= 9e-7). The
binary path's thresholds (refined > 0.5, transition < 0.05 / 0.03, edges >
0.15) could turn such a difference into a flip of 1; none happens on these
inputs, and the test would show one."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seedvr2_tpu.core import alpha as ja
from seedvr2_tpu_torch.core import alpha as ta

TOL = 1e-5


def _rgb(seed, shape=(3, 40, 56, 3)):
    """Smooth colour regions with a hard edge and noise: real edges for the
    Sobel filter and the cascade's thresholds to act on."""
    rng = np.random.default_rng(seed)
    t, h, w, _ = shape
    yy, xx = np.mgrid[:h, :w] / max(h, w)
    base = np.stack([np.sin(3 * xx + 2 * yy), np.cos(4 * yy), xx - yy], -1)
    base = np.where((xx > 0.4)[..., None], base, -base)
    x = base[None] * 0.6 + rng.normal(0, 0.15, (t, h, w, 3))
    return np.clip(x, -1, 1).astype(np.float32)


def _alphas(t, h, w):
    """A mostly 0 / 1 disc (the binary path) and a soft ramp (the gradient
    path) at the input size."""
    yy, xx = np.mgrid[:h, :w]
    disc = ((yy - h / 2) ** 2 + (xx - w / 2) ** 2 < (h / 3) ** 2)
    ramp = np.broadcast_to(xx / (w - 1), (h, w))
    return {name: np.repeat(a[None, :, :, None], t, 0).astype(np.float32)
            for name, a in (("binary", disc), ("gradient", ramp))}


def test_detect_edges_matches_jax():
    rgb01 = (_rgb(0) + 1) / 2
    out = ta.detect_edges(torch.from_numpy(rgb01)).numpy()
    ref = np.asarray(ja.detect_edges(jnp.asarray(rgb01)))
    assert out.shape == (3, 40, 56, 1) and out.max() == pytest.approx(1.0)
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("radius", [2, 3])
def test_guided_filter_matches_jax(radius):
    rgb01 = (_rgb(1) + 1) / 2
    src = np.random.default_rng(2).uniform(0, 1, (3, 40, 56, 1)).astype(
        np.float32)
    out = ta.guided_filter(torch.from_numpy(rgb01), torch.from_numpy(src),
                           radius, 0.002).numpy()
    ref = np.asarray(ja.guided_filter(jnp.asarray(rgb01), jnp.asarray(src),
                                      radius, 0.002))
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("path", ["binary", "gradient"])
def test_paths_match_jax(path):
    """Each path at the same 2x upscale, called directly."""
    rgb01 = (_rgb(3) + 1) / 2
    alpha = _alphas(3, 20, 28)[path]
    fn_t = {"binary": ta._binary_path, "gradient": ta._gradient_path}[path]
    fn_j = {"binary": ja._binary_path, "gradient": ja._gradient_path}[path]
    out = fn_t(torch.from_numpy(alpha), torch.from_numpy(rgb01)).numpy()
    ref = np.asarray(fn_j(jnp.asarray(alpha), jnp.asarray(rgb01), 40, 56))
    assert out.shape == (3, 40, 56, 1)
    assert 0.0 <= out.min() and out.max() <= 1.0
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("path", ["binary", "gradient"])
@pytest.mark.parametrize("signed", [True, False])
def test_process_alpha_for_batch_matches_jax(path, signed):
    """The phase-4 entry: the binary-vs-gradient choice on the host, RGB
    given in [-1, 1] (taken as such because a value is negative) or in
    [0, 1] (used as is), and the batch's padded alpha cut to the decoded
    frames (5 alpha frames, 3 RGB frames)."""
    rgb = _rgb(4)
    if not signed:
        rgb = (rgb + 1) / 2
    alpha = _alphas(5, 20, 28)[path]
    out = ta.process_alpha_for_batch(torch.from_numpy(rgb), alpha).numpy()
    ref = ja.process_alpha_for_batch(rgb, alpha, None)
    assert out.shape == ref.shape == (3, 40, 56, 1)
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)
    if path == "binary":  # the cascade snapped most pixels to 0 or 1
        assert ((out < 0.01) | (out > 0.99)).mean() > 0.6


def test_range_rule_and_path_choice():
    """[-1, 1] RGB equals the same frames given in [0, 1]; the binary path
    is taken above a 95 % share of near-0 / near-1 alpha values."""
    rgb = _rgb(5)
    alpha = _alphas(3, 20, 28)["binary"]
    a = ta.process_alpha_for_batch(torch.from_numpy(rgb), alpha)
    b = ta.process_alpha_for_batch(torch.from_numpy((rgb + 1) / 2), alpha)
    torch.testing.assert_close(a, b, atol=TOL, rtol=0)
    rgb01 = torch.from_numpy((rgb + 1) / 2)
    soft = alpha * 0.6 + 0.2  # every value in [0.2, 0.8]: gradient
    torch.testing.assert_close(
        ta.edge_guided_alpha_upscale(soft, rgb01),
        ta._gradient_path(torch.from_numpy(soft), rgb01))
    torch.testing.assert_close(
        ta.edge_guided_alpha_upscale(alpha, rgb01),
        ta._binary_path(torch.from_numpy(alpha), rgb01))
