"""The decoder upsample's kernel route (ops/upsample.py) on the CPU, where
`upsample_shuffle` runs its plain version, in fp32:

 - the plain version against the plain forms the CPU serves:
   `_upsample_pixel_shuffle`, then remove_head, then `causal_conv3d`'s
   concatenation of the causal head (frame 0 twice, or a carried tail);
 - `_upsample3d` through the kernel route (forced on) against the default
   route, on first and later slices, with the head correction on and off;
 - whole decodes of 5- and 9-frame clips through the route against JAX's;
 - the unit plan the kernel's walk is sized by;
 - the one predicate (`corrects_head`) that both `_upsample3d` and
   `causal_conv3d` ask, against the path `causal_conv3d` takes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seedvr2_tpu_torch.models.vae import model as tm
from seedvr2_tpu_torch.ops import upsample as tu

from .test_torch_vae import TOL
from .test_torch_vae_lowering import (_clip, _jax_vae, _port_vae, _t,
                                      clean_env, params)  # noqa: F401

# the same fp32 matmul and bias add on both sides
EXACT = dict(rtol=1e-6, atol=1e-6)


def _holder(ci, c, tr, seed):
    gen = torch.Generator().manual_seed(seed)
    up = tm._ConvHolder(upscale_conv=torch.nn.Conv3d(ci, 4 * tr * c, 1),
                        conv=torch.nn.Conv3d(c, c, 3))
    with torch.no_grad():
        for p in up.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    return up


def _x(ci, t, h, w, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(1, ci, t, h, w, generator=gen)


@pytest.mark.parametrize("tr", [1, 2])
@pytest.mark.parametrize("case", ["first", "later", "unextended"])
@pytest.mark.parametrize("t", [2, 3])
def test_plain_matches_shuffle_drop_and_head(tr, case, t):
    """x of a 5- (2 latent frames) and a 9-frame clip (3): the plain
    version equals the pixel-shuffle form, the first slice's drop of frame
    1 and the head frames causal_conv3d would concatenate in front."""
    ci, c = 6, 5
    up = _holder(ci, c, tr, seed=tr)
    x = _x(ci, t, 3, 5, seed=t)
    first = case != "later"
    drop = tr == 2 and first
    ref = tm._upsample_pixel_shuffle(up.upscale_conv, x, 2, tr)
    if drop:
        ref = torch.cat([ref[:, :, :1], ref[:, :, 2:]], dim=2)
    head = None
    if case == "later":
        head = torch.randn(1, c, 2, 6, 10)
        ref = torch.cat([head, ref], dim=2)
    elif case == "first":
        ref = torch.cat([ref[:, :, :1].expand(-1, -1, 2, -1, -1), ref], dim=2)
    n_head = 0 if case == "unextended" else 2
    with torch.no_grad():
        out = tu.upsample_shuffle(x, up.upscale_conv.weight,
                                  up.upscale_conv.bias, tr, drop, n_head,
                                  head)
    assert out.shape == (1, c, n_head + t * tr - drop, 6, 10)
    torch.testing.assert_close(out, ref, **EXACT)


def _route(monkeypatch, on):
    monkeypatch.setattr(tm, "_upsample_kernel", lambda x, lowering: on)


@pytest.mark.parametrize("temporal", [False, True])
@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("correction", [False, True])
@pytest.mark.parametrize("t", [1, 2, 3])
def test_upsample3d_kernel_route_matches_default(monkeypatch, temporal, first,
                                                 correction, t):
    """`_upsample3d` through the kernel's route against the plain route:
    the same output and the same carried tail, whether the conv after it
    takes the concatenated head or corrects the head itself (a first
    temporal slice of one frame has too few frames for the correction)."""
    ci, c = 6, 5
    tr = 2 if temporal else 1
    up = _holder(ci, c, tr, seed=7)
    x = _x(ci, t, 3, 4, seed=8)
    path = "decoder.up_blocks.0.upsamplers.0"
    state = None if first else {f"{path}.conv": torch.randn(1, c, 2, 6, 8)}
    lowering = tm.Lowering(upsample_convt=False, head_correction=correction)
    calls = []
    real = tu.upsample_shuffle
    monkeypatch.setattr(tu, "upsample_shuffle",
                        lambda *a: calls.append(a[5]) or real(*a))
    outs = []
    for on in (False, True):
        _route(monkeypatch, on)
        new_state = {}
        with torch.no_grad():
            out = tm._upsample3d(up, path, x, state, new_state, temporal,
                                 first, lowering)
        outs.append((out, new_state[f"{path}.conv"]))
    (ref, ref_tail), (out, tail) = outs
    torch.testing.assert_close(out, ref, **EXACT)
    torch.testing.assert_close(tail, ref_tail, **EXACT)
    t_out = t * tr - (temporal and first)
    assert calls == [0 if correction and t_out >= 2 else 2]


@pytest.mark.parametrize("frames", [5, 9])
@pytest.mark.parametrize("correction", [False, True])
def test_decode_through_kernel_route_matches_jax(params, monkeypatch, frames,
                                                 correction):
    """Whole decodes (9 frames: a first slice, then a later one carrying
    each upsampler's tail) through the kernel route against JAX's VAE with
    the same head-correction switch, and against the port's default
    route."""
    switch = "head_correction" if correction else None
    jvae = _jax_vae(params, monkeypatch, switch)
    x = _clip(frames, 20 + frames)
    z = np.asarray(jvae.encode(jnp.asarray(x)))
    lowering = tm.Lowering(head_correction=correction)
    ref = _port_vae(params, lowering=lowering).decode(_t(z))
    calls = []
    real = tu.upsample_shuffle
    monkeypatch.setattr(tu, "upsample_shuffle",
                        lambda *a: calls.append(1) or real(*a))
    _route(monkeypatch, True)
    y = _port_vae(params, lowering=lowering).decode(_t(z))
    np.testing.assert_allclose(y.numpy(),
                               np.asarray(jvae.decode(jnp.asarray(z))), **TOL)
    torch.testing.assert_close(y, ref, rtol=2e-5, atol=2e-5)
    slices = 1 if frames == 5 else 2
    assert len(calls) == 3 * slices  # every upsampler of every slice


@pytest.mark.parametrize("b,ci,t,h,w", [
    (1, 512, 2, 135, 240),    # the 3B clip's first upsampler
    (2, 512, 3, 7, 9),        # later slices, two batch elements
    (1, 256, 1, 71, 240),     # a 7B decode tile's last one
    (2, 64, 1, 5, 5)])        # a still: one output frame
def test_plan_units_fits_shared_memory(b, ci, t, h, w):
    """The walk the smoke prints: a unit's x (every input channel of its
    positions) is at most 128 KB of bf16, a frame's units cover its
    positions with less than one unit to spare, one unit a frame tile."""
    nt, ptiles, units = tu.plan_units(b, t, h, w, ci)
    assert nt * ci * 2 <= 128 * 1024
    assert (ptiles - 1) * nt < h * w <= ptiles * nt
    assert units == b * t * ptiles


@pytest.mark.parametrize("correction", [False, True])
@pytest.mark.parametrize("kt,stride,t,state_frames,t_pad", [
    (3, (1, 1, 1), 5, None, 1), (3, (1, 1, 1), 1, None, 1),
    (3, (1, 1, 1), 2, 2, 1), (3, (1, 1, 1), 3, 1, 1),
    (1, (1, 1, 1), 4, None, 0), (3, (2, 2, 2), 5, None, 1),
    (3, (1, 1, 1), 4, None, 0), (2, (1, 1, 1), 3, None, 1)])
def test_corrects_head_matches_causal_conv3d(monkeypatch, correction, kt,
                                             stride, t, state_frames, t_pad):
    """`corrects_head` says whether causal_conv3d runs the head correction,
    as causal_conv3d itself decides: its correction convs are the calls
    padded at the front of T."""
    conv = torch.nn.Conv3d(3, 4, (kt, 3, 3))
    path = "p"
    x = torch.randn(1, 3, t, 4, 4)
    state = (None if state_frames is None
             else {path: torch.randn(1, 3, state_frames, 4, 4)})
    lowering = tm.Lowering(head_correction=correction)
    fronts = []
    real = tm._conv3d
    monkeypatch.setattr(tm, "_conv3d", lambda *a: fronts.append(
        len(a) > 4 and a[4][0] > 0) or real(*a))
    with torch.no_grad():
        tm.causal_conv3d(conv, path, x, state, {}, stride=stride,
                         t_pad=t_pad, s_pad=((1, 1), (1, 1)),
                         lowering=lowering)
    n_head = tm.head_frames(state, path, t_pad)
    assert any(fronts) == tm.corrects_head(lowering, kt, stride, t, n_head)
