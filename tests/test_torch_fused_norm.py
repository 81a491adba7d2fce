"""The plans and plain versions of K12's two kernels (the moments and the
apply pass) and of K4's persistent grid, on the CPU. The CUDA kernels run
only on a GPU: tests/test_torch_cuda.py (marked `cuda`) and chip_smoke.py
hold them to these plain versions on the card.

K12's plan is checked in numpy with the kernels' own integer arithmetic
(`_moments_blocks`, `_apply_blocks`, mirrors of csrc/fused_norm.cu's
block decode; `_k4_rows` of csrc/fused_quant.cu's row walk); its plain
version from per-piece partial sums is held to the JAX package's Pallas
kernel in interpret mode, in fp32."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import K12_SHAPES
from seedvr2_tpu.ops import fused_norm as jfn
from seedvr2_tpu_torch.ops import fused_norm as tfn
from seedvr2_tpu_torch.ops import fused_quant as tfq


def _moments_blocks(plan, shape, groups):
    """k12_moments_kernel's blocks, with its integer arithmetic: for each
    block, (group (b * T + t) * G + g, partial within the group, plane
    (b * C + c) * T + t, first value, end value)."""
    _, c_, t_, h, w = shape
    blk = np.arange(plan.moments_blocks, dtype=np.int64)
    gi, p = blk // plan.parts, blk % plan.parts
    g, t, b = gi % groups, (gi // groups) % t_, gi // groups // t_
    c = g * (c_ // groups) + p // plan.pieces
    e0 = (p % plan.pieces) * plan.piece
    return gi, p, (b * c_ + c) * t_ + t, e0, np.minimum(e0 + plan.piece,
                                                        h * w)


def _apply_blocks(plan, shape, head_frames):
    """k12_apply_kernel's blocks, with its integer arithmetic: for each
    block, (input plane, first value, end value, first output plane
    (b * C + c) * (T + hp) + frame, output frames written)."""
    _, _, t_, h, w = shape
    blk = np.arange(plan.apply_blocks, dtype=np.int64)
    plane = blk // plan.apply_pieces
    e0 = (blk % plan.apply_pieces) * plan.apply_piece
    t = plane % t_
    out = (plane // t_) * (t_ + head_frames) + np.where(t > 0,
                                                        t + head_frames, 0)
    return (plane, e0, np.minimum(e0 + plan.apply_piece, h * w), out,
            np.where(t > 0, 1, head_frames + 1))


def _k4_rows(plan, block, rows):
    """The rows block `block` of K4's persistent grid quantizes, in the
    kernel's order: block, block + grid, ..."""
    return np.arange(block, rows, plan.grid, dtype=np.int64)


def _tiles(plane, e0, e1, n_planes, hw):
    """Every one of n_planes planes of hw values is covered by the ranges
    [e0, e1) of its entries exactly once, each range starting at a multiple
    of 8."""
    assert (e0 < e1).all() and (e0 % 8 == 0).all()
    order = np.lexsort((e0, plane))
    p, a, z = plane[order], e0[order], e1[order]
    first = np.r_[True, p[1:] != p[:-1]]
    last = np.r_[p[1:] != p[:-1], True]
    np.testing.assert_array_equal(p[first], np.arange(n_planes))
    assert (a[first] == 0).all() and (z[last] == hw).all()
    inner = ~last[:-1]
    np.testing.assert_array_equal(z[:-1][inner], a[1:][inner])


# (shape (B, C, T, H, W), groups): the served shapes of the 720p clip, B = 2,
# one channel a group, H * W not a multiple of 8
PLAN_CASES = ([((1,) + s, 32) for s in K12_SHAPES]
              + [((2, 64, 3, 30, 40), 32), ((1, 32, 3, 10, 16), 32),
                 ((2, 64, 2, 7, 9), 32), ((2, 8, 4, 190, 180), 2)])


@pytest.mark.parametrize("shape,groups", PLAN_CASES,
                         ids=["x".join(map(str, s)) for s, _ in PLAN_CASES])
def test_k12_plan_covers_every_value_once(shape, groups):
    """The moments kernel's blocks cover every value of every (b, t,
    group) once, each block's partial at its own index gi * parts + p;
    the apply kernel's blocks read every input plane once and write every
    output plane (the hp head frames included) once."""
    b, c, t, h, w = shape
    hw, hp = h * w, 2
    plan = tfn.plan_k12(shape, groups)
    gi, p, plane, e0, e1 = _moments_blocks(plan, shape, groups)
    assert plan.moments_blocks == len(gi) < 2 ** 31
    np.testing.assert_array_equal(gi * plan.parts + p,
                                  np.arange(plan.moments_blocks))
    assert set(gi.tolist()) == set(range(b * t * groups))
    tt, cc, bb = plane % t, (plane // t) % c, plane // t // c
    np.testing.assert_array_equal((bb * t + tt) * groups + cc // (c // groups),
                                  gi)
    _tiles(plane, e0, e1, b * c * t, hw)

    plane, e0, e1, out, nf = _apply_blocks(plan, shape, hp)
    assert plan.apply_blocks == len(plane) < 2 ** 31
    _tiles(plane, e0, e1, b * c * t, hw)
    assert ((nf == hp + 1) == (plane % t == 0)).all()
    f = np.concatenate([np.arange(n) for n in nf])
    rep = np.repeat(np.arange(len(nf)), nf)
    _tiles(out[rep] + f, e0[rep], e1[rep], b * c * (t + hp), hw)
    assert plan.piece % 8 == plan.apply_piece % 8 == 0


def test_k12_plan_refuses_groups_it_does_not_take():
    with pytest.raises(ValueError):
        tfn.plan_k12((1, 96, 2, 8, 8), 5)      # C % G
    with pytest.raises(ValueError):
        tfn.plan_k12((1, 512, 2, 8, 8), 1)     # 512 channels a group


def test_fold_from_sums_matches_fold():
    """The moments kernel's fold on fp32 sums of x and x^2 against the JAX
    order's `_fold` (mean and a squared norm): the same function, rounded in
    other places, within fp32 noise; also on x = 3 + randn, where the
    variance cancels against mean^2."""
    rng = np.random.default_rng(0)
    g = 8
    for shift in (0.0, 3.0):
        x = torch.from_numpy(shift + rng.standard_normal(
            (2, 64, 3, 6, 10)).astype(np.float32))
        w = torch.from_numpy(rng.uniform(0.5, 1.5, 64).astype(np.float32))
        b = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
        xr = x.reshape(2, g, 8, 3, 60)
        a, bc = tfn.fold_from_sums(xr.sum(dim=(2, 4)),
                                   (xr * xr).sum(dim=(2, 4)), 8 * 60, w, b,
                                   1e-6)
        ra, rbc = tfn._fold(x, w, b, g, 1e-6)
        torch.testing.assert_close(a, ra, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(bc, rbc, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 3, 12, 16, 8), (1, 2, 7, 16, 8),
                                   (1, 2, 184, 180, 8)],
                         ids=["even_h", "odd_h", "two_pieces"])
def test_k12_plain_from_partials_matches_jax(shape):
    """K12 as its kernels compute it, plainly: the moments from per-piece
    partial sums (two pieces a plane in the last case), folded, then the
    apply pass; against the Pallas kernel in interpret mode and JAX's
    unfused reference, in fp32, within 2e-5 (the bound of
    test_norm_silu_head_matches_jax); head frames equal frame 0. The
    wrappers' CPU routes are those plain versions."""
    rng = np.random.default_rng(shape[2])
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal((shape[-1],)).astype(np.float32)
    b = rng.standard_normal((shape[-1],)).astype(np.float32)
    args = (jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    jk = np.asarray(jfn.norm_silu_head(*args, groups=4, head_frames=2,
                                       interpret=True))
    jr = np.asarray(jfn.norm_silu_head_reference(*args, groups=4,
                                                 head_frames=2))
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3).contiguous()
    wt, bt = torch.from_numpy(w), torch.from_numpy(b)
    a, bc = tfn.norm_moments_plain(xt, wt, bt, 4)
    out = tfn.norm_silu_apply_plain(xt, a, bc, 2)
    for got, want in zip(tfn.norm_moments(xt, wt, bt, 4), (a, bc)):
        assert torch.equal(got, want)
    assert torch.equal(tfn.norm_silu_apply(xt, a, bc, 2), out)
    out = out.permute(0, 2, 3, 4, 1).numpy()
    assert out.shape == jk.shape
    np.testing.assert_allclose(out, jk, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out, jr, rtol=2e-5, atol=2e-5)
    for f in (0, 1):
        np.testing.assert_array_equal(out[:, f], out[:, 2])


@pytest.mark.parametrize("k", [64, 2560, 3072])
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("l", [1, 58, 7200, 16320, 32400])
def test_k4_plan_covers_every_row_once(l, b, k):
    """K4's persistent grid, for 528 resident blocks (4 a SM on 132 SMs)
    and for 5: every row of every batch is quantized by exactly one block;
    a block's threads cover K with two chunks of 8 each."""
    rows = b * l
    for resident in (528, 5):
        plan = tfq.plan_k4(rows, k, lambda threads: resident)
        assert plan.threads % 32 == 0 and plan.threads <= tfq.K4_MAX_THREADS
        assert 16 * (plan.threads - 32) < k <= 16 * plan.threads
        assert 1 <= plan.grid <= min(resident, rows)
        got = np.concatenate([_k4_rows(plan, blk, rows)
                              for blk in range(plan.grid)])
        np.testing.assert_array_equal(np.sort(got), np.arange(rows))


@pytest.mark.parametrize("k", [0, 12, 8200, 16384])
def test_k4_plan_refuses_k_it_does_not_take(k):
    with pytest.raises(ValueError):
        tfq.plan_k4(58, k, lambda threads: 528)
