"""The port's uniform window plan and its kernels' plain versions against
the JAX package on the CPU: the uniform attention plans (ids, tables,
masks), the window layout copies, the rope helpers, the uniform NaDiT
forward (fp32, q8 and w8a8 trees), the uniform forward against the grouped
one, the plain versions of K8 (dense attention) and K9 (windowed attention)
against the JAX composition and the Pallas kernels in interpret mode, and
K10's plain version (quantizing int8 GEMM) against its Pallas kernel.

Tolerances, with their reasons:
 - plans, layouts and tables: exact (the same numpy code, copies).
 - rope rotations: fp32 rtol 1e-6 (the same two products and a sum; a
   compiler may fuse them into one multiply-add).
 - NaDiT forwards against JAX: fp32 1e-4, as tests/test_torch_dit.py holds
   the grouped forward (matmuls summed in other orders, 2 blocks).
 - uniform against grouped: fp32 2e-5, as the JAX package holds its own two
   plans (tests/test_uniform_windows.py).
 - K8/K9 plain versions against the JAX composition: fp32 1e-5 (the same
   composition, einsums summed in other orders); against the interpret-mode
   kernels: bf16 2e-2, the bound tests/test_flash_attention.py sets (the
   kernels round q*scale to bf16 where the composition rounds q).
 - K10: bit-equal. Exact int32 sums, the same fp32 reciprocal, rounding and
   epilogue order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seedvr2_tpu.core import configs as jc
from seedvr2_tpu.models.dit import nadit as jn
from seedvr2_tpu.models.dit import rope as jr
from seedvr2_tpu.ops import attention as jattn
from seedvr2_tpu.ops import flash_attention as jfa
from seedvr2_tpu.ops import int8_matmul as jim
from seedvr2_tpu.ops import quant_matmul as jqm
from seedvr2_tpu_torch.core import configs as tc
from seedvr2_tpu_torch.core.weights import state_dict_from_jax
from seedvr2_tpu_torch.models.dit import nadit as tn
from seedvr2_tpu_torch.models.dit import rope as tr
from seedvr2_tpu_torch.ops import attention as tattn
from seedvr2_tpu_torch.ops import flash_attention as tfa
from seedvr2_tpu_torch.ops import int8_matmul as tim
from seedvr2_tpu_torch.ops import quant_matmul as tqm
from seedvr2_tpu_torch.ops.gather import RowIndex

from .test_torch_dit import random_params

# lowered so the tiny config (width 64) has converted and dense linears
MIN_DIM, ALIGN = 64, 32


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------- plans


@pytest.mark.parametrize("family", ["dit_3b", "dit_7b"])
@pytest.mark.parametrize("shape,txt_len", [
    ((2, 90, 160), 58),    # the 5-frame 720p clip's latent
    ((2, 136, 240), 58),   # the 5-frame 1080p clip's latent
    ((3, 16, 22), 7), ((5, 12, 20), 7)])
def test_uniform_plans_equal(family, shape, txt_len):
    """build_dit_plan(uniform=True): per method the same uniform partition,
    table ids, per-window rope tables (mmrope3d and rope3d_window) and key
    validity, and the same 3B text tables."""
    t_cfg = tc.DIT_3B if family == "dit_3b" else tc.DIT_7B
    j_cfg = jc.DIT_3B if family == "dit_3b" else jc.DIT_7B
    a = tn.build_dit_plan(t_cfg, shape, txt_len, uniform=True)
    b = jn.build_dit_plan(j_cfg, shape, txt_len, uniform=True)
    for x, y in ((a.txt_cos, b.txt_cos), (a.txt_sin, b.txt_sin)):
        assert (x is None) == (y is None)
        if x is not None:
            np.testing.assert_array_equal(x, y)
    assert a.uniform.keys() == b.uniform.keys() == {"window",
                                                    "shifted_window"}
    for m in a.uniform:
        ua, ub = a.uniform[m], b.uniform[m]
        assert (ua.up.size, ua.up.wshape, ua.up.nwin, ua.up.pads,
                ua.up.win_info) == (ub.up.size, ub.up.wshape, ub.up.nwin,
                                    ub.up.pads, ub.up.win_info)
        for x, y in ((ua.ids, ub.ids), (ua.cos, ub.cos), (ua.sin, ub.sin),
                     (ua.valid, ub.valid), (ua.up.kv_valid, ub.up.kv_valid)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    assert tn.build_dit_plan(t_cfg, shape, txt_len).uniform is None


@pytest.mark.parametrize("size", [(2, 45, 80), (3, 8, 10), (5, 17, 29)])
@pytest.mark.parametrize("method", ["window", "shifted_window"])
def test_window_layouts_equal(size, method):
    """_to_windows / _from_windows equal the JAX ones, and crop back."""
    up = tn.build_uniform_plan(size, (4, 3, 3), method)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, int(np.prod(size)), 5)).astype(np.float32)
    xw = tn._to_windows(_t(x), up)
    np.testing.assert_array_equal(xw.numpy(),
                                  np.asarray(jn._to_windows(jnp.asarray(x),
                                                            up)))
    np.testing.assert_array_equal(tn._from_windows(xw, up).numpy(), x)
    y = rng.standard_normal(xw.shape).astype(np.float32)
    np.testing.assert_array_equal(
        tn._from_windows(_t(y), up).numpy(),
        np.asarray(jn._from_windows(jnp.asarray(y), up)))


def test_rope_helpers_equal():
    up = tn.build_uniform_plan((2, 45, 80), (4, 3, 3), "shifted_window")
    info = up.win_info[0]  # front-clipped on h and w
    assert info[1][1] > 0 and info[2][1] > 0
    real = (info[0][0], info[1][0], info[2][0])
    cr, sr = tr.mmrope3d_video_table(real, 58, 126)
    for x, y in zip(tr.embed_window_table(cr, sr, up.wshape, info, 128, 58),
                    jr.embed_window_table(cr, sr, up.wshape, info, 128, 58)):
        np.testing.assert_array_equal(x, y)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 10, 2, 16)).astype(np.float32)
    cos = rng.standard_normal((3, 10, 16)).astype(np.float32)
    sin = rng.standard_normal((3, 10, 16)).astype(np.float32)
    np.testing.assert_allclose(
        tr.apply_rope_ext(_t(x), _t(cos), _t(sin)).numpy(),
        np.asarray(jr.apply_rope_ext(jnp.asarray(x), cos, sin)), rtol=1e-6,
        atol=1e-6)
    tc_, ts_ = tr.mmrope3d_text_table(10, 12)
    np.testing.assert_allclose(
        tr.apply_rope(_t(x), _t(tc_), _t(ts_)).numpy(),
        np.asarray(jr.apply_rope(jnp.asarray(x), jnp.asarray(tc_),
                                 jnp.asarray(ts_))), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ forwards


@pytest.fixture(scope="module")
def trees():
    """The tiny 3B-family tree as fp32, q8 and w8a8 JAX trees, each with the
    port model holding the same weights (through state_dict_from_jax)."""
    params = random_params(lambda key: jn.init_dit_params(
        key, jc.small_test_config(), dtype=jnp.float32), 7)

    def model(tree, convert=None):
        m = tn.NaDiT(tc.small_test_config(), dtype=torch.float32)
        m.load_state_dict(state_dict_from_jax(params), strict=True)
        if convert is not None:
            m = convert(m)
            m.load_state_dict(state_dict_from_jax(tree), strict=True)
        return tree, m

    return {
        "fp32": model(params),
        "q8": model(jqm.quantize_dit_params(params, min_dim=MIN_DIM),
                    lambda m: tqm.quantize_dit_q8(m, MIN_DIM)),
        "w8a8": model(jim.quantize_dit_params_w8a8(params, min_dim=MIN_DIM,
                                                   align=ALIGN),
                      lambda m: tim.quantize_dit_w8a8(m, MIN_DIM, ALIGN)),
    }


def _inputs(cfg, batch, shape, txt_len=7):
    rng = np.random.default_rng(42)
    vid = rng.standard_normal((batch, *shape, cfg.vid_in_channels),
                              dtype=np.float32)
    txt = rng.standard_normal((batch, txt_len, cfg.txt_in_dim),
                              dtype=np.float32)
    ts = np.asarray([500.0, 37.0][:batch], np.float32)
    return vid, txt, ts


def _port_forward(model, vid, txt, ts, uniform, use_kernels=True):
    cfg = model.cfg
    dplan = tn.upload_plan(tn.build_dit_plan(cfg, vid.shape[1:4],
                                             txt.shape[1], uniform=uniform),
                           cfg, "cpu")
    with torch.no_grad():
        return tn.nadit_forward(model, _t(vid), _t(txt), _t(ts), dplan,
                                use_kernels=use_kernels).numpy()


@pytest.mark.parametrize("tree,batch,shape", [
    ("fp32", 1, (3, 16, 22)), ("fp32", 2, (5, 12, 20)),
    ("q8", 1, (3, 16, 22)), ("w8a8", 1, (3, 16, 22))])
def test_uniform_forward_matches_jax(trees, tree, batch, shape):
    """The uniform NaDiT forward against the JAX package's uniform forward
    of the same tree (its XLA attention composition on the CPU); shapes
    whose shifted layers front-clip windows (offset tables) and clip
    trailing ones (masked keys)."""
    jtree, model = trees[tree]
    vid, txt, ts = _inputs(model.cfg, batch, shape)
    plan = jn.build_dit_plan(jc.small_test_config(), shape, txt.shape[1],
                             uniform=True)
    ref = np.asarray(jax.jit(lambda p, v, x, t: jn.nadit_forward(
        p, jc.small_test_config(), v, x, t, plan))(
            jtree, jnp.asarray(vid), jnp.asarray(txt), jnp.asarray(ts)))
    out = _port_forward(model, vid, txt, ts, uniform=True)
    assert out.shape == ref.shape and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    # CPU: the wrappers run their plain versions
    np.testing.assert_array_equal(
        out, _port_forward(model, vid, txt, ts, True, use_kernels=False))


@pytest.mark.parametrize("shape", [(3, 16, 22), (2, 34, 58), (5, 12, 20)])
def test_uniform_equals_grouped_forward(trees, shape):
    """The port's two plans agree on the same weights (fp32, two batch
    rows), as the JAX package's do."""
    _, model = trees["fp32"]
    vid, txt, ts = _inputs(model.cfg, 2, shape)
    np.testing.assert_allclose(
        _port_forward(model, vid, txt, ts, uniform=True),
        _port_forward(model, vid, txt, ts, uniform=False),
        rtol=2e-5, atol=2e-5)


# ------------------------------------------------ K8 / K9 plain versions


def _qkv(rng, shape, dtype=np.float32, sk=None):
    b, s, h, d = shape
    q = rng.standard_normal((b, s, h, d)).astype(dtype)
    kv_shape = (b, s if sk is None else sk, h, d)
    return (q, rng.standard_normal(kv_shape).astype(dtype),
            rng.standard_normal(kv_shape).astype(dtype))


def _tables(rng, n, s, d):
    ang = rng.standard_normal((n, s, d // 2)).astype(np.float32)
    return (np.repeat(np.cos(ang), 2, axis=-1),
            np.repeat(np.sin(ang), 2, axis=-1))


def _windowed_case(rng, b=4, s=100, h=2, d=16, dtype=np.float32):
    """Two tables; id 0's keys 0..69 invalid (its whole first 64-key tile,
    as a front-clipped window's pad slots), id 1's last 20 invalid."""
    q, k, v = _qkv(rng, (b, s, h, d), dtype)
    cos, sin = _tables(rng, 2, s, d)
    valid = np.ones((2, s), bool)
    valid[0, :70] = False
    valid[1, -20:] = False
    ids = np.array([0, 1, 1, 0][:b], np.int32)
    return q, k, v, cos, sin, ids, valid


def test_k9_plain_matches_jax_composition():
    q, k, v, cos, sin, ids, valid = _windowed_case(np.random.default_rng(3))
    ref = np.asarray(jattn.attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), rope_cos=cos,
        rope_sin=sin, table_ids=ids, kv_valid=valid))
    out = tattn.attention(_t(q), _t(k), _t(v), rope_cos=_t(cos),
                          rope_sin=_t(sin), table_ids=RowIndex(ids, "cpu"),
                          kv_valid=_t(valid))
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rows,kv_len,sk", [(60, 90, None), (None, 77, None),
                                            (None, 150, 160)],
                         ids=["short_table", "rope", "cross"])
def test_k8_plain_matches_jax_composition(rows, kv_len, sk):
    """Shared tables (one shorter than S: identity rows), a kv_len mask,
    and Sq != Sk without rope."""
    rng = np.random.default_rng(4)
    q, k, v = _qkv(rng, (2, 100, 2, 16), sk=sk)
    cos = sin = None
    if sk is None:
        cos, sin = (t[0] for t in _tables(rng, 1, rows or 100, 16))
    ref = np.asarray(jattn.attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), rope_cos=cos,
        rope_sin=sin, kv_len=kv_len))
    out = tattn.attention(_t(q), _t(k), _t(v),
                          rope_cos=None if cos is None else _t(cos),
                          rope_sin=None if sin is None else _t(sin),
                          kv_len=kv_len)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)


def _f32(t):
    return np.asarray(t.float().numpy() if isinstance(t, torch.Tensor)
                      else np.asarray(t, np.float32), np.float32)


def test_k9_plain_matches_pallas_interpret():
    """K9's plain version against `flash_windowed_attention` in interpret
    mode, bf16 operands at the kernel's lane width."""
    rng = np.random.default_rng(5)
    q, k, v, cos, sin, ids, valid = _windowed_case(rng, s=128, d=128)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    ref = jfa.flash_windowed_attention(jq, jk, jv, None, cos, sin, ids,
                                       valid, interpret=True)
    out = tfa.flash_windowed_attention_plain(
        _bf16(q), _bf16(k), _bf16(v), None, _t(cos), _t(sin),
        RowIndex(ids, "cpu"), _t(valid))
    np.testing.assert_allclose(_f32(out), _f32(ref), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("rope,kv_len,sk", [(True, 200, None),
                                            (False, 200, 256)],
                         ids=["rope", "cross"])
def test_k8_plain_matches_pallas_interpret(rope, kv_len, sk):
    rng = np.random.default_rng(6)
    q, k, v = _qkv(rng, (1, 128 if sk else 256, 2, 128), sk=sk)
    cos = sin = None
    if rope:
        cos, sin = (t[0] for t in _tables(rng, 1, 256, 128))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    ref = jfa.flash_attention(jq, jk, jv, rope_cos=cos, rope_sin=sin,
                              kv_len=kv_len, interpret=True)
    out = tfa.flash_attention_plain(
        _bf16(q), _bf16(k), _bf16(v), None,
        None if cos is None else _t(cos), None if sin is None else _t(sin),
        kv_len)
    np.testing.assert_allclose(_f32(out), _f32(ref), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("shape", [(2, 90, 160), (2, 136, 240)],
                         ids=["clip720", "clip1080"])
def test_live_key_tiles_match_brute_force_on_3b_plans(shape):
    """The key tiles K9's step walks (`live_key_tiles`) on the 3B uniform
    plans of the 720p and 1080p clips' latents, every window method, against
    a loop over each id's validity row: a 64-key tile is live when it holds
    a valid key. Exact."""
    plan = tn.build_dit_plan(tc.DIT_3B, shape, 58, uniform=True)
    for method, u in plan.uniform.items():
        live = tfa.live_key_tiles(_t(u.valid)).numpy()
        n_u, s = u.valid.shape
        want = np.zeros((n_u, -(-s // 64)), bool)
        for i in range(n_u):
            for c in range(s):
                want[i, c // 64] |= bool(u.valid[i, c])
        np.testing.assert_array_equal(live, want, err_msg=method)
        assert live[:, -1].all()  # the text rows close every window


def test_attention_wrappers_check_shapes():
    """On the CPU the K8/K9 wrappers run their plain versions; shapes the
    kernels do not take raise on every device."""
    rng = np.random.default_rng(7)
    q, k, v, cos, sin, ids, valid = _windowed_case(rng)
    args = [_t(q), _t(k), _t(v), None, _t(cos), _t(sin),
            RowIndex(ids, "cpu"), _t(valid)]
    np.testing.assert_array_equal(
        tfa.flash_windowed_attention(*args).numpy(),
        tfa.flash_windowed_attention_plain(*args).numpy())
    for pos, arg in ((1, _t(k[:, :90])),                  # Sq != Sk
                     (6, RowIndex(ids[:3], "cpu")),       # too few ids
                     (6, RowIndex(ids + 1, "cpu")),       # id 2 of 2 tables
                     (7, _t(valid[:, :90]))):             # short mask
        case = list(args)
        case[pos] = arg
        with pytest.raises(ValueError):
            tfa.flash_windowed_attention(*case)
    with pytest.raises(ValueError):  # fused rope needs Sq == Sk
        tfa.flash_attention(_t(q), _t(k[:, :90]), _t(v[:, :90]),
                            rope_cos=_t(cos[0]), rope_sin=_t(sin[0]))
    with pytest.raises(ValueError):
        tfa.flash_attention(_t(q), _t(k), _t(v), kv_len=0)


# ------------------------------------------------------------------- K10


@pytest.mark.parametrize("m,k,n,x_dtype", [(96, 512, 256, np.float32),
                                           (50, 256, 512, jnp.bfloat16)])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_k10_plain_bit_equal_to_pallas(m, k, n, x_dtype, out_dtype):
    """int8_matmul_qx's plain version against the Pallas kernel in
    interpret mode: the same per-row reciprocal quantization, exact int32
    sums and the same epilogue order, so bit for bit (ragged M padded on
    the JAX side)."""
    rng = np.random.default_rng(m)
    x = jnp.asarray(rng.standard_normal((m, k)) * 3, x_dtype)
    wq = rng.integers(-127, 128, (k, n)).astype(np.int8)
    ws = (rng.random(n) * 0.05).astype(np.float32)
    ref = jim.int8_matmul_qx(x, jnp.asarray(wq), jnp.asarray(ws),
                             out_dtype=getattr(jnp, out_dtype), block_m=32,
                             block_n=256, interpret=True)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        torch.float32 if x_dtype == np.float32 else torch.bfloat16)
    out = tim.int8_matmul_qx(xt, _t(wq.T), _t(ws),
                             out_dtype=getattr(torch, out_dtype))
    assert out.dtype == getattr(torch, out_dtype)
    np.testing.assert_array_equal(_f32(out), _f32(np.asarray(
        ref.astype(jnp.float32))))
    if out_dtype == "bfloat16" and x_dtype == jnp.bfloat16:
        assert tim.int8_matmul_qx(xt, _t(wq.T), _t(ws)).dtype == torch.bfloat16
    with pytest.raises(ValueError):
        tim.int8_matmul_qx(xt, _t(wq.T[:, :-32]), _t(ws))


def test_k10_plan_covers_every_3b_shape():
    """plan_qx gives every 3B DiT linear at every token count of the served
    requests a plan the kernel takes: swapped tiles (8 or 64 tokens) that
    hold all M rows, else 128 x 256 tiles; grid rows within 65535."""
    # (N, K): qkv, joint swiglu gate+up, attention out, mlp out, the
    # embedding's proj_out, txt_in
    linears = [(7680, 2560), (13824, 2560), (2560, 2560), (2560, 6912),
               (15360, 2560), (2560, 5120)]
    for m in (1, 8, 9, 58, 64, 65, 7200, 8160, 16320, 32400):
        for n, k in linears:
            swap, bt = tim.plan_qx(m)
            assert k % 32 == 0 and n % 8 == 0
            if swap:
                assert bt in (8, 64) and m <= bt and -(-n // 128) <= 65535
            else:
                assert bt == 256 and m > 64 and -(-m // 128) <= 65535
