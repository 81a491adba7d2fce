"""The port's small modules against the JAX package on the CPU in fp32:
diffusion math, layers, transforms, colour correction and text embeddings.

Tolerance: fp32 elementwise math computed in the same order on both sides
agrees to a few ulps; 1e-5 (relative and absolute) leaves room for
reductions summed in another order. Exceptions state their own reason."""

import numpy as np
import pytest
import torch
from torch import nn

import jax.numpy as jnp

from seedvr2_tpu.core import diffusion as jd
from seedvr2_tpu.ops import layers as jl
from seedvr2_tpu.utils import color_fix as jcf
from seedvr2_tpu.utils import text_embeds as jte
from seedvr2_tpu.utils import transforms as jt
from seedvr2_tpu_torch.core import diffusion as td
from seedvr2_tpu_torch.ops import layers as tl
from seedvr2_tpu_torch.utils import color_fix as tcf
from seedvr2_tpu_torch.utils import text_embeds as tte
from seedvr2_tpu_torch.utils import transforms as tt

TOL = dict(rtol=1e-5, atol=1e-5)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               **(tol or TOL))


# ------------------------------------------------------------- diffusion


@pytest.mark.parametrize("steps,shift", [(1, 1.0), (4, 1.0), (50, 3.0)])
def test_trailing_timesteps(steps, shift):
    np.testing.assert_array_equal(td.trailing_timesteps(1000.0, steps, shift),
                                  jd.trailing_timesteps(1000.0, steps, shift))


@pytest.mark.parametrize("pred_type", ["v_lerp", "x_0", "x_T"])
def test_schedule_and_euler(pred_type):
    rng = _rng(1)
    pred, x = (rng.standard_normal((2, 3, 4, 4)).astype(np.float32)
               for _ in range(2))
    ts, js = td.LerpSchedule(), jd.LerpSchedule()
    t = 640.0
    for a, b in zip(ts.convert_from_pred(torch.from_numpy(pred), pred_type,
                                         torch.from_numpy(x), t),
                    js.convert_from_pred(jnp.asarray(pred), pred_type,
                                         jnp.asarray(x), t)):
        _close(a, b)
    _close(ts.forward(torch.from_numpy(x), torch.from_numpy(pred), t),
           js.forward(jnp.asarray(x), jnp.asarray(pred), t))
    for s in (-5.0, 300.0, 1200.0):
        _close(td.euler_step_to(ts, torch.from_numpy(pred),
                                torch.from_numpy(x), t, s, pred_type),
               jd.euler_step_to(js, jnp.asarray(pred), jnp.asarray(x), t, s,
                                pred_type))


def test_timestep_shift_and_cfg():
    shapes = np.array([[1, 90, 160], [2, 90, 160], [4, 135, 240]], np.float32)
    t = np.array([1000.0, 500.0, 250.0], np.float32)
    _close(td.timestep_shift(torch.from_numpy(t), torch.from_numpy(shapes)),
           jd.timestep_shift(jnp.asarray(t), jnp.asarray(shapes)))
    rng = _rng(2)
    pos, neg = (rng.standard_normal((2, 5, 6)).astype(np.float32)
                for _ in range(2))
    for rescale in (0.0, 0.7):
        _close(td.classifier_free_guidance(torch.from_numpy(pos),
                                           torch.from_numpy(neg), 3.5,
                                           rescale),
               jd.classifier_free_guidance(jnp.asarray(pos), jnp.asarray(neg),
                                           3.5, rescale))


# ---------------------------------------------------------------- layers


def _linear_pair(rng, d_in, d_out, bias=True):
    w = rng.standard_normal((d_in, d_out)).astype(np.float32) / np.sqrt(d_in)
    b = rng.standard_normal(d_out).astype(np.float32) if bias else None
    layer = nn.Linear(d_in, d_out, bias=bias)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(w.T))
        if bias:
            layer.bias.copy_(torch.from_numpy(b))
    p = {"w": jnp.asarray(w)}
    if bias:
        p["b"] = jnp.asarray(b)
    return layer, p


def test_norms_and_activations():
    rng = _rng(3)
    x = rng.standard_normal((2, 7, 32)).astype(np.float32) * 3
    w = rng.standard_normal(32).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    _close(tl.rms_norm(xt, 1e-5), jl.rms_norm(xj, 1e-5))
    _close(tl.rms_norm(xt, 1e-6, torch.from_numpy(w)),
           jl.rms_norm(xj, 1e-6, jnp.asarray(w)))
    v = rng.standard_normal((2, 3, 5, 6, 32)).astype(np.float32) + 1.5
    b = rng.standard_normal(32).astype(np.float32)
    _close(tl.group_norm(torch.from_numpy(v), 8, 1e-6, torch.from_numpy(w),
                         torch.from_numpy(b)),
           jl.group_norm(jnp.asarray(v), 8, 1e-6, jnp.asarray(w),
                         jnp.asarray(b)))
    _close(tl.silu(xt), jl.silu(xj))
    _close(tl.gelu_tanh(xt), jl.gelu_tanh(xj))


@pytest.mark.parametrize("mlp_type", ["swiglu", "normal"])
def test_linear_and_mlp(mlp_type):
    rng = _rng(4)
    d = 32
    x = rng.standard_normal((2, 9, d)).astype(np.float32)
    lin, p = _linear_pair(rng, d, 24)
    _close(tl.linear(torch.from_numpy(x), lin), jl.linear(jnp.asarray(x), p))
    mlp, pj = nn.Module(), {}
    if mlp_type == "swiglu":
        hidden = tl.swiglu_hidden_dim(d, 4, multiple_of=16)
        names = (("proj_in_gate", d, hidden), ("proj_in", d, hidden),
                 ("proj_out", hidden, d))
        bias = False
    else:
        names = (("proj_in", d, 4 * d), ("proj_out", 4 * d, d))
        bias = True
    for name, a, b in names:
        layer, pj[name] = _linear_pair(rng, a, b, bias)
        setattr(mlp, name, layer)
    _close(tl.mlp_forward(torch.from_numpy(x), mlp, mlp_type),
           jl.mlp_forward(jnp.asarray(x), pj, mlp_type), rtol=1e-5, atol=2e-5)
    for dim, r in ((2560, 4), (64, 4), (3072, 4)):
        assert tl.swiglu_hidden_dim(dim, r) == jl.swiglu_hidden_dim(dim, r)


# ------------------------------------------------------------ transforms


@pytest.mark.parametrize("shape,res", [((3, 24, 20, 3), 32),
                                       ((1, 36, 64, 3), 72),
                                       ((2, 40, 30, 3), 16)])
def test_prepare_video(shape, res):
    x = _rng(5).uniform(0, 1, shape).astype(np.float32)
    h, w = shape[1:3]
    nh, nw = tt.side_resize_dims(h, w, res)
    assert (nh, nw) == jt.side_resize_dims(h, w, res)
    np.testing.assert_array_equal(tt.resize_matrix(h, nh),
                                  jt.resize_matrix(h, nh))
    _close(tt.prepare_video(torch.from_numpy(x), res),
           jt.prepare_video(jnp.asarray(x), res))
    assert tt.compute_target_dims(h, w, res) == jt.compute_target_dims(h, w,
                                                                       res)
    assert tt.side_resize_dims(h, w, res, max_size=res + 8) == \
        jt.side_resize_dims(h, w, res, max_size=res + 8)


# ----------------------------------------------------------------- colour


def test_wavelet_reconstruction():
    rng = _rng(6)
    a = rng.uniform(-1, 1, (2, 40, 48, 3)).astype(np.float32)
    b = rng.uniform(-1, 1, (2, 40, 48, 3)).astype(np.float32)
    _close(tcf.wavelet_reconstruction(torch.from_numpy(a),
                                      torch.from_numpy(b)),
           jcf.wavelet_reconstruction(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("seed", [7, 8])
def test_lab_color_transfer(seed):
    """Sort-based histogram matching is discontinuous: a last-ulp
    difference in a LAB value (pow vs cbrt) can swap two neighbours' ranks,
    which moves each by one gap between adjacent sorted reference values.
    So: nearly every element within 1e-4, the few swapped ones within 1e-2
    (observed: 10 of 17280 above 1e-4, max 3.1e-3)."""
    rng = _rng(seed)
    a = rng.uniform(-1, 1, (3, 40, 48, 3)).astype(np.float32)
    b = rng.uniform(-1.1, 1.1, (3, 40, 48, 3)).astype(np.float32)
    out = tcf.apply_color_correction("lab", torch.from_numpy(a),
                                     torch.from_numpy(b)).numpy()
    ref = np.asarray(jcf.apply_color_correction("lab", jnp.asarray(a),
                                                jnp.asarray(b)))
    diff = np.abs(out - ref)
    assert diff.max() < 1e-2
    assert (diff > 1e-4).mean() < 1e-3
    x = torch.from_numpy(a)
    assert tcf.apply_color_correction("none", x, x) is x
    with pytest.raises(ValueError, match="unknown colour correction"):
        tcf.apply_color_correction("sepia", x, x)


# ------------------------------------------------------------ embeddings


def test_packaged_text_embeddings_equal(monkeypatch):
    """The port ships its own copies of the published embeddings, byte-equal
    to the JAX package's files, and its loader opens nothing outside
    seedvr2_tpu_torch/. Its own safetensors reader gives the JAX loader's
    values bit for bit (both upcast the stored bf16 to fp32)."""
    import builtins
    import os

    import seedvr2_tpu
    import seedvr2_tpu_torch
    from seedvr2_tpu_torch.core import weights as tw

    port_dir = os.path.dirname(os.path.abspath(seedvr2_tpu_torch.__file__))
    jax_assets = os.path.join(os.path.dirname(seedvr2_tpu.__file__), "assets")
    for name in ("pos_emb.safetensors", "neg_emb.safetensors"):
        with open(os.path.join(port_dir, "assets", name), "rb") as f:
            ours = f.read()
        with open(os.path.join(jax_assets, name), "rb") as f:
            assert ours == f.read(), name
    assert all(os.path.abspath(d).startswith(port_dir + os.sep)
               for d in tte.ASSET_DIRS)

    opened = []

    def recording_open(path, *args, **kwargs):
        opened.append(os.path.abspath(path))
        return builtins.open(path, *args, **kwargs)

    monkeypatch.setattr(tw, "open", recording_open, raising=False)
    t = tte.load_text_embeddings()
    assert len(opened) == 2
    assert all(p.startswith(port_dir + os.sep) for p in opened), opened
    j = jte.load_text_embeddings([], None)
    for k in ("pos", "neg"):
        assert t[k].shape == j[k].shape and t[k].dtype == np.float32
        np.testing.assert_array_equal(t[k], j[k])
    assert t["pos"].shape == (tte.POS_LEN, tte.TXT_DIM)
    z = tte.load_text_embeddings(txt_dim=48)
    assert z["pos"].shape == (tte.POS_LEN, 48) and not z["pos"].any()
