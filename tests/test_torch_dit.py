"""The port's NaDiT against the JAX package's on the CPU in fp32, with the
same weights carried over by the weight bridge, and the bridge itself
against seedvr2_tpu.core.export."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seedvr2_tpu.core import export as jexport
from seedvr2_tpu.core.configs import small_test_config as j_small
from seedvr2_tpu.models.dit import nadit as jn
from seedvr2_tpu_torch.core.configs import small_test_config
from seedvr2_tpu_torch.core.weights import (load_safetensors_checkpoint,
                                            state_dict_from_jax)
from seedvr2_tpu_torch.models.dit import nadit as tn


def random_params(init, seed: int):
    """A JAX-layout parameter tree with `init`'s structure (jax.eval_shape:
    nothing is compiled) and seeded numpy fp32 values: weights "w"
    U(+-1/sqrt(fan_in)), biases "b" U(+-0.1), norm weights and ada scales
    1 + N(0, 0.1^2), other ada vectors N(0, 0.1^2). Norm weights away from 1
    exercise the qk-norm weight folding that a fresh init (all ones) would
    hide."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = getattr(path[-1], "key", "")
        shape = leaf.shape
        if name == "w":
            bound = 1.0 / np.sqrt(np.prod(shape[:-1]))
            v = rng.uniform(-bound, bound, shape)
        elif name == "b":
            v = rng.uniform(-0.1, 0.1, shape)
        else:
            v = rng.normal(0.0, 0.1, shape)
            if name == "weight" or name.endswith("_scale"):
                v = v + 1.0
        return v.astype(np.float32)

    shapes = jax.eval_shape(lambda k: init(k), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _jax_dit_params(cfg, seed=0):
    return random_params(lambda k: jn.init_dit_params(k, cfg,
                                                      dtype=jnp.float32), seed)


@pytest.fixture(scope="module")
def dit_pair():
    cfg = small_test_config()
    params = _jax_dit_params(j_small())
    model = tn.NaDiT(cfg, dtype=torch.float32)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return cfg, params, model


@pytest.mark.parametrize("shape", [(3, 8, 10), (1, 6, 6), (5, 12, 8)])
def test_nadit_forward_matches_jax(dit_pair, shape):
    """fp32 on both sides with identical weights: 2 blocks of matmuls summed
    in other orders stay within 1e-4 (observed 7e-7 on outputs of ~2)."""
    cfg, params, model = dit_pair
    T, H, W = shape
    txt_len = 7
    rng = np.random.default_rng(42)
    vid = rng.standard_normal((1, T, H, W, cfg.vid_in_channels),
                              dtype=np.float32)
    txt = rng.standard_normal((1, txt_len, cfg.txt_in_dim), dtype=np.float32)
    plan = jn.build_dit_plan(j_small(), shape, txt_len)
    ref = np.asarray(jax.jit(lambda p, v, x, t: jn.nadit_forward(
        p, j_small(), v, x, t, plan))(params, jnp.asarray(vid),
                                      jnp.asarray(txt), jnp.asarray([500.0])))
    dplan = tn.upload_plan(tn.build_dit_plan(cfg, shape, txt_len), cfg, "cpu")
    with torch.no_grad():
        out = tn.nadit_forward(model, torch.from_numpy(vid),
                               torch.from_numpy(txt), torch.tensor([500.0]),
                               dplan).numpy()
        plain = tn.nadit_forward(model, torch.from_numpy(vid),
                                 torch.from_numpy(txt), torch.tensor([500.0]),
                                 dplan, use_kernels=False).numpy()
    assert out.shape == (1, T, H, W, cfg.vid_out_channels)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(out, plain)  # CPU: wrappers run plain


def assert_bridge_matches_export(tree, module):
    """state_dict_from_jax == export.to_torch_state_dict (fp32), key for key
    and bit for bit, and its keys are exactly the port module's keys."""
    ours = state_dict_from_jax(tree)
    ref = jexport.to_torch_state_dict(tree, dtype=np.float32)
    assert ours.keys() == ref.keys() == module.state_dict().keys()
    for k in ref:
        np.testing.assert_array_equal(ours[k].numpy(), ref[k])
    module.load_state_dict(ours, strict=True)


def test_weight_bridge_matches_export_dit(dit_pair):
    _, params, model = dit_pair
    assert_bridge_matches_export(params, model)


def test_checkpoint_loads_strict(dit_pair, tmp_path):
    """A reference-layout fp16 checkpoint written by the JAX package loads
    through the port's own safetensors reader with strict=True."""
    cfg, params, _ = dit_pair
    path = str(tmp_path / "dit.safetensors")
    jexport.save_checkpoint(params, path)
    model = load_safetensors_checkpoint(path, tn.NaDiT(cfg,
                                                       dtype=torch.float32))
    ref = jexport.to_torch_state_dict(params)  # fp16, as saved
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), ref[k].astype(np.float32))
    bad = tn.NaDiT(small_test_config(num_layers=3), dtype=torch.float32)
    with pytest.raises(RuntimeError):
        load_safetensors_checkpoint(path, bad)


def test_init_dit_distributions():
    """init_dit draws the JAX package's distributions: same keys and shapes
    as init_dit_params, U(+-1/sqrt(fan_in)) linears, unit norm weights,
    N(0, 1/D) ada (+1 for scales)."""
    cfg = small_test_config(vid_dim=128, head_dim=64)
    gen = torch.Generator().manual_seed(0)
    model = tn.init_dit(cfg, "cpu", torch.float32, generator=gen)
    shapes = jax.eval_shape(lambda k: jn.init_dit_params(
        k, j_small(vid_dim=128, head_dim=64), dtype=jnp.float32),
        jax.random.PRNGKey(0))
    ref = jexport.to_torch_state_dict(jax.tree_util.tree_map(
        lambda x: np.zeros(x.shape, np.float32), shapes), dtype=np.float32)
    sd = model.state_dict()
    assert sd.keys() == ref.keys()
    D = cfg.vid_dim
    for k, v in sd.items():
        assert tuple(v.shape) == ref[k].shape, k
        if k.endswith("norm_q.vid.weight") or k == "vid_out_norm.weight":
            assert torch.all(v == 1)
        elif k.endswith("attn_scale"):
            assert abs(v.mean().item() - 1) < 6 / D  # 6 sigma of the mean
        elif k.endswith("blocks.0.attn.proj_qkv.vid.weight"):
            bound = 1 / np.sqrt(v.shape[1])
            assert v.abs().max() <= bound
            assert abs(v.std().item() - bound / np.sqrt(3)) < 0.05 * bound
