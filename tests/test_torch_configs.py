"""The PyTorch port's host-side copies equal the JAX package's originals:
configs, the window planner, the rope tables and the whole DiT plan
(exact equality: the same numpy code on the same inputs). Also checks that
the port imports with JAX and the JAX package blocked."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seedvr2_tpu.core import configs as jc
from seedvr2_tpu.models.dit import nadit as jn
from seedvr2_tpu.models.dit import rope as jr
from seedvr2_tpu.models.dit import windows as jw
from seedvr2_tpu_torch.core import configs as tc
from seedvr2_tpu_torch.models.dit import nadit as tn
from seedvr2_tpu_torch.models.dit import rope as tr
from seedvr2_tpu_torch.models.dit import windows as tw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", ["DIT_3B", "DIT_7B", "VAE_V3"])
def test_config_constants_equal(name):
    assert dataclasses.asdict(getattr(tc, name)) == dataclasses.asdict(
        getattr(jc, name))


def test_derived_configs_equal():
    for fam in ("dit_3b", "dit_7b"):
        assert dataclasses.asdict(tc.small_test_config(fam)) == \
            dataclasses.asdict(jc.small_test_config(fam))
    assert dataclasses.asdict(tc.RunnerConfig()) == dataclasses.asdict(
        jc.RunnerConfig())
    for name in ("seedvr2_ema_3b_fp16.safetensors", "seedvr2_ema_7b.gguf"):
        assert tc.dit_config_for(name).family == jc.dit_config_for(name).family
    t, j = tc.DIT_3B, jc.DIT_3B
    for i in range(t.num_layers):
        assert (t.block_shared(i), t.block_vid_only(i), t.window_method(i)) \
            == (j.block_shared(i), j.block_vid_only(i), j.window_method(i))
    assert tc.VAE_V3.slicing_latent_min_size == jc.VAE_V3.slicing_latent_min_size


SIZES = [(3, 8, 10), (1, 45, 80), (2, 45, 80), (2, 68, 120), (5, 12, 8)]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("method", ["window", "shifted_window"])
def test_window_plans_equal(size, method):
    a = tw.build_layer_plan(size, (4, 3, 3), method)
    b = jw.build_layer_plan(size, (4, 3, 3), method)
    assert a.num_windows == b.num_windows
    np.testing.assert_array_equal(a.inv, b.inv)
    assert [g.shape for g in a.groups] == [g.shape for g in b.groups]
    for ga, gb in zip(a.groups, b.groups):
        np.testing.assert_array_equal(ga.idx, gb.idx)


def test_rope_tables_equal():
    for args in (((1, 15, 27), 58, 126), ((2, 3, 4), 7, 12)):
        for x, y in zip(tr.mmrope3d_video_table(*args),
                        jr.mmrope3d_video_table(*args)):
            np.testing.assert_array_equal(x, y)
    for x, y in zip(tr.mmrope3d_text_table(58, 126),
                    jr.mmrope3d_text_table(58, 126)):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(tr.rope3d_pixel_table((2, 5, 6), 64),
                    jr.rope3d_pixel_table((2, 5, 6), 64)):
        np.testing.assert_array_equal(x, y)
    c, s = jr.mmrope3d_video_table((2, 3, 4), 7, 12)
    for x, y in zip(tr.extend_tables(c, s, 16, 7),
                    jr.extend_tables(c, s, 16, 7)):
        np.testing.assert_array_equal(x, y)
    z = np.random.default_rng(0).standard_normal((3, 5, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        tr.rotate_half_full(torch.from_numpy(z)).numpy(),
        np.asarray(jr.rotate_half_full(jnp.asarray(z))))


@pytest.mark.parametrize("cfg_name,shape,txt_len", [
    ("DIT_3B", (2, 90, 160), 58),   # the 5-frame 720p clip's latent
    ("DIT_3B", (1, 136, 240), 64),  # a 1080p image's latent
    ("small", (3, 8, 10), 7),
])
def test_dit_plan_equal(cfg_name, shape, txt_len):
    if cfg_name == "small":
        t_cfg, j_cfg = tc.small_test_config(), jc.small_test_config()
    else:
        t_cfg, j_cfg = getattr(tc, cfg_name), getattr(jc, cfg_name)
    a = tn.build_dit_plan(t_cfg, shape, txt_len)
    b = jn.build_dit_plan(j_cfg, shape, txt_len)
    assert (a.grid, a.txt_len, a.seq_len) == (b.grid, b.txt_len, b.seq_len)
    for m in ("window", "shifted_window"):
        la, lb = a.layer_plans[m], b.layer_plans[m]
        assert la.num_windows == lb.num_windows
        np.testing.assert_array_equal(la.inv, lb.inv)
        np.testing.assert_array_equal(la.flat, lb.flat)
        for ga, gb in zip(la.groups, lb.groups, strict=True):
            assert ga.shape == gb.shape
            for x, y in ((ga.idx, gb.idx), (ga.cos, gb.cos), (ga.sin, gb.sin)):
                np.testing.assert_array_equal(x, y)
    assert a.transitions.keys() == b.transitions.keys()
    for k in a.transitions:
        np.testing.assert_array_equal(a.transitions[k], b.transitions[k])


def test_port_imports_without_jax():
    """Every module of seedvr2_tpu_torch, and chip_smoke.py, import with
    `jax` and the JAX package made unimportable (a None entry in
    sys.modules makes any later `import jax...` raise)."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['seedvr2_tpu'] = None\n"
        "import seedvr2_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "seedvr2_tpu_torch.__path__, 'seedvr2_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 35
