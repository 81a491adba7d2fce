"""`--vae_*_tile_size auto` (seedvr2_tpu_torch/utils/memplan.py, the
runner's `_resolve_tile`) against the JAX package's utils/memplan.py on the
CPU. The probe, which runs on the card in the port and compiles on the TPU
in JAX, is replaced in both packages by one shared function of the tile
shape, so the ladder walk, the candidates it probes and its choice must be
the same for a sweep of budgets (exactly: host integers). The port's own
overhead terms are held to the buffers its tiled encode / decode
allocates (an allocation-recording dispatch mode, the tile runs stubbed),
and to JAX's formula where the terms are the same. Also: the giant-image
skip, the probe cache (round trip, key, atomic and failure-proof write), an
out-of-memory probe as "does not fit" and any other probe error raised
(where JAX serves 1024 px), the runner resolving per item shape as JAX's
does (and decoding equal to the same fixed tile), the CPU default, the CLI
parsing `auto`, and the out-of-memory retry shrinking an auto plan."""

import dataclasses
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

import jax.numpy as jnp

import inference_cli
from seedvr2_tpu.core.configs import RunnerConfig as JRunnerConfig
from seedvr2_tpu.core.configs import VAEConfig as JVAEConfig
from seedvr2_tpu.core.runner import VideoDiffusionRunner as JRunner
from seedvr2_tpu.models.vae import pipeline_vae as jv
from seedvr2_tpu.utils import memplan as jm
from seedvr2_tpu_torch import cli
from seedvr2_tpu_torch.core import configs as tc
from seedvr2_tpu_torch.core.runner import VAETiling
from seedvr2_tpu_torch.core.runner import VideoDiffusionRunner as TRunner
from seedvr2_tpu_torch.core.weights import state_dict_from_jax
from seedvr2_tpu_torch.models.dit.nadit import NaDiT
from seedvr2_tpu_torch.models.vae import model as tmodel
from seedvr2_tpu_torch.models.vae import pipeline_vae as tv
from seedvr2_tpu_torch.utils import memplan as tm

from .test_torch_dit import random_params
from .test_torch_vae import TINY


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("SEEDVR2_MEMPROBE_CACHE",
                       str(tmp_path / "memprobe.json"))
    tm.reset_cache_for_tests()
    jm.reset_cache_for_tests()
    yield
    tm.reset_cache_for_tests()
    jm.reset_cache_for_tests()


def _stubs(**cfg):
    """VAE stand-ins carrying what plan_auto_tile reads: cfg and dtype (and
    for the port, what its probe key reads: a module and a Lowering)."""
    return (SimpleNamespace(cfg=JVAEConfig(**cfg), dtype=jnp.bfloat16),
            SimpleNamespace(cfg=tc.VAEConfig(**cfg), dtype=torch.bfloat16,
                            model=torch.nn.Linear(1, 1),
                            lowering=tmodel.Lowering()))


def _fake_probe(calls):
    """The shared probe: bytes grow with the tile area and the frames, as
    a VAE's workspace does (30 kB a latent pixel and frame, plus 50 MB)."""
    def probe(vae, kind, batch, frames, th, tw):
        calls.append((kind, batch, frames, th, tw))
        return 30_000 * th * tw * frames * batch + 50_000_000
    return probe


_REAL_JAX_OVERHEAD = jm._overhead_bytes


def _jax_overhead(kind, batch, frames_px, h, w, n_tiles, th, tw, tl, sf,
                  latc, dtype):
    """JAX's overhead formula (bf16), given to both packages."""
    return _REAL_JAX_OVERHEAD(kind, batch, frames_px, h, w, n_tiles, th, tw,
                              tl, sf, latc, jnp.bfloat16)


def _plans(monkeypatch, kind, lat_hw, frames, overlap, budget):
    """(choice, probed candidates) of each package for the same probe, the
    same overhead function (JAX's) and JAX's margin (the fake probes leave
    no measured fragmentation)."""
    out = []
    monkeypatch.setattr(tm, "_SAFETY_BYTES", jm._SAFETY_BYTES)
    for mod, vae in zip((jm, tm), _stubs()):
        calls = []
        monkeypatch.setattr(mod, "probe_tile_bytes", _fake_probe(calls))
        monkeypatch.setattr(mod, "_overhead_bytes", _jax_overhead)
        got = mod.plan_auto_tile(vae, kind, lat_hw, 1, frames, overlap,
                                 budget)
        out.append((got, calls))
    return out


def test_ladders_equal_jax_margin_above_it():
    """JAX's ladders; the port's margin is above JAX's 600 MB (measured on
    the card: PERF.md)."""
    assert tm.DECODE_LADDER == jm.DECODE_LADDER
    assert tm.ENCODE_LADDER == jm.ENCODE_LADDER
    assert tm._SAFETY_BYTES > jm._SAFETY_BYTES


def test_measured_fragmentation_joins_the_margin(monkeypatch):
    """A probe's cached fragmentation (reserved beyond its allocated peak)
    is added to that candidate's margin: a budget the bytes alone fit is
    refused when the fragmentation does not fit too."""
    _, vae = _stubs()
    monkeypatch.setattr(tm, "probe_tile_bytes", _fake_probe([]))
    need = 30_000 * 100 * 150 * 2 + 50_000_000 + tm._SAFETY_BYTES
    assert tm.plan_auto_tile(vae, "decode", (100, 150), 1, 5, (64, 64),
                             need) is None
    key = tm.probe_key(vae, "decode", 1, 2, 100, 150)
    tm._store_entries({f"{key}|gap": 10 ** 9})
    assert tm.fragmentation(vae, "decode", 1, 2, 100, 150) == 10 ** 9
    assert tm.plan_auto_tile(vae, "decode", (100, 150), 1, 5, (64, 64),
                             need) is not None
    assert tm.plan_auto_tile(vae, "decode", (100, 150), 1, 5, (64, 64),
                             need + 10 ** 9) is None


# latent images: 4K, 1080p, 720p, a 540x960 input, small and odd shapes
IMAGES = [(270, 480), (135, 240), (90, 160), (68, 120), (40, 60), (33, 257)]


@pytest.mark.parametrize("kind", ["decode", "encode"])
@pytest.mark.parametrize("lat_hw", IMAGES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_ladder_walk_and_choice_equal_jax(monkeypatch, kind, lat_hw):
    """For budgets from nothing to plenty (log-spaced, 5 and 17 frames, two
    overlaps) both packages probe the same candidates in the same order
    and pick the same plan."""
    seen = set()
    for frames in (5, 17):
        for overlap in ((64, 64), (128, 96)):
            for budget in np.geomspace(1e7, 1e12, 23).astype(np.int64):
                (jgot, jcalls), (tgot, tcalls) = _plans(
                    monkeypatch, kind, lat_hw, frames, overlap, int(budget))
                assert tgot == jgot, (frames, overlap, budget)
                assert tcalls == jcalls
                seen.add(tgot)
    # the sweep crosses rungs: untiled, tiled, the smallest rung
    assert len(seen) >= (3 if lat_hw[0] * lat_hw[1] >= 90 * 160 else 2)


def test_giant_image_skips_the_untiled_probe(monkeypatch):
    """At 4K the untiled candidate is not probed (a hopeless run), in both
    packages; the ladder is."""
    for mod, vae in zip((jm, tm), _stubs()):
        calls = []
        monkeypatch.setattr(mod, "probe_tile_bytes", lambda *a, c=calls: (
            c.append(a[4:]), 10 ** 18)[1])
        mod.plan_auto_tile(vae, "decode", (270, 480), 1, 5, (64, 64),
                           10 ** 12)
        assert (270, 480) not in calls and calls
    # a small image probes untiled first and serves it when it fits
    calls = []
    monkeypatch.setattr(tm, "probe_tile_bytes", _fake_probe(calls))
    assert tm.plan_auto_tile(_stubs()[1], "decode", (100, 150), 1, 5,
                             (64, 64), 10 ** 15) is None
    assert calls == [("decode", 1, 2, 100, 150)]


# ----------------------------------------------------- overhead vs buffers


class Allocations(TorchDispatchMode):
    """Bytes of every new storage an op creates (views and in-place ops
    create none), except while `paused`."""

    def __init__(self):
        super().__init__()
        self.sizes, self.paused = [], False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.paused:
            seen = {t.untyped_storage().data_ptr()
                    for t in tree_flatten((args, kwargs))[0]
                    if isinstance(t, torch.Tensor)}
            for t in tree_flatten(out)[0]:
                if isinstance(t, torch.Tensor):
                    ptr = t.untyped_storage().data_ptr()
                    if ptr not in seen and t.untyped_storage().nbytes():
                        seen.add(ptr)
                        self.sizes.append(t.untyped_storage().nbytes())
        return out


# (kind, image px (H, W), tile px, overlap px): grids of 2 x 2, 2 x 3, 3 x 1
GRIDS = [("decode", (96, 128), 64, 16), ("decode", (80, 176), 72, 8),
         ("decode", (160, 48), 64, 16), ("encode", (96, 128), 64, 16),
         ("encode", (80, 176), 72, 8)]


@pytest.mark.parametrize("kind,hw,tile,ov", GRIDS)
def test_overhead_terms_are_the_tiled_paths_buffers(monkeypatch, kind, hw,
                                                    tile, ov):
    """Every storage the port's tiled VideoVAE call creates outside its
    tile runs (stubbed: each returns a fresh tile of the real shape) is
    one of overhead_terms' buffers: on the CPU the fp32 accumulator, its
    normalized copy and the bf16 result once, the two fp32 tiles per tile
    (the fade mask and count planes are host arrays the CPU wraps without a
    copy; on the card each is one copy of the "mask" / "count" size).
    Their sum is _overhead_bytes, which equals JAX's formula without the
    terms JAX alone has (the stacked crops; for encode the resident
    input)."""
    model = tmodel.VideoAutoencoder(tc.VAEConfig(**TINY), device="meta")
    vae = tv.VideoVAE(model, torch.bfloat16)
    cfg, sf, frames = vae.cfg, 8, 5
    rec = Allocations()

    def stub(out_shape):
        def run(m, x, lowering):
            rec.paused = True
            try:
                return torch.zeros(out_shape(x), dtype=torch.bfloat16)
            finally:
                rec.paused = False
        return run

    lat = cfg.latent_channels
    monkeypatch.setattr(tv, "_decode_slices", stub(lambda z: (
        z.shape[0], frames, z.shape[2] * sf, z.shape[3] * sf, 3)))
    monkeypatch.setattr(tv, "_encode_slices", stub(lambda x: (
        x.shape[0], 2, x.shape[2] // sf, x.shape[3] // sf, 2 * lat)))
    h, w = hw[0] // sf, hw[1] // sf
    kw = dict(tiled=True, tile_size=(tile, tile), tile_overlap=(ov, ov))
    if kind == "decode":
        arg = torch.zeros(1, 2, h, w, lat, dtype=torch.bfloat16)
        with rec:
            vae.decode(arg, **kw)
        tiles = vae.last_decode_tiles
    else:
        arg = torch.zeros(1, frames, hw[0], hw[1], 3, dtype=torch.bfloat16)
        with rec:
            vae.encode(arg, **kw)
        tiles = vae.last_encode_tiles
    th, tw = tiles[0][2] // sf, tiles[0][3] // sf
    n = len(tiles)
    assert n > 1 and all(t[2:] == tiles[0][2:] for t in tiles)
    terms = tm.overhead_terms(kind, 1, frames, h, w, th, tw, 2, sf, lat,
                              torch.bfloat16)
    once = sorted([terms["acc"], terms["normalized"], terms["result"]])
    each = [terms["tile_f32"] // 2] * 2
    assert sorted(rec.sizes) == sorted(once + each * n)
    total = tm._overhead_bytes(kind, 1, frames, h, w, n, th, tw, 2, sf, lat,
                               torch.bfloat16)
    assert total == sum(terms.values()) == sum(once) + sum(each) + \
        terms["mask"] + terms["count"]
    assert terms["mask"] == (th * tw * (sf * sf if kind == "decode" else 1)
                             * 4)
    # JAX's terms: decode 2 acc + acc // 2 (bf16) + the crops; encode the
    # pixel input + 2 acc
    jax_b = jm._overhead_bytes(kind, 1, frames, h, w, n, th, tw, 2, sf, lat,
                               jnp.bfloat16)
    if kind == "decode":
        crops = n * 1 * 2 * th * tw * lat * 2
        assert jax_b - crops == sum(once)
    else:
        inp = 1 * frames * h * sf * w * sf * 3 * 2
        assert jax_b - inp == terms["acc"] + terms["normalized"]


# ------------------------------------------------------------ probe cache


@pytest.fixture(scope="module")
def tiny_vae():
    return tv.VideoVAE(tv.init_vae_params(tc.VAEConfig(**TINY), "cpu",
                                          torch.float32), torch.float32)


def test_probe_cache_round_trip_and_key(tiny_vae, tmp_path, monkeypatch):
    """A stored probe is served from the file (no run: the CPU cannot run
    one), in a fresh process mirror too; the key holds the device, the
    dtype, the config's switches, the Lowering, the kind, batch, frames and
    tile shape."""
    key = tm.probe_key(tiny_vae, "decode", 1, 2, 8, 12)
    assert key.startswith("cpu|float32|(8, 8, 16, 16)|1|4|4|none|True|False|"
                          "False|full|")
    assert key.endswith("|decode|1|2|8|12")
    assert str(dataclasses.astuple(tiny_vae.lowering)) in key
    tm._store_entries({key: 12345})
    data = json.loads((tmp_path / "memprobe.json").read_text())
    assert data == {key: 12345}
    tm.reset_cache_for_tests()
    assert tm.probe_tile_bytes(tiny_vae, "decode", 1, 2, 8, 12) == 12345
    # every field of the signature moves the key
    legacy = tv.VideoVAE(tv.init_vae_params(tc.VAEConfig(
        **TINY, mid_attention=False), "cpu", torch.float32), torch.float32)
    other = [tm.probe_key(legacy, "decode", 1, 2, 8, 12),
             tm.probe_key(tiny_vae, "encode", 1, 2, 8, 12),
             tm.probe_key(tiny_vae, "decode", 1, 3, 8, 12),
             tm.probe_key(tiny_vae, "decode", 1, 2, 12, 8)]
    monkeypatch.setattr(tiny_vae, "lowering", dataclasses.replace(
        tiny_vae.lowering, upsample_convt=False))
    other.append(tm.probe_key(tiny_vae, "decode", 1, 2, 8, 12))
    assert len(set(other + [key])) == 6
    # an unwritable path never fails the plan
    monkeypatch.setenv("SEEDVR2_MEMPROBE_CACHE",
                       str(tmp_path / "memprobe.json" / "x.json"))
    tm.reset_cache_for_tests()
    tm._store_entries({key: 1})
    assert tm._load_cache()[key] == 1


def test_oom_verdict_is_kept_as_a_bound(monkeypatch):
    """A tile whose probe ran out of memory with R bytes of room is not run
    again while R + its overhead + the margin exceeds the budget; with more
    room than that it is probed again."""
    _, vae = _stubs()
    calls = []
    monkeypatch.setattr(tm, "probe_tile_bytes", _fake_probe(calls))
    monkeypatch.setattr(tm, "_SAFETY_BYTES", 1000)
    key = tm.probe_key(vae, "decode", 1, 2, 100, 150)
    tm._store_entries({f"{key}|oom": 5 * 10 ** 9})
    assert tm.oom_bound(vae, "decode", 1, 2, 100, 150) == 5 * 10 ** 9
    tm.plan_auto_tile(vae, "decode", (100, 150), 1, 5, (64, 64), 5 * 10 ** 9)
    assert calls and (100, 150) not in [c[3:] for c in calls]
    calls.clear()
    assert tm.plan_auto_tile(vae, "decode", (100, 150), 1, 5, (64, 64),
                             10 ** 12) is None
    assert calls == [("decode", 1, 2, 100, 150)]


def test_oom_probe_is_a_verdict_other_errors_raise(monkeypatch):
    """An out-of-memory probe means "does not fit": the walk goes on to the
    next candidate. Any other probe error propagates, where JAX, whose
    probes may be unsupported, serves the fixed 1024 px plan."""
    _, vae = _stubs()
    calls = []

    def probe(vae, kind, batch, frames, th, tw):
        calls.append((th, tw))
        if th * tw > 60 * 120:
            raise torch.cuda.OutOfMemoryError("stub: tile too large")
        return 1000

    monkeypatch.setattr(tm, "probe_tile_bytes", probe)
    monkeypatch.setattr(tm, "_SAFETY_BYTES", 0)
    got = tm.plan_auto_tile(vae, "decode", (135, 240), 1, 5, (64, 64),
                            10 ** 12)
    assert calls[0] == (135, 240) and len(calls) > 2
    th, tw = calls[-1]
    assert th * tw <= 60 * 120 and got is not None

    def broken(*a):
        raise RuntimeError("a fault in the VAE")

    monkeypatch.setattr(tm, "probe_tile_bytes", broken)
    with pytest.raises(RuntimeError, match="fault"):
        tm.plan_auto_tile(vae, "decode", (135, 240), 1, 5, (64, 64), 10 ** 12)
    monkeypatch.setattr(jm, "probe_tile_bytes", broken)
    assert jm.plan_auto_tile(_stubs()[0], "decode", (135, 240), 1, 5,
                             (64, 64), 10 ** 12) == (1024, 1024)


# ------------------------------------------------------------------ runner


@pytest.fixture(scope="module")
def vae_params():
    return random_params(lambda k: jv.init_vae_params(
        k, JVAEConfig(**TINY), dtype=jnp.float32), seed=5)


def _runners(vae_params, **tiling):
    """The JAX and the port runner over the same tiny VAE; the DiT plays no
    part in a VAE phase."""
    jcfg, tcfg = JVAEConfig(**TINY), tc.VAEConfig(**TINY)
    jr = JRunner(None, None, jv.VideoVAE(vae_params, jcfg,
                                         dtype=jnp.float32),
                 JRunnerConfig(vae=jcfg), compute_dtype=jnp.float32,
                 **tiling)
    model = tmodel.VideoAutoencoder(tcfg, dtype=torch.float32)
    model.load_state_dict(state_dict_from_jax(vae_params), strict=True)
    tr = TRunner(NaDiT(tc.small_test_config(), dtype=torch.float32),
                 tv.VideoVAE(model, torch.float32),
                 tc.RunnerConfig(vae=tcfg), compute_dtype=torch.float32,
                 tiling=VAETiling(**tiling))
    return jr, tr


def _budget(runner, monkeypatch, value):
    monkeypatch.setattr(runner, "_auto_tile_budget", lambda: value)


@pytest.mark.parametrize("budget", [1000, 10 ** 15])
def test_runner_resolves_per_shape_as_jax(vae_params, monkeypatch, budget):
    """Mixed shapes in one decode call (a chunked video's shorter last
    batch) plan each shape alone, to JAX's plans: a tight budget tiles on
    a one-rung ladder, a loose one goes untiled on the real ladder; the
    decode equals the JAX runner's and the same fixed tile's."""
    tiled = budget == 1000
    for mod in (jm, tm):
        if tiled:
            monkeypatch.setattr(mod, "DECODE_LADDER", (96,))
        monkeypatch.setattr(mod, "probe_tile_bytes", _fake_probe([]))
    kw = dict(decode_tiled=True, decode_tile_size="auto",
              decode_tile_overlap=(16, 16))
    jr, tr = _runners(vae_params, **kw)
    _budget(jr, monkeypatch, budget)
    _budget(tr, monkeypatch, budget)
    rng = np.random.default_rng(8)
    zs = [rng.standard_normal((t, 24, 32, TINY["latent_channels"])).astype(
        np.float32) for t in (2, 1)]
    ref = jr.vae_decode([jnp.asarray(z) for z in zs])
    out = tr.vae_decode([torch.from_numpy(z) for z in zs])
    assert tr._auto_tile_cache == jr._auto_tile_cache
    assert set(tr._auto_tile_cache) == {("decode", z.shape) for z in zs}
    assert tr._auto_tile_cache[("decode", zs[0].shape)] == (
        (True, (96, 96)) if tiled else (False, (1024, 1024)))
    fixed = _runners(vae_params, decode_tiled=tiled,
                     decode_tile_size=(96, 96),
                     decode_tile_overlap=(16, 16))[1].vae_decode(
        [torch.from_numpy(z) for z in zs])
    for o, r, f in zip(out, ref, fixed):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-4)
        assert torch.equal(o, f)


def test_runner_auto_encode_resolves_as_jax(vae_params, monkeypatch):
    for mod in (jm, tm):
        monkeypatch.setattr(mod, "ENCODE_LADDER", (96,))
        monkeypatch.setattr(mod, "probe_tile_bytes", _fake_probe([]))
    jr, tr = _runners(vae_params, encode_tiled=True,
                      encode_tile_size="auto", encode_tile_overlap=(16, 16))
    _budget(jr, monkeypatch, 1000)
    _budget(tr, monkeypatch, 1000)
    x = np.random.default_rng(4).uniform(-1, 1, (5, 128, 160, 3)).astype(
        np.float32)
    ref = jr.vae_encode([jnp.asarray(x)])[0]
    lat = tr.vae_encode([torch.from_numpy(x)])[0]
    assert tr._auto_tile_cache == jr._auto_tile_cache == {
        ("encode", x.shape): (True, (96, 96))}
    assert len(tr.vae.last_encode_tiles) > 1
    np.testing.assert_allclose(lat.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_cpu_runner_serves_the_default(vae_params):
    """On the CPU there is no budget: "auto" serves the fixed 1024 px plan
    with the configured tiled flag, as in JAX."""
    jr, tr = _runners(vae_params, decode_tiled=False,
                      decode_tile_size="auto")
    assert tr._auto_tile_budget() is None
    z = np.random.default_rng(5).standard_normal(
        (2, 6, 8, TINY["latent_channels"])).astype(np.float32)
    out = tr.vae_decode([torch.from_numpy(z)])[0]
    jr.vae_decode([jnp.asarray(z)])
    assert out.shape == (5, 48, 64, 3)
    assert tr._auto_tile_cache == jr._auto_tile_cache == {
        ("decode", z.shape): (False, (1024, 1024))}


def test_cli_parses_auto(monkeypatch):
    args = cli.parse_arguments(["in.npy", "--vae_decode_tile_size", "auto",
                                "--vae_encode_tile_size", "640"])
    assert (args.vae_decode_tile_size, args.vae_encode_tile_size) == (
        "auto", 640)
    t = cli.tiling_from_args(args)
    assert (t.decode_tile_size, t.encode_tile_size) == ("auto", (640, 640))
    monkeypatch.setattr("sys.argv", ["inference_cli.py", "in.png",
                                     "--vae_decode_tile_size", "AUTO",
                                     "--vae_encode_tile_size", "640"])
    jargs = inference_cli.parse_arguments()
    assert (jargs.vae_decode_tile_size, jargs.vae_encode_tile_size) == (
        cli.parse_arguments(["x.npy", "--vae_decode_tile_size", "AUTO",
                             "--vae_encode_tile_size", "640"])
        .vae_decode_tile_size, 640)
    # the preset fills only flags left at their defaults
    p = cli.parse_arguments(["in.npy", "--preset", "throughput",
                             "--vae_decode_tile_size", "auto"])
    t = cli.tiling_from_args(p)
    assert t.decode_tile_size == "auto" and t.encode_tile_size == (1536,) * 2
    with pytest.raises(SystemExit):
        cli.parse_arguments(["in.npy", "--vae_decode_tile_size", "big"])


def test_oom_retry_shrinks_an_auto_plan(vae_params, monkeypatch):
    """The retry backs the planner up: when the card rejects the auto plan
    anyway, the runner shrinks it x0.7 a side into the shape's plan (the
    "auto" setting stays, so other shapes get their own probes), and the
    next call of that shape starts from the shrunk tile. JAX's sequence."""
    monkeypatch.setattr(tm, "DECODE_LADDER", (384,))
    monkeypatch.setattr(tm, "probe_tile_bytes", _fake_probe([]))
    _, tr = _runners(vae_params, decode_tiled=True, decode_tile_size="auto",
                     decode_tile_overlap=(16, 16))
    _budget(tr, monkeypatch, 1000)
    z = np.random.default_rng(6).standard_normal(
        (2, 24, 32, TINY["latent_channels"])).astype(np.float32)
    real, calls = tr.vae.decode, []

    def flaky(b, tiled=False, tile_size=(512, 512), **kw):
        calls.append((tiled, tile_size))
        if tiled and min(tile_size) > 256:  # 256 = the shrink floor
            raise torch.cuda.OutOfMemoryError("stub: out of memory")
        return real(b, tiled=tiled, tile_size=tile_size, **kw)

    monkeypatch.setattr(tr.vae, "decode", flaky)
    out = tr.vae_decode([torch.from_numpy(z)])[0]
    assert out.shape == (5, 192, 256, 3)
    assert calls == [(True, (384, 384)), (True, (256, 256))]
    assert tr.oom_retries == 1
    assert tr.tiling.decode_tile_size == "auto"
    assert tr._auto_tile_cache[("decode", z.shape)] == (True, (256, 256))
    tr.vae_decode([torch.from_numpy(z + 1)])
    assert calls[2:] == [(True, (256, 256))]
