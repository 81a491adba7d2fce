"""The request record (seedvr2_tpu_torch/utils/spans.py): the spans and
copy counters a tiny request through cli.process_frames records, untiled
and tiled, their profiler ranges nested under the phases, repeated spans
added up under one key, the counted bytes against the arrays' sizes worked
out by hand, and a span that leaves the device alone (no synchronise, copy
or allocation)."""

import time

import numpy as np
import pytest
import torch

from seedvr2_tpu_torch import cli
from seedvr2_tpu_torch.core import pipeline
from seedvr2_tpu_torch.core.configs import VAEConfig, small_test_config
from seedvr2_tpu_torch.core.runner import VAETiling
from seedvr2_tpu_torch.utils import spans

TINY_VAE = VAEConfig(block_out_channels=(8, 16, 32, 32), norm_num_groups=4)
# 5 frames of 24 x 20 to a short side of 32: 38 x 32 out (48 x 32 padded
# to 16 inside the VAE)
T, H, W, RES = 5, 24, 20, 32
OUT_H, OUT_W, PAD_H = 38, 32, 48
TXT_POS, TXT_NEG = 7, 9
F32 = 4

UNTILED = {
    "request",
    "encode", "encode.host", "encode.prepare", "encode.upload", "encode.vae",
    "encode.vae.slice",
    "dit", "dit.host", "dit.condition", "dit.forward",
    "decode", "decode.host", "decode.alloc", "decode.vae", "decode.vae.slice",
    "decode.to_host", "decode.write",
    "postprocess", "postprocess.host", "postprocess.upload",
    "postprocess.prepare", "postprocess.color", "postprocess.to_host",
    "postprocess.write",
    spans.H2D, spans.D2H}
TILED = (UNTILED - {"encode.vae.slice", "decode.vae.slice"}) | {
    f"{p}.vae.{s}" for p in ("encode", "decode")
    for s in ("plan", "tile", "tile.slice", "blend")}
PHASES = ("encode", "dit", "decode", "postprocess")


@pytest.fixture(scope="module")
def runners():
    """{tiled: a tiny runner}, tiles of 24 px overlapping by 8 when tiled."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "VAE_V3", TINY_VAE)
        for tiled in (False, True):
            tiling = VAETiling(encode_tiled=tiled, encode_tile_size=(24, 24),
                               encode_tile_overlap=(8, 8),
                               decode_tiled=tiled, decode_tile_size=(24, 24),
                               decode_tile_overlap=(8, 8))
            out[tiled] = cli.make_runner(
                torch.device("cpu"), seed=0, tiling=tiling,
                dit_cfg=small_test_config("dit_3b", num_layers=2))
    return out


def _request(runner, **kw):
    rng = np.random.default_rng(0)
    frames = rng.uniform(0, 1, (T, H, W, 3)).astype(np.float32)
    d = runner.dit_cfg.txt_in_dim
    emb = {"pos": rng.standard_normal((TXT_POS, d)).astype(np.float32),
           "neg": rng.standard_normal((TXT_NEG, d)).astype(np.float32)}
    return cli.process_frames(runner, frames, emb, resolution=RES, seed=1,
                              **kw)


@pytest.mark.parametrize("tiled", [False, True])
def test_record_keys(runners, tiled):
    """Every span and both counters, once each; a phase's host seconds
    within its seconds, the phases within the request."""
    out, rec = _request(runners[tiled])
    assert out.shape == (T, OUT_H, OUT_W, 3)
    assert set(rec) == (TILED if tiled else UNTILED)
    assert all(v > 0 for v in rec.values())
    for p in PHASES:
        assert rec[f"{p}.host"] <= rec[p]
    assert sum(rec[p] for p in PHASES) <= rec["request"]


def _ranges(prof):
    return [(e.name[len(spans.PREFIX):], e.time_range.start,
             e.time_range.end) for e in prof.events()
            if e.name.startswith(spans.PREFIX)]


@pytest.mark.parametrize("tiled", [False, True])
def test_spans_nest_under_their_phase(runners, tiled):
    """In a CPU profiler trace each span is a `seedvr2.<full name>` range
    inside a range of its parent (a phase's parent is the request), and
    the ranges are the record's spans."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _, rec = _request(runners[tiled])
    ranges = _ranges(prof)
    assert {n for n, _, _ in ranges} == {
        k for k in rec if not k.endswith((".host", "_bytes"))}
    for name, a, b in ranges:
        if name == "request":
            continue
        parent = name.rsplit(".", 1)[0] if "." in name else "request"
        assert any(p == parent and pa <= a and b <= pb
                   for p, pa, pb in ranges), name


def test_repeated_tiles_add_up(runners):
    """A tiled decode opens one range a tile and one a blend, recorded
    under one key each; spans of one name add their seconds."""
    runner = runners[True]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _, rec = _request(runner)
    names = [n for n, _, _ in _ranges(prof)]
    n_tiles = len(runner.vae.last_decode_tiles)
    assert n_tiles > 1
    for step in ("tile", "blend"):
        assert names.count(f"decode.vae.{step}") == n_tiles
        assert f"decode.vae.{step}" in rec
    rec = {}
    with spans.recording(rec):
        for _ in range(3):
            with spans.span("tile"):
                time.sleep(0.002)
    assert list(rec) == ["tile"] and rec["tile"] >= 0.006


def _untiled_bytes(runner):
    """(h2d, d2h) of the untiled request, by hand: the frames up (encode)
    and again as the colour fix's reference, each with the resize's two
    matrices (38 x 24 and 32 x 20, fp32); the text rows in the compute
    dtype; the time embedding's 128 frequencies (float64: numpy's product
    with the float64 log); the decoded frames down (decode), up and down
    again (postprocess), whose lab colour fix uploads the D65 white point
    (3 fp32) three times."""
    frames_in = T * H * W * 3 * F32
    frames_out = T * OUT_H * OUT_W * 3 * F32
    resize = (OUT_H * H + OUT_W * W) * F32
    item = torch.empty((), dtype=runner.compute_dtype).element_size()
    text = (TXT_POS + TXT_NEG) * runner.dit_cfg.txt_in_dim * item
    h2d = (2 * (frames_in + resize) + text + 128 * 8 + frames_out
           + 3 * 3 * F32)
    return h2d, 2 * frames_out


def test_copy_counters_count_the_arrays_bytes(runners):
    """h2d_bytes / d2h_bytes equal the copied arrays' sizes; the tiled
    request adds its masks and the blend's count (encode, in latent
    pixels) and 1 / count (decode)."""
    _, rec = _request(runners[False])
    h2d, d2h = _untiled_bytes(runners[False])
    assert (rec[spans.H2D], rec[spans.D2H]) == (h2d, d2h)
    assert all(isinstance(rec[k], int) for k in (spans.H2D, spans.D2H))

    tiled = runners[True]
    _, rec = _request(tiled)
    sf = 8
    enc = tiled.vae.last_encode_tiles
    dec = tiled.vae.last_decode_tiles
    masks = (sum(th // sf * tw // sf for _, _, th, tw in enc)
             + (PAD_H // sf) * (OUT_W // sf)
             + sum(th * tw for _, _, th, tw in dec) + PAD_H * OUT_W) * F32
    assert rec[spans.H2D] == h2d + masks
    assert rec[spans.D2H] == d2h


def test_device_noise_counts_nothing(runners):
    """A noise override that is already a tensor on the device crosses
    nothing; the same noise as a host array counts its bytes."""
    runner = runners[False]
    noise = np.random.default_rng(3).standard_normal(
        (2, PAD_H // 8, OUT_W // 8, 16)).astype(np.float32)
    _, host = _request(runner, noise_override=[noise])
    _, dev = _request(runner, noise_override=[torch.from_numpy(noise)])
    assert host[spans.H2D] - dev[spans.H2D] == noise.nbytes
    assert dev[spans.H2D] == _untiled_bytes(runner)[0]


def test_spans_leave_the_device_alone(monkeypatch):
    """A span and a count add only their range: no other operation, no
    allocation, no synchronise; outside a record a span keeps its bare
    name and records nothing."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: calls.append(a))
    rec = {}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            profile_memory=True) as prof:
        with spans.recording(rec), spans.span("a"), spans.span("b"):
            spans.count(spans.H2D, 8)
        with spans.span("bare"):
            spans.count(spans.H2D, 8)
    assert sorted(e.name for e in prof.events()) == [
        "seedvr2.a", "seedvr2.a.b", "seedvr2.bare"]
    assert set(rec) == {"a", "a.b", spans.H2D} and rec[spans.H2D] == 8
    assert calls == []


def test_a_request_synchronises_once_a_phase(runners, monkeypatch):
    """The spans add no synchronise: a CPU request calls none, and each
    phase on a card's context calls exactly its closing one."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: calls.append(a))
    _request(runners[True])
    assert calls == []
    ctx = {"device": torch.device("cuda"), "timings": {}}
    for p in PHASES:
        with pipeline._phase(ctx, p):
            with spans.span("step"):
                pass
    assert len(calls) == len(PHASES)
    assert set(ctx["timings"]) == {f"{p}{s}" for p in PHASES
                                   for s in ("", ".host", ".step")}


def test_record_printed_with_bytes_as_bytes(runners, capsys):
    """One formatter: spans in seconds, counters in whole bytes, launch
    counts as counts, in the CLI's report too."""
    rec = {"decode": 0.5, "decode.write": 0.25, spans.H2D: 1024,
           spans.D2H: 2048.0, "upsample_kernel_launches": 3}
    line = spans.format_record(rec)
    assert line == ("decode 0.5000 s, decode.write 0.2500 s, "
                    "h2d_bytes 1024 B, d2h_bytes 2048 B, "
                    "upsample_kernel_launches 3")
    cli._report(runners[False], "out.npy", 5, rec)
    assert capsys.readouterr().err.startswith(
        "wrote out.npy (5 frames); request record: " + line)


@pytest.mark.parametrize("t", [0.0, 7, 1000.0, 999.9999, 1.0 / 3.0, 123.456,
                               2.0 ** 25 + 1])
def test_step_scalar_filled_on_the_device(t):
    """The diffusion step's scalars are filled on the device, bit-equal to
    their upload, with nothing to upload (so nothing waits for the
    stream)."""
    from seedvr2_tpu_torch.core import diffusion

    rec = {}
    with spans.recording(rec):
        got = diffusion._f32(t, torch.zeros(2))
    want = torch.as_tensor(t, dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == ()
    assert got.view(torch.int32) == want.view(torch.int32)
    assert rec == {}
