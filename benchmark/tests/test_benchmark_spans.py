"""The readers of the request record's host spans and copy counters
(`dit.host_s`, `vae.decode_host_s`, `post.host_s`, `io.d2h_mib`,
`io.h2d_mib`) on hand-made runs: the mean per request of their keys, and
nothing from a program that records none of them."""

import json

import pytest

from benchmark import harness

MIB = 2 ** 20
RECORDS = [
    {"dit": 0.30, "dit.host": 0.20, "decode": 1.0, "decode.alloc": 0.01,
     "decode.write": 0.05, "decode.vae.plan": 0.02,
     "postprocess.prepare": 0.001, "postprocess.write": 0.02,
     "h2d_bytes": 3 * MIB, "d2h_bytes": 4 * MIB},
    {"dit": 0.34, "dit.host": 0.24, "decode": 1.2, "decode.alloc": 0.03,
     "decode.write": 0.07, "decode.vae.plan": 0.04,
     "postprocess.prepare": 0.003, "postprocess.write": 0.04,
     "h2d_bytes": 5 * MIB, "d2h_bytes": 6 * MIB},
]
READERS = ("dit.host_s", "vae.decode_host_s", "post.host_s", "io.d2h_mib",
           "io.h2d_mib")


def _run(records):
    return harness.Run(
        cell=None, window_s=2.0, setup_s=0.0, peak_bytes=0, work=[],
        requests=[{"wall_s": 1.0, "frames": 5, "timings": t, "input": i}
                  for i, t in enumerate(records)])


@pytest.mark.parametrize("name,want", [
    ("dit.host_s", 0.22),
    ("vae.decode_host_s", 0.02 + 0.06 + 0.03),
    ("post.host_s", 0.002 + 0.03),
    ("io.d2h_mib", 5.0),
    ("io.h2d_mib", 4.0),
])
def test_reader_takes_the_mean_a_request(name, want):
    assert harness.read_metric(name, _run(RECORDS)) == pytest.approx(want)


def test_untiled_decode_has_no_plan():
    """An untiled decode records no `decode.vae.plan`: the alloc and the
    write alone."""
    records = [{k: v for k, v in r.items() if k != "decode.vae.plan"}
               for r in RECORDS]
    assert harness.read_metric("vae.decode_host_s", _run(records)) == \
        pytest.approx(0.02 + 0.06)


@pytest.mark.parametrize("name", READERS)
def test_reader_of_a_program_without_the_spans(name):
    """A program that records only its phases (the port before its spans
    and counters) gives nothing to read, and the line leaves it out."""
    run = _run([{"encode": 0.6, "dit": 0.3, "decode": 1.0,
                 "postprocess": 0.2}])
    assert harness.read_metric(name, run) is None


def test_the_readers_are_declared():
    """Each reader is a per-layer metric of both cells."""
    with open(harness.BENCHMARK_JSON) as f:
        per_layer = {m["name"]: m for m in json.load(f)["per_layer"]}
    for name in READERS:
        assert per_layer[name]["workloads"] == ["3b-clip1080",
                                                "7b-throughput-image1080"]
        assert per_layer[name]["moves"] == "frames_per_s"
