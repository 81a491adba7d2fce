"""The port's multi-host frame fan-out (seedvr2_tpu_torch/parallel/
multihost.py and the CLI's --num_hosts / --host_index / --join_parts)
against the JAX package's.

The numpy helpers are pinned equal to JAX's (frame ranges, segment paths,
the fp16 segment files, the streamed join). Then two processes, which
import no JAX, join a gloo process group through `distributed_init`, run
one real collective, and each serves its frame range of a tiny .npy clip
through the CLI with --num_hosts 2 (the CLI joins its own process group
at --coordinator_address and takes the host index from its rank); the
segments equal the ones --host_index 0 / 1 writes in this process, and the
CLI's --join_parts output equals JAX's join_segments on the same segments.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from seedvr2_tpu.parallel import multihost as jmh
from seedvr2_tpu_torch import cli
from seedvr2_tpu_torch.parallel import multihost as tmh

from .test_torch_model_manager import (DIT_NAME, VAE_NAME,  # noqa: F401
                                       tiny_checkpoints)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("total,hosts,overlap", [
    (10, 2, 2), (7, 3, 1), (5, 1, 0), (0, 2, 0), (3, 5, 1), (13, 4, 3),
    (100, 8, 5)])
def test_frame_ranges_pinned_to_jax(total, hosts, overlap):
    assert tmh.frame_ranges(total, hosts, overlap) == \
        jmh.frame_ranges(total, hosts, overlap)


def test_part_path_pinned_to_jax():
    for out in ("a/b/video.mp4", "x.npy", "/abs/clip"):
        for i in (0, 3):
            assert tmh.part_path(out, i) == jmh.part_path(out, i)


def _segments(rng, n, overlap):
    """n segments of a blended video (T, 6, 4, C), consecutive ones sharing
    `overlap` frames, with values fp16 rounds."""
    return [rng.uniform(0, 1, (t, 6, 4, 3)).astype(np.float32)
            for t in rng.integers(overlap + 1, overlap + 6, n)]


@pytest.mark.parametrize("hosts,overlap", [(1, 0), (2, 2), (3, 1), (4, 3),
                                           (3, 0)])
def test_segments_and_streamed_join_pinned_to_jax(tmp_path, hosts, overlap):
    """The fp16 segment files byte for byte, each streamed chunk of the
    join and the whole join equal to JAX's."""
    rng = np.random.default_rng(hosts * 10 + overlap)
    segs = _segments(rng, hosts, overlap)
    t_out = str(tmp_path / "t" / "v.mp4")
    j_out = str(tmp_path / "j" / "v.mp4")
    for i, seg in enumerate(segs):
        a = tmh.save_segment(t_out, i, seg)
        b = jmh.save_segment(j_out, i, seg)
        assert open(a, "rb").read() == open(b, "rb").read()
        assert np.load(a).dtype == np.float16
    t_chunks = list(tmh.iter_joined_segments(t_out, hosts, overlap))
    j_chunks = list(jmh.iter_joined_segments(j_out, hosts, overlap))
    assert len(t_chunks) == len(j_chunks) == hosts
    for a, b in zip(t_chunks, j_chunks):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tmh.join_segments(t_out, hosts, overlap),
                                  jmh.join_segments(j_out, hosts, overlap))


def test_missing_segment_raises(tmp_path):
    out = str(tmp_path / "v.npy")
    tmh.save_segment(out, 0, np.zeros((2, 2, 2, 3), np.float32))
    with pytest.raises(FileNotFoundError, match="host 1 not finished"):
        tmh.join_segments(out, 2, 0)


def test_default_host_index_without_a_group():
    assert tmh.default_host_index() == 0


def test_distributed_init_failure_only_warns():
    """A rendezvous that cannot start (an address with no port) warns and
    returns False, as JAX's does: the file fan-out needs no coordinator."""
    with pytest.warns(UserWarning, match="file-based fan-out only"):
        assert not tmh.distributed_init("127.0.0.1:noport", 2, 1,
                                        backend="gloo")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_WORKER = r"""
import os, sys
sys.path.insert(0, os.environ["SEEDVR2_REPO"])
import torch
import torch.distributed as dist
from seedvr2_tpu_torch import cli
from seedvr2_tpu_torch.parallel import multihost
from seedvr2_tpu_torch.utils.debug import _rank_tag

idx = int(os.environ["RANK"])
assert multihost.distributed_init(os.environ["COORD"], 2, idx,
                                  backend="gloo")
assert multihost.default_host_index() == idx and _rank_tag() == \
    f" [rank{idx}]"
t = torch.tensor([float(idx + 1)])
dist.all_reduce(t)  # one real collective over the hosts' group
assert t.item() == 3.0, t
dist.destroy_process_group()
# the CLI joins the fleet's group itself; the rank is the host index
path = cli.main([*os.environ["CLI_ARGS"].split("|"), "--num_hosts", "2",
                 "--coordinator_address", os.environ["COORD2"]])
assert not dist.is_initialized()
assert path.endswith(f".part{idx}.npy"), path
assert not any(m == "seedvr2_tpu" or m.startswith("seedvr2_tpu.")
               for m in sys.modules)
print(f"host {idx} ok", flush=True)
"""

CLIP_FRAMES, OVERLAP = 11, 2


def test_cli_fleet_fan_out_and_join_equal_jax(tmp_path, tiny_checkpoints):
    d = tiny_checkpoints
    clip = tmp_path / "clip.npy"
    np.save(clip, np.random.default_rng(3).uniform(
        0, 1, (CLIP_FRAMES, 24, 20, 3)).astype(np.float32))
    base = [str(clip), "--device", "cpu", "--dit_model", str(d / DIT_NAME),
            "--vae_model", str(d / VAE_NAME), "--model_dir", str(d),
            "--resolution", "32", "--batch_size", "5", "--temporal_overlap",
            str(OVERLAP), "--color_correction", "wavelet", "--seed", "3"]
    fleet = str(tmp_path / "fleet" / "out.npy")
    coords = [f"127.0.0.1:{_free_port()}" for _ in range(2)]
    procs = []
    for rank in range(2):
        env = dict(os.environ, SEEDVR2_REPO=REPO, RANK=str(rank),
                   COORD=coords[0], COORD2=coords[1], OMP_NUM_THREADS="2",
                   CLI_ARGS="|".join([*base, "--output", fleet]))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"host {rank} ok" in log, log[-4000:]

    # the same hosts in this process, each given its --host_index
    local = str(tmp_path / "local" / "out.npy")
    for i in range(2):
        path = cli.main([*base, "--output", local, "--num_hosts", "2",
                         "--host_index", str(i)])
        assert path == tmh.part_path(local, i)
        np.testing.assert_array_equal(np.load(path),
                                      np.load(tmh.part_path(fleet, i)))
    ranges = tmh.frame_ranges(CLIP_FRAMES, 2, OVERLAP)
    assert [np.load(tmh.part_path(fleet, i)).shape[0] for i in range(2)] \
        == [e - s for s, e in ranges]

    assert cli.main([*base, "--output", fleet, "--num_hosts", "2",
                     "--join_parts"]) == fleet
    joined = np.load(fleet)
    expect = jmh.join_segments(fleet, 2, OVERLAP)
    assert joined.shape == (CLIP_FRAMES, 38, 32, 3)
    np.testing.assert_array_equal(joined, expect)


def test_cli_host_index_outside_the_fleet_exits_2(tmp_path, capsys):
    clip = tmp_path / "clip.npy"
    np.save(clip, np.zeros((4, 8, 8, 3), np.float32))
    with pytest.raises(SystemExit) as e:
        cli.main([str(clip), "--device", "cpu", "--num_hosts", "2",
                  "--host_index", "2"])
    assert e.value.code == 2
    assert "--host_index 2 outside [0, 2)" in capsys.readouterr().err


def test_cli_fleet_host_serves_every_local_card(monkeypatch, tmp_path):
    """Under --num_hosts a host with several cards starts one worker a card
    (their mesh spans the host's cards) and hands them its host index:
    --host_index as given, else the fleet group's rank (0 without one)."""
    import torch
    import torch.multiprocessing as mp

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    seen = []
    monkeypatch.setattr(mp, "spawn", lambda fn, args, nprocs:
                        seen.append((args[0], args[2], nprocs)))
    clip = str(tmp_path / "clip.npy")
    np.save(clip, np.zeros((4, 8, 8, 3), np.float32))
    assert cli.main([clip, "--num_hosts", "2"]) is None
    assert cli.main([clip, "--num_hosts", "2", "--host_index", "1"]) is None
    assert seen == [([clip, "--num_hosts", "2", "--host_index", "0"], 2, 2),
                    ([clip, "--num_hosts", "2", "--host_index", "1"], 2, 2)]


def test_cli_fleet_under_a_launcher(monkeypatch, tmp_path, capsys):
    """torchrun per host: the group is the host's (the mesh takes its ranks,
    its rank 0 writes), so it does not say which host this is and
    --host_index is required; without WORLD_SIZE a fleet's group is one
    process a host, each writing its own segment."""
    import torch.distributed as dist

    args = cli.parse_arguments(["in.npy", "--num_hosts", "2"])
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert cli._fleet_group(args)
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert not cli._fleet_group(args)
    assert not cli._fleet_group(cli.parse_arguments(["in.npy"]))
    clip = str(tmp_path / "clip.npy")
    np.save(clip, np.zeros((4, 8, 8, 3), np.float32))
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        assert cli._n_devices(args) == 1 and cli._writes(args)
        with pytest.raises(SystemExit) as e:
            cli.main([clip, "--device", "cpu", "--num_hosts", "2"])
    finally:
        dist.destroy_process_group()
    assert e.value.code == 2
    assert "needs --host_index" in capsys.readouterr().err
