"""Multi-host frame-range fan-out for long videos.

Port of seedvr2_tpu.parallel.multihost. The reference fans a video out
across GPUs with multiprocessing and shared memory (inference_cli.py:
1048-1214: an even frame split, overlap on the non-last workers, a Hann
blend at the seams). Across hosts there is no shared memory, so the fan-out
is file-based: every host processes its frame range (overlap included)
into a .npy segment, and a join pass blends the seams. Parallelism inside a
host stays the mesh's (dp waves, tp) over the host's cards: the CLI starts
one worker a local card, or torchrun runs per host; either way the mesh's
process group is the host's own.

CLI surface:
    # on each host i of n (same command, different --host_index):
    python -m seedvr2_tpu_torch.cli in.mp4 --num_hosts n --host_index i ...
    # then once, anywhere with access to the segments:
    python -m seedvr2_tpu_torch.cli in.mp4 --num_hosts n --join_parts ...

With the hosts' process group initialised (`distributed_init`, one
process a host: --coordinator_address), --host_index defaults to the
process's rank, so the same command line works fleet-wide; under torchrun
per host --host_index is given. The numpy helpers are copies of the JAX package's, pinned equal
by test.
"""

import os
import warnings
from typing import List, Optional, Tuple

import numpy as np


def frame_ranges(total: int, n_hosts: int,
                 overlap: int) -> List[Tuple[int, int]]:
    """Even frame split; every non-last range extends by `overlap` frames
    so the seams can be Hann-blended at join (reference
    inference_cli.py:1076-1097)."""
    assert n_hosts >= 1 and total >= 0
    base, rem = divmod(total, n_hosts)
    ranges = []
    start = 0
    for i in range(n_hosts):
        length = base + (1 if i < rem else 0)
        end = start + length
        ext_end = min(end + overlap, total) if i < n_hosts - 1 else end
        ranges.append((start, ext_end))
        start = end
    return ranges


def part_path(output: str, host_index: int) -> str:
    base, _ = os.path.splitext(output)
    return f"{base}.part{host_index}.npy"


def save_segment(output: str, host_index: int, frames: np.ndarray) -> str:
    """Segments store fp16: output frames are [0, 1] headed for 8-bit video,
    so half precision is visually lossless and halves the bytes a 4K
    segment puts on the shared filesystem (a 5-s 4K segment: ~6 GB fp32 ->
    3 GB fp16)."""
    path = part_path(output, host_index)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.save(path, frames.astype(np.float16))
    return path


def _load_segment(output: str, host_index: int) -> np.ndarray:
    path = part_path(output, host_index)
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"missing segment {path} (host {host_index} not finished?)")
    return np.load(path).astype(np.float32)


def iter_joined_segments(output: str, n_hosts: int, overlap: int):
    """Yield the assembled video as in-order (Ti, H, W, C) float32 chunks,
    Hann-blending each overlapped seam (reference inference_cli.py:
    1168-1204) while holding AT MOST one segment (+ the carried tail) in
    RAM, so a long 4K video is never assembled in memory."""
    from ..core.pipeline import blend_overlapping_frames

    tail = None
    for i in range(n_hosts):
        seg = _load_segment(output, i)
        if tail is not None:
            ov = min(overlap, tail.shape[0], seg.shape[0])
            if ov > 0:
                seg[:ov, :, :, :3] = blend_overlapping_frames(
                    tail[-ov:, :, :, :3], seg[:ov, :, :, :3], ov)
        if i < n_hosts - 1 and overlap > 0 and seg.shape[0] > overlap:
            # the last `overlap` frames reappear as the next segment's
            # head; hold them back so the blended version is emitted once
            yield seg[:-overlap]
            tail = seg[-overlap:]
        else:
            yield seg
            tail = None


def join_segments(output: str, n_hosts: int, overlap: int) -> np.ndarray:
    """Assembled (T, H, W, C) video in one array (tests / small jobs; the
    CLI streams iter_joined_segments straight to the writer)."""
    return np.concatenate(
        list(iter_joined_segments(output, n_hosts, overlap)), axis=0)


def default_host_index() -> int:
    """torch.distributed's rank when a process group is initialised, else
    0."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def distributed_init(coordinator_address: str, num_hosts: int,
                     host_index: Optional[int] = None,
                     backend: Optional[str] = None) -> bool:
    """torch.distributed.init_process_group over `num_hosts` processes,
    one a host, rendezvousing at tcp://<coordinator_address> (host 0's
    host:port; the reference's init_torch, src/common/distributed/
    basic.py:62-76). host_index: this host's rank (default $RANK, else 0).
    backend: default NCCL where a card is visible, else gloo. Returns True
    on success; a failure only warns, as in JAX: the file-based fan-out
    needs no coordinator, only a shared path for its segments."""
    import torch
    import torch.distributed as dist

    if host_index is None:
        host_index = int(os.environ.get("RANK", "0"))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    try:
        dist.init_process_group(
            backend=backend, init_method=f"tcp://{coordinator_address}",
            world_size=int(num_hosts), rank=int(host_index))
        return True
    except Exception as exc:  # noqa: BLE001
        warnings.warn(f"torch.distributed.init_process_group failed "
                      f"({exc}); continuing with file-based fan-out only")
        return False
