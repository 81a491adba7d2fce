"""List-partition helpers (reference: src/common/partition.py:22-58).

A copy of seedvr2_tpu.utils.partition, pinned equal to it by test. They
split work items across ranks and waves: the VAE phases' and the DiT
phase's waves (core/runner.py, core/pipeline.py) and the tiled VAE's tile
waves (models/vae/pipeline_vae.py).
"""

from typing import Any, List, Sequence


def partition_by_size(data: Sequence[Any], size: int) -> List[List[Any]]:
    """Split into consecutive chunks of `size`; the last chunk may be
    shorter. partition_by_size([1,2,3,4,5], 2) == [[1,2],[3,4],[5]]."""
    if size <= 0:
        raise ValueError(f"size must be positive, got {size}")
    return [list(data[i: i + size]) for i in range(0, len(data), size)]


def partition_by_groups(data: Sequence[Any], groups: int) -> List[List[Any]]:
    """Round-robin into `groups` lists (sizes differ by at most one).
    partition_by_groups([1,2,3,4,5], 2) == [[1,3,5],[2,4]]."""
    if groups <= 0:
        raise ValueError(f"groups must be positive, got {groups}")
    return [list(data[i::groups]) for i in range(groups)]


def shift_list(data: Sequence[Any], n: int) -> List[Any]:
    """Rotate left by n: shift_list([1,2,3,4,5], 3) == [4,5,1,2,3]."""
    if not data:
        return list(data)
    n = n % len(data)
    return list(data[n:]) + list(data[:n])
