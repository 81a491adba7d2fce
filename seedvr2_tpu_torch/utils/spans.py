"""Spans and copy counters of a request: the request record.

`span(name)` opens the profiler range `seedvr2.<full name>` and, inside a
request record, adds its host seconds (`time.perf_counter`) to the record
under the full name: the enclosing span's full name and its own, joined by
dots (`decode.vae.plan` under decode, `encode.vae.plan` under encode).
Repeated spans (tiles, slices, batches) add up under one key. `count(name,
n)` adds n to the record; `to_device` / `to_host` are the program's copy
sites between host data (numpy arrays, Python numbers and sequences) and
tensors, counted as `h2d_bytes` / `d2h_bytes` whatever the device, so a
CPU run counts the card's bytes. On the card each such upload also waits
for the stream (PyTorch ends a blocking copy from host memory with a
stream synchronise): a span holding one lasts until the device catches
up.

The record is a request's `ctx["timings"]` (core/pipeline.py), made the
current record by `recording` through a context variable, so code deep in
a call (the VAE front end) needs no context argument. Outside a record a
span only opens its range. A span or a counter never synchronises, copies
or allocates on the device: it only records. Every range starts with
`seedvr2.`, the prefix the benchmark's trace reader keeps out of the
device's busy time; a profiled run's idle gaps are named by the innermost
range at their midpoint.
"""

import time
from contextlib import contextmanager
from contextvars import ContextVar

import numpy as np
import torch

PREFIX = "seedvr2."
H2D, D2H = "h2d_bytes", "d2h_bytes"

# (the record, the enclosing span's full name and a dot) of this request
_current: ContextVar = ContextVar("seedvr2_request_record", default=None)


@contextmanager
def recording(record: dict):
    """Make `record` the current record; spans opened inside start their
    full names afresh (a phase's spans are named from the phase)."""
    token = _current.set((record, ""))
    try:
        yield record
    finally:
        _current.reset(token)


@contextmanager
def span(name: str):
    """The profiler range `seedvr2.<full name>`; inside a record, its host
    seconds added to the record under the full name."""
    state = _current.get()
    if state is None:
        with torch.profiler.record_function(PREFIX + name):
            yield
        return
    record, parent = state
    full = parent + name
    token = _current.set((record, full + "."))
    try:
        with torch.profiler.record_function(PREFIX + full):
            t0 = time.perf_counter()
            yield
            record[full] = record.get(full, 0.0) + time.perf_counter() - t0
    finally:
        _current.reset(token)


def count(name: str, n) -> None:
    """Add n to the current record's `name` (nothing outside a record)."""
    state = _current.get()
    if state is not None:
        state[0][name] = state[0].get(name, 0) + n


def to_device(x, device, dtype=None) -> torch.Tensor:
    """torch.as_tensor(x, dtype, device); host data (a numpy array, a
    Python number or sequence) counts the bytes it becomes on the device
    as h2d_bytes, and so does a tensor from another device; a tensor
    already there counts nothing."""
    t = torch.as_tensor(x, dtype=dtype, device=device)
    if not isinstance(x, torch.Tensor) or x.device != t.device:
        count(H2D, t.numel() * t.element_size())
    return t


def to_host(t: torch.Tensor) -> np.ndarray:
    """t.cpu().numpy(), its bytes counted as d2h_bytes."""
    count(D2H, t.numel() * t.element_size())
    return t.cpu().numpy()


def format_record(record: dict) -> str:
    """A request record on one line: byte counts in bytes, launch counts
    as counts, spans in seconds."""
    return ", ".join(f"{k} {int(v)} B" if k.endswith("_bytes")
                     else f"{k} {int(v)}" if k.endswith("_launches")
                     else f"{k} {v:.4f} s" for k, v in record.items())
