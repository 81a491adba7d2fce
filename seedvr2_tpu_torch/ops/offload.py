"""Host-memory weight tiering on the H100: BlockSwap and module packing.

Port of seedvr2_tpu.ops.offload. The reference wraps each transformer
block's forward with .to(gpu)/.to(cpu) pairs (src/optimization/
blockswap.py:379-456); the JAX package streams host numpy blocks with
jax.device_put. Here:

 - A module's parameters and buffers are *packed* once into one flat byte
   buffer (`pack`), each storage at an offset aligned to `ALIGN` bytes, and
   the module's tensors become views of it; tensors that share a storage
   (K3's joined gate / up weight and its two halves) stay views of one
   copy. A pack in host memory is page-locked at its exact size
   (`PinnedBytes`).
 - `StreamedNaDiT` keeps the IO parameters and the first `keep_blocks`
   blocks on the device and every later block in a pinned pack of its own.
   The device holds two slot buffers of the largest block's size; each
   streamed block is ONE `copy_(non_blocking=True)` from its pack into a
   slot on a dedicated copy stream, and runs through the port's own
   `_block_forward` on a shell module whose tensors are views of that slot
   (built once per block and slot), so every lane keeps its kernels.
   Both hazards are fenced by events, never by the host: the compute
   stream waits on the copy's done event, and the copy into a slot waits on
   the compute stream's event recorded after the last kernel of the block
   that read the slot before. The block loop has no host synchronisation;
   the swap telemetry (`SwapStats`) is CUDA events, read when asked for.
   `nadit_forward` stays the only block loop: it takes the blocks from
   `StreamedNaDiT._blocks`, a generator that yields each block ready.
 - On the CPU (the tests) the same class runs with host buffers as its
   "device" slots and plain copies, so the packing, the views and the slot
   rotation run there too.
"""

import copy
import time
import weakref
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch import nn

from ..models.dit.nadit import DevicePlan, NaDiT, nadit_forward

# byte alignment of every storage in a pack: a multiple of the 16 bytes the
# kernels' wrappers require of their operands, and the 256 that cudaMalloc
# gives a tensor of its own, so a packed weight is aligned as a separately
# allocated one is
ALIGN = 256


# ------------------------------------------------------------------ packing


@dataclass(frozen=True)
class _Entry:
    """One parameter or buffer of a packed module: where its bytes sit in
    the pack and how its view is laid over them."""

    module: nn.Module
    name: str
    offset: int       # byte offset of the tensor's first element
    nbytes: int       # bytes from the first to one past the last element
    shape: Tuple[int, ...]
    stride: Tuple[int, ...]
    dtype: torch.dtype

    def tensor(self) -> torch.Tensor:
        m = self.module
        return (m._parameters[self.name] if self.name in m._parameters
                else m._buffers[self.name])

    def view(self, buf: torch.Tensor) -> torch.Tensor:
        raw = buf[self.offset:self.offset + self.nbytes]
        return raw.view(self.dtype).as_strided(self.shape, self.stride)


def _named_tensors(module: nn.Module):
    """(submodule, name, tensor) of every parameter and buffer, each
    (submodule, name) once."""
    seen = set()
    for mod in module.modules():
        for table in (mod._parameters, mod._buffers):
            for name, t in table.items():
                if t is not None and (id(mod), name) not in seen:
                    seen.add((id(mod), name))
                    yield mod, name, t


def _extent(t: torch.Tensor) -> Tuple[int, int]:
    """[first, last + 1) byte of t in its storage (strides are >= 0)."""
    es = t.element_size()
    first = t.storage_offset() * es
    if t.numel() == 0:
        return first, first
    last = sum((n - 1) * s for n, s in zip(t.shape, t.stride()))
    return first, first + (last + 1) * es


def _storage_key(t: torch.Tensor) -> Tuple:
    if t.device.type == "meta":
        return (t.device, id(t))  # meta tensors share no storage
    return (t.device, t.untyped_storage().data_ptr())


def _spans(items) -> Dict[Tuple, List[int]]:
    """Storage key -> [first, last + 1) bytes its tensors cover."""
    spans: Dict[Tuple, List[int]] = {}
    for _, _, t in items:
        lo, hi = _extent(t)
        span = spans.setdefault(_storage_key(t), [lo, hi])
        span[0], span[1] = min(span[0], lo), max(span[1], hi)
    return spans


def layout(module: nn.Module) -> Tuple[List[_Entry], int]:
    """The pack layout of `module`: an entry per parameter and buffer, and
    the pack's size in bytes. Each storage the tensors use is laid out once
    (the span they cover) at an ALIGN-aligned offset, so tensors that share
    a storage stay overlapping views."""
    items = list(_named_tensors(module))
    base, total = {}, 0
    for key, (lo, hi) in _spans(items).items():
        base[key] = total - lo
        total += -(-(hi - lo) // ALIGN) * ALIGN
    entries = []
    for mod, name, t in items:
        lo, hi = _extent(t)
        entries.append(_Entry(mod, name, base[_storage_key(t)] + lo, hi - lo,
                              tuple(t.shape), tuple(t.stride()), t.dtype))
    return entries, total


def module_bytes(module: nn.Module) -> int:
    """Bytes `module` holds: every parameter and buffer, quantised buffers
    and K3's joined gate / up weight included, each byte counted once (a
    joined weight's halves are views of it), a pack's alignment gaps not."""
    byte_ranges: Dict[Tuple, List[Tuple[int, int]]] = {}
    for _, _, t in _named_tensors(module):
        byte_ranges.setdefault(_storage_key(t), []).append(_extent(t))
    total = 0
    for ranges in byte_ranges.values():
        end = None
        for lo, hi in sorted(ranges):
            if end is not None and lo < end:
                lo = end  # the overlap is counted already
            if hi > lo:
                total += hi - lo
                end = hi if end is None else max(end, hi)
    return total


def _host_available() -> Optional[int]:
    """MemAvailable of /proc/meminfo in bytes (None where there is none)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


def _unregister(ptr: int) -> None:
    torch.cuda.cudart().cudaHostUnregister(ptr)


class PinnedBytes:
    """`nbytes` of page-locked host memory as a uint8 tensor: a pageable
    allocation registered with CUDA at its exact size (torch's pinned
    allocator rounds every block up to a power of two, which would nearly
    double a 16 GB DiT), unregistered when this object goes. Refuses, with
    the numbers, a size beyond the host's available memory, and raises if
    the registration fails: nothing falls back to pageable memory."""

    def __init__(self, nbytes: int):
        avail = _host_available()
        if avail is not None and nbytes > avail:
            raise MemoryError(
                f"pinning {nbytes / 2 ** 30:.2f} GiB of host memory for the "
                f"DiT's weights, but only {avail / 2 ** 30:.2f} GiB is "
                "available")
        # zeroed first: the fill's threads fault the pages in, faster than
        # the registration faults them one by one
        self.tensor = torch.zeros(max(nbytes, 1), dtype=torch.uint8)
        ptr = self.tensor.data_ptr()
        rc = int(torch.cuda.cudart().cudaHostRegister(ptr, max(nbytes, 1), 0))
        if rc != 0 or not self.tensor.is_pinned():
            raise RuntimeError(f"cudaHostRegister of {nbytes} bytes failed "
                               f"(cudaError {rc})")
        weakref.finalize(self, _unregister, ptr)


class Packed:
    """A module whose parameters and buffers are views of one flat byte
    buffer (`buffer`, on `buffer.device`), with the layout to lay the same
    views over another buffer of the same bytes."""

    def __init__(self, module: nn.Module, entries: List[_Entry], nbytes: int,
                 buffer: torch.Tensor, owner=None):
        self.module, self.entries, self.nbytes = module, entries, nbytes
        self.buffer = buffer
        self._owner = owner  # keeps a PinnedBytes registered

    def bind(self, buf: torch.Tensor) -> None:
        """Point the module's tensors at their views of buf (their Python
        objects stay; their old storage goes when nothing else holds it)."""
        for e in self.entries:
            e.tensor().data = e.view(buf)

    def shell(self, buf: torch.Tensor) -> nn.Module:
        """A copy of the module's structure whose tensors are views of buf
        (the module itself is left as it is)."""
        memo = {}
        for e in self.entries:
            t, v = e.tensor(), e.view(buf)
            memo[id(t)] = (nn.Parameter(v, requires_grad=False)
                           if isinstance(t, nn.Parameter) else v)
        return copy.deepcopy(self.module, memo)


def pack(module: nn.Module, device, pin: bool = False) -> Packed:
    """Copy `module`'s parameters and buffers into one new buffer on
    `device` (page-locked when `pin`, host memory only) and bind the module
    to its views there."""
    device = torch.device(device)
    entries, nbytes = layout(module)
    owner = None
    if pin:
        if device.type != "cpu":
            raise ValueError("only host memory is pinned")
        owner = PinnedBytes(nbytes)
        buf = owner.tensor
    else:
        buf = torch.empty(max(nbytes, 1), dtype=torch.uint8, device=device)
    with torch.no_grad():
        for e in entries:
            e.view(buf).copy_(e.tensor())
    packed = Packed(module, entries, nbytes, buf, owner)
    packed.bind(buf)
    return packed


def place(module: nn.Module, device) -> None:
    """Move `module` to `device` keeping its shared storages shared (one
    packed copy), unless it is there already."""
    device = torch.device(device)
    if any(t.device.type != device.type or (
            device.index is not None and t.device.index != device.index)
            for _, _, t in _named_tensors(module)):
        pack(module, device)


# ------------------------------------------------------------------ streaming


class SwapStats:
    """Swap telemetry (mirrors the reference's debug.get_swap_summary,
    src/utils/debug.py:662-736, with the JAX package's summary() keys).

    `record` times are TRUE transfer stalls: how long the compute stream
    waited for a streamed block's copy, i.e. the copy's done event less the
    event the compute stream recorded when it reached the block (the
    previous block's end), floored at 0 (~0 means the prefetch hid the
    copy). `copy_ms` holds each copy's own time. `measured_transfer_ms` is
    one synchronous block upload measured at construction: the un-hidden
    cost of a single swap. On the card the times are CUDA events, resolved
    when `summary()` or `transfer()` is asked for (one wait for the last
    forward's events), never inside the block loop."""

    def __init__(self):
        self.block_swaps = 0
        self.block_total_ms = 0.0
        self.block_times: List[float] = []
        self.copy_ms: List[float] = []
        self.measured_transfer_ms = 0.0
        self.block_bytes = 0
        self._pending: List[Tuple] = []  # (start, done, ready) events

    def record(self, ms: float):
        self.block_swaps += 1
        self.block_total_ms += ms
        self.block_times.append(ms)

    def _resolve(self):
        if not self._pending:
            return
        self._pending[-1][1].synchronize()
        self._pending[-1][2].synchronize()
        for start, done, ready in self._pending:
            self.copy_ms.append(start.elapsed_time(done))
            self.record(max(0.0, ready.elapsed_time(done)))
        self._pending.clear()

    def summary(self) -> Dict[str, float]:
        self._resolve()
        if not self.block_times:
            return {"total_swaps": 0}
        return {
            "total_swaps": self.block_swaps,
            "block_swaps": self.block_swaps,
            "block_total_ms": self.block_total_ms,
            "block_avg_ms": self.block_total_ms / self.block_swaps,
            "block_min_ms": min(self.block_times),
            "block_max_ms": max(self.block_times),
            "block_stall_total_ms": self.block_total_ms,
            "measured_transfer_ms": self.measured_transfer_ms,
            "block_bytes": self.block_bytes,
        }

    def transfer(self) -> Dict[str, float]:
        """The copies' own times: mean / max ms and the mean rate of the
        streamed blocks' copies in GB/s (1e9 bytes)."""
        self._resolve()
        if not self.copy_ms:
            return {"copies": 0}
        mean = sum(self.copy_ms) / len(self.copy_ms)
        return {"copies": len(self.copy_ms), "copy_avg_ms": mean,
                "copy_max_ms": max(self.copy_ms),
                "copy_gbps": self.block_bytes / (mean * 1e6) if mean else 0.0}


class StreamedNaDiT:
    """NaDiT forward with transformer blocks streamed from pinned host
    memory (the reference's BlockSwap). Takes `model` over and places it:
    its IO parameters and blocks [0, keep_blocks) on `device`, every later
    block packed into a page-locked host buffer of its own (its tensors
    become views there, so no second host copy is kept). Outputs equal
    nadit_forward's on the resident model, bit for bit: the same kernels run
    on the same weights. One StreamedNaDiT serves a model at a time.
    Under a mesh (the runner's attach_mesh) every rank streams its own
    whole blocks into its own slots (tensor parallelism does not shard a
    streamed DiT) and the runner spreads the batches over dp."""

    def __init__(self, model: NaDiT, keep_blocks: int = 0, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.model = model
        self.cfg = model.cfg
        self.stats = SwapStats()
        n = len(model.blocks)
        self.keep_blocks = keep = max(0, min(int(keep_blocks), n))
        cuda = self.device.type == "cuda"
        for name, child in model.named_children():
            if name != "blocks":
                place(child, self.device)
        for blk in model.blocks[:keep]:
            place(blk, self.device)
        self.host = [pack(blk, "cpu", pin=cuda) for blk in model.blocks[keep:]]
        slot_bytes = max((p.nbytes for p in self.host), default=0)
        self.slots = [torch.empty(max(slot_bytes, 1), dtype=torch.uint8,
                                  device=self.device) for _ in range(2)]
        # shells[j][s]: streamed block j with its tensors in slot s
        self.shells = [[p.shell(slot) for slot in self.slots]
                       for p in self.host]
        self._next_slot = 0
        self._copy_stream = torch.cuda.Stream(self.device) if cuda else None
        self._slot_free: List[Optional[torch.cuda.Event]] = [None, None]
        if self.host:
            self.stats.block_bytes = self.host[0].nbytes
            # one synchronous upload, so the telemetry separates "cost of a
            # swap" from "stall after prefetch"
            src = self.host[0].buffer[:self.host[0].nbytes]
            t0 = time.perf_counter()
            self.slots[0][:src.numel()].copy_(src, non_blocking=cuda)
            if cuda:
                torch.cuda.synchronize(self.device)
            self.stats.measured_transfer_ms = (
                time.perf_counter() - t0) * 1000.0

    def resident_bytes(self) -> int:
        """Device bytes the streamed DiT holds: the IO parameters, the kept
        blocks and the two slots."""
        head = sum(module_bytes(c) for name, c in self.model.named_children()
                   if name != "blocks")
        kept = sum(module_bytes(b) for b in self.model.blocks[:self.keep_blocks])
        return head + kept + sum(s.numel() for s in self.slots)

    def _copy(self, j: int, slot: int):
        """Start streamed block j's copy into `slot`; its (start, done)
        events on the card, None on the CPU."""
        src = self.host[j].buffer[:self.host[j].nbytes]
        dst = self.slots[slot][:src.numel()]
        if self._copy_stream is None:
            t0 = time.perf_counter()
            dst.copy_(src)
            ms = (time.perf_counter() - t0) * 1000.0
            self.stats.copy_ms.append(ms)
            self.stats.record(ms)  # the compute waits for the whole copy
            return None
        cs = self._copy_stream
        if self._slot_free[slot] is not None:  # write after read
            cs.wait_event(self._slot_free[slot])
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        start.record(cs)
        with torch.cuda.stream(cs):
            dst.copy_(src, non_blocking=True)
        done.record(cs)
        return start, done

    def _blocks(self) -> Iterator[nn.Module]:
        """The blocks in order, each ready on the device: the kept ones as
        they are, each streamed one as its slot's shell once the compute
        stream waits on its copy. The copies of the first two streamed
        blocks start before the kept blocks run; block j + 2's copy starts
        once block j's kernels are queued, behind their done event."""
        yield from self.model.blocks[:self.keep_blocks]
        n = len(self.host)
        if n == 0:
            return
        slots = [(self._next_slot + j) % 2 for j in range(n)]
        self._next_slot = (self._next_slot + n) % 2
        cuda = self._copy_stream is not None
        compute = torch.cuda.current_stream(self.device) if cuda else None
        copies = [None] * n
        for j in range(min(2, n)):
            copies[j] = self._copy(j, slots[j])
        for j in range(n):
            if cuda:
                ready = torch.cuda.Event(enable_timing=True)
                ready.record(compute)
                compute.wait_event(copies[j][1])  # read after write
                self.stats._pending.append((*copies[j], ready))
            yield self.shells[j][slots[j]]
            if cuda:
                free = torch.cuda.Event()
                free.record(compute)  # after block j's last kernel
                self._slot_free[slots[j]] = free
            if j + 2 < n:
                copies[j + 2] = self._copy(j + 2, slots[j + 2])

    @torch.no_grad()
    def __call__(self, vid: torch.Tensor, txt: torch.Tensor,
                 timestep: torch.Tensor, dplan: DevicePlan,
                 use_kernels: bool = True,
                 downscale: Optional[torch.Tensor] = None,
                 attention_mode: str = "flash") -> torch.Tensor:
        """nadit_forward(model, ...) with the blocks streamed."""
        pending = self.stats._pending
        if pending and all(ev.query() for ev in pending[-1][1:]):
            self.stats._resolve()  # earlier forwards' events, no wait
        try:
            return nadit_forward(self.model, vid, txt, timestep, dplan,
                                 use_kernels, downscale, blocks=self._blocks(),
                                 attention_mode=attention_mode)
        finally:
            if self._copy_stream is not None:
                # a forward that stopped early left a slot's fence behind
                # its last kernel: fence both slots at the forward's end
                end = torch.cuda.Event()
                end.record(torch.cuda.current_stream(self.device))
                self._slot_free = [end, end]


class HostCopy:
    """Per-phase DiT offload (the reference's manage_model_device,
    memory_manager.py:573-930): ONE page-locked host copy of every
    parameter and buffer of `model`, made once. `release()` points the
    module's tensors at it and lets the device storage go; `restore()`
    copies it back into one device buffer with non_blocking copies and
    synchronises once at the end."""

    def __init__(self, model: nn.Module, device):
        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        self.packed = pack(model, "cpu", pin=cuda)  # the module is released
        self._device_buf: Optional[torch.Tensor] = None

    @property
    def resident(self) -> bool:
        return self._device_buf is not None

    def restore(self) -> None:
        if self.resident:
            return
        src = self.packed.buffer[:self.packed.nbytes]
        buf = torch.empty(max(src.numel(), 1), dtype=torch.uint8,
                          device=self.device)
        cuda = self.device.type == "cuda"
        buf[:src.numel()].copy_(src, non_blocking=cuda)
        self.packed.bind(buf)
        if cuda:
            torch.cuda.synchronize(self.device)
        self._device_buf = buf

    def release(self) -> None:
        if not self.resident:
            return
        self.packed.bind(self.packed.buffer)
        self._device_buf = None
