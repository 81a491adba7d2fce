"""Row gather for static index vectors (kernel K2).

Port of seedvr2_tpu.ops.gather.gather_rows: x[..., idx, :] for the NaDiT
window-order transitions. On a CUDA tensor it launches the hand-written
kernel `csrc/gather_rows.cu` (replaces the Pallas TPU kernel
`_gather_kernel`; see the source for what bounds it and why it is shaped
so); on a CPU tensor it runs the plain version. The index vector is
validated on the host and uploaded once (`RowIndex`), so a launch never
synchronises with the device.

Its gradient (`gather_rows_grad`, the `GatherRows` autograd Function): every
window-order transition is a permutation of the rows, so the gradient of a
gather is the same kernel run on the incoming gradient with the inverse
index (`RowIndex.inverse`, built and uploaded once). `gather_rows` itself
refuses an input that needs a gradient while grad mode is on, since the
kernel's output has no autograd history.
"""

import numpy as np
import torch

from . import _build


class RowIndex:
    """A static gather index: checked on the host, uploaded once."""

    def __init__(self, idx, device):
        idx = np.asarray(idx)
        if idx.ndim != 1 or idx.size == 0 or not np.issubdtype(idx.dtype,
                                                               np.integer):
            raise ValueError("a row index is a non-empty 1-D integer vector")
        self.lo = int(idx.min())
        self.hi = int(idx.max())
        if self.lo < 0 or self.hi >= 2 ** 31:
            raise ValueError("row indices must lie in [0, 2**31)")
        self.numpy = idx.astype(np.int32)
        self.tensor = torch.as_tensor(self.numpy, device=device)
        self._inverse = None

    def __len__(self):
        return self.numpy.shape[0]

    @property
    def inverse(self) -> "RowIndex":
        """The inverse permutation (inverse[idx[j]] = j), on the same
        device, built and uploaded at first use. Raises ValueError when the
        index is not a permutation of its len(idx) source rows."""
        if self._inverse is None:
            n = len(self)
            if self.hi != n - 1 or np.unique(self.numpy).size != n:
                raise ValueError("the row index is not a permutation of its "
                                 f"{n} source rows: no inverse")
            inv = np.empty(n, np.int32)
            inv[self.numpy] = np.arange(n, dtype=np.int32)
            self._inverse = RowIndex(inv, self.tensor.device)
        return self._inverse


def gather_rows_plain(x: torch.Tensor, index: RowIndex) -> torch.Tensor:
    """Plain version: x (..., L, D) -> x[..., idx, :]."""
    return torch.index_select(x, -2, index.tensor.to(x.device).long())


def gather_rows(x: torch.Tensor, index: RowIndex) -> torch.Tensor:
    """x: (B, L, D) -> (B, len(idx), D) with out[b, j] = x[b, idx[j]].

    CPU tensors take the plain version; CUDA tensors launch the kernel, or
    raise on what it does not take (dtype, rank, contiguity, index device or
    range). An x that needs a gradient while grad mode is on is refused on
    every device: `gather_rows_grad` carries one."""
    _build.refuse_grad("gather_rows", x)
    if index.hi >= x.shape[-2]:
        raise IndexError(f"row index {index.hi} out of range for "
                         f"{x.shape[-2]} rows")
    if x.device.type == "cpu":
        return gather_rows_plain(x, index)
    if x.device.type != "cuda":
        raise RuntimeError(f"gather_rows: no kernel for device {x.device}")
    if x.dtype != torch.bfloat16 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError("gather_rows kernel takes a contiguous (B, L, D) "
                         f"bf16 tensor, got {tuple(x.shape)} {x.dtype}")
    idx = index.tensor
    if idx.device != x.device:
        raise ValueError("gather_rows: index lives on another device")
    B, L, D = x.shape
    L2 = len(index)
    out = torch.empty((B, L2, D), dtype=x.dtype, device=x.device)
    lib = _build.kernel_library().lib
    err = lib.seedvr2_gather_rows(
        x.data_ptr(), idx.data_ptr(), out.data_ptr(), B, L, L2, D,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "seedvr2_gather_rows")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


class GatherRows(torch.autograd.Function):
    """K2 with its gradient: forward launches K2 (the plain gather on the
    CPU), backward launches K2 on the incoming gradient with the inverse
    permutation (raises for an index that is not a permutation of x's
    rows)."""

    @staticmethod
    def forward(ctx, x, index: RowIndex):
        ctx.index = index
        ctx.rows = x.shape[-2]
        return gather_rows(x, index)

    @staticmethod
    def backward(ctx, grad):
        index = ctx.index
        if len(index) != ctx.rows:
            raise ValueError(f"gather_rows backward: {len(index)} rows "
                             f"gathered from {ctx.rows} are no permutation")
        out = gather_rows(grad.contiguous(), index.inverse)
        if grad.is_cuda:
            GatherRows.launches += 1  # K2's launches as the gradient
        return out, None


GatherRows.launches = 0


def gather_rows_grad(x: torch.Tensor, index: RowIndex) -> torch.Tensor:
    """gather_rows with a gradient: the kernel alone when x needs none (or
    grad mode is off), else through GatherRows."""
    if torch.is_grad_enabled() and x.requires_grad:
        return GatherRows.apply(x, index)
    return gather_rows(x, index)
