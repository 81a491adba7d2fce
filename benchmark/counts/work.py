"""The work one request needs, counted from the configuration and the
request's shape with the benchmark's own window and tile arithmetic, so the
counts read the same whatever implements them.

A request's work is a list of `Work` items: the operations of a matrix
product (2 per multiply-add) or of attention, the bytes its inputs and
outputs take (each input byte read once, each output byte written once),
the number type it runs in (the peak it is held to) and the kernel that
serves it on the main path. Norms, activations, gathers and copies are
not counted: they are bound by bytes and hold no operation a peak counts.
"""

from dataclasses import dataclass
from typing import Optional

from ..reference.dit import w8a8_converts


@dataclass(frozen=True)
class Work:
    layer: str            # "dit" or "vae"
    what: str             # "linear", "attention", "conv", ...
    ops: float
    bytes: float
    dtype: str            # "bf16" or "int8": the peak it is held to
    kernel: Optional[str]  # "k1", "k3", or None for a library kernel


def linear(m: int, k: int, n: int, quant: str, bias: bool = True,
           layer: str = "dit") -> Work:
    """(m, k) @ (k, n): bf16 operands and output, or the int8 lane's int8
    operands, fp32 row and column scales and bf16 output (kernel K3)."""
    ops = 2.0 * m * n * k
    out = 2.0 * m * n + (2.0 * n if bias else 0.0)
    if quant == "w8a8" and w8a8_converts(k, n):
        return Work(layer, "linear", ops, m * k + n * k + 4.0 * (m + n) + out,
                    "int8", "k3")
    return Work(layer, "linear", ops, 2.0 * (m * k + n * k) + out, "bf16",
                None)
