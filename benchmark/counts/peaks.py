"""Published peaks of one NVIDIA H100 SXM (dense, at the 700 W power
limit): the table every roofline share and `mfu` of this benchmark is
held to. A card set below 700 W reaches less; the runs print the card's
power limit beside these shares."""

PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}  # per second
HBM_BYTES = 3.35e12  # per second


def bound_s(ops: float, nbytes: float, dtype: str) -> float:
    """The least time the chip could take: the larger of the operations
    over the type's peak and the bytes over the memory's."""
    return max(ops / PEAK_OPS[dtype], nbytes / HBM_BYTES)
