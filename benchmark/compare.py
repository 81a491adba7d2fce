"""The comparison that decides `correct`: the program's output frames of
the window's sampled requests against the plain reference's, each number
compared held to its limit from `benchmark/limits/<cell>.json`:

    {"numbers": {"<name>": {"limit": ..., "lower": ..., "upper": ...}}}

`lower` is the largest reading of sound runs over a dozen seeds or more,
`upper` the smallest reading of the control (the next precision down),
and the limit lies between them; PERF.md gives the readings behind each.
A number is the worst over the sampled requests."""

import json
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

LIMITS = Path(__file__).resolve().parent / "limits"


def load_limits(cell: str) -> dict:
    path = LIMITS / f"{cell}.json"
    if not path.exists():
        return {}
    with open(path) as f:
        return json.load(f)["numbers"]


def readings(out: np.ndarray, ref: torch.Tensor) -> Dict[str, float]:
    """Gaps between the program's output frames and the reference's, both
    (T, H, W, 3) in [0, 1]: the root mean square, mean absolute and largest
    absolute difference over every pixel and channel."""
    if tuple(out.shape) != tuple(ref.shape):
        return {"shape": float("inf")}
    d = torch.as_tensor(out, dtype=torch.float32, device=ref.device) - ref
    return {"rms": float(d.square().mean().sqrt()),
            "mean_abs": float(d.abs().mean()),
            "max_abs": float(d.abs().max())}


def worst(all_readings: List[Dict[str, float]]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for r in all_readings:
        for k, v in r.items():
            out[k] = max(out.get(k, -1.0), v)
    return out


def judge(got: Dict[str, float], limits: dict) -> Tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) for every limited number; a
    limited number that was not read, or no limit at all, is not correct."""
    table = {name: {"value": got.get(name, float("inf")),
                    "limit": spec["limit"]} for name, spec in limits.items()}
    ok = bool(limits) and all(v["value"] <= v["limit"] and
                              np.isfinite(v["value"]) for v in table.values())
    if "shape" in got:
        ok = False
        table["shape"] = {"value": got["shape"], "limit": 0.0}
    return ok, table
