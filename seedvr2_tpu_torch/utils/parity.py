"""Real-checkpoint parity harness.

Port of seedvr2_tpu.utils.parity. The reference consumes precomputed text
embeddings `pos_emb.pt` / `neg_emb.pt` (src/core/generation_utils.py:512-553)
and publishes no numeric outputs, so parity is established by: (1)
converting the .pt embeddings into .npy or .safetensors files, (2)
capturing the reference's output once, (3) re-running the same config here
and scoring PSNR against that capture (the CLI's --parity_check, one JSON
line).
"""

import json
import os
from typing import Dict, Optional

import numpy as np


def convert_embedding_file(src: str, dst: str) -> np.ndarray:
    """Convert one torch-saved embedding (pos_emb.pt / neg_emb.pt) to a
    .npy or .safetensors file consumable by
    utils/text_embeds.load_text_embeddings."""
    import torch

    t = torch.load(src, map_location="cpu", weights_only=True)
    arr = t.float().numpy()
    if arr.ndim == 3 and arr.shape[0] == 1:  # (1, L, D) -> (L, D)
        arr = arr[0]
    if dst.endswith(".npy"):
        np.save(dst, arr)
    elif dst.endswith(".safetensors"):
        from ..core.weights import write_safetensors

        write_safetensors(dst, {"embedding": torch.from_numpy(arr)})
    else:
        raise ValueError(f"unsupported target format: {dst}")
    return arr


def convert_embeddings(src_dir: str, dst_dir: str, fmt: str = "npy") -> Dict:
    """Convert pos_emb.pt + neg_emb.pt from src_dir into dst_dir."""
    os.makedirs(dst_dir, exist_ok=True)
    out = {}
    for name in ("pos_emb", "neg_emb"):
        src = os.path.join(src_dir, f"{name}.pt")
        if not os.path.isfile(src):
            raise FileNotFoundError(
                f"{src} not found (download it next to the reference "
                "weights; see docs/parity.md)")
        dst = os.path.join(dst_dir, f"{name}.{fmt}")
        out[name] = convert_embedding_file(src, dst).shape
    return out


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    """Peak signal-to-noise ratio in dB (inf for identical inputs)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    mse = float(np.mean((a - b) ** 2))
    if mse == 0.0:
        return float("inf")
    return 10.0 * np.log10(data_range ** 2 / mse)


def load_capture(path: str) -> np.ndarray:
    """Load a reference output capture: .npy (T, H, W, C) in [0, 1], or an
    image file (through utils/video_io, which needs OpenCV)."""
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    from . import video_io

    return video_io.read_image(path)


def compare_to_capture(result: np.ndarray, capture_path: str,
                       min_psnr: Optional[float] = None) -> Dict:
    """Score a pipeline output against a reference capture. Returns the
    parity report dict (also printed as one JSON line by the CLI)."""
    ref = load_capture(capture_path)
    if result.shape != ref.shape:
        return {"parity": "shape_mismatch", "result_shape": list(result.shape),
                "capture_shape": list(ref.shape)}
    value = psnr(result[..., :3], ref[..., :3])
    report = {
        "parity": "ok",
        "psnr_db": round(value, 2) if np.isfinite(value) else "inf",
        "max_abs_diff": round(float(np.abs(result - ref).max()), 6),
        "capture": capture_path,
    }
    if min_psnr is not None:
        report["passed"] = bool(value >= min_psnr)
        report["min_psnr_db"] = min_psnr
    return report


def print_report(report: Dict) -> None:
    print(json.dumps(report))
