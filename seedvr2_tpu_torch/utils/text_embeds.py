"""Precomputed text embeddings (SeedVR2 ships no text encoder).

Port of seedvr2_tpu.utils.text_embeds.load_text_embeddings for the
safetensors and .npy forms. The published embeddings ship with this package
as bf16 safetensors (seedvr2_tpu_torch/assets/{pos,neg}_emb.safetensors,
byte-equal copies of the JAX package's) and are read through the port's own
safetensors reader.
"""

import os
from typing import Dict, Optional

import numpy as np

from ..core.weights import read_safetensors

POS_LEN, NEG_LEN, TXT_DIM = 58, 64, 5120

# this package's own asset directory
ASSET_DIRS = (os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets"),)

_NAMES = {"pos": ("pos_emb.safetensors", "pos_emb.npy"),
          "neg": ("neg_emb.safetensors", "neg_emb.npy")}


def _load_one(path: str) -> np.ndarray:
    if path.endswith(".safetensors"):
        tensors = read_safetensors(path)
        return next(iter(tensors.values())).float().numpy()
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    raise ValueError(f"unsupported embedding format: {path}")


def find_embedding_path(kind: str, search_dirs,
                        include_packaged: bool = True) -> Optional[str]:
    """The file load_text_embeddings serves for `kind` ("pos"/"neg"), or
    None. User dirs win over the packaged assets."""
    dirs = list(search_dirs)
    if include_packaged:
        dirs.extend(ASSET_DIRS)
    for d in dirs:
        if not d or not os.path.isdir(d):
            continue
        for c in _NAMES[kind]:
            p = os.path.join(d, c)
            if os.path.isfile(p):
                return p
    return None


def load_text_embeddings(search_dirs=(), debug=None, txt_dim: int = TXT_DIM,
                         allow_zero: bool = False) -> Dict[str, np.ndarray]:
    """pos_emb/neg_emb from the given directories, falling back to the
    packaged published embeddings. A user file whose width is not `txt_dim`
    raises; the packaged assets are skipped on a width mismatch (logged
    through `debug`, a utils.debug.Debug). A published-width model
    (txt_dim == 5120) without embeddings raises, since unconditioned output
    is wrong output, unless allow_zero (the CLI's --allow_zero_embeddings,
    for benchmarks) gives it zeros with a forced warning; other widths
    (test configs) get zeros."""
    out: Dict[str, Optional[np.ndarray]] = {"pos": None, "neg": None}
    for kind in out:
        p = find_embedding_path(kind, search_dirs, include_packaged=False)
        if p is None:
            pk = find_embedding_path(kind, (), include_packaged=True)
            if pk is not None:
                emb = _load_one(pk)
                if emb.shape[-1] == txt_dim:
                    out[kind] = emb
                elif debug:
                    debug.log(
                        f"packaged {kind}_emb dim {emb.shape[-1]} != model "
                        f"txt_in_dim {txt_dim}; skipping",
                        category="setup")
            continue
        emb = _load_one(p)
        if emb.shape[-1] != txt_dim:
            raise ValueError(f"{p}: text embedding dim {emb.shape[-1]} does "
                             f"not match the model's txt_in_dim {txt_dim}")
        out[kind] = emb
    if out["pos"] is None:
        if not allow_zero and txt_dim == TXT_DIM:
            raise FileNotFoundError(
                "pos_emb not found in the search dirs or the packaged assets"
                " — a published-model run without text conditioning "
                "produces wrong output. Provide pos_emb.safetensors/.npy "
                "next to the weights, or pass --allow_zero_embeddings to "
                "benchmark without conditioning.")
        if debug:
            debug.log("text embeddings not found; using zeros",
                      level="WARNING", category="setup", force=True)
        out["pos"] = np.zeros((POS_LEN, txt_dim), np.float32)
    if out["neg"] is None:
        out["neg"] = np.zeros((NEG_LEN, txt_dim), np.float32)
    return {"pos": out["pos"], "neg": out["neg"]}
