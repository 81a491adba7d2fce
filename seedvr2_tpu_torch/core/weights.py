"""Weight bridge: JAX parameter trees and reference-layout checkpoints.

`state_dict_from_jax` reimplements the transform of
seedvr2_tpu.core.export.to_torch_state_dict for a tree of numpy arrays: keys
are the dotted tree paths with "w" -> "weight" (transposed (in, out) ->
(out, in) for linears, (kt, kh, kw, ci, co) -> (co, ci, kt, kh, kw) for 3D
convs) and "b" -> "bias". Its keys are exactly the port modules' state_dict
keys. w8a8 trees ({"w8a8": (K, N) int8, "ws": (N,) fp32, "b"?}, from
quantize_dit_params_w8a8) map onto ops.int8_matmul.W8A8Linear buffers:
"w8a8" transposed to (N, K) and kept int8, "ws" kept fp32.

`load_safetensors_checkpoint` loads a reference-layout checkpoint into a
port module with strict=True, through a small safetensors reader of this
package's own (an 8-byte little-endian header length, a JSON header, then
raw little-endian bytes), so a host without the `safetensors` package can
read the checkpoints and the packaged text embeddings.
"""

import json
import struct
from typing import Dict

import numpy as np
import torch

_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool, "F8_E4M3": torch.float8_e4m3fn,
    "F8_E5M2": torch.float8_e5m2,
}


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}."))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def state_dict_from_jax(params, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """JAX parameter tree (numpy leaves) -> reference-layout state dict of
    `dtype` tensors (integer leaves and w8a8 scales keep their types)."""
    state = {}
    for key, arr in _flatten(params).items():
        parts = key.split(".")
        if arr.dtype.name == "bfloat16":
            arr = arr.astype(np.float32)
        if parts[-1] == "w8a8":
            arr = arr.T  # (K, N) -> (N, K), int8 exact
        elif parts[-1] == "ws":
            state[key] = torch.from_numpy(np.array(arr, np.float32))
            continue
        elif parts[-1] == "w":
            parts[-1] = "weight"
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 5:
                arr = arr.transpose(4, 3, 0, 1, 2)
            elif arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
        elif parts[-1] == "b":
            parts[-1] = "bias"
        t = torch.from_numpy(np.array(arr))
        state[".".join(parts)] = t.to(dtype) if t.is_floating_point() else t
    return state


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a .safetensors file, on the host, in its stored
    dtype."""
    out = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        for name, info in header.items():
            if name == "__metadata__":
                continue
            start, end = info["data_offsets"]
            dtype = _ST_DTYPES.get(info["dtype"])
            if dtype is None:
                raise ValueError(f"{path}: unsupported dtype {info['dtype']}")
            # each tensor is read into its own buffer: the file is never
            # held in memory twice
            buf = bytearray(end - start)
            f.seek(8 + n + start)
            if f.readinto(buf) != len(buf):
                raise ValueError(f"{path}: truncated at tensor {name}")
            t = (torch.frombuffer(buf, dtype=dtype) if buf
                 else torch.empty(0, dtype=dtype))
            out[name] = t.reshape(info["shape"])
    return out


def load_safetensors_checkpoint(path: str, module: torch.nn.Module
                                ) -> torch.nn.Module:
    """Load a reference-layout checkpoint into a port module (DiT or VAE):
    every key must match (strict=True); values are cast to the module's
    parameter dtypes on copy."""
    module.load_state_dict(read_safetensors(path), strict=True)
    return module
