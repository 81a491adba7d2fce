"""Weight bridge: JAX parameter trees and reference-layout checkpoints.

`state_dict_from_jax` reimplements the transform of
seedvr2_tpu.core.export.to_torch_state_dict for a tree of numpy arrays: keys
are the dotted tree paths with "w" -> "weight" (transposed (in, out) ->
(out, in) for linears, (kt, kh, kw, ci, co) -> (co, ci, kt, kh, kw) for 3D
convs) and "b" -> "bias". Its keys are exactly the port modules' state_dict
keys. Quantised trees map onto the buffers of the port's quantised linears,
integers kept exact and tables kept fp32:
 - w8a8 ({"w8a8": (K, N) int8, "ws": (N,)}, quantize_dit_params_w8a8) onto
   ops.int8_matmul.W8A8Linear: "w8a8" transposed to (N, K);
 - Q8_0 ({"q8": (K, N) int8, "scales": (K/32, N)}) onto
   ops.quant_matmul.Q8Linear, both transposed;
 - affine ({"qa": (K, N) int8, "s", "m": (K/32, N)}) onto
   ops.quant_matmul.AffineLinear, all three transposed.

`should_skip` names the rope / freqs / dummy buffers the reference's modules
save (`SKIP_PATTERNS`); the loaders (core/loader.py) drop them, as the JAX
loader does, and recompute rope at plan time. `read_safetensors` is a small
safetensors reader of this package's own (an 8-byte little-endian header
length, a JSON header, then raw little-endian bytes), so a host without the
`safetensors` package can read the checkpoints and the packaged text
embeddings.

The trainer's side (parallel/train.py): `save_checkpoint` ports
seedvr2_tpu.core.export.save_checkpoint (reference-layout keys, fp16
values, a file the port's loaders read), from a model or from a training
state; `train_state_from_jax` carries a JAX TrainState (numpy leaves, optax
adamw's ScaleByAdamState) across as a one-rank port TrainState.
"""

import json
import re
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

# keys of the reference's rope buffers, never weights
SKIP_PATTERNS = (
    re.compile(r"\.rope\."),
    re.compile(r"\.freqs$"),
    re.compile(r"\.dummy$"),
)

# quantised leaves: name -> the leaf that marks its node; transposed
# (K, N) -> (N, K) or (K/32, N) -> (N, K/32)
_QUANT_LEAVES = {"w8a8": "w8a8", "q8": "q8", "scales": "q8", "qa": "qa",
                 "s": "qa", "m": "qa"}


def should_skip(key: str) -> bool:
    return any(p.search(key) for p in SKIP_PATTERNS)


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
    `dtype` tensors (integer leaves and quantisation tables keep their
    types)."""
    flat = _flatten(params)
    state = {}
    for key, arr in flat.items():
        parts = key.split(".")
        if arr.dtype.name == "bfloat16":
            arr = arr.astype(np.float32)
        node = key.rpartition(".")[0]
        marker = _QUANT_LEAVES.get(parts[-1])
        if marker is not None and f"{node}.{marker}" in flat:
            arr = np.ascontiguousarray(arr.T)  # int8 exact, tables fp32
            state[key] = torch.from_numpy(
                arr if arr.dtype == np.int8 else arr.astype(np.float32))
            continue
        if parts[-1] == "ws":
            state[key] = torch.from_numpy(np.array(arr, np.float32))
            continue
        if parts[-1] == "w":
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


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor]) -> None:
    """A .safetensors file of `tensors` (name -> tensor, each in its own
    dtype): an 8-byte header length, the JSON header padded to 8 bytes,
    then each tensor's raw little-endian bytes; read_safetensors reads it
    back."""
    names = {v: k for k, v in _ST_DTYPES.items()}
    header, off = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    raw = json.dumps(header).encode()
    raw += b" " * ((-len(raw)) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)) + raw)
        for t in tensors.values():
            t = t.detach().cpu().reshape(-1)
            if t.numel() and t.stride(0) != 1:  # a strided view, size 1 too
                t = t.clone(memory_format=torch.contiguous_format)
            f.write(t.view(torch.uint8).numpy().tobytes())


def save_checkpoint(model_or_state, path: str, dtype=torch.float16) -> None:
    """A reference-layout .safetensors checkpoint (the state-dict names,
    floating tensors in `dtype`, integer ones as they are) of an nn.Module
    or of a parallel.train.TrainState (its whole parameters: every rank of
    its mesh takes part, the mesh's first rank writes)."""
    if hasattr(model_or_state, "opt_state"):
        from ..parallel.train import full_params

        state = model_or_state
        tensors = full_params(state)
        if state.mesh is not None and state.mesh.rank != state.mesh.ranks[0]:
            return
    else:
        tensors = model_or_state.state_dict()
    write_safetensors(path, {k: v.detach().to(dtype)
                             if v.is_floating_point() else v.detach()
                             for k, v in tensors.items()})


def train_state_from_jax(state):
    """A JAX parallel.train.TrainState with numpy leaves (jax.device_get of
    one) as a one-rank parallel.train.TrainState of whole fp32 CPU tensors:
    the params through state_dict_from_jax, optax's ScaleByAdamState (the
    first element of adamw's chained state: count, mu, nu) onto the moments
    "mu" / "nu" under the same names, the step from the state (checked
    against the count)."""
    from ..parallel.train import TrainState

    adam = next(s for s in state.opt_state
                if all(hasattr(s, a) for a in ("count", "mu", "nu")))
    step = int(np.asarray(state.step))
    if int(np.asarray(adam.count)) != step:
        raise ValueError(f"optax count {int(np.asarray(adam.count))} is not "
                         f"the state's step {step}")
    return TrainState(
        params=state_dict_from_jax(state.params),
        opt_state={"mu": state_dict_from_jax(adam.mu),
                   "nu": state_dict_from_jax(adam.nu)},
        step=step)
