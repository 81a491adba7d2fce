"""The port's host library (csrc/host/seedvr2_native.cpp) through ctypes.

Counterpart of seedvr2_tpu.ops.native: GGUF block dequantization (Q8_0,
Q4_K, Q6_K) and the uint8 <-> float32 frame converters, in C++ threaded
over blocks. The library is compiled by g++ at the first call in a process,
never at import, into `build/torch_kernels/host/` at the checkout root,
under a name that carries a hash of the source and the flags (an edited
source rebuilds), and written atomically.

Unlike the JAX package there is no numpy fallback: if g++ is missing or the
build fails, the call raises with the compiler's output, so a loader never
silently takes the slow path. The numpy dequantizers of ops/gguf.py stay as
the plain versions the tests hold this library to, bit for bit: Q8_0 and
Q6_K only multiply, and a Q4_K value d * sc * q has at most 21 significant
bits (an f16 d, a 6-bit scale, a 4-bit quant), exact in fp32, so its
subtraction of dmin * m rounds once as numpy's does; -ffp-contract=off
keeps every expression as written all the same.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "host" / \
    "seedvr2_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels" / \
    "host"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
             "-ffp-contract=off")

_U8P = ctypes.POINTER(ctypes.c_uint8)
_F32P = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    "dequant_q8_0": [_U8P, ctypes.c_int64, _F32P],
    "dequant_q4_k": [_U8P, ctypes.c_int64, _F32P],
    "dequant_q6_k": [_U8P, ctypes.c_int64, _F32P],
    "frames_u8_to_f32": [_U8P, _F32P, ctypes.c_int64, ctypes.c_int,
                         ctypes.c_int],
    "frames_f32_to_u8": [_F32P, _U8P, ctypes.c_int64, ctypes.c_int,
                         ctypes.c_int],
}

# ggml type id -> (entry point, bytes a block, values a block)
DEQUANT = {8: ("dequant_q8_0", 34, 32), 12: ("dequant_q4_k", 144, 256),
           14: ("dequant_q6_k", 210, 256)}

_lock = threading.Lock()
_lib = None
build_seconds = 0.0  # g++ time of this process's build; 0.0 when cached


def _build() -> ctypes.CDLL:
    global build_seconds
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(GXX_FLAGS).encode()).hexdigest()
    path = BUILD_DIR / f"libseedvr2_native_{digest[:16]}.so"
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
        cmd = [os.environ.get("CXX", "g++"), *GXX_FLAGS, str(SOURCE), "-o",
               str(tmp)]
        t0 = time.perf_counter()
        try:
            res = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as exc:
            raise RuntimeError(f"host library: cannot run {cmd[0]!r} ({exc});"
                               " the port's GGUF dequantizer is built from "
                               f"{SOURCE}") from exc
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"host library build failed "
                               f"({res.returncode}): {' '.join(cmd)}\n"
                               f"{res.stdout}{res.stderr}")
        build_seconds = time.perf_counter() - t0
        os.replace(tmp, path)  # atomic: a concurrent build never sees half
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = None
    return lib


def library() -> ctypes.CDLL:
    """The process's host library, built on first use; raises if it cannot
    be built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _build()
        return _lib


def dequantize_blocks(blocks: np.ndarray, ggml_type: int) -> np.ndarray:
    """(n_blocks, block_bytes) uint8 of a Q8_0 / Q4_K / Q6_K tensor ->
    (n_blocks, values a block) float32."""
    name, nbytes, elems = DEQUANT[ggml_type]
    blocks = np.ascontiguousarray(blocks, dtype=np.uint8)
    if blocks.ndim != 2 or blocks.shape[1] != nbytes:
        raise ValueError(f"{name}: blocks of shape {blocks.shape}, expected "
                         f"(n, {nbytes})")
    out = np.empty((blocks.shape[0], elems), np.float32)
    getattr(library(), name)(blocks.ctypes.data_as(_U8P),
                             ctypes.c_int64(blocks.shape[0]),
                             out.ctypes.data_as(_F32P))
    return out


def frames_to_float(frames_u8: np.ndarray, swap_rb: bool = False
                    ) -> np.ndarray:
    """(..., C) uint8 -> float32 in [0, 1] (value * (1 / 255)), the first
    three channels reversed when swap_rb."""
    frames_u8 = np.ascontiguousarray(frames_u8, dtype=np.uint8)
    c = frames_u8.shape[-1]
    out = np.empty(frames_u8.shape, np.float32)
    library().frames_u8_to_f32(frames_u8.ctypes.data_as(_U8P),
                               out.ctypes.data_as(_F32P),
                               ctypes.c_int64(frames_u8.size // c),
                               ctypes.c_int(c), ctypes.c_int(int(swap_rb)))
    return out


def frames_to_uint8(frames_f32: np.ndarray, swap_rb: bool = False
                    ) -> np.ndarray:
    """(..., C) float32 in [0, 1] -> uint8 (x * 255 + 0.5, clamped), the
    first three channels reversed when swap_rb."""
    frames_f32 = np.ascontiguousarray(frames_f32, dtype=np.float32)
    c = frames_f32.shape[-1]
    out = np.empty(frames_f32.shape, np.uint8)
    library().frames_f32_to_u8(frames_f32.ctypes.data_as(_F32P),
                               out.ctypes.data_as(_U8P),
                               ctypes.c_int64(frames_f32.size // c),
                               ctypes.c_int(c), ctypes.c_int(int(swap_rb)))
    return out
