"""Build and load the port's hand-written CUDA kernels.

Every `*.cu` under `seedvr2_tpu_torch/csrc/` is compiled by `nvcc` for
Hopper (`sm_90a`), one `nvcc` process per source, all started together, and
the objects are linked into ONE shared library with a plain C interface,
which is loaded with `ctypes`. The library lives in `build/torch_kernels/` at the
checkout root and its file name carries a hash of the sources, so an edited
source rebuilds. The build happens at the first kernel launch in a process,
never at import: the CPU-only test environment imports every module.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argtypes. Every entry returns cudaGetLastError().
_SIGNATURES = {
    # qkv, cos_q, sin_q, cos_k, sin_k, out, B, S, H, D, kv_len, eps, qscale,
    # stream
    "seedvr2_packed_attention": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _F, _F, _P],
    # x, idx, out, B, L, L2, D, stream
    "seedvr2_gather_rows": [_P, _P, _P, _I, _I, _I, _I, _P],
    # xq, wq, xs, ws, out, M, N, K, stream
    "seedvr2_int8_matmul": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    # x, scale, shift, q, s, rows, L, K, eps, stream
    "seedvr2_rms_ada_quantize": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    # g, u, q, s, rows, K, row_stride, stream
    "seedvr2_silu_mul_quantize": [_P, _P, _P, _P, _I, _I, _I, _P],
    # x, q, scales, out, M, N, K, stream
    "seedvr2_quant_matmul_q8": [_P, _P, _P, _P, _I, _I, _I, _P],
    # x, q, s, m, out, M, N, K, stream
    "seedvr2_quant_matmul_affine": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
}


@dataclass
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float   # 0.0 when the library was already built
    ptxas_log: str         # nvcc/ptxas report of the build ("" when cached)


_lock = threading.Lock()
_loaded = None


def _sources():
    return sorted(p for p in CSRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "of seedvr2_tpu_torch are built from source")
    return found


def _build() -> KernelLibrary:
    digest = hashlib.sha256()
    for p in _sources():
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    path = BUILD_DIR / f"libseedvr2_kernels_{digest.hexdigest()[:16]}.so"
    seconds, log = 0.0, ""
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        stem = f"{path.stem}.{os.getpid()}"
        tmp = path.with_name(f"{stem}.tmp.so")
        cu = [p for p in _sources() if p.suffix == ".cu"]
        objs = [BUILD_DIR / f"{stem}.{p.stem}.o" for p in cu]
        nvcc = _nvcc()
        t0 = time.perf_counter()
        try:
            procs = [subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", "-o", str(o),
                 str(p)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True) for p, o in zip(cu, objs)]
            log = "".join(proc.communicate()[0] for proc in procs)
            if any(proc.returncode for proc in procs):
                raise RuntimeError(f"nvcc failed:\n{log}")
            res = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o",
                                  str(tmp), *map(str, objs)],
                                 capture_output=True, text=True)
        finally:
            for o in objs:
                o.unlink(missing_ok=True)
        seconds = time.perf_counter() - t0
        log += res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{log}")
        os.replace(tmp, path)  # atomic: a concurrent build never sees half
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return KernelLibrary(lib=lib, path=path, build_seconds=seconds,
                         ptxas_log=log)


def kernel_library() -> KernelLibrary:
    """The process's kernel library, built on first use."""
    global _loaded
    with _lock:
        if _loaded is None:
            _loaded = _build()
        return _loaded


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
