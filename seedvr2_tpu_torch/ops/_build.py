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

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C entry points: name -> argtypes. Every entry returns cudaGetLastError().
_SIGNATURES = {
    # qkv, cos_q, sin_q, cos_k, sin_k, scratch, out, B, S, H, D, kv_len, eps,
    # qscale, stream
    "seedvr2_packed_attention": [_P] * 7 + [_I] * 5 + [_F, _F, _P],
    # qkv, cos_q, sin_q, cos_k, sin_k, scratch, out, lse, B, S, H, D, kv_len,
    # eps, qscale, stream
    "seedvr2_packed_attention_lse": [_P] * 8 + [_I] * 5 + [_F, _F, _P],
    # q_src, q_stride, k_src, k_stride, cos_q, sin_q, cos_k, sin_k, ids,
    # q_dst, k_dst, B, Sq, Sk, H, D, table_rows, norm, eps, qscale, stream
    "seedvr2_qk_prepass": [_P, _L, _P, _L] + [_P] * 7 + [_I] * 7
                          + [_F, _F, _P],
    # q, k, v, cos, sin, valid, ids, scratch, out, B, Sq, Sk, H, D, kv_len,
    # table_rows, qscale, stream
    "seedvr2_flash_attention": [_P] * 9 + [_I] * 7 + [_F, _P],
    # q, k, v, cos, sin, valid, ids, scratch, out, lse, B, S, H, D, qscale,
    # stream
    "seedvr2_flash_attention_lse": [_P] * 10 + [_I] * 4 + [_F, _P],
    # q_hat, k_hat, v, out, dout, lse, valid, ids, dq, delta, B, S, H, D,
    # wg, blocks, stream
    "seedvr2_win_bwd_dq": [_P] * 10 + [_I] * 6 + [_P],
    # q_hat, k_hat, v, dout, lse, delta, valid, ids, dk, dv, B, S, H, D,
    # blocks, stream
    "seedvr2_win_bwd_dkdv": [_P] * 10 + [_I] * 5 + [_P],
    # dq_acc, dk_acc, cos, sin, ids, dq, dk, B, S, H, D, gq, gk, stream
    "seedvr2_win_rope_bwd": [_P] * 7 + [_I] * 4 + [_F, _F, _P],
    # q_hat, k_hat, v, v_stride, out, dout, lse, dq, delta, B, S, H, D,
    # kv_len, wg, blocks, stream
    "seedvr2_attn_bwd_dq": [_P, _P, _P, _L] + [_P] * 5 + [_I] * 7 + [_P],
    # q_hat, k_hat, v, v_stride, dout, lse, delta, dk, dv, dv_stride, B, S,
    # H, D, kv_len, blocks, stream
    "seedvr2_attn_bwd_dkdv": [_P, _P, _P, _L] + [_P] * 5 + [_L] + [_I] * 6
                             + [_P],
    # q_src, k_src, src_stride, cos_q, sin_q, cos_k, sin_k, dq_acc, dk_acc,
    # dq_dst, dk_dst, dst_stride, partials, tables, B, S, H, D, eps, gq, gk,
    # stream
    "seedvr2_prepass_bwd": [_P, _P, _L] + [_P] * 8 + [_L, _P, _P]
                           + [_I] * 4 + [_F] * 3 + [_P],
    # x, idx, out, B, L, L2, D, stream
    "seedvr2_gather_rows": [_P, _P, _P, _I, _I, _I, _I, _P],
    # xq, wq, xs, ws, out, M, N, K, swap, bt, stream
    "seedvr2_int8_matmul": [_P] * 5 + [_I] * 6 + [_P],
    # x, wq, ws, xs, xq (scratch), out, M, N, K, x_f32, out_f32, swap, bt,
    # stream
    "seedvr2_int8_matmul_qx": [_P] * 6 + [_I] * 7 + [_P],
    # x, scale, shift, q, s, rows, L, K, eps, threads, grid, stream
    "seedvr2_rms_ada_quantize": [_P] * 5 + [_L, _I, _I, _F, _I, _I, _P],
    # threads, out: resident K4 blocks on the device
    "seedvr2_rms_ada_quantize_resident": [_I, _P],
    # g, u, q, s, rows, K, row_stride, stream
    "seedvr2_silu_mul_quantize": [_P, _P, _P, _P, _I, _I, _I, _P],
    # x, q, scales, ws, out, M, N, K, G4, bt, splits, stream
    "seedvr2_quant_matmul_q8": [_P] * 5 + [_I] * 7 + [_P],
    # x, q, s, m, xg, mnp, ws, out, M, N, K, G4, XW, bt, splits, stream
    "seedvr2_quant_matmul_affine": [_P] * 8 + [_I] * 8 + [_P],
    # x, xg, m, mnp, M, N, K, G4, XW, stream
    "seedvr2_k7_prepass": [_P] * 4 + [_I] * 5 + [_P],
    # ws, out, pairs, splits, stream
    "seedvr2_split_reduce": [_P, _P, _L, _I, _I, _P],
    # x_ext, wk, xs, ws, bias, out, T, H, Wp, C, Co, W_out, out strides
    # (co, t, h, w), pixel tiles, channel tiles, stream
    "seedvr2_int8_conv3d": [_P] * 6 + [_I] * 6 + [_L] * 4 + [_I] * 2 + [_P],
    # x, weight, bias, weight/bias bf16, partials, counters, A, Bc, B, C, T,
    # G, H*W, pieces, piece, eps, stream
    "seedvr2_k12_moments": [_P] * 3 + [_I] + [_P] * 4 + [_I] * 4
                           + [_L, _I, _L, _F, _P],
    # x, A, Bc, out, B, C, T, H*W, head frames, pieces, piece, stream
    "seedvr2_k12_apply": [_P] * 4 + [_I] * 3 + [_L, _I, _I, _L, _P],
    # x, w, bias, out, B, Ci, T, H, W, frame stride, C, tr, drop, head
    # frames, repeat frame 0 into them, stream
    "seedvr2_upsample_shuffle": [_P] * 4 + [_I] * 5 + [_L] + [_I] * 5 + [_P],
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


def library_path() -> Path:
    """Where the build of the current sources and flags lives (named by
    their hash); it may not exist yet. Builds nothing."""
    digest = hashlib.sha256()
    for p in _sources():
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libseedvr2_kernels_{digest.hexdigest()[:16]}.so"


def _build() -> KernelLibrary:
    path = library_path()
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


def refuse_grad(name: str, *tensors) -> None:
    """Raise when grad mode is on and a tensor needs a gradient: a kernel's
    output has no autograd history, so a raw kernel wrapper must not be
    handed one (its autograd Function is)."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                    for t in tensors):
        raise RuntimeError(f"{name}: an input needs a gradient; the kernel's "
                           "output would carry none. Call its autograd "
                           "Function (the *_grad entry point) instead")


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
