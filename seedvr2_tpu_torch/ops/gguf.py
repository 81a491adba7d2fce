"""GGUF checkpoints: container parser and block dequantizers (numpy).

A copy of the numpy parts of seedvr2_tpu.ops.gguf, pinned equal to it by
tests/test_torch_gguf.py, with one difference: the quantised serving
layouts come out in the port's (N, K) = (out, in) order, the GGUF's own, so
nothing is transposed at load:
 - keep_q8: a 2D Q8_0 tensor stays {"q8": int8 (N, K), "scales": fp32
   (N, K/32)} (served by ops.quant_matmul.Q8Linear, kernel K6); other large
   quantised linears are requantized to that layout on the host;
 - native_kquants: a large 2D Q4_K/Q5_K tensor keeps its affine form
   {"qa": raw quants int8 (N, K), "s", "m": fp32 (N, K/32)} with
   w = qa * s - m (ops.quant_matmul.AffineLinear, kernel K7).
Everything else is dequantized to float32 in torch layout. The JAX
package's optional g++ host dequantizer (ops/native.py) is not copied: the
numpy dequantizers compute the same values.

Implemented from the public GGML/GGUF block-format spec.
"""

import struct
from typing import Dict, Tuple

import numpy as np

GGUF_MAGIC = b"GGUF"

# ggml type ids
F32, F16 = 0, 1
Q4_0, Q4_1, Q5_0, Q5_1, Q8_0, Q8_1 = 2, 3, 6, 7, 8, 9
Q2_K, Q3_K, Q4_K, Q5_K, Q6_K, Q8_K = 10, 11, 12, 13, 14, 15
BF16 = 30

QK = 32      # small-block size
QK_K = 256   # k-quant super-block size

TYPE_NAMES = {F32: "F32", F16: "F16", Q4_0: "Q4_0", Q4_1: "Q4_1",
              Q5_0: "Q5_0", Q5_1: "Q5_1", Q8_0: "Q8_0", Q2_K: "Q2_K",
              Q3_K: "Q3_K", Q4_K: "Q4_K", Q5_K: "Q5_K", Q6_K: "Q6_K",
              BF16: "BF16"}

BLOCK_SIZES = {  # (bytes per block, elements per block)
    F32: (4, 1), F16: (2, 1), BF16: (2, 1),
    Q4_0: (2 + 16, QK), Q4_1: (4 + 16, QK),
    Q5_0: (2 + 4 + 16, QK), Q5_1: (4 + 4 + 16, QK),
    Q8_0: (2 + 32, QK),
    Q2_K: (16 + 64 + 2 + 2, QK_K),
    Q3_K: (32 + 64 + 12 + 2, QK_K),
    Q4_K: (2 + 2 + 12 + 128, QK_K),
    Q5_K: (2 + 2 + 12 + 32 + 128, QK_K),
    Q6_K: (128 + 64 + 16 + 2, QK_K),
}


# ------------------------------------------------------------- dequantizers
# All take raw block bytes (n_blocks, block_bytes) uint8 -> (n_blocks, elems)
# float32.


def _f16(x: np.ndarray) -> np.ndarray:
    return x.view(np.float16).astype(np.float32)


def _deq_q8_0(blocks: np.ndarray) -> np.ndarray:
    d = _f16(blocks[:, :2].copy())
    q = blocks[:, 2:].view(np.int8).astype(np.float32)
    return d * q


def _deq_q4_0(blocks: np.ndarray) -> np.ndarray:
    d = _f16(blocks[:, :2].copy())
    qs = blocks[:, 2:]
    lo = (qs & 0x0F).astype(np.int8) - 8
    hi = (qs >> 4).astype(np.int8) - 8
    q = np.concatenate([lo, hi], axis=1).astype(np.float32)
    return d * q


def _deq_q4_1(blocks: np.ndarray) -> np.ndarray:
    d = _f16(blocks[:, :2].copy())
    m = _f16(blocks[:, 2:4].copy())
    qs = blocks[:, 4:]
    lo = (qs & 0x0F).astype(np.float32)
    hi = (qs >> 4).astype(np.float32)
    q = np.concatenate([lo, hi], axis=1)
    return d * q + m


def _unpack_qh(qh_bytes: np.ndarray) -> np.ndarray:
    """(n, 4) uint8 -> (n, 32) bits."""
    qh = qh_bytes.view(np.uint32).reshape(-1, 1)
    shifts = np.arange(32, dtype=np.uint32)
    return ((qh >> shifts) & 1).astype(np.uint8)


def _deq_q5_0(blocks: np.ndarray) -> np.ndarray:
    d = _f16(blocks[:, :2].copy())
    bits = _unpack_qh(blocks[:, 2:6].copy())
    qs = blocks[:, 6:]
    lo = (qs & 0x0F).astype(np.int16)
    hi = (qs >> 4).astype(np.int16)
    q = np.concatenate([lo | (bits[:, :16] << 4),
                        hi | (bits[:, 16:] << 4)], axis=1)
    return d * (q.astype(np.float32) - 16.0)


def _deq_q5_1(blocks: np.ndarray) -> np.ndarray:
    d = _f16(blocks[:, :2].copy())
    m = _f16(blocks[:, 2:4].copy())
    bits = _unpack_qh(blocks[:, 4:8].copy())
    qs = blocks[:, 8:]
    lo = (qs & 0x0F).astype(np.int16)
    hi = (qs >> 4).astype(np.int16)
    q = np.concatenate([lo | (bits[:, :16] << 4),
                        hi | (bits[:, 16:] << 4)], axis=1)
    return d * q.astype(np.float32) + m


def _unpack_k_scales(scales: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Q4_K/Q5_K 12-byte packed 6-bit scales/mins -> (n, 8), (n, 8)."""
    sc = np.empty((scales.shape[0], 8), np.float32)
    mn = np.empty((scales.shape[0], 8), np.float32)
    s = scales.astype(np.uint16)
    for j in range(8):
        if j < 4:
            sc[:, j] = (s[:, j] & 63).astype(np.float32)
            mn[:, j] = (s[:, j + 4] & 63).astype(np.float32)
        else:
            sc[:, j] = ((s[:, j + 4] & 0x0F) | ((s[:, j - 4] >> 6) << 4)
                        ).astype(np.float32)
            mn[:, j] = ((s[:, j + 4] >> 4) | ((s[:, j] >> 6) << 4)
                        ).astype(np.float32)
    return sc, mn


def _deq_q4_k(blocks: np.ndarray) -> np.ndarray:
    n = blocks.shape[0]
    d = _f16(blocks[:, :2].copy())
    dmin = _f16(blocks[:, 2:4].copy())
    sc, mn = _unpack_k_scales(blocks[:, 4:16])
    qs = blocks[:, 16:]  # (n, 128)
    # layout: 4 chunks of 32 bytes; each gives 64 values (lo 32, hi 32)
    qs = qs.reshape(n, 4, 32)
    lo = (qs & 0x0F).astype(np.float32)
    hi = (qs >> 4).astype(np.float32)
    vals = np.empty((n, 8, 32), np.float32)
    vals[:, 0::2] = lo
    vals[:, 1::2] = hi
    scale = d * sc  # (n, 8)
    minv = dmin * mn
    return (vals * scale[:, :, None] - minv[:, :, None]).reshape(n, QK_K)


def _deq_q5_k(blocks: np.ndarray) -> np.ndarray:
    n = blocks.shape[0]
    d = _f16(blocks[:, :2].copy())
    dmin = _f16(blocks[:, 2:4].copy())
    sc, mn = _unpack_k_scales(blocks[:, 4:16])
    qh = blocks[:, 16:48]   # (n, 32): bit j of byte -> group j
    qs = blocks[:, 48:176].reshape(n, 4, 32)
    lo = (qs & 0x0F).astype(np.float32)
    hi = (qs >> 4).astype(np.float32)
    vals = np.empty((n, 8, 32), np.float32)
    vals[:, 0::2] = lo
    vals[:, 1::2] = hi
    bits = np.stack([(qh >> j) & 1 for j in range(8)], axis=1)  # (n, 8, 32)
    vals += bits.astype(np.float32) * 16.0
    scale = d * sc
    minv = dmin * mn
    return (vals * scale[:, :, None] - minv[:, :, None]).reshape(n, QK_K)


def _deq_q6_k(blocks: np.ndarray) -> np.ndarray:
    n = blocks.shape[0]
    ql = blocks[:, :128]
    qh = blocks[:, 128:192]
    scales = blocks[:, 192:208].view(np.int8).astype(np.float32)  # (n, 16)
    d = _f16(blocks[:, 208:210].copy())
    # two 128-element halves; in each: ql 64 bytes, qh 32 bytes
    ql = ql.reshape(n, 2, 64)
    qh = qh.reshape(n, 2, 32)
    out = np.empty((n, 2, 128), np.float32)
    for half in range(2):
        l, h = ql[:, half], qh[:, half]
        q1 = (l[:, :32] & 0x0F) | (((h >> 0) & 3) << 4)
        q2 = (l[:, 32:] & 0x0F) | (((h >> 2) & 3) << 4)
        q3 = (l[:, :32] >> 4) | (((h >> 4) & 3) << 4)
        q4 = (l[:, 32:] >> 4) | (((h >> 6) & 3) << 4)
        out[:, half] = np.concatenate([q1, q2, q3, q4],
                                      axis=1).astype(np.float32) - 32.0
    vals = out.reshape(n, QK_K)
    # 16 scale groups of 16 elements
    scale = np.repeat(scales, 16, axis=1)
    return d * scale * vals


def _deq_q2_k(blocks: np.ndarray) -> np.ndarray:
    n = blocks.shape[0]
    scales = blocks[:, :16]
    qs = blocks[:, 16:80]
    d = _f16(blocks[:, 80:82].copy())
    dmin = _f16(blocks[:, 82:84].copy())
    sc = (scales & 0x0F).astype(np.float32)   # (n, 16)
    mn = (scales >> 4).astype(np.float32)
    # 2-bit values: qs (n, 64); each 32-byte chunk holds 128 values
    qs = qs.reshape(n, 2, 32)
    vals = np.empty((n, 16, 16), np.float32)
    idx = 0
    for half in range(2):
        for shift in range(4):
            v = ((qs[:, half] >> (2 * shift)) & 3).astype(np.float32)  # (n,32)
            vals[:, idx] = v[:, :16]
            vals[:, idx + 1] = v[:, 16:]
            idx += 2
    dd = d * sc    # (n, 16)
    mm = dmin * mn
    return (vals * dd[:, :, None] - mm[:, :, None]).reshape(n, QK_K)


def _deq_q3_k(blocks: np.ndarray) -> np.ndarray:
    n = blocks.shape[0]
    hmask = blocks[:, :32]
    qs = blocks[:, 32:96]
    scales_raw = blocks[:, 96:108]
    d = _f16(blocks[:, 108:110].copy())
    # unpack 16 6-bit scales from 12 bytes (llama.cpp layout)
    a = scales_raw[:, :8].astype(np.int16)
    b = scales_raw[:, 8:].astype(np.int16)
    sc = np.empty((n, 16), np.float32)
    for j in range(8):
        sc[:, j] = ((a[:, j] & 0x0F) | (((b[:, j % 4] >> (2 * (j // 4))) & 3) << 4)
                    ).astype(np.float32) - 32
    for j in range(8):
        sc[:, j + 8] = ((a[:, j] >> 4) | (((b[:, j % 4] >> (2 * (j // 4 + 2))) & 3) << 4)
                        ).astype(np.float32) - 32
    qs = qs.reshape(n, 2, 32)
    vals = np.empty((n, 16, 16), np.float32)
    idx = 0
    for half in range(2):
        for shift in range(4):
            v = ((qs[:, half] >> (2 * shift)) & 3).astype(np.int16)
            vals[:, idx] = v[:, :16]
            vals[:, idx + 1] = v[:, 16:]
            idx += 2
    # high bit: hmask bit j for value group j (128 values per bit plane)
    bits = np.stack([(hmask >> j) & 1 for j in range(8)], axis=1)  # (n,8,32)
    bits = bits.reshape(n, 16, 16)
    vals = vals - 4.0 * (1 - bits)
    return d * np.repeat(sc, 16, axis=1) * vals.reshape(n, QK_K)


_DEQUANT = {
    Q8_0: _deq_q8_0, Q4_0: _deq_q4_0, Q4_1: _deq_q4_1,
    Q5_0: _deq_q5_0, Q5_1: _deq_q5_1,
    Q4_K: _deq_q4_k, Q5_K: _deq_q5_k, Q6_K: _deq_q6_k,
    Q2_K: _deq_q2_k, Q3_K: _deq_q3_k,
}


def dequantize(data: np.ndarray, ggml_type: int, n_elements: int) -> np.ndarray:
    """Raw tensor bytes -> float32 flat array of n_elements."""
    if ggml_type == F32:
        return data.view(np.float32)[:n_elements].copy()
    if ggml_type == F16:
        return data.view(np.float16)[:n_elements].astype(np.float32)
    if ggml_type == BF16:
        u = data.view(np.uint16)[:n_elements].astype(np.uint32) << 16
        return u.view(np.float32).copy()
    block_bytes, block_elems = BLOCK_SIZES[ggml_type]
    n_blocks = n_elements // block_elems
    blocks = data[: n_blocks * block_bytes].reshape(n_blocks, block_bytes)
    return _DEQUANT[ggml_type](blocks).reshape(-1)[:n_elements]


# ------------------------------------------------------------------ parser

_KV_READERS = {}


def _read_str(f) -> str:
    (n,) = struct.unpack("<Q", f.read(8))
    return f.read(n).decode("utf-8", errors="replace")


def _read_value(f, vtype: int):
    simple = {0: "<B", 1: "<b", 2: "<H", 3: "<h", 4: "<I", 5: "<i",
              6: "<f", 7: "<?", 10: "<Q", 11: "<q", 12: "<d"}
    if vtype in simple:
        fmt = simple[vtype]
        return struct.unpack(fmt, f.read(struct.calcsize(fmt)))[0]
    if vtype == 8:
        return _read_str(f)
    if vtype == 9:  # array
        (elem_type,) = struct.unpack("<I", f.read(4))
        (count,) = struct.unpack("<Q", f.read(8))
        return [_read_value(f, elem_type) for _ in range(count)]
    raise ValueError(f"unknown gguf kv type {vtype}")


def read_gguf(path: str, keep_q8: bool = False, native_kquants: bool = False
              ) -> Tuple[Dict[str, np.ndarray], Dict[str, int], dict]:
    """Parse a GGUF file.

    Returns (tensors: name -> float32 ndarray in torch layout,
             qtypes: name -> ggml type id, metadata kv dict).

    With keep_q8=True, 2D Q8_0 tensors are returned quantized as
    {"q8": int8 (out, in), "scales": float32 (out, in/32)} for the fused
    dequant-matmul serving path (ops/quant_matmul.py); other quant formats
    are requantized to that layout.

    With native_kquants=True additionally, large 2D Q4_K/Q5_K tensors keep
    their native affine reconstruction {"qa": raw quants int8 (out, in),
    "s", "m": per-32-group scale/min (out, in/32)} — zero requantization
    error on top of the k-quant grid (served by quant_matmul_affine)."""
    tensors: Dict[str, np.ndarray] = {}
    qtypes: Dict[str, int] = {}
    with open(path, "rb") as f:
        if f.read(4) != GGUF_MAGIC:
            raise ValueError(f"not a GGUF file: {path}")
        (version,) = struct.unpack("<I", f.read(4))
        (n_tensors,) = struct.unpack("<Q", f.read(8))
        (n_kv,) = struct.unpack("<Q", f.read(8))
        meta = {}
        for _ in range(n_kv):
            key = _read_str(f)
            (vtype,) = struct.unpack("<I", f.read(4))
            meta[key] = _read_value(f, vtype)
        infos = []
        for _ in range(n_tensors):
            name = _read_str(f)
            (ndim,) = struct.unpack("<I", f.read(4))
            dims = struct.unpack(f"<{ndim}Q", f.read(8 * ndim))
            (ttype,) = struct.unpack("<I", f.read(4))
            (offset,) = struct.unpack("<Q", f.read(8))
            infos.append((name, dims, ttype, offset))
        alignment = meta.get("general.alignment", 32)
        data_start = f.tell()
        data_start += (alignment - data_start % alignment) % alignment

        for name, dims, ttype, offset in infos:
            n_elem = int(np.prod(dims))
            if ttype in (F32, F16, BF16):
                nbytes = n_elem * BLOCK_SIZES[ttype][0]
            else:
                bb, be = BLOCK_SIZES[ttype]
                nbytes = (n_elem // be) * bb
            f.seek(data_start + offset)
            raw = np.frombuffer(f.read(nbytes), dtype=np.uint8)
            qtypes[name] = ttype
            # ComfyUI-GGUF writers store >4D tensors flattened (GGUF caps
            # dims at 4) and record the true torch shape in metadata; the
            # reference recovers it the same way (model_loader.py:232-241).
            logical = meta.get(f"comfy.gguf.orig_shape.{name}")
            torch_shape = (tuple(int(v) for v in logical)
                           if logical else tuple(reversed(dims)))
            if int(np.prod(torch_shape)) != n_elem:
                raise ValueError(
                    f"{name}: comfy.gguf.orig_shape {torch_shape} does not "
                    f"match the stored element count {n_elem}")
            # Quantized serving layouts need a true 2D (out, in) matrix
            # whose LOGICAL `in` axis is block-aligned (blocks must not
            # straddle rows after the reshape); a tensor whose logical
            # shape isn't 2D (e.g. a flattened conv) or whose `in` isn't
            # block-aligned must dequantize dense instead. dims[0] (the
            # stored innermost axis) is WRONG for 1D-stored tensors with
            # orig_shape metadata — it would be the total element count.
            if keep_q8 and ttype == Q8_0 and len(torch_shape) == 2 \
                    and torch_shape[1] % QK == 0:
                blocks = raw.reshape(-1, 34)
                # the file's (out, in) order is the kernel's: q (N, K) int8,
                # f16 scales widened to fp32 (N, K/32)
                q = blocks[:, 2:].view(np.int8).reshape(torch_shape)
                scales = blocks[:, :2].copy().view(np.float16).astype(
                    np.float32).reshape(torch_shape[0], torch_shape[1] // QK)
                tensors[name] = {"q8": np.ascontiguousarray(q),
                                 "scales": scales}
                continue
            if native_kquants and ttype in (Q4_K, Q5_K) \
                    and len(torch_shape) == 2 \
                    and torch_shape[1] % QK_K == 0 \
                    and min(torch_shape) >= 1024:
                # native affine serving: w = s*q - m per 32-group (exactly
                # the reference reconstruction, no further requantization)
                blocks = raw.reshape(-1, BLOCK_SIZES[ttype][0])
                nb = blocks.shape[0]
                d = _f16(blocks[:, :2].copy())
                dmin = _f16(blocks[:, 2:4].copy())
                sc, mn = _unpack_k_scales(blocks[:, 4:16])
                if ttype == Q4_K:
                    qs = blocks[:, 16:].reshape(nb, 4, 32)
                    vals = np.empty((nb, 8, 32), np.int8)
                    vals[:, 0::2] = (qs & 0x0F).astype(np.int8)
                    vals[:, 1::2] = (qs >> 4).astype(np.int8)
                else:  # Q5_K: 4-bit low + 1 high bit per group
                    qh = blocks[:, 16:48]
                    qs = blocks[:, 48:176].reshape(nb, 4, 32)
                    vals16 = np.empty((nb, 8, 32), np.int16)
                    vals16[:, 0::2] = (qs & 0x0F).astype(np.int16)
                    vals16[:, 1::2] = (qs >> 4).astype(np.int16)
                    bits = np.stack([(qh >> j) & 1 for j in range(8)],
                                    axis=1).astype(np.int16)
                    vals = (vals16 + bits * 16).astype(np.int8)
                scale = (d * sc).astype(np.float32)   # (nb, 8)
                minv = (dmin * mn).astype(np.float32)
                N, K = torch_shape
                tensors[name] = {
                    "qa": np.ascontiguousarray(vals.reshape(N, K)),
                    "s": np.ascontiguousarray(scale.reshape(N, K // 32)),
                    "m": np.ascontiguousarray(minv.reshape(N, K // 32)),
                }
                continue
            flat = dequantize(raw, ttype, n_elem)
            # gguf dims are innermost-first; torch layout is the reverse
            # (or the recorded logical shape when the writer flattened)
            w = flat.reshape(torch_shape)
            if keep_q8 and ttype not in (F32, F16, BF16) \
                    and len(torch_shape) == 2 \
                    and dims[0] % QK == 0 and min(torch_shape) >= 1024:
                # K-quant formats (Q4_K_M etc.): requantize large linears to
                # the Q8_0 serving layout so the fused dequant-matmul kernel
                # applies and a 7B Q4_K_M checkpoint fits one chip's HBM
                # (bf16 expansion would be 13 GB). The q8 step on top of the
                # q4 grid adds ~0.1% rel error — far below the q4 error.
                k, n = torch_shape[1], torch_shape[0]
                g = w.reshape(n, k // QK, QK).astype(np.float32)
                scales = np.abs(g).max(axis=2) / 127.0
                inv = np.zeros_like(scales)
                np.divide(1.0, scales, out=inv, where=scales > 0)
                q = np.clip(np.round(g * inv[:, :, None]), -127,
                            127).astype(np.int8).reshape(n, k)
                tensors[name] = {"q8": q, "scales": scales}
                continue
            tensors[name] = w
    return tensors, qtypes, meta


def load_gguf_state_dict(path: str, keep_q8: bool = False,
                         native_kquants: bool = False,
                         handle_prefix: str = "model.diffusion_model."
                         ) -> Dict[str, np.ndarray]:
    """Tensors keyed for the model tree. ComfyUI-converted GGUF checkpoints
    (the published SeedVR2 Q4_K_M/Q8_0 files) prefix every tensor with
    `model.diffusion_model.`; when any tensor carries the prefix, it is
    stripped and unprefixed tensors are dropped — the same contract as the
    reference's _load_gguf_state (src/core/model_loader.py:160-190)."""
    tensors, _, _ = read_gguf(path, keep_q8=keep_q8,
                              native_kquants=native_kquants)
    if handle_prefix and any(k.startswith(handle_prefix) for k in tensors):
        n = len(handle_prefix)
        tensors = {k[n:]: v for k, v in tensors.items()
                   if k.startswith(handle_prefix)}
    return tensors
