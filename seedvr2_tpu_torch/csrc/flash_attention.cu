// Dense and windowed flash attention (kernels K8 and K9 of the port).
//
// Replaces: the Pallas TPU kernels behind `flash_attention` (`_fa_kernel`,
// `_fa_rope_kernel`; K8) and `flash_windowed_attention`
// (`_fa_rope_mask_kernel`; K9) in comfyui-seedvr2_tpu/ops/flash_attention.py.
//
// Computes, per (batch row b, head h): q and k rotated by interleaved
// rotate-half RoPE from fp32 (S, D) tables, q scaled by scale*log2e, both
// rounded to bf16, then softmax(q k^T) v in the exp2 domain over the valid
// keys, rounded to bf16:
//  - K8, dense: one shared table (rows at or past its length pass through
//    unrotated) or none; key columns >= kv_len masked; Sq may differ from Sk
//    when there is no table.
//  - K9, windowed (the DiT's uniform window plan): window b's table and key
//    validity row are picked by ids[b] from (nU, S, D) tables and an (nU, S)
//    mask; Sq == Sk. A front-clipped shifted window puts its pad slots
//    first, so a row's first live key tile can begin with masked columns:
//    the running max is clamped at -1e30 and the sum divided as max(l,
//    1e-30), as the TPU kernel does.
// q (B, Sq, H, D), k and v (B, Sk, H, D) and out (B, Sq, H, D) are bf16 and
// contiguous, read in place (row stride H*D). S need not be a multiple of
// 64, so the TPU wrapper's pad to 512 rows has no counterpart here.
//
// What bounds them on an H100: at the uniform plan's windows (S = 405 video
// + 58 text = 463, D = 128) a (b, h) does 4*S*S*D flops against 4*S*D*2
// bytes of q, k, v and out, ~230 flop/byte, just under the ~295 flop/byte
// ridge, so the least time is set by bytes.
//
// Both run on the Hopper step K1 shares (packed_attention.cu; K8 0.16 ms at
// B=12 S=463 H=20 with a table on an H100 80GB HBM3, 700 W, about 2x
// SDPA, held by the pre-pass and per-block costs): with a table, the
// pre-pass ropes q and k once into a scratch the wrapper allocates (q times
// scale*log2e; K9's rows each by the table their id picks) and the step
// reads q-hat, k-hat and v by TMA; without one (K8 only), the step reads q
// and k as they are and scales the fp32 scores. K9's step stages its
// window's key validity row and walks only the key tiles that hold a valid
// key, so a tile of pad slots alone is never loaded or multiplied (K9 0.37
// ms at the 720p clip's shifted layer, 32 windows of S=463 H=20, on that
// card, 0.11 of it the pre-pass; SDPA 0.43 ms). The TMA's zero fill past a
// batch row's last row replaces zero rows written by hand, and its clipped
// stores keep rows past Sq unwritten. K9's training launch
// (`seedvr2_flash_attention_lse`) is the same call through the step's LSE
// instantiation, which also stores each row's log-sum-exp for K9's
// backward (attention_backward.cu).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_sm90.cuh"

// K8 when ids is null: cos/sin one (table_rows, D) fp32 table or null (then
// Sq may differ from Sk), keys < kv_len. K9 otherwise: cos/sin (nU, Sk, D)
// with table_rows == Sk, valid (nU, Sk) bytes, ids (B,) int32 < nU, Sq ==
// Sk, kv_len unused. With a table, scratch holds (2, B, S, H, D) bf16 for
// q-hat and k-hat. With lse ((B, H, S) fp32; K9's training launch), each
// row's log-sum-exp of its scores is stored too. Shapes, types, alignment
// and the ids' range are validated by the Python wrappers
// (seedvr2_tpu_torch/ops/flash_attention.py).
static int flash_attention(const void* q, const void* k, const void* v,
                           const void* cos, const void* sin,
                           const void* valid, const void* ids, void* scratch,
                           void* out, float* lse, int B, int Sq, int Sk, int H,
                           int D, int kv_len, int table_rows, float qscale,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || Sq == 0) return int(cudaSuccess);
  const long long hd = (long long)H * D;
  const int* id = static_cast<const int*>(ids);
  if (cos == nullptr) {
    if (id != nullptr || lse != nullptr) return int(cudaErrorInvalidValue);
    return int(seedvr2::attention_sm90(q, hd, k, hd, v, hd, out, B, Sq, Sk, H,
                                       D, kv_len, qscale, st));
  }
  __nv_bfloat16* q_hat = static_cast<__nv_bfloat16*>(scratch);
  __nv_bfloat16* k_hat = q_hat + (long long)B * Sq * hd;
  const float* c = static_cast<const float*>(cos);
  const float* s = static_cast<const float*>(sin);
  const long long t_stride = id != nullptr ? (long long)table_rows * D : 0;
  const seedvr2::PrepassSide qs{q, hd, c, s, q_hat, Sq, qscale, id, t_stride};
  const seedvr2::PrepassSide ks{k, hd, c, s, k_hat, Sk, 1.f, id, t_stride};
  cudaError_t err =
      seedvr2::qk_prepass(D, qs, ks, B, H, table_rows, false, 0.f, st);
  if (err != cudaSuccess) return int(err);
  return int(seedvr2::attention_sm90(
      q_hat, hd, k_hat, hd, v, hd, out, B, Sq, Sk, H, D, kv_len, 1.f, st,
      static_cast<const unsigned char*>(id != nullptr ? valid : nullptr), id,
      lse));
}

extern "C" int seedvr2_flash_attention(const void* q, const void* k,
                                       const void* v, const void* cos,
                                       const void* sin, const void* valid,
                                       const void* ids, void* scratch,
                                       void* out, int B, int Sq, int Sk,
                                       int H, int D, int kv_len,
                                       int table_rows, float qscale,
                                       void* stream) {
  return flash_attention(q, k, v, cos, sin, valid, ids, scratch, out, nullptr,
                         B, Sq, Sk, H, D, kv_len, table_rows, qscale, stream);
}

// K9's training launch: as seedvr2_flash_attention's K9 (every argument
// given, S = Sq = Sk), and each row's log-sum-exp (exp2 domain of the
// pre-pass output's scores, over the keys its window id marks) into lse
// ((B, H, S) fp32, every row written): the lse that the dq and dk/dv
// kernels of K9's backward (attention_backward.cu) read. Its output is
// bit-equal to the serving launch's.
extern "C" int seedvr2_flash_attention_lse(const void* q, const void* k,
                                           const void* v, const void* cos,
                                           const void* sin, const void* valid,
                                           const void* ids, void* scratch,
                                           void* out, void* lse, int B, int S,
                                           int H, int D, float qscale,
                                           void* stream) {
  if (cos == nullptr || sin == nullptr || valid == nullptr || ids == nullptr ||
      lse == nullptr)
    return int(cudaErrorInvalidValue);
  return flash_attention(q, k, v, cos, sin, valid, ids, scratch, out,
                         static_cast<float*>(lse), B, S, S, H, D, S, S, qscale,
                         stream);
}
