// Host entry points of the Hopper attention kernels that K1 (packed window
// attention), K8 (dense flash attention) and K9 (windowed flash attention)
// share. Both are defined in packed_attention.cu; flash_attention.cu's
// K8 / K9 entry calls them.

#pragma once

#include <cuda_runtime.h>

namespace seedvr2 {

// One side (q or k) of the norm / rope pre-pass: `rows` rows a batch row of
// H heads of D bf16 values, row r of batch row b at src + (b * rows + r) *
// src_stride, head h at column h * D. dst is (B, rows, H, D) contiguous.
// cos / sin: (table_rows, D) fp32, or null for no rotation. With ids (B
// int32, K9's per-window tables), batch row b's table starts at cos +
// ids[b] * table_stride.
struct PrepassSide {
  const void* src;
  long long src_stride;
  const float* cos;
  const float* sin;
  void* dst;
  int rows;
  float mult;
  const int* ids;
  long long table_stride;
};

// Normalises (when `norm`) and ropes q and k once per (b, row, h), times
// each side's mult, rounded to bf16 (one launch for both sides). Rows at or
// past table_rows pass unrotated.
cudaError_t qk_prepass(int D, const PrepassSide& q, const PrepassSide& k,
                       int B, int H, int table_rows, bool norm, float eps,
                       cudaStream_t stream);

// out (B, Sq, H, D) = softmax2(q k^T * score_scale) v over the first kv_len
// keys, q (B, Sq, H, D), k and v (B, Sk, H, D) read in place at the given row
// strides (elements; head h at column h * D). Every pointer 16-byte aligned,
// every stride a multiple of 8, D in {64, 128}. With key_valid ((nU, Sk)
// bytes) and ids (B int32 < nU), batch row b's keys are those that row
// ids[b] of key_valid marks instead (kv_len unused), and key tiles that hold
// none of them are neither loaded nor multiplied. With lse ((B, H, S) fp32;
// Sq == Sk == S; K1's and K9's training launches), each row's log-sum-exp
// of its scores over its keys (exp2 domain) is written there too, by the
// kernel's LSE instantiation.
cudaError_t attention_sm90(const void* q, long long q_stride, const void* k,
                           long long k_stride, const void* v,
                           long long v_stride, void* out, int B, int Sq,
                           int Sk, int H, int D, int kv_len,
                           float score_scale, cudaStream_t stream,
                           const unsigned char* key_valid = nullptr,
                           const int* ids = nullptr, float* lse = nullptr);

}  // namespace seedvr2
