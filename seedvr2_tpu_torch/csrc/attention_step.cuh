// The Hopper attention step's tile products, shared by K1's forward
// (packed_attention.cu, also K8's and K9's step) and K1's backward
// (attention_backward.cu).
//
// A tile is 64 rows of D bf16 columns as TMA writes it: D / 64 panels of
// 64 rows x 128 bytes (boxes of 64 x 64, 128-byte swizzle), BOX_BYTES
// apart. Products are issued by one warpgroup on tiles in shared memory;
// their fp32 accumulators follow the wgmma m64nN layout: thread (warp w,
// lane = 4g + t) holds, for each 8-column block i, d[4i], d[4i+1] at row
// 16w + g, columns 8i + 2t, 8i + 2t + 1, and d[4i+2], d[4i+3] at row 16w +
// g + 8. Two adjacent blocks of a 64-column accumulator are then the
// register A fragment of one 16-deep step of a further product (pack_p).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90.cuh"

namespace seedvr2 {
namespace step {

using namespace seedvr2::sm90;

constexpr int BN = 64;   // rows of a tile (keys of a key tile)
constexpr int BOX = 64;  // rows and bf16 columns (128 bytes) of a box
constexpr uint32_t BOX_BYTES = BOX * BOX * 2;

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&p);
}

// Issues (and commits, without waiting) sc = A B^T for a 64-row tile A and
// N rows of a tile B (the forward's S = q k^T, N = 64; b_tile may start at
// a multiple of 8 rows): D/16 steps of 16 columns, a step 32 bytes into the
// 128-byte swizzled rows of one 64-column panel; both operands K-major.
template <int D, int N = BN>
__device__ __forceinline__ void issue_scores(float (&sc)[N / 2],
                                             uint32_t a_tile,
                                             uint32_t b_tile) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) sc[i] = 0.f;
  reg_fence(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
    wgmma_ss(sc, sw128_desc(a_tile + off, 16, 1024),
             sw128_desc(b_tile + off, 16, 1024), 1);
  }
  wgmma_commit();
}

// Issues (and commits) o += P B for a 64-row tile B (the forward's O += P
// v): P (64 x 64) as register A fragments, B MN-major; a 16-row step
// starts 16 rows (2048 bytes) further, B's D columns (N) are split in
// panels BOX_BYTES apart (leading byte offset), 8-row groups 1024 bytes
// apart (stride byte offset).
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[BN / 16][4],
                                         uint32_t b_tile) {
  reg_fence(o);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < BN / 16; ++ks) {
    const uint64_t db = sw128_desc(b_tile + ks * 16 * 128, BOX_BYTES, 1024);
    wgmma_rs<1>(o, pa[ks], db, 1);
  }
  wgmma_commit();
}

// K9's key tiles (the MASKED forward step and the MASKED dq kernel of its
// backward): stages a window's validity row `row` (Sk bytes, nonzero = a
// valid key) as one 64-bit word a 64-key tile into words[0 .. n) (n =
// ceil(Sk / 64); warp w takes tiles w, w + warps, ...: lane l's keys l
// and l + 32), then, behind a barrier, thread 0 lists the tiles whose
// word is not 0, in order: their words at words[n ..], their indices
// (int) after those, their count after the indices. Every thread of the
// block calls it; it ends with a barrier and returns the count, so the
// producer and the consumers walk one list and their mbarrier phases
// agree. words needs n * 20 + 4 bytes.
__device__ __forceinline__ int stage_live_tiles(uint64_t* words,
                                                const unsigned char* row,
                                                int Sk) {
  const int n = (Sk + BN - 1) / BN;
  const int lane = threadIdx.x % 32;
  for (int j = threadIdx.x / 32; j < n; j += blockDim.x / 32) {
    const int c = j * BN + lane;
    const uint32_t lo = __ballot_sync(0xffffffffu, c < Sk && row[c] != 0);
    const uint32_t hi =
        __ballot_sync(0xffffffffu, c + 32 < Sk && row[c + 32] != 0);
    if (lane == 0) words[j] = lo | (uint64_t(hi) << 32);
  }
  __syncthreads();
  uint64_t* live_words = words + n;
  int* live_tiles = reinterpret_cast<int*>(live_words + n);
  if (threadIdx.x == 0) {
    int m = 0;
    for (int j = 0; j < n; ++j)
      if (words[j] != 0) {
        live_words[m] = words[j];
        live_tiles[m++] = j;
      }
    live_tiles[n] = m;
  }
  __syncthreads();
  return live_tiles[n];
}

// A 64 x 64 accumulator rounded to bf16 as the register A fragments of
// four 16-deep steps.
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BN / 16][4],
                                       const float (&sc)[BN / 2]) {
#pragma unroll
  for (int ks = 0; ks < BN / 16; ++ks) {
    pa[ks][0] = pack_bf16(sc[8 * ks], sc[8 * ks + 1]);
    pa[ks][1] = pack_bf16(sc[8 * ks + 2], sc[8 * ks + 3]);
    pa[ks][2] = pack_bf16(sc[8 * ks + 4], sc[8 * ks + 5]);
    pa[ks][3] = pack_bf16(sc[8 * ks + 6], sc[8 * ks + 7]);
  }
}

}  // namespace step
}  // namespace seedvr2
