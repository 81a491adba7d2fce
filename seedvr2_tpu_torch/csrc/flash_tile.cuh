// The flash-attention-2 tile step of K9 (windowed attention,
// flash_attention.cu). It served K1 and K8 too until their Hopper redesign
// (packed_attention.cu); it serves K9 alone until K9 moves onto that step.
//
// A block of 4 warps owns 64 query rows; each warp owns 16 of them end to
// end. Its q rows are bf16 A fragments in registers, the scores of one
// 64-key tile and the fp32 output accumulator are `mma.sync.m16n8k16`
// fragments in registers, and the softmax runs in the exp2 domain (the
// caller folds scale*log2e into q). Shared memory holds the q tile, one k
// tile and the transposed v tile; rows are padded by 8 bf16 so that the
// fragment loads fall in distinct banks.
//
// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4): a lane holds
// the score / output columns 2t and 2t + 1 of rows g and g + 8.

#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace flash {

constexpr int BQ = 64;       // q rows per block
constexpr int BK = 64;       // k rows per tile
constexpr int NWARPS = BQ / 16;
constexpr int NTHREADS = NWARPS * 32;
constexpr int PAD = 8;       // bf16 elements of row padding (bank spread)

template <int D>
constexpr size_t smem_bytes() {
  return size_t(BQ) * (D + PAD) * 2      // Qs: q tile, row-major
         + size_t(BK) * (D + PAD) * 2    // Ks: k tile, row-major
         + size_t(D) * (BK + PAD) * 2;   // Vt: v tile, transposed (D x BK)
}

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

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);  // p[0] low, p[1] high
}

// D(16x8, fp32) += A(16x16, bf16, row) * B(16x8, bf16, col). Per lane:
// a = {A[g][2t..], A[g+8][2t..], A[g][2t+8..], A[g+8][2t+8..]},
// b = {B[2t..][g], B[2t+8..][g]}, d = {D[g][2t], D[g][2t+1], D[g+8][2t],
// D[g+8][2t+1]}.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy one 64-row v tile into the transposed Vt (D x (BK + PAD)): 16-byte
// loads along D, neighbouring threads on neighbouring rows so the 2-byte
// shared stores do not share a bank. Rows at or past `rows` are zero (their
// probabilities are 0, and 0 * garbage could be NaN).
template <int D>
__device__ __forceinline__ void load_v_tile(const __nv_bfloat16* __restrict__ v0,
                                            size_t row_stride, int rows,
                                            __nv_bfloat16* Vt) {
  constexpr int VS = BK + PAD;
  for (int i = threadIdx.x; i < BK * D / 8; i += NTHREADS) {
    const int r = i % BK;
    const int c = (i / BK) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows)
      val = *reinterpret_cast<const uint4*>(v0 + size_t(r) * row_stride + c);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
    for (int x = 0; x < 8; ++x) Vt[(c + x) * VS + r] = e[x];
  }
}

// A warp's online-softmax state: the bf16 q fragments of its 16 rows, the
// fp32 output accumulator and the running max / sum of rows g and g + 8.
template <int D>
struct Rows {
  uint32_t qa[D / 16][4];
  float o[D / 8][4];
  float m_lo, m_hi, l_lo, l_hi;

  // Take the warp's 16 rows of the staged Qs tile as A fragments, and reset
  // the softmax state.
  __device__ __forceinline__ void begin(const __nv_bfloat16* Qs, int r0, int g,
                                        int t) {
    constexpr int QS = D + PAD;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const __nv_bfloat16* q_lo = Qs + (r0 + g) * QS + kk * 16 + 2 * t;
      const __nv_bfloat16* q_hi = q_lo + 8 * QS;
      qa[kk][0] = ld_pair(q_lo);
      qa[kk][1] = ld_pair(q_hi);
      qa[kk][2] = ld_pair(q_lo + 8);
      qa[kk][3] = ld_pair(q_hi + 8);
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    m_lo = m_hi = -INFINITY;
    l_lo = l_hi = 0.f;
  }

  // Scores of the warp's rows against the 64 keys of the staged Ks tile.
  __device__ __forceinline__ void scores(float (&s)[BK / 8][4],
                                         const __nv_bfloat16* Ks, int g,
                                         int t) const {
    constexpr int QS = D + PAD;
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb)
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nb = 0; nb < BK / 8; ++nb) {
        const __nv_bfloat16* kp = Ks + (nb * 8 + g) * QS + kk * 16 + 2 * t;
        mma_bf16(s[nb], qa[kk], ld_pair(kp), ld_pair(kp + 8));
      }
    }
  }

  // Fold one tile of (already masked, -inf) scores into the state: the
  // running max is clamped at -1e30 so that a tile, or a row's first tiles,
  // with no valid key at all leave exp2(-inf - m) = 0 and no NaN; then
  // O += P V with the probabilities rounded to bf16.
  __device__ __forceinline__ void update(float (&s)[BK / 8][4],
                                         const __nv_bfloat16* Vt, int g,
                                         int t) {
    constexpr int VS = BK + PAD;
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb) {
      mx_lo = fmaxf(mx_lo, fmaxf(s[nb][0], s[nb][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[nb][2], s[nb][3]));
    }
    const float mn_lo = fmaxf(fmaxf(m_lo, quad_max(mx_lo)), -1e30f);
    const float mn_hi = fmaxf(fmaxf(m_hi, quad_max(mx_hi)), -1e30f);
    const float corr_lo = exp2f(m_lo - mn_lo);
    const float corr_hi = exp2f(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb) {
      s[nb][0] = exp2f(s[nb][0] - mn_lo);
      s[nb][1] = exp2f(s[nb][1] - mn_lo);
      s[nb][2] = exp2f(s[nb][2] - mn_hi);
      s[nb][3] = exp2f(s[nb][3] - mn_hi);
      sum_lo += s[nb][0] + s[nb][1];
      sum_hi += s[nb][2] + s[nb][3];
    }
    l_lo = l_lo * corr_lo + quad_sum(sum_lo);
    l_hi = l_hi * corr_hi + quad_sum(sum_hi);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= corr_lo;
      o[j][1] *= corr_lo;
      o[j][2] *= corr_hi;
      o[j][3] *= corr_hi;
    }
    // the score fragments of two adjacent 8-key blocks are the A fragment of
    // one 16-key step
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const uint32_t pa[4] = {pack_bf16(s[2 * ks][0], s[2 * ks][1]),
                              pack_bf16(s[2 * ks][2], s[2 * ks][3]),
                              pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]),
                              pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3])};
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const __nv_bfloat16* vp = Vt + (j * 8 + g) * VS + ks * 16 + 2 * t;
        mma_bf16(o[j], pa, ld_pair(vp), ld_pair(vp + 8));
      }
    }
  }

  // out = O / max(l, 1e-30) for rows g and g + 8, as bf16 pairs; out_lo
  // points at row g's column 2t, `stride` elements between rows. Rows whose
  // index (lo + 8 for the high one) is not below `rows` are not written.
  __device__ __forceinline__ void store(__nv_bfloat16* out_lo, size_t stride,
                                        int lo, int rows) const {
    const float d_lo = fmaxf(l_lo, 1e-30f);
    const float d_hi = fmaxf(l_hi, 1e-30f);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (lo < rows)
        *reinterpret_cast<__nv_bfloat162*>(out_lo + j * 8) =
            __floats2bfloat162_rn(o[j][0] / d_lo, o[j][1] / d_lo);
      if (lo + 8 < rows)
        *reinterpret_cast<__nv_bfloat162*>(out_lo + 8 * stride + j * 8) =
            __floats2bfloat162_rn(o[j][2] / d_hi, o[j][3] / d_hi);
    }
  }
};

}  // namespace flash
