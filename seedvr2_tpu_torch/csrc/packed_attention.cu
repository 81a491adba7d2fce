// Packed window attention for NaDiT (kernel K1 of the port).
//
// Replaces: the Pallas TPU kernel `_fa_packed_kernel` behind
// `flash_packed_attention` (comfyui-seedvr2_tpu/ops/flash_attention.py).
//
// Computes, per (window row b, head h): fp32 RMS qk-norm over D, interleaved
// rotate-half RoPE from four (S, D) fp32 tables that already carry the
// qk-norm weights and the baked text rope, then softmax(q k^T * scale) v in
// the exp2 domain (scale*log2e folded into q), masking key columns >= kv_len.
// q, k and v are read in place from ONE packed (B, S, 3*H*D) bf16 operand at
// column offsets h*D, (H+h)*D and (2H+h)*D; the output is (B, S, H*D) bf16.
//
// What bounds it on an H100: at the 3B window sizes (S = 512..3712, D = 128)
// the work is 4*S*S*D flops per (b, h) against 2*S*D*3 bytes of input, far
// above the ~295 flop/byte ridge, so it is compute-bound: the tensor cores
// and the softmax's exp2/max/sum on the CUDA cores set the time.
//
// Design: one block of 4 warps per (64-row q tile, head, window row). Each
// warp owns 16 q rows end to end, flash-attention-2 style: its q fragments,
// score fragments, softmax statistics and fp32 output accumulator all stay
// in registers, and the products are bf16 `mma.sync.m16n8k16` with fp32
// accumulation, whose fragment layouts let a thread rescale exactly the two
// output rows it holds. Shared memory holds only the normalised q tile and
// one 64-row k tile and (transposed) v tile, about 52 KB for D = 128
// whatever S is (set through cudaFuncAttributeMaxDynamicSharedMemorySize);
// tiles wholly past kv_len are skipped, and the rows are padded by 8 so the
// fragment loads do not collide in shared-memory banks. A right, simple
// kernel first: no TMA, no wgmma, no software pipelining; those are for the
// PRs that make it fast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);  // p[0] low, p[1] high
}

// D(16x8, fp32) += A(16x16, bf16, row) * B(16x8, bf16, col). Per lane
// (g = lane / 4, t = lane % 4): a = {A[g][2t..], A[g+8][2t..], A[g][2t+8..],
// A[g+8][2t+8..]}, b = {B[2t..][g], B[2t+8..][g]}, d = {D[g][2t], D[g][2t+1],
// D[g+8][2t], D[g+8][2t+1]}.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp normalises and ropes one row of D values: lane l owns the D/32
// consecutive values starting at l*D/32, i.e. whole interleaved pairs.
// out = (x_n * cos + rot(x_n) * sin) * mult with x_n = x * rsqrt(mean(x^2) +
// eps) and rot(x)[2i] = -x[2i+1], rot(x)[2i+1] = x[2i].
template <int D>
__device__ __forceinline__ void norm_rope_row(
    const __nv_bfloat16* __restrict__ src, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, float eps, float mult,
    __nv_bfloat16* dst, int lane) {
  constexpr int EPL = D / 32;
  static_assert(EPL % 2 == 0, "each lane must own whole pairs");
  const int c0 = lane * EPL;
  float x[EPL];
  float ss = 0.f;
#pragma unroll
  for (int e = 0; e < EPL; ++e) {
    x[e] = __bfloat162float(src[c0 + e]);
    ss += x[e] * x[e];
  }
  ss = warp_sum(ss);
  const float inv = rsqrtf(ss / float(D) + eps);
#pragma unroll
  for (int e = 0; e < EPL; e += 2) {
    const float a = x[e] * inv;
    const float b = x[e + 1] * inv;
    const float ra = a * cos_t[c0 + e] - b * sin_t[c0 + e];
    const float rb = b * cos_t[c0 + e + 1] + a * sin_t[c0 + e + 1];
    dst[c0 + e] = __float2bfloat16(ra * mult);
    dst[c0 + e + 1] = __float2bfloat16(rb * mult);
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
packed_attention_kernel(const __nv_bfloat16* __restrict__ qkv,
                        const float* __restrict__ cos_q,
                        const float* __restrict__ sin_q,
                        const float* __restrict__ cos_k,
                        const float* __restrict__ sin_k,
                        __nv_bfloat16* __restrict__ out, int S, int H,
                        int kv_len, float eps, float qscale) {
  constexpr int QS = D + PAD;   // row stride of Qs and Ks
  constexpr int VS = BK + PAD;  // row stride of Vt
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + BQ * QS;
  __nv_bfloat16* Vt = Ks + BK * QS;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;    // fragment row group
  const int t = lane % 4;    // fragment column pair
  const int r0 = warp * 16;  // this warp's first row inside the tile
  const size_t row_stride = size_t(3) * H * D;
  const __nv_bfloat16* base = qkv + size_t(b) * S * row_stride;

  // q side: norm + rope + scale*log2e, staged as bf16, then held as A
  // fragments in registers for the whole key loop
  for (int r = r0; r < r0 + 16; ++r) {
    const size_t row = size_t(q0 + r);
    norm_rope_row<D>(base + row * row_stride + size_t(h) * D,
                     cos_q + row * D, sin_q + row * D, eps, qscale,
                     Qs + r * QS, lane);
  }
  __syncwarp();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* q_lo = Qs + (r0 + g) * QS + kk * 16 + 2 * t;
    const __nv_bfloat16* q_hi = q_lo + 8 * QS;
    qa[kk][0] = ld_pair(q_lo);
    qa[kk][1] = ld_pair(q_hi);
    qa[kk][2] = ld_pair(q_lo + 8);
    qa[kk][3] = ld_pair(q_hi + 8);
  }

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY;  // rows g and g + 8
  float l_lo = 0.f, l_hi = 0.f;

  const int n_tiles = (kv_len + BK - 1) / BK;  // tiles past kv_len skipped
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();  // every warp is done with the previous k/v tile
    for (int r = r0; r < r0 + 16; ++r) {
      const size_t row = size_t(k0 + r);
      norm_rope_row<D>(base + row * row_stride + size_t(H + h) * D,
                       cos_k + row * D, sin_k + row * D, eps, 1.f,
                       Ks + r * QS, lane);
    }
    // v: 16-byte loads along D, stored transposed; neighbouring threads take
    // neighbouring rows so the 2-byte shared stores do not share a bank
    for (int i = threadIdx.x; i < BK * D / 8; i += NTHREADS) {
      const int r = i % BK;
      const int c = (i / BK) * 8;
      const uint4 v = *reinterpret_cast<const uint4*>(
          base + size_t(k0 + r) * row_stride + size_t(2 * H + h) * D + c);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int x = 0; x < 8; ++x) Vt[(c + x) * VS + r] = e[x];
    }
    __syncthreads();

    // scores of this warp's 16 rows against the tile's 64 keys
    float s[BK / 8][4];
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

    // online softmax (exp2 domain) on the two rows this lane holds
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb) {
      const int col = k0 + nb * 8 + 2 * t;
      if (col >= kv_len) s[nb][0] = s[nb][2] = -INFINITY;
      if (col + 1 >= kv_len) s[nb][1] = s[nb][3] = -INFINITY;
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

    // O += P V: the score fragments of two adjacent 8-key blocks are the A
    // fragment of one 16-key step, rounded to bf16
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

  __nv_bfloat16* out_lo =
      out + (size_t(b) * S + q0 + r0 + g) * H * D + size_t(h) * D + 2 * t;
  __nv_bfloat16* out_hi = out_lo + size_t(8) * H * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(out_lo + j * 8) =
        __floats2bfloat162_rn(o[j][0] / l_lo, o[j][1] / l_lo);
    *reinterpret_cast<__nv_bfloat162*>(out_hi + j * 8) =
        __floats2bfloat162_rn(o[j][2] / l_hi, o[j][3] / l_hi);
  }
}

template <int D>
cudaError_t launch(const void* qkv, const void* cos_q, const void* sin_q,
                   const void* cos_k, const void* sin_k, void* out, int B,
                   int S, int H, int kv_len, float eps, float qscale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      packed_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(S / BQ, H, B);
  packed_attention_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const float*>(cos_q), static_cast<const float*>(sin_q),
      static_cast<const float*>(cos_k), static_cast<const float*>(sin_k),
      static_cast<__nv_bfloat16*>(out), S, H, kv_len, eps, qscale);
  return cudaGetLastError();
}

}  // namespace

// Shapes are validated by the Python wrapper
// (seedvr2_tpu_torch/ops/flash_attention.py): S % 64 == 0, 1 <= kv_len <= S,
// D in {64, 128}, contiguous bf16 qkv/out and fp32 (S, D) tables.
extern "C" int seedvr2_packed_attention(const void* qkv, const void* cos_q,
                                        const void* sin_q, const void* cos_k,
                                        const void* sin_k, void* out, int B,
                                        int S, int H, int D, int kv_len,
                                        float eps, float qscale,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 128) {
    err = launch<128>(qkv, cos_q, sin_q, cos_k, sin_k, out, B, S, H, kv_len,
                      eps, qscale, st);
  } else if (D == 64) {
    err = launch<64>(qkv, cos_q, sin_q, cos_k, sin_k, out, B, S, H, kv_len,
                     eps, qscale, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return int(err);
}
