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
// fragment loads do not collide in shared-memory banks. The score, softmax
// and P V step is `flash::Rows` (flash_tile.cuh), shared with K8 and K9;
// what is K1's own is the qk-norm + rope staging. A right, simple
// kernel first: no TMA, no wgmma, no software pipelining; those are for the
// PRs that make it fast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_tile.cuh"

namespace {

using namespace flash;

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
  Rows<D> rows;
  rows.begin(Qs, r0, g, t);

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
    load_v_tile<D>(base + size_t(k0) * row_stride + size_t(2 * H + h) * D,
                   row_stride, BK, Vt);
    __syncthreads();

    float s[BK / 8][4];
    rows.scores(s, Ks, g, t);
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb) {
      const int col = k0 + nb * 8 + 2 * t;
      if (col >= kv_len) s[nb][0] = s[nb][2] = -INFINITY;
      if (col + 1 >= kv_len) s[nb][1] = s[nb][3] = -INFINITY;
    }
    rows.update(s, Vt, g, t);
  }

  const int lo = q0 + r0 + g;
  rows.store(out + (size_t(b) * S + lo) * H * D + size_t(h) * D + 2 * t,
             size_t(H) * D, lo, S);
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
