// Fused group-norm affine + SiLU + causal head for the VAE's
// SEEDVR2_FUSED_NORM=1 lane (kernel K12 of the port).
//
// Replaces: the Pallas TPU kernel `_ns_kernel` behind `norm_silu_head`
// (comfyui-seedvr2_tpu/ops/fused_norm.py).
//
// On an NCDHW bf16 activation x (B, C, T, H, W), with the group norm folded
// per (b, c, t) into A = inv_std * weight and Bc = bias - mean * A (computed
// beside it in plain torch, as the JAX package computes them in jnp), writes
// out (B, C, T + hp, H, W) with
//   y = bf16(x * A + Bc)   (rounded to the storage type before the SiLU, as
//                           the unfused norm -> SiLU composition does)
//   out[f] = bf16(y * sigmoid(y)) of input frame max(f - hp, 0),
// so the hp causal head frames repeat frame 0 and the concatenation that
// prepends them never materializes. Arithmetic in the plain version's order:
// __fmul_rn then __fadd_rn (no contraction), sigmoid as 1 / (1 + expf(-y)).
//
// What bounds it on an H100: memory. It reads x once and writes (T + hp) / T
// of it, a few flops a byte: the 720p clip's first encoder stage
// (128 x 5 x 720 x 1280) is 1.18 GB read + 1.65 GB written, 0.85 ms at
// 3.35 TB/s.
//
// Design: one block per 8192-element chunk of one (b, c, t) plane, 16-byte
// loads and stores (8 bf16 a thread a step) where the plane length H*W is a
// multiple of 8, scalar ones otherwise. A block of frame 0 writes its result
// to the hp + 1 output frames it feeds, so every input byte is read once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256, VEC = 8, ITEMS = 4;
constexpr long long CHUNK = (long long)THREADS * VEC * ITEMS;

__device__ __forceinline__ float norm_silu(float x, float a, float b) {
  float y = __fadd_rn(__fmul_rn(x, a), b);
  y = __bfloat162float(__float2bfloat16_rn(y));
  return __fmul_rn(y, __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-y))));
}

__global__ void __launch_bounds__(THREADS)
norm_silu_head_kernel(const __nv_bfloat16* __restrict__ x,
                      const float* __restrict__ A,
                      const float* __restrict__ Bc,
                      __nv_bfloat16* __restrict__ out, int T, long long HW,
                      int hp, long long chunks) {
  const long long plane = blockIdx.x / chunks;  // (b * C + c) * T + t
  const long long chunk = blockIdx.x % chunks;
  const int t = int(plane % T);
  const long long bc = plane / T;
  const float a = A[plane], b = Bc[plane];
  const __nv_bfloat16* src = x + plane * HW;
  __nv_bfloat16* dst = out + (bc * (T + hp) + (t == 0 ? 0 : t + hp)) * HW;
  const int nf = t == 0 ? hp + 1 : 1;
  const long long e0 = chunk * CHUNK;
  const long long e1 = e0 + CHUNK < HW ? e0 + CHUNK : HW;
  if (HW % VEC == 0) {
    for (long long e = e0 + threadIdx.x * VEC; e < e1; e += THREADS * VEC) {
      const uint4 v = *reinterpret_cast<const uint4*>(src + e);
      const __nv_bfloat162* in = reinterpret_cast<const __nv_bfloat162*>(&v);
      uint4 r;
      __nv_bfloat162* res = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
      for (int k = 0; k < VEC / 2; ++k) {
        const float2 f = __bfloat1622float2(in[k]);
        res[k] = __floats2bfloat162_rn(norm_silu(f.x, a, b),
                                       norm_silu(f.y, a, b));
      }
      for (int f = 0; f < nf; ++f)
        *reinterpret_cast<uint4*>(dst + f * HW + e) = r;
    }
  } else {
    for (long long e = e0 + threadIdx.x; e < e1; e += THREADS) {
      const __nv_bfloat16 r =
          __float2bfloat16_rn(norm_silu(__bfloat162float(src[e]), a, b));
      for (int f = 0; f < nf; ++f) dst[f * HW + e] = r;
    }
  }
}

}  // namespace

// x: (B, C, T, H, W) bf16, A and Bc: (B, C, T) fp32, out: (B, C, T + hp, H,
// W) bf16, all contiguous, x and out 16-byte aligned: checked by the Python
// wrapper (seedvr2_tpu_torch/ops/fused_norm.py).
extern "C" int seedvr2_norm_silu_head(const void* x, const void* A,
                                      const void* Bc, void* out, int B, int C,
                                      int T, long long HW, int hp,
                                      void* stream) {
  if (B == 0 || C == 0 || T == 0 || HW == 0) return int(cudaSuccess);
  const long long chunks = (HW + CHUNK - 1) / CHUNK;
  const long long blocks = (long long)B * C * T * chunks;
  if (blocks > 2147483647LL || hp < 0) return int(cudaErrorInvalidValue);
  norm_silu_head_kernel<<<unsigned(blocks), THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(A),
      static_cast<const float*>(Bc), static_cast<__nv_bfloat16*>(out), T, HW,
      hp, chunks);
  return int(cudaGetLastError());
}
