// Fused group-norm affine + SiLU + causal head for the VAE's
// SEEDVR2_FUSED_NORM=1 lane (kernel K12 of the port): two kernels, the
// group moments and the fused apply pass.
//
// Replaces: the Pallas TPU kernel `_ns_kernel` behind `norm_silu_head`
// (comfyui-seedvr2_tpu/ops/fused_norm.py), and the jnp moments in front of
// it.
//
// On an NCDHW bf16 activation x (B, C, T, H, W) with G groups:
//  1. k12_moments: the fp32 sums S and S2 of x and x^2 over each (b, t,
//     group) (C/G planes of H*W values), folded with the norm's weight w
//     and bias b into A = inv * w and Bc = b - (mean * inv) * w per
//     (b, c, t), mean = S / n, inv = rsqrt(max(S2 / n - mean^2, 0) + eps).
//  2. k12_apply: out (B, C, T + hp, H, W) with
//       y = bf16(x * A + Bc)   (rounded to the storage type before the
//                               SiLU, as the unfused composition does)
//       out[f] = bf16(y * sigmoid(y)) of input frame max(f - hp, 0),
//     so the hp causal head frames repeat frame 0 and the concatenation
//     that prepends them never materializes. Arithmetic in the plain
//     version's order: __fmul_rn then __fadd_rn (no contraction), sigmoid
//     as 1 / (1 + expf(-y)), the reciprocal correctly rounded.
//
// What bounds it on an H100: memory. The function reads x once and writes
// (T + hp) / T of it, a few flops a byte: the 720p clip's first encoder
// stage (128 x 5 x 720 x 1280) is 1.18 GB read + 1.65 GB written, 0.85 ms
// at 3.35 TB/s; the two kernels read x twice, 1.20 ms.
//
// Design. Both kernels: 256 threads, 16-byte loads (8 bf16 a thread) where
// H*W is a multiple of 8, scalar ones otherwise; a block walks one piece of
// one plane (the Python wrapper's plan, `plan_k12` in
// seedvr2_tpu_torch/ops/fused_norm.py, sizes the pieces: 64 KB of x for the
// moments, 16 KB for the apply pass).
//  - k12_moments: one block a piece, grid (b, t, group, channel, piece),
//    each thread issuing eight 16-byte loads before it uses any. A block
//    writes one partial (S, S2); the last block of its (b, t, group) to
//    finish (a __threadfence and a counter ticket) sums the group's
//    partials in piece order, with a fixed tree, so the result does not
//    depend on which block came last and a rerun is bit-identical (no float
//    atomics), then writes A and Bc of the group's channels and returns the
//    counter to 0 for the next launch. It replaces about 15 torch launches
//    that read x three times, two thirds of the earlier design's time.
//  - k12_apply: one 16-byte load a thread a step; a block of frame 0 writes
//    its result to the hp + 1 output frames it feeds, so x is read once.
//    This is the earlier design's pass, which already ran near the H100's
//    read + write rate: four or eight loads in flight a thread, and
//    frame-0 pieces cut shorter to even the stores, measured slower at
//    every shape (more registers, fewer resident warps).
//    Where x fits the 50 MB L2 (the decoder's low-resolution stages), the
//    apply pass reads it from there after the moments.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256, VEC = 8, UNROLL = 8;
constexpr int STEP = THREADS * VEC * UNROLL;  // values a moments block step

__device__ __forceinline__ float norm_silu(float x, float a, float b) {
  float y = __fadd_rn(__fmul_rn(x, a), b);
  y = __bfloat162float(__float2bfloat16_rn(y));
  // __frcp_rn is IEEE 1 / v, the same bits as the division, fewer steps
  return __fmul_rn(y, __frcp_rn(__fadd_rn(1.0f, expf(-y))));
}

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[VEC]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// Sum of (s, ss) over the block, in a fixed tree; the result in thread 0.
__device__ __forceinline__ float2 block_sum2(float s, float ss,
                                             float2* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = make_float2(s, ss);
  __syncthreads();
  float2 v = make_float2(0.f, 0.f);
  if (warp == 0) {
    if (lane < THREADS / 32) v = red[lane];
#pragma unroll
    for (int off = THREADS / 64; off > 0; off >>= 1) {
      v.x += __shfl_xor_sync(0xffffffffu, v.x, off);
      v.y += __shfl_xor_sync(0xffffffffu, v.y, off);
    }
  }
  return v;
}

template <bool VECTOR>
__global__ void __launch_bounds__(THREADS)
k12_moments_kernel(const __nv_bfloat16* __restrict__ x,
                   const void* __restrict__ weight,
                   const void* __restrict__ bias, int wb_bf16,
                   float2* __restrict__ part, unsigned* __restrict__ count,
                   float* __restrict__ A, float* __restrict__ Bc, int C, int T,
                   int G, long long HW, int pieces, long long piece,
                   float eps) {
  __shared__ float2 red[THREADS / 32];
  __shared__ float2 total;
  __shared__ bool last;
  const int cg = C / G, parts = cg * pieces;
  const unsigned gi = blockIdx.x / parts;  // (b * T + t) * G + g
  const int p = blockIdx.x % parts;        // channel * pieces + piece
  const int g = gi % G, t = (gi / G) % T;
  const long long b = gi / G / T;
  const int c = g * cg + p / pieces;
  const __nv_bfloat16* src = x + ((b * C + c) * T + t) * HW;
  const long long e0 = (p % pieces) * piece;
  const long long e1 = e0 + piece < HW ? e0 + piece : HW;

  float s = 0.f, ss = 0.f;
  if (VECTOR) {
    for (long long base = e0 + threadIdx.x * VEC; base < e1; base += STEP) {
      uint4 v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long e = base + u * THREADS * VEC;
        v[u] = e < e1 ? __ldg(reinterpret_cast<const uint4*>(src + e))
                      : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        float f[VEC], q[VEC];
        unpack8(v[u], f);
#pragma unroll
        for (int i = 0; i < VEC; ++i) q[i] = f[i] * f[i];
        // pairwise within the 8 values, then into the running sums
        s += ((f[0] + f[1]) + (f[2] + f[3])) +
             ((f[4] + f[5]) + (f[6] + f[7]));
        ss += ((q[0] + q[1]) + (q[2] + q[3])) +
              ((q[4] + q[5]) + (q[6] + q[7]));
      }
    }
  } else {
    for (long long e = e0 + threadIdx.x; e < e1; e += THREADS) {
      const float f = __bfloat162float(src[e]);
      s += f;
      ss = fmaf(f, f, ss);
    }
  }
  const float2 mine = block_sum2(s, ss, red);
  if (threadIdx.x == 0) {
    part[blockIdx.x] = mine;
    __threadfence();  // the partial is visible before the ticket is taken
    last = atomicAdd(&count[gi], 1u) == unsigned(parts - 1);
  }
  __syncthreads();
  if (!last) return;

  // The group's last block: its partials in piece order, a fixed tree.
  __threadfence();
  const float2* gp = part + (long long)gi * parts;
  float2 acc = make_float2(0.f, 0.f);
  for (int i = threadIdx.x; i < parts; i += THREADS) {
    const float2 v = __ldcg(gp + i);
    acc.x += v.x;
    acc.y += v.y;
  }
  const float2 sum = block_sum2(acc.x, acc.y, red);
  if (threadIdx.x == 0) {
    total = sum;
    count[gi] = 0u;  // ready for the next launch on this stream
  }
  __syncthreads();
  if (threadIdx.x >= cg) return;
  const float n = float((long long)cg * HW);
  const float mean = __fdiv_rn(total.x, n);
  const float var = fmaxf(
      __fsub_rn(__fdiv_rn(total.y, n), __fmul_rn(mean, mean)), 0.f);
  const float inv = rsqrtf(__fadd_rn(var, eps));
  const int ch = g * cg + threadIdx.x;
  float w, bb;
  if (wb_bf16) {
    w = __bfloat162float(static_cast<const __nv_bfloat16*>(weight)[ch]);
    bb = __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[ch]);
  } else {
    w = static_cast<const float*>(weight)[ch];
    bb = static_cast<const float*>(bias)[ch];
  }
  const long long at = (b * C + ch) * T + t;
  A[at] = __fmul_rn(inv, w);
  Bc[at] = __fsub_rn(bb, __fmul_rn(__fmul_rn(mean, inv), w));
}

__global__ void __launch_bounds__(THREADS)
k12_apply_kernel(const __nv_bfloat16* __restrict__ x,
                 const float* __restrict__ A, const float* __restrict__ Bc,
                 __nv_bfloat16* __restrict__ out, int T, long long HW, int hp,
                 int pieces, long long piece) {
  const long long plane = blockIdx.x / pieces;  // (b * C + c) * T + t
  const long long e0 = (blockIdx.x % pieces) * piece;
  const long long e1 = e0 + piece < HW ? e0 + piece : HW;
  const int t = int(plane % T);
  const float a = A[plane], bc = Bc[plane];
  const __nv_bfloat16* src = x + plane * HW;
  __nv_bfloat16* dst = out + ((plane / T) * (T + hp) + (t ? t + hp : 0)) * HW;
  const int nf = t ? 1 : hp + 1;
  if (HW % VEC == 0) {
    for (long long e = e0 + threadIdx.x * VEC; e < e1; e += THREADS * VEC) {
      const uint4 v = *reinterpret_cast<const uint4*>(src + e);
      float f[VEC];
      unpack8(v, f);
      uint4 r;
      __nv_bfloat162* res = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
      for (int k = 0; k < VEC / 2; ++k)
        res[k] = __floats2bfloat162_rn(norm_silu(f[2 * k], a, bc),
                                       norm_silu(f[2 * k + 1], a, bc));
      for (int i = 0; i < nf; ++i)
        *reinterpret_cast<uint4*>(dst + i * HW + e) = r;
    }
  } else {
    for (long long e = e0 + threadIdx.x; e < e1; e += THREADS) {
      const __nv_bfloat16 y =
          __float2bfloat16_rn(norm_silu(__bfloat162float(src[e]), a, bc));
      for (int i = 0; i < nf; ++i) dst[i * HW + e] = y;
    }
  }
}

}  // namespace

// x: (B, C, T, H, W) bf16; weight, bias: (C,) fp32 or bf16 (wb_bf16);
// part: B*T*G*parts float pairs (parts = C/G * pieces); count: B*T*G
// unsigned, 0 on entry and left 0; A, Bc: (B, C, T) fp32. Contiguous, x
// 16-byte aligned, piece a multiple of 8, pieces * piece >= H*W: checked
// by the Python wrapper (seedvr2_tpu_torch/ops/fused_norm.py).
extern "C" int seedvr2_k12_moments(const void* x, const void* weight,
                                   const void* bias, int wb_bf16, void* part,
                                   void* count, void* A, void* Bc, int B,
                                   int C, int T, int G, long long HW,
                                   int pieces, long long piece, float eps,
                                   void* stream) {
  if (B == 0 || C == 0 || T == 0 || HW == 0) return int(cudaSuccess);
  if (G <= 0 || C % G || C / G > THREADS || pieces <= 0 || piece % VEC)
    return int(cudaErrorInvalidValue);
  const long long blocks = (long long)B * T * C * pieces;
  if (blocks > 2147483647LL) return int(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto* xp = static_cast<const __nv_bfloat16*>(x);
  auto* pp = static_cast<float2*>(part);
  auto* cp = static_cast<unsigned*>(count);
  auto* ap = static_cast<float*>(A);
  auto* bp = static_cast<float*>(Bc);
  if (HW % VEC == 0)
    k12_moments_kernel<true><<<unsigned(blocks), THREADS, 0, s>>>(
        xp, weight, bias, wb_bf16, pp, cp, ap, bp, C, T, G, HW, pieces, piece,
        eps);
  else
    k12_moments_kernel<false><<<unsigned(blocks), THREADS, 0, s>>>(
        xp, weight, bias, wb_bf16, pp, cp, ap, bp, C, T, G, HW, pieces, piece,
        eps);
  return int(cudaGetLastError());
}

// x: (B, C, T, H, W) bf16, A and Bc: (B, C, T) fp32, out: (B, C, T + hp, H,
// W) bf16, all contiguous, x and out 16-byte aligned; every plane in
// `pieces` pieces of `piece` values (a multiple of 8): checked by the
// Python wrapper.
extern "C" int seedvr2_k12_apply(const void* x, const void* A, const void* Bc,
                                 void* out, int B, int C, int T, long long HW,
                                 int hp, int pieces, long long piece,
                                 void* stream) {
  if (B == 0 || C == 0 || T == 0 || HW == 0) return int(cudaSuccess);
  if (hp < 0 || pieces <= 0 || piece % VEC) return int(cudaErrorInvalidValue);
  const long long blocks = (long long)B * C * T * pieces;
  if (blocks > 2147483647LL) return int(cudaErrorInvalidValue);
  k12_apply_kernel<<<unsigned(blocks), THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(A),
      static_cast<const float*>(Bc), static_cast<__nv_bfloat16*>(out), T, HW,
      hp, pieces, piece);
  return int(cudaGetLastError());
}
