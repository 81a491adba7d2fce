// Fused producer + per-row int8 quantization for the w8a8 lane (kernels K4
// and K5 of the port).
//
// Replaces: the Pallas TPU kernels `_rms_ada_q_kernel` behind
// `rms_ada_quantize` (K4) and `_silu_mul_q_kernel` behind
// `silu_mul_quantize` (K5), comfyui-seedvr2_tpu/ops/fused_quant.py.
//
// Computes, per row of K values, in fp32:
//   K4: y = (x * rsqrt(mean(x^2) + eps)) * scale[b] + shift[b]
//   K5: y = silu(g) * u
// then sc = max(absmax(y), 1e-8) / 127 and q = clamp(rint(y / sc), -127, 127)
// (round half to even, as jnp.round and torch.round), writing q int8 and sc
// fp32 for the int8 GEMM (K3) to consume.
//
// What bounds it on an H100: memory. K4 at M = 7200 rows of K = 2560 reads
// 36.9 MB of bf16 and writes 18.4 MB of int8 (about 0.0165 ms at 3.35 TB/s);
// K5 at K = 6912 reads 199 MB and writes 50 MB (about 0.074 ms). A handful
// of flops per byte is far below the ridge.
//
// Design: one block per row (128 threads for K4's 2560-wide rows, 256 for
// K5's 6912: 16 and 8 resident blocks an SM, to hide the load latency of
// these short rows). The row is read once from device memory with 16-byte
// loads (8 bf16 a thread a step; scale and shift as float4), its fp32 values
// are kept in shared memory (K * 4 bytes: 10 KB for K4, 27 KB for K5) laid
// out value-major so that a warp's accesses fall in distinct banks, and each
// thread revisits only the values it loaded, so the two block reductions
// (sum of squares, absmax) are the only barriers. q leaves as 8-byte stores. K5 reads
// g and u in place as the two halves of the gate+up product, with a row
// stride. Numerics kept as the plain version's: IEEE division (no fast math,
// no reciprocal multiply), rintf, and the producer math in __fmul_rn /
// __fadd_rn so that nvcc does not contract it into FMAs. Left different: the
// order of the row sums and rsqrtf, which can move a value across a .5
// rounding boundary, so q may differ from the plain version by 1 in a small
// share of entries.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int K4_THREADS = 128;
constexpr int K5_THREADS = 256;
constexpr int VEC = 8;  // bf16 values per 16-byte load

// Value i of a thread's chunk c lives at y[i * nchunks + c]: consecutive
// threads touch consecutive words.
__device__ __forceinline__ int slot(int c, int i, int nchunks) {
  return i * nchunks + c;
}

template <int THREADS>
__device__ __forceinline__ float block_reduce(float v, float* red,
                                             bool take_max) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = take_max ? fmaxf(v, o) : v + o;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // red may still be read by a previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < THREADS / 32 ? red[lane] : 0.f;  // 0: identity of both (|y| >= 0)
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = take_max ? fmaxf(v, o) : v + o;
  }
  return v;  // every thread holds the block's result
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[VEC]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// Quantize the row held in y (this thread's chunks) and store q and sc.
template <int THREADS>
__device__ __forceinline__ void quantize_store(const float* y, int K,
                                               float amax, int8_t* q,
                                               float* s) {
  const float sc = fmaxf(amax, 1e-8f) / 127.0f;
  const int nchunks = K / VEC;
  for (int c = threadIdx.x; c < nchunks; c += THREADS) {
    uint32_t packed[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float r =
          fminf(fmaxf(rintf(y[slot(c, i, nchunks)] / sc), -127.f), 127.f);
      packed[i / 4] |= (uint32_t(int(r)) & 0xffu) << (8 * (i % 4));
    }
    *reinterpret_cast<uint2*>(q + (long long)c * VEC) =
        make_uint2(packed[0], packed[1]);
  }
  if (threadIdx.x == 0) *s = sc;
}

// 8 consecutive fp32 values as two float4 loads (p 16-byte aligned).
__device__ __forceinline__ void load8f(const float* p, float (&f)[VEC]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__global__ void __launch_bounds__(K4_THREADS)
rms_ada_quantize_kernel(const __nv_bfloat16* __restrict__ x,
                        const float* __restrict__ scale,
                        const float* __restrict__ shift,
                        int8_t* __restrict__ q, float* __restrict__ s, int L,
                        int K, float eps) {
  constexpr int THREADS = K4_THREADS;
  extern __shared__ float y[];  // K fp32 values of this row
  __shared__ float red[THREADS / 32];
  const long long row = blockIdx.x;
  const long long b = row / L;
  const __nv_bfloat16* xr = x + row * K;
  const float* sc_b = scale + b * K;
  const float* sh_b = shift + b * K;
  const int nchunks = K / VEC;

  float ss = 0.f;
  for (int c = threadIdx.x; c < nchunks; c += THREADS) {
    float f[VEC];
    load8(xr + c * VEC, f);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      y[slot(c, i, nchunks)] = f[i];
      ss = __fadd_rn(ss, __fmul_rn(f[i], f[i]));
    }
  }
  ss = block_reduce<THREADS>(ss, red, false);
  const float inv = rsqrtf(__fadd_rn(ss / float(K), eps));

  float amax = 0.f;
  for (int c = threadIdx.x; c < nchunks; c += THREADS) {
    float sc[VEC], sh[VEC];
    load8f(sc_b + c * VEC, sc);
    load8f(sh_b + c * VEC, sh);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float& yk = y[slot(c, i, nchunks)];
      const float v = __fadd_rn(__fmul_rn(__fmul_rn(yk, inv), sc[i]), sh[i]);
      yk = v;
      amax = fmaxf(amax, fabsf(v));
    }
  }
  amax = block_reduce<THREADS>(amax, red, true);
  quantize_store<THREADS>(y, K, amax, q + row * K, s + row);
}

__global__ void __launch_bounds__(K5_THREADS)
silu_mul_quantize_kernel(const __nv_bfloat16* __restrict__ g,
                         const __nv_bfloat16* __restrict__ u,
                         int8_t* __restrict__ q, float* __restrict__ s, int K,
                         long long row_stride) {
  constexpr int THREADS = K5_THREADS;
  extern __shared__ float y[];
  __shared__ float red[THREADS / 32];
  const long long row = blockIdx.x;
  const __nv_bfloat16* gr = g + row * row_stride;
  const __nv_bfloat16* ur = u + row * row_stride;
  const int nchunks = K / VEC;

  float amax = 0.f;
  for (int c = threadIdx.x; c < nchunks; c += THREADS) {
    float fg[VEC], fu[VEC];
    load8(gr + c * VEC, fg);
    load8(ur + c * VEC, fu);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float act = fg[i] / __fadd_rn(1.0f, expf(-fg[i]));
      const float v = __fmul_rn(act, fu[i]);
      y[slot(c, i, nchunks)] = v;
      amax = fmaxf(amax, fabsf(v));
    }
  }
  amax = block_reduce<THREADS>(amax, red, true);
  quantize_store<THREADS>(y, K, amax, q + row * K, s + row);
}

constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > kDefaultSmem)
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                int(smem));
  return cudaSuccess;
}

}  // namespace

// x: (rows, K) bf16 with rows = B * L, scale/shift: (B, K) fp32, q: (rows, K)
// int8, s: (rows,) fp32; all contiguous, K % 8 == 0, checked by the Python
// wrapper (seedvr2_tpu_torch/ops/fused_quant.py).
extern "C" int seedvr2_rms_ada_quantize(const void* x, const void* scale,
                                        const void* shift, void* q, void* s,
                                        int rows, int L, int K, float eps,
                                        void* stream) {
  if (rows == 0) return int(cudaSuccess);
  const size_t smem = size_t(K) * sizeof(float);
  cudaError_t err = prepare(rms_ada_quantize_kernel, smem);
  if (err != cudaSuccess) return int(err);
  rms_ada_quantize_kernel<<<rows, K4_THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<int8_t*>(q),
      static_cast<float*>(s), L, K, eps);
  return int(cudaGetLastError());
}

// g, u: rows of K bf16 values spaced row_stride elements apart (the halves of
// a (rows, 2K) product), q: (rows, K) int8, s: (rows,) fp32.
extern "C" int seedvr2_silu_mul_quantize(const void* g, const void* u, void* q,
                                         void* s, int rows, int K,
                                         int row_stride, void* stream) {
  if (rows == 0) return int(cudaSuccess);
  const size_t smem = size_t(K) * sizeof(float);
  cudaError_t err = prepare(silu_mul_quantize_kernel, smem);
  if (err != cudaSuccess) return int(err);
  silu_mul_quantize_kernel<<<rows, K5_THREADS, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(g),
      static_cast<const __nv_bfloat16*>(u), static_cast<int8_t*>(q),
      static_cast<float*>(s), K, (long long)row_stride);
  return int(cudaGetLastError());
}
