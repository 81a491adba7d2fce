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
// What bounds it on an H100: memory. K4 at the 1080p clip's 16320 rows of
// K = 2560 reads 83.6 MB of bf16 and writes 41.8 MB of int8 (about 0.037 ms
// at 3.35 TB/s); K5 at K = 6912 reads 451 MB and writes 113 MB (about 0.168
// ms). A handful of flops per byte is far below the ridge.
//
// K4's design: persistent blocks (as many as are resident on the card),
// each walking rows blockIdx.x, + gridDim.x, ... A thread owns two fixed
// 8-wide column chunks (160 threads at K = 2560), so it holds its chunks'
// fp32 scale and shift in registers, loaded once for the batch row it is on
// and again only when the rows cross into the next one: the rows re-read
// nothing but x. Each thread copies its own chunks of the next three rows
// with cp.async into a four-stage shared-memory ring and reads back only
// those, so the ring needs no barrier and the loads stay in flight through
// a row's work; the row then stays in registers, as x and then as y. Each
// reduction (sum of squares, then absmax) takes one barrier, on alternate
// shared buffers. Measured on the H100 against this: one chunk a thread
// (320 threads), two rows a step, three or five chunks a thread, and one
// warp a row with scale and shift in shared memory were no faster. The
// quantization rounds y / qs with the correctly rounded quotient from the
// row's reciprocal and one FMA correction, and to an integer by adding
// 1.5 * 2^23, which keeps it off the conversion units.
//
// K5's design: one block per row (256 threads for 6912-wide rows, 8
// resident blocks an SM, to hide the load latency of these short rows).
// The row is read once with 16-byte loads, its fp32 values are kept in
// shared memory (K * 4 bytes: 27 KB) laid out value-major so that a warp's
// accesses fall in distinct banks, and each thread revisits only the values
// it loaded, so the block reduction (absmax) is the only barrier. q leaves
// as 8-byte stores. g and u are read in place as the two halves of the
// gate+up product, with a row stride.
//
// Numerics kept as the plain version's in both: the IEEE quotient y / sc
// (no fast math), round half to even, and the producer math in __fmul_rn
// / __fadd_rn so that nvcc does not contract it into FMAs. Left different:
// the order of the row sums and rsqrtf, which can move a value across a .5
// rounding boundary, so q may differ from the plain version by 1 in a small
// share of entries.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int K4_CPT = 2;     // 8-column chunks a K4 thread owns
constexpr int K4_STAGES = 4;  // rows in K4's copy ring, 3 of them ahead
constexpr int K4_MAX_THREADS = 512;
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

__device__ __forceinline__ void unpack8(const uint4& raw, float (&f)[VEC]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
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

// Sum (MAX false) or max of v over the block, the block's result in every
// thread, with one barrier: every warp reduces the per-warp values itself,
// in the same order. The caller alternates `red` between consecutive
// reductions, so no barrier guards its reuse.
template <bool MAX>
__device__ __forceinline__ float k4_block_reduce(float v, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = MAX ? fmaxf(v, o) : v + o;
  }
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < int(blockDim.x / 32) ? red[lane] : 0.f;  // 0: identity of both
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = MAX ? fmaxf(v, o) : v + o;
  }
  return v;
}

// Start the copies of `row`'s chunks that this thread owns into ring stage
// `stage`: a thread reads back only what it copied, so the ring needs no
// barrier. One commit group a row, empty or not.
__device__ __forceinline__ void k4_fetch(const __nv_bfloat16* x, uint4* ring,
                                         long long row, int stage,
                                         long long rows, int K,
                                         const int (&col)[K4_CPT]) {
#pragma unroll
  for (int j = 0; j < K4_CPT; ++j) {
    if (row < rows && col[j] < K) {
      const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(
          ring + (stage * K4_CPT + j) * blockDim.x + threadIdx.x));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                   "l"(x + row * K + col[j]));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__global__ void __launch_bounds__(K4_MAX_THREADS)
rms_ada_quantize_kernel(const __nv_bfloat16* __restrict__ x,
                        const float* __restrict__ scale,
                        const float* __restrict__ shift,
                        int8_t* __restrict__ q, float* __restrict__ s,
                        long long rows, int L, int K, float eps) {
  extern __shared__ uint4 ring[];  // [K4_STAGES][K4_CPT][threads]
  __shared__ float red[2][K4_MAX_THREADS / 32];
  int col[K4_CPT];
#pragma unroll
  for (int j = 0; j < K4_CPT; ++j)
    col[j] = (threadIdx.x + j * blockDim.x) * VEC;
  // this thread's columns of scale and shift, for the batch row whose rows
  // are [lo, hi): reloaded only when a row leaves that span
  float sc[K4_CPT][VEC] = {}, sh[K4_CPT][VEC] = {};
  long long lo = 0, hi = 0;
#pragma unroll
  for (int i = 0; i < K4_STAGES - 1; ++i)
    k4_fetch(x, ring, blockIdx.x + (long long)i * gridDim.x, i, rows, K, col);
  int stage = 0;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    k4_fetch(x, ring, row + (long long)(K4_STAGES - 1) * gridDim.x,
             (stage + K4_STAGES - 1) % K4_STAGES, rows, K, col);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(K4_STAGES - 1));
    // the row's values, as x and then as y, in registers
    float y[K4_CPT][VEC];
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < K4_CPT; ++j) {
      unpack8(col[j] < K ? ring[(stage * K4_CPT + j) * blockDim.x +
                                threadIdx.x]
                         : make_uint4(0u, 0u, 0u, 0u),
              y[j]);
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        ss = __fadd_rn(ss, __fmul_rn(y[j][i], y[j][i]));
    }
    stage = (stage + 1) % K4_STAGES;
    ss = k4_block_reduce<false>(ss, red[0]);

    if (row < lo || row >= hi) {
      const long long b = row / L;
      lo = b * L;
      hi = lo + L;
#pragma unroll
      for (int j = 0; j < K4_CPT; ++j) {
        if (col[j] < K) {
          load8f(scale + b * K + col[j], sc[j]);
          load8f(shift + b * K + col[j], sh[j]);
        }
      }
    }
    const float inv = rsqrtf(__fadd_rn(ss / float(K), eps));
    float amax = 0.f;
#pragma unroll
    for (int j = 0; j < K4_CPT; ++j) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        y[j][i] = __fadd_rn(__fmul_rn(__fmul_rn(y[j][i], inv), sc[j][i]),
                            sh[j][i]);
        if (col[j] < K) amax = fmaxf(amax, fabsf(y[j][i]));
      }
    }
    amax = k4_block_reduce<true>(amax, red[1]);

    const float qs = fmaxf(amax, 1e-8f) / 127.0f;
    const float rq = __frcp_rn(qs);
#pragma unroll
    for (int j = 0; j < K4_CPT; ++j) {
      if (col[j] >= K) continue;
      uint32_t bits[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        // y / qs correctly rounded, as IEEE division gives it: from the
        // correctly rounded reciprocal, one FMA residual and one FMA
        // correction (Markstein's theorem; |y / qs| <= 127 keeps it far
        // from overflow, and a quotient too small for the theorem rounds to
        // 0 either way)
        const float t = __fmul_rn(y[j][i], rq);
        const float v = fminf(
            fmaxf(__fmaf_rn(__fmaf_rn(-qs, t, y[j][i]), rq, t), -127.f),
            127.f);
        // round half to even by adding 1.5 * 2^23 (where the float's ulp is
        // 1): the sum's low byte is then the int8 value
        bits[i] = __float_as_uint(__fadd_rn(v, 12582912.0f));
      }
      const uint32_t lo4 =
          __byte_perm(__byte_perm(bits[0], bits[1], 0x0040),
                      __byte_perm(bits[2], bits[3], 0x0040), 0x5410);
      const uint32_t hi4 =
          __byte_perm(__byte_perm(bits[4], bits[5], 0x0040),
                      __byte_perm(bits[6], bits[7], 0x0040), 0x5410);
      *reinterpret_cast<uint2*>(q + row * K + col[j]) = make_uint2(lo4, hi4);
    }
    if (threadIdx.x == 0) s[row] = qs;
  }
  asm volatile("cp.async.wait_all;\n" ::);  // no copy outlives the block
}

// K4's dynamic shared memory: the copy ring.
size_t k4_smem(int threads) {
  return size_t(K4_STAGES) * K4_CPT * threads * sizeof(uint4);
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

// K4 in blocks of `threads` threads: the shared memory its launches ask
// for allowed (set before every launch: the ring plus the static buffers
// may pass 48 KB, and the last setting may have been for fewer threads).
cudaError_t k4_prepare(int threads) {
  if (threads <= 0 || threads % 32 || threads > K4_MAX_THREADS)
    return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(rms_ada_quantize_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(k4_smem(threads)));
}

}  // namespace

// The number of K4 blocks of `threads` threads that the current device
// holds at once (the persistent grid), in *out.
extern "C" int seedvr2_rms_ada_quantize_resident(int threads, int* out) {
  cudaError_t err = k4_prepare(threads);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rms_ada_quantize_kernel, threads, k4_smem(threads));
  *out = per_sm * sms;
  return int(err);
}

// x: (rows, K) bf16 with rows = B * L, scale/shift: (B, K) fp32, q: (rows, K)
// int8, s: (rows,) fp32; all contiguous, K % 8 == 0, K <= 16 * threads,
// threads a multiple of 32 and at most 512, grid blocks (the persistent
// grid, at most the resident count): the plan of the Python wrapper
// (`plan_k4`, seedvr2_tpu_torch/ops/fused_quant.py), which checks the rest.
extern "C" int seedvr2_rms_ada_quantize(const void* x, const void* scale,
                                        const void* shift, void* q, void* s,
                                        long long rows, int L, int K,
                                        float eps, int threads, int grid,
                                        void* stream) {
  if (rows == 0) return int(cudaSuccess);
  if (K % VEC || (long long)K4_CPT * VEC * threads < K || grid <= 0 || L <= 0)
    return int(cudaErrorInvalidValue);
  const cudaError_t err = k4_prepare(threads);
  if (err != cudaSuccess) return int(err);
  rms_ada_quantize_kernel<<<grid, threads, k4_smem(threads),
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<int8_t*>(q),
      static_cast<float*>(s), rows, L, K, eps);
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
