// w8a8 int8 GEMM with the dequantizing epilogue (kernel K3 of the port), and
// below it the quantizing variant K10 that takes float activations.
//
// Replaces: the Pallas TPU kernel `_mm_kernel` behind `int8_matmul`
// (comfyui-seedvr2_tpu/ops/int8_matmul.py).
//
// Computes out[m, n] = bf16((float(sum_k xq[m, k] * wq[n, k]) * xs[m]) * ws[n])
// with xq (M, K) int8 activations and wq (N, K) int8 weights, both
// K-contiguous, xs (M,) and ws (N,) fp32 scales. The int32 sums are exact and
// the epilogue multiplies in the JAX kernel's order and rounds once, so the
// result equals the plain version bit for bit. The bias is not added here:
// the caller adds it after the bf16 rounding, as the JAX package does.
//
// What bounds it on an H100: operations. At the 3B DiT shapes (M = 7200
// tokens, K = 2560..6912, N = 2560..15360) each call does 2*M*N*K int8 ops,
// hundreds of ops per byte moved, so the int8 tensor cores (1979 TOP/s dense)
// set the floor: 0.143 ms for qkv (N = 7680), 0.258 ms for gate+up
// (N = 13824).
//
// Design, a right and simple first version: 128x128 output tiles per block
// of 8 warps, each warp a 64x32 sub-tile held as int32 accumulators in
// registers; K walked in 64-byte steps with `cp.async` double buffering into
// shared memory (rows padded from 64 to 80 bytes so that the fragment loads
// fall in distinct banks); products by `mma.sync.aligned.m16n8k32` s8 x s8 ->
// s32, whose A and B fragments are plain 32-bit loads of 4 consecutive K
// bytes from the row-major tiles. Ragged M and N edges are zero-filled on
// load (cp.async src-size 0) and masked on store; K % 32 == 0, N % 8 == 0 are
// required. No TMA, no wgmma, no persistent scheduling: those are for the PRs
// that make it fast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int WARPS_M = 2, WARPS_N = 4;          // warp tile 64 x 32
constexpr int THREADS = WARPS_M * WARPS_N * 32;  // 256
constexpr int MI = BM / WARPS_M / 16;            // 4 m16 tiles per warp
constexpr int NI = BN / WARPS_N / 8;             // 4 n8 tiles per warp
constexpr int SROW = BK + 16;                    // padded smem row, bytes
constexpr int CHUNKS = BM * BK / 16;             // 16-byte chunks per tile

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// D(16x8, s32) += A(16x32, s8, row) * B(32x8, s8, col). Per lane
// (g = lane / 4, t = lane % 4), 4 bytes a register: a = {A[g][4t..],
// A[g+8][4t..], A[g][4t+16..], A[g+8][4t+16..]}, b = {B[4t..][g],
// B[4t+16..][g]}, d = {D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]}.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy one (rows x BK) K-slice of a row-major (R, K) int8 matrix into a
// padded smem tile; rows >= R and columns >= K are zero-filled.
__device__ __forceinline__ void load_tile(int8_t* tile,
                                          const int8_t* __restrict__ src,
                                          int row0, int R, int k0, int K) {
#pragma unroll
  for (int i = 0; i < CHUNKS / THREADS; ++i) {
    const int c = threadIdx.x + i * THREADS;
    const int r = c / (BK / 16);
    const int kc = (c % (BK / 16)) * 16;
    const bool valid = row0 + r < R && k0 + kc < K;
    const int8_t* g = valid ? src + (long long)(row0 + r) * K + k0 + kc : src;
    cp_async16(tile + r * SROW + kc, g, valid ? 16 : 0);
  }
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(THREADS, 2)
int8_matmul_kernel(const int8_t* __restrict__ xq,
                   const int8_t* __restrict__ wq,
                   const float* __restrict__ xs, const float* __restrict__ ws,
                   __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) int8_t As[2][BM * SROW];
  __shared__ __align__(16) int8_t Bs[2][BN * SROW];

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane / 4, t = lane % 4;

  int acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;

  const int ktiles = (K + BK - 1) / BK;
  load_tile(As[0], xq, m0, M, 0, K);
  load_tile(Bs[0], wq, n0, N, 0, K);
  cp_async_commit();

  for (int kt = 0; kt < ktiles; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < ktiles) {
      load_tile(As[st ^ 1], xq, m0, M, (kt + 1) * BK, K);
      load_tile(Bs[st ^ 1], wq, n0, N, (kt + 1) * BK, K);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int8_t* a_s = As[st] + (wm * MI * 16 + g) * SROW + t * 4;
    const int8_t* b_s = Bs[st] + (wn * NI * 8 + g) * SROW + t * 4;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[MI][4];
      uint32_t b[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int8_t* p = a_s + i * 16 * SROW + kk;
        a[i][0] = ld32(p);
        a[i][1] = ld32(p + 8 * SROW);
        a[i][2] = ld32(p + 16);
        a[i][3] = ld32(p + 8 * SROW + 16);
      }
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int8_t* p = b_s + j * 8 * SROW + kk;
        b[j][0] = ld32(p);
        b[j][1] = ld32(p + 16);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);
    }
    __syncthreads();  // this stage is refilled by the next iteration's load
  }

  // epilogue: (float(acc) * xs[m]) * ws[n], rounded once to bf16
#pragma unroll
  for (int j = 0; j < NI; ++j) {
    const int n = n0 + wn * NI * 8 + j * 8 + 2 * t;
    if (n >= N) continue;  // N % 8 == 0: both columns in or both out
    const float w0 = ws[n], w1 = ws[n + 1];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * MI * 16 + i * 16 + g + 8 * h;
        if (m >= M) continue;
        const float x = xs[m];
        const float v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h]), x), w0);
        const float v1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h + 1]), x), w1);
        *reinterpret_cast<__nv_bfloat162*>(out + (long long)m * N + n) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}


// ---------------------------------------------------------------------------
// K10: the quantizing int8 GEMM.
//
// Replaces: the Pallas TPU kernel `_mm_qx_kernel` behind `int8_matmul_qx`
// (comfyui-seedvr2_tpu/ops/int8_matmul.py).
//
// Computes out = (float(sum_k q[m, k] * wq[n, k]) * xs[m]) * ws[n] from bf16
// or fp32 activations x (M, K), quantized per row inside the kernel as the
// TPU kernel does: xs = max(amax_k |x[m, k]|, 1e-8) * (1/127) and
// q = clip(rint(x * (1 / xs)), -127, 127), the reciprocal an IEEE division
// and the product rounded once (no fast-math), so the result equals the
// plain version bit for bit. Output bf16 or fp32.
//
// What bounds it: operations, as K3 (2*M*N*K int8 ops); the activation is
// read once by the amax pass and once per N tile of the main loop, as bf16
// instead of int8.
//
// Design: two launches. Pass 1 (`row_scale_kernel`), one warp a row, reads
// x once and writes the row scales to a scratch vector the wrapper
// allocates. Pass 2 is K3's kernel with its A tile staged differently:
// each thread loads its 16-byte chunks of the next x tile into registers
// while the tensor cores work on the current one, then quantizes them with
// its rows' reciprocals into the other int8 shared-memory stage; the weight
// tiles keep K3's cp.async double buffering, the mma.sync.m16n8k32 loop and
// the epilogue are K3's.

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(256)
row_scale_kernel(const T* __restrict__ x, float* __restrict__ xs, int M,
                 int K) {
  constexpr int EPC = 16 / sizeof(T);
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const T* xr = x + (long long)row * K;
  float amax = 0.f;
  for (int c = lane * EPC; c < K; c += 32 * EPC) {
    const uint4 v = *reinterpret_cast<const uint4*>(xr + c);
    const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int i = 0; i < EPC; ++i) amax = fmaxf(amax, fabsf(to_float(e[i])));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (lane == 0)
    xs[row] = __fmul_rn(fmaxf(amax, 1e-8f), static_cast<float>(1.0 / 127.0));
}

__device__ __forceinline__ uint32_t quant_byte(float v, float inv, int shift) {
  const float r = fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.f), 127.f);
  return (uint32_t(int(r)) & 0xffu) << shift;
}

__device__ __forceinline__ void store_out(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v0,
                                          float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

template <typename T, typename OutT>
__global__ void __launch_bounds__(THREADS, 2)
int8_matmul_qx_kernel(const T* __restrict__ x, const int8_t* __restrict__ wq,
                      const float* __restrict__ xs,
                      const float* __restrict__ ws, OutT* __restrict__ out,
                      int M, int N, int K) {
  __shared__ __align__(16) int8_t As[2][BM * SROW];
  __shared__ __align__(16) int8_t Bs[2][BN * SROW];
  constexpr int EPC = 16 / sizeof(T);                // x values a chunk
  constexpr int CPR = BK / EPC;                      // chunks a tile row
  constexpr int XCH = BM * BK / EPC / THREADS;       // chunks a thread
  static_assert(EPC == 4 || EPC == 8, "bf16 or fp32 activations");

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane / 4, t = lane % 4;

  // this thread's x chunks: the same rows and columns of every K tile
  float inv[XCH];
#pragma unroll
  for (int i = 0; i < XCH; ++i) {
    const int m = m0 + (threadIdx.x + i * THREADS) / CPR;
    inv[i] = m < M ? __fdiv_rn(1.f, xs[m]) : 0.f;
  }
  uint4 xr[XCH];
  auto load_x = [&](int k0) {
#pragma unroll
    for (int i = 0; i < XCH; ++i) {
      const int c = threadIdx.x + i * THREADS;
      const int m = m0 + c / CPR, kc = k0 + (c % CPR) * EPC;
      xr[i] = make_uint4(0u, 0u, 0u, 0u);
      if (m < M && kc < K)
        xr[i] = *reinterpret_cast<const uint4*>(x + (long long)m * K + kc);
    }
  };
  auto store_q = [&](int8_t* tile) {
#pragma unroll
    for (int i = 0; i < XCH; ++i) {
      const int c = threadIdx.x + i * THREADS;
      const T* e = reinterpret_cast<const T*>(&xr[i]);
      int8_t* dst = tile + (c / CPR) * SROW + (c % CPR) * EPC;
      uint32_t w0 = 0, w1 = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) w0 |= quant_byte(to_float(e[j]), inv[i], 8 * j);
      if constexpr (EPC == 8) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          w1 |= quant_byte(to_float(e[4 + j]), inv[i], 8 * j);
        *reinterpret_cast<uint2*>(dst) = make_uint2(w0, w1);
      } else {
        *reinterpret_cast<uint32_t*>(dst) = w0;
      }
    }
  };

  int acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;

  const int ktiles = (K + BK - 1) / BK;
  load_x(0);
  load_tile(Bs[0], wq, n0, N, 0, K);
  cp_async_commit();
  store_q(As[0]);

  for (int kt = 0; kt < ktiles; ++kt) {
    const int st = kt & 1;
    const bool more = kt + 1 < ktiles;
    if (more) {
      load_x((kt + 1) * BK);  // in flight while this tile is multiplied
      load_tile(Bs[st ^ 1], wq, n0, N, (kt + 1) * BK, K);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int8_t* a_s = As[st] + (wm * MI * 16 + g) * SROW + t * 4;
    const int8_t* b_s = Bs[st] + (wn * NI * 8 + g) * SROW + t * 4;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[MI][4];
      uint32_t b[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int8_t* p = a_s + i * 16 * SROW + kk;
        a[i][0] = ld32(p);
        a[i][1] = ld32(p + 8 * SROW);
        a[i][2] = ld32(p + 16);
        a[i][3] = ld32(p + 8 * SROW + 16);
      }
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int8_t* p = b_s + j * 8 * SROW + kk;
        b[j][0] = ld32(p);
        b[j][1] = ld32(p + 16);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);
    }
    // the other A stage was last read before the previous iteration's
    // closing barrier
    if (more) store_q(As[st ^ 1]);
    __syncthreads();
  }

  // epilogue: (float(acc) * xs[m]) * ws[n], rounded once to the output type
#pragma unroll
  for (int j = 0; j < NI; ++j) {
    const int n = n0 + wn * NI * 8 + j * 8 + 2 * t;
    if (n >= N) continue;  // N % 8 == 0: both columns in or both out
    const float w0 = ws[n], w1 = ws[n + 1];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * MI * 16 + i * 16 + g + 8 * h;
        if (m >= M) continue;
        const float xm = xs[m];
        store_out(out + (long long)m * N + n,
                  __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h]), xm), w0),
                  __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h + 1]), xm), w1));
      }
    }
  }
}

template <typename T, typename OutT>
cudaError_t launch_qx(const void* x, const void* wq, const void* ws, void* xs,
                      void* out, int M, int N, int K, cudaStream_t stream) {
  row_scale_kernel<T><<<unsigned((M + 7) / 8), 256, 0, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(xs), M, K);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(unsigned((N + BN - 1) / BN), unsigned((M + BM - 1) / BM));
  int8_matmul_qx_kernel<T, OutT><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(xs), static_cast<const float*>(ws),
      static_cast<OutT*>(out), M, N, K);
  return cudaGetLastError();
}

}  // namespace

// xq: (M, K) int8, wq: (N, K) int8, xs: (M,) fp32, ws: (N,) fp32, out:
// (M, N) bf16; all contiguous and 16-byte aligned, K % 32 == 0, N % 8 == 0,
// checked by the Python wrapper (seedvr2_tpu_torch/ops/int8_matmul.py).
extern "C" int seedvr2_int8_matmul(const void* xq, const void* wq,
                                   const void* xs, const void* ws, void* out,
                                   int M, int N, int K, void* stream) {
  if (M == 0 || N == 0) return int(cudaSuccess);
  const unsigned gy = unsigned((M + BM - 1) / BM);
  if (gy > 65535u) return int(cudaErrorInvalidValue);
  const dim3 grid(unsigned((N + BN - 1) / BN), gy);
  int8_matmul_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wq),
      static_cast<const float*>(xs), static_cast<const float*>(ws),
      static_cast<__nv_bfloat16*>(out), M, N, K);
  return int(cudaGetLastError());
}

// x: (M, K) bf16 (x_f32 = 0) or fp32 (x_f32 = 1), wq: (N, K) int8, ws: (N,)
// fp32, xs: (M,) fp32 scratch that receives the row scales, out: (M, N) bf16
// (out_f32 = 0) or fp32; all contiguous and 16-byte aligned, K % 32 == 0,
// N % 8 == 0, checked by the Python wrapper.
extern "C" int seedvr2_int8_matmul_qx(const void* x, const void* wq,
                                      const void* ws, void* xs, void* out,
                                      int M, int N, int K, int x_f32,
                                      int out_f32, void* stream) {
  if (M == 0 || N == 0) return int(cudaSuccess);
  if ((M + BM - 1) / BM > 65535) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_f32)
    err = out_f32 ? launch_qx<float, float>(x, wq, ws, xs, out, M, N, K, st)
                  : launch_qx<float, __nv_bfloat16>(x, wq, ws, xs, out, M, N,
                                                    K, st);
  else
    err = out_f32
              ? launch_qx<__nv_bfloat16, float>(x, wq, ws, xs, out, M, N, K, st)
              : launch_qx<__nv_bfloat16, __nv_bfloat16>(x, wq, ws, xs, out, M,
                                                        N, K, st);
  return int(err);
}
