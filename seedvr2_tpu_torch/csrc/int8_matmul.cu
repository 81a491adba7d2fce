// w8a8 int8 GEMM with the dequantizing epilogue (kernel K3 of the port).
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
