// Dequantizing GEMMs of the quantised-checkpoint lanes (kernels K6 and K7 of
// the port): one kernel body, two epilogues per 32-group (a template flag).
//
// Replaces: the Pallas TPU kernels `_qmm_kernel` behind `quant_matmul_q8`
// (K6) and `_aqmm_kernel` behind `quant_matmul_affine` (K7), both in
// comfyui-seedvr2_tpu/ops/quant_matmul.py.
//
// Computes, with x (M, K) bf16 activations, q (N, K) int8 weights
// (K-contiguous, the GGUF (out, in) order) and per-32-group fp32 tables
// (N, K/32):
//   K6: out[m, n] = bf16(sum_g s[n, g] * (x_g[m] . q_g[n]))
//   K7: out[m, n] = bf16(sum_g s[n, g] * (x_g[m] . q_g[n]) - xg[m, g] * mn[n, g])
// where x_g . q_g is the 32-term dot of group g and xg[m, g] the fp32 sum of
// the 32 x values of row m in group g: w = q*s - m folded into a side term,
// as the JAX kernel does. The bias is not added here: the caller adds it
// after the bf16 rounding, as the JAX package does.
//
// Exactness: the Pallas body dequantises a tile to fp32 and takes an fp32
// dot. Dequantising to a bf16 tile here would round s*q to 8 mantissa bits,
// an error the JAX function does not have. Instead q is widened to bf16
// (exact for |q| <= 127), each 32-wide group's two `mma.sync.m16n8k16`
// products go into a zeroed fp32 partial, and the partial is folded in with
// acc = fma(partial, s, acc). The result differs from the fp32 reference
// only by the order of its fp32 sums; one rounding to bf16 at the end.
//
// What bounds it on an H100: at the 3B DiT's video shapes (M = 7200..32400
// tokens) operations, 2*M*N*K on the bf16 tensor cores (989 TFLOP/s dense):
// 0.649 ms for qkv at 16320 tokens; at M = 1 (time embedding) and M = 58
// (text) bytes, the weights' 1.125 B (K6) or 1.25 B (K7) each over 3.35 TB/s.
//
// Design, a right and simple first version: 128x128 output tiles per block of
// 8 warps (2 x 4), each warp a 64x32 sub-tile; K walked one 32-group per
// stage through a 4-stage `cp.async` ring in dynamic shared memory (x rows
// padded 64 -> 80 bytes, q rows 32 -> 48 bytes, so fragment loads fall in
// distinct banks); the group's tables ride in the same stage. Per m16 row
// tile a warp takes its partials over the group (4 n8 tiles, 16 registers),
// then folds them into the fp32 accumulators (64 registers), so the doubled
// accumulator the exact form needs costs a quarter, not all, of the
// accumulator registers. K7's row sums xg come from the A fragments already
// in registers (each lane holds 8 of a row's 32 values; two shuffles add up
// the 4 lanes of a row). Ragged M and N edges are zero-filled on load
// (src-size 0) and masked on store. K % 32 == 0 and N % 2 == 0 are required.
// Two blocks an SM cap the registers at 128: K7 fits, K6 spills 16 bytes;
// without the cap (about 190 registers, one block an SM) neither spills but
// both run slower at the video shapes, so the cap stays.
// No TMA, no wgmma, no nibble packing, no split-K: those are for the PRs
// that make it fast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 32;       // BK = one quant group
constexpr int STAGES = 4;
constexpr int WARPS_M = 2, WARPS_N = 4;          // warp tile 64 x 32
constexpr int THREADS = WARPS_M * WARPS_N * 32;  // 256
constexpr int MI = BM / WARPS_M / 16;            // 4 m16 tiles per warp
constexpr int NI = BN / WARPS_N / 8;             // 4 n8 tiles per warp
constexpr int XROW = BK * 2 + 16;                // x smem row, bytes
constexpr int QROW = BK + 16;                    // q smem row, bytes
constexpr int X_BYTES = BM * XROW;               // 10240
constexpr int Q_BYTES = BN * QROW;               // 6144
constexpr int T_BYTES = BN * 4;                  // one fp32 table column
constexpr int STAGE_BYTES = X_BYTES + Q_BYTES + 2 * T_BYTES;  // 17408
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;              // 69632

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// D(16x8, f32) += A(16x16, bf16, row) * B(16x8, bf16, col). Per lane
// (g = lane / 4, t = lane % 4), 2 values a register: a = {A[g][2t..],
// A[g+8][2t..], A[g][2t+8..], A[g+8][2t+8..]}, b = {B[2t..][g], B[2t+8..][g]},
// d = {D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]}.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two consecutive int8 quants -> a packed bf16 pair (exact: |q| <= 127).
__device__ __forceinline__ uint32_t q2_to_bf16x2(const int8_t* p) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(float(p[0]), float(p[1]));
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t r) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r));
}

// One stage: the (BM x 32) x slice, the (BN x 32) q slice and the group's
// table column(s), for K group `grp`. Out-of-range rows are zero-filled.
template <bool AFFINE>
__device__ __forceinline__ void load_stage(
    uint8_t* st, const __nv_bfloat16* __restrict__ x,
    const int8_t* __restrict__ q, const float* __restrict__ s,
    const float* __restrict__ mn, int m0, int n0, int grp, int M, int N,
    int K) {
  const int k0 = grp * BK;
  const int G = K / BK;
  // x: BM rows x 4 chunks of 16 bytes
#pragma unroll
  for (int i = 0; i < BM * 4 / THREADS; ++i) {
    const int c = threadIdx.x + i * THREADS;
    const int r = c / 4, kc = (c % 4) * 8;
    const bool ok = m0 + r < M;
    const __nv_bfloat16* g = ok ? x + (long long)(m0 + r) * K + k0 + kc : x;
    cp_async16(st + r * XROW + kc * 2, g, ok ? 16 : 0);
  }
  // q: BN rows x 2 chunks
  {
    const int c = threadIdx.x;
    const int r = c / 2, kc = (c % 2) * 16;
    const bool ok = n0 + r < N;
    const int8_t* g = ok ? q + (long long)(n0 + r) * K + k0 + kc : q;
    cp_async16(st + X_BYTES + r * QROW + kc, g, ok ? 16 : 0);
  }
  // tables: s (and mn) column of this group, BN floats each
  if (threadIdx.x < BN) {
    const int r = threadIdx.x;
    const bool ok = n0 + r < N;
    const float* g = ok ? s + (long long)(n0 + r) * G + grp : s;
    cp_async4(st + X_BYTES + Q_BYTES + r * 4, g, ok ? 4 : 0);
  } else if (AFFINE) {
    const int r = threadIdx.x - BN;
    const bool ok = n0 + r < N;
    const float* g = ok ? mn + (long long)(n0 + r) * G + grp : mn;
    cp_async4(st + X_BYTES + Q_BYTES + T_BYTES + r * 4, g, ok ? 4 : 0);
  }
}

template <bool AFFINE>
__global__ void __launch_bounds__(THREADS, 2)
quant_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                    const int8_t* __restrict__ q, const float* __restrict__ s,
                    const float* __restrict__ mn,
                    __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(16) uint8_t smem[];

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane / 4, t = lane % 4;

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  const int groups = K / BK;
#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < groups)
      load_stage<AFFINE>(smem + p * STAGE_BYTES, x, q, s, mn, m0, n0, p, M, N,
                         K);
    cp_async_commit();
  }

  for (int kt = 0; kt < groups; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed; stage kt-1 is free to refill
    {
      const int nxt = kt + STAGES - 1;
      if (nxt < groups)
        load_stage<AFFINE>(smem + (nxt % STAGES) * STAGE_BYTES, x, q, s, mn,
                           m0, n0, nxt, M, N, K);
      cp_async_commit();
    }

    const uint8_t* st = smem + (kt % STAGES) * STAGE_BYTES;
    const uint8_t* xs = st + (wm * MI * 16 + g) * XROW + t * 4;
    const int8_t* qs = reinterpret_cast<const int8_t*>(st + X_BYTES) +
                       (wn * NI * 8 + g) * QROW + t * 2;
    const float* ss = reinterpret_cast<const float*>(st + X_BYTES + Q_BYTES) +
                      wn * NI * 8 + 2 * t;
    const float* ms = ss + BN;

    // B fragments of the whole group (both k16 halves), widened to bf16
    uint32_t b[NI][2][2];
    float sc[NI][2], mv[NI][2];
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int8_t* p = qs + j * 8 * QROW;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        b[j][h][0] = q2_to_bf16x2(p + 16 * h);
        b[j][h][1] = q2_to_bf16x2(p + 16 * h + 8);
      }
      sc[j][0] = ss[j * 8];
      sc[j][1] = ss[j * 8 + 1];
      if (AFFINE) {
        mv[j][0] = ms[j * 8];
        mv[j][1] = ms[j * 8 + 1];
      }
    }

#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const uint8_t* p = xs + i * 16 * XROW;
      uint32_t a[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        a[h][0] = *reinterpret_cast<const uint32_t*>(p + 32 * h);
        a[h][1] = *reinterpret_cast<const uint32_t*>(p + 8 * XROW + 32 * h);
        a[h][2] = *reinterpret_cast<const uint32_t*>(p + 32 * h + 16);
        a[h][3] =
            *reinterpret_cast<const uint32_t*>(p + 8 * XROW + 32 * h + 16);
      }
      float part[NI][4];
#pragma unroll
      for (int j = 0; j < NI; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) part[j][c] = 0.f;
        mma_bf16(part[j], a[0], b[j][0][0], b[j][0][1]);
        mma_bf16(part[j], a[1], b[j][1][0], b[j][1][1]);
      }
      float xg0 = 0.f, xg1 = 0.f;  // group sums of rows g and g + 8
      if (AFFINE) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 r0 = bf16x2_to_float2(a[h][0]);
          const float2 r1 = bf16x2_to_float2(a[h][1]);
          const float2 r2 = bf16x2_to_float2(a[h][2]);
          const float2 r3 = bf16x2_to_float2(a[h][3]);
          xg0 += (r0.x + r0.y) + (r2.x + r2.y);
          xg1 += (r1.x + r1.y) + (r3.x + r3.y);
        }
        xg0 += __shfl_xor_sync(0xffffffffu, xg0, 1);
        xg1 += __shfl_xor_sync(0xffffffffu, xg1, 1);
        xg0 += __shfl_xor_sync(0xffffffffu, xg0, 2);
        xg1 += __shfl_xor_sync(0xffffffffu, xg1, 2);
      }
#pragma unroll
      for (int j = 0; j < NI; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[i][j][c] = fmaf(part[j][c], sc[j][c & 1], acc[i][j][c]);
          if (AFFINE)
            acc[i][j][c] = fmaf(-(c < 2 ? xg0 : xg1), mv[j][c & 1],
                                acc[i][j][c]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: one rounding to bf16
#pragma unroll
  for (int j = 0; j < NI; ++j) {
    const int n = n0 + wn * NI * 8 + j * 8 + 2 * t;
    if (n >= N) continue;  // N even: both columns in or both out
#pragma unroll
    for (int i = 0; i < MI; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * MI * 16 + i * 16 + g + 8 * h;
        if (m >= M) continue;
        *reinterpret_cast<__nv_bfloat162*>(out + (long long)m * N + n) =
            __floats2bfloat162_rn(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
  }
}

template <bool AFFINE>
int launch(const void* x, const void* q, const void* s, const void* mn,
           void* out, int M, int N, int K, void* stream) {
  if (M == 0 || N == 0) return int(cudaSuccess);
  if (K <= 0 || K % BK || N % 2) return int(cudaErrorInvalidValue);
  const unsigned gy = unsigned((M + BM - 1) / BM);
  if (gy > 65535u) return int(cudaErrorInvalidValue);
  // above 48 KB of dynamic shared memory a kernel has to opt in
  const cudaError_t e = cudaFuncSetAttribute(
      quant_matmul_kernel<AFFINE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (e != cudaSuccess) return int(e);
  const dim3 grid(unsigned((N + BN - 1) / BN), gy);
  quant_matmul_kernel<AFFINE>
      <<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
          static_cast<const float*>(s), static_cast<const float*>(mn),
          static_cast<__nv_bfloat16*>(out), M, N, K);
  return int(cudaGetLastError());
}

}  // namespace

// x: (M, K) bf16, q: (N, K) int8, scales: (N, K/32) fp32, out: (M, N) bf16;
// all contiguous, x and q 16-byte aligned, K % 32 == 0, N % 2 == 0, checked
// by the Python wrapper (seedvr2_tpu_torch/ops/quant_matmul.py).
extern "C" int seedvr2_quant_matmul_q8(const void* x, const void* q,
                                       const void* scales, void* out, int M,
                                       int N, int K, void* stream) {
  return launch<false>(x, q, scales, scales, out, M, N, K, stream);
}

// As above with q in [0, 31] and the affine tables s, m: (N, K/32) fp32.
extern "C" int seedvr2_quant_matmul_affine(const void* x, const void* q,
                                           const void* s, const void* m,
                                           void* out, int M, int N, int K,
                                           void* stream) {
  return launch<true>(x, q, s, m, out, M, N, K, stream);
}
