// The port's int8 GEMMs, K3 and K10, on one Hopper s8 GEMM body (TMA ring,
// `wgmma`; helpers in sm90.cuh).
//
// K3, the w8a8 GEMM with the dequantizing epilogue.
//
// Replaces: the Pallas TPU kernel `_mm_kernel` behind `int8_matmul`
// (comfyui-seedvr2_tpu/ops/int8_matmul.py).
//
// Computes out[m, n] = bf16((float(sum_k xq[m, k] * wq[n, k]) * xs[m]) * ws[n])
// (or the same fp32 value unrounded: the fp32 epilogue of a row-sharded
// projection under tensor parallelism, whose partials are summed over the
// ranks before the one rounding) with xq (M, K) int8 activations and wq (N, K) int8 weights, both
// K-contiguous, xs (M,) and ws (N,) fp32 scales. The int32 sums are exact and
// the epilogue multiplies in the JAX kernel's order and rounds once, so the
// result equals the plain version bit for bit. The bias is not added here:
// the caller adds it after the bf16 rounding, as the JAX package does.
//
// What bounds it on an H100: operations. At the 3B DiT's video rows (M =
// 7200..32400 tokens, K = 2560..6912, N = 2560..15360) each call does
// 2*M*N*K int8 ops, hundreds of ops per byte moved, so the int8 tensor cores
// (1979 TOP/s dense) set the floor: 0.583 ms for the 1080p clip's gate+up
// (M = 16320, N = 13824, K = 2560). At M = 1 and 58 (the time embedding,
// the text rows) the weights' N*K bytes bound it.
//
// Design: K10's pass 2, `seedvr2::s8_gemm` below, called as it is on the
// pre-quantized rows, with the tiles `plan_qx` (ops/int8_matmul.py) picks
// for M: 128 tokens by 256 weight rows at the video rows, 128 weight rows
// by 8 or 64 tokens at M <= 64.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

// ---------------------------------------------------------------------------
// K10: the quantizing int8 GEMM, as one row-quantize pass and a Hopper s8
// GEMM.
//
// Replaces: the Pallas TPU kernel `_mm_qx_kernel` behind `int8_matmul_qx`
// (comfyui-seedvr2_tpu/ops/int8_matmul.py).
//
// Computes out = (float(sum_k q[m, k] * wq[n, k]) * xs[m]) * ws[n] from bf16
// or fp32 activations x (M, K), quantized per row as the TPU kernel does:
// xs = max(amax_k |x[m, k]|, 1e-8) * (1/127) and q = clip(rint(x * (1 /
// xs)), -127, 127), the reciprocal an IEEE division and the product rounded
// once (no fast-math), so the result equals the plain version bit for bit.
// Output bf16 or fp32.
//
// What bounds it on an H100: at the DiT's video rows operations, 2*M*N*K on
// the int8 tensor cores (1979 TOP/s dense): 0.324 ms at the 1080p qkv (M =
// 16320, N = 7680, K = 2560); its output (251 MB of bf16 there, 0.075 ms)
// and the quantize pass (x read, xq written: 125 MB, 0.037 ms) are bytes.
// At M = 1 and 58 the weights' N*K bytes bound it. Measured on an H100 80GB
// HBM3 (700 W; chip_smoke.py): 0.54 ms at the qkv, 0.072 of it the
// quantize pass (~1.7 TB/s), 0.017 ms device time at M = 58.
//
// Design, two launches of one call:
//  1. `quantize_rows_kernel`, one block a row, the row held in registers:
//     its amax, then its int8 values, written ONCE into an (M, K) scratch
//     xq beside the row scales xs (both allocated by the wrapper). The
//     first design quantized each x tile again in every block of its rows:
//     N/128 times, 60 at the qkv.
//  2. `s8_gemm_kernel`, the shape of K6/K7's Hopper GEMM (quant_matmul.cu)
//     with both operands in shared memory: one producer warp issues TMA
//     loads (128-byte swizzle, 128 bytes of K a row) of the A and B tiles
//     into a ring of mbarrier-guarded stages; two consumer warpgroups issue
//     `wgmma.mma_async.m64nNk32.s32.s8.s8` (8-bit wgmma takes K-major
//     operands only, which xq and wq both are) with one stage's products in
//     flight while the stage before is released; int32 accumulators, exact.
//     At the video rows a block computes 128 tokens (xq, the A side, 64 a
//     warpgroup) by 256 weight rows (wq, N = 256), the blocks ordered in
//     bands of 16 token tiles so that those in flight share a few weight
//     tiles, which then stay in L2 while the output streams through it
//     (with the paired epilogue stores: 1.17 -> 0.90 ms at the gate+up on
//     an H100 80GB HBM3, where every token tile walking all the weight
//     tiles had them evicted). At M <= 64 the roles
//     swap (`plan_qx` in ops/int8_matmul.py): 128 weight rows by 8 or 64
//     tokens, so N/128 blocks stream the weights. TMA zero-fills rows past M
//     or N and K past its end (K % 128 != 0), which add nothing to the
//     sums. The epilogue (float(acc) * xs[m]) * ws[n], each product rounded
//     once (__fmul_rn), then once to the output type, is staged in the spent
//     ring in the TMA box layout and written by TMA stores, which clip rows
//     past M and N.
// Pass 2 alone (`seedvr2::s8_gemm`) takes any int8 xq with its row scales:
// K3's entry calls it on the w8a8 lane's pre-quantized rows.
// Requirements (checked by the wrapper): K % 32 == 0, N % 8 == 0, x and wq
// 16-byte aligned.

namespace qx {

using namespace seedvr2::sm90;

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ uint32_t quant_byte(float v, float inv, int shift) {
  const float r = fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.f), 127.f);
  return (uint32_t(int(r)) & 0xffu) << shift;
}

constexpr int QTHREADS = 128;  // threads a row in the quantize pass
constexpr int QCHUNKS = 8;     // 16-byte chunks a thread keeps in registers

// One 16-byte chunk of x (4 fp32 or 8 bf16 values) quantized with the
// reciprocal inv: 4 or 8 bytes, the first four in .x.
template <typename T>
__device__ __forceinline__ uint2 quant_chunk(const uint4& v, float inv) {
  const T* e = reinterpret_cast<const T*>(&v);
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < int(16 / sizeof(T)); ++j)
    w[j / 4] |= quant_byte(to_float(e[j]), inv, 8 * (j % 4));
  return make_uint2(w[0], w[1]);
}

template <typename T>
__device__ __forceinline__ float chunk_amax(const uint4& v, float amax) {
  const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
  for (int i = 0; i < int(16 / sizeof(T)); ++i)
    amax = fmaxf(amax, fabsf(to_float(e[i])));
  return amax;
}

// Pass 1: one block of 128 threads a row, each holding up to 8 of the
// row's 16-byte chunks in registers (all of a bf16 row of K <= 8192), so x
// is read from device memory once: the amax (warp shuffles, then across
// the four warps), xs = max(amax, 1e-8) * (1/127), then q = clip(rint(x *
// fdiv_rn(1, xs))) from the registers (a longer row reads its remainder
// again), 4 or 8 bytes a chunk.
template <typename T>
__global__ void __launch_bounds__(QTHREADS)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ xq,
                     float* __restrict__ xs, int K) {
  constexpr int EPC = 16 / sizeof(T);
  static_assert(EPC == 4 || EPC == 8, "bf16 or fp32 activations");
  __shared__ float warp_amax[QTHREADS / 32];
  const long long row = blockIdx.x;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * K);
  const int nc = K / EPC;  // chunks in the row
  uint4 v[QCHUNKS];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < QCHUNKS; ++i) {
    const int c = threadIdx.x + i * QTHREADS;
    if (c < nc) {
      v[i] = xr[c];
      amax = chunk_amax<T>(v[i], amax);
    }
  }
  for (int c = threadIdx.x + QCHUNKS * QTHREADS; c < nc; c += QTHREADS)
    amax = chunk_amax<T>(xr[c], amax);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (threadIdx.x % 32 == 0) warp_amax[threadIdx.x / 32] = amax;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < QTHREADS / 32; ++w) amax = fmaxf(amax, warp_amax[w]);
  const float s =
      __fmul_rn(fmaxf(amax, 1e-8f), static_cast<float>(1.0 / 127.0));
  if (threadIdx.x == 0) xs[row] = s;
  const float inv = __fdiv_rn(1.f, s);
  int8_t* qr = xq + row * K;
  auto put_q = [&](int c, const uint4& chunk) {
    const uint2 q = quant_chunk<T>(chunk, inv);
    if constexpr (EPC == 8)
      *reinterpret_cast<uint2*>(qr + c * 8) = q;
    else
      *reinterpret_cast<uint32_t*>(qr + c * 4) = q.x;
  };
#pragma unroll
  for (int i = 0; i < QCHUNKS; ++i) {
    const int c = threadIdx.x + i * QTHREADS;
    if (c < nc) put_q(c, v[i]);
  }
  for (int c = threadIdx.x + QCHUNKS * QTHREADS; c < nc; c += QTHREADS)
    put_q(c, xr[c]);
}

constexpr int BK = 128;                        // K bytes a stage
constexpr int CONSUMERS = 2;                   // warpgroups of 64 A rows
constexpr int THREADS = CONSUMERS * 128 + 32;  // + one producer warp
constexpr int A_ROWS = CONSUMERS * 64;         // A rows a block
constexpr uint32_t A_BYTES = A_ROWS * BK;
constexpr int BAND = 16;                       // A tiles a band of blocks

// BN: the B rows a block (wgmma's N): 256 weight rows, or 8 / 64 tokens
// when the roles swap.
template <int BN>
struct Cfg {
  static constexpr uint32_t STAGE = A_BYTES + BN * BK;  // 1024-byte multiple
  static constexpr int STAGES = BN == 256 ? 4 : 8;
  static constexpr size_t SMEM =
      size_t(STAGES) * STAGE + 2 * STAGES * 8 + 1024;
  static_assert(SMEM <= 232448, "shared memory");
};

__device__ __forceinline__ void put(unsigned char* p, float v) {
  *reinterpret_cast<float*>(p) = v;
}
__device__ __forceinline__ void put_bf16(unsigned char* p, float v) {
  *reinterpret_cast<__nv_bfloat16*>(p) = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void put2(unsigned char* p, float v0, float v1,
                                     float) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void put2(unsigned char* p, float v0, float v1,
                                     __nv_bfloat16) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// Accumulator layout of a wgmma m64nBN tile (mma.sync's m16n8 C layout per
// warp): thread (warp w, lane 4g + t) holds, for each 8-column block i,
// d[4i], d[4i+1] at A row 16w + g, B columns 8i + 2t, 8i + 2t + 1, and
// d[4i+2], d[4i+3] at A row 16w + g + 8.
//
// grid: one block a (128 A rows, BN B rows) tile, in bands of BAND A tiles:
// consecutive blocks take the band's A tiles, then its next B tile, so the
// blocks in flight share a few B tiles (the weights at the video rows) in
// L2 instead of streaming all of them past every A tile. SWAP = false: A =
// xq (tokens), B = wq; SWAP = true: A = wq, B = xq. out (M, N), bf16 or
// fp32 (OutT).
template <int BN, bool SWAP, typename OutT>
__global__ void __launch_bounds__(THREADS, 1)
s8_gemm_kernel(const __grid_constant__ CUtensorMap tm_a,
               const __grid_constant__ CUtensorMap tm_b,
               const __grid_constant__ CUtensorMap tm_o,
               const float* __restrict__ xs, const float* __restrict__ ws,
               int M, int N, int K) {
  using C = Cfg<BN>;
  constexpr int NA = BN / 2;              // accumulator registers a thread
  constexpr int NB = 128 / sizeof(OutT);  // output columns a box row
  constexpr int ROWS = SWAP ? BN : 64;    // output rows (tokens) a warpgroup
  constexpr int COLS = SWAP ? 64 : BN;    // output columns a warpgroup
  constexpr uint32_t BOX = ROWS * 128;    // one output box, 1024-byte multiple
  static_assert(CONSUMERS * (COLS / NB) * BOX <= C::STAGES * C::STAGE,
                "the epilogue's staging fits in the ring");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t full = base + C::STAGES * C::STAGE;
  const uint32_t empty = full + 8 * C::STAGES;

  const int a_tiles = ((SWAP ? N : M) + A_ROWS - 1) / A_ROWS;
  const int b_tiles = ((SWAP ? M : N) + BN - 1) / BN;
  const int band = blockIdx.x / (BAND * b_tiles);
  const int in_band = min(a_tiles - band * BAND, BAND);  // A tiles of it
  const int r = blockIdx.x - band * BAND * b_tiles;
  const int a0 = (band * BAND + r % in_band) * A_ROWS;  // first A row
  const int b0 = (r / in_band) * BN;                    // first B row
  const int n_st = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // producer: one thread keeps the ring full
    if (threadIdx.x == CONSUMERS * 128) {
      for (int j = 0; j < n_st; ++j) {
        const int s = j % C::STAGES;
        const uint32_t st = base + s * C::STAGE, bar = full + 8 * s;
        mbar_wait(empty + 8 * s, ((j / C::STAGES) & 1) ^ 1);
        mbar_expect_tx(bar, C::STAGE);
        tma_load_2d(st, &tm_a, bar, j * BK, a0);
        tma_load_2d(st + A_BYTES, &tm_b, bar, j * BK, b0);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns A rows a0 + 64 wg .. + 63
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  uint32_t acc[NA];  // the first product overwrites it (scale-d 0)

  // Stage j's four k32 products are issued before stage j - 1, whose
  // products have then landed, is handed back to the producer.
  for (int j = 0; j < n_st; ++j) {
    const int s = j % C::STAGES;
    const uint32_t st = base + s * C::STAGE;
    mbar_wait(full + 8 * s, (j / C::STAGES) & 1);
    reg_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk)
      wgmma_s8(acc, sw128_desc(st + wg * 64 * 128 + kk * 32, 16, 1024),
               sw128_desc(st + A_BYTES + kk * 32, 16, 1024), j > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    reg_fence(acc);
    if (j > 0) mbar_arrive(empty + 8 * ((j - 1) % C::STAGES));
  }
  wgmma_wait<0>();
  reg_fence(acc);

  // epilogue: every consumer is past the ring, so it holds the staging.
  // Warpgroup wg's output is COLS / NB TMA boxes of ROWS rows (tokens) by
  // 128 bytes (NB columns), 128-byte swizzle: 16-byte chunk c of row r at c
  // ^ (r % 8).
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS * 128) : "memory");
  const uint32_t box0 = base + wg * (COLS / NB) * BOX;
  unsigned char* stage = smem_raw + (box0 - raw);
  const int r0 = warp * 16 + g;  // this thread's A rows r0, r0 + 8
  float sa[2];                   // their scales: xs, or ws when SWAP
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int ra = a0 + wg * 64 + r0 + 8 * h;
    sa[h] = SWAP ? (ra < N ? ws[ra] : 0.f) : (ra < M ? xs[ra] : 0.f);
  }
  // byte offset of output (row, col) of the warpgroup's boxes
  auto box_off = [](int row, int col) {
    const uint32_t byte = (col % NB) * sizeof(OutT);
    return (col / NB) * BOX + row * 128 +
           ((((byte >> 4) ^ (row & 7)) << 4) | (byte & 15));
  };
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int cb = 8 * i + 2 * t;  // this thread's B columns cb, cb + 1
    float sb[2];                   // their scales: ws, or xs when SWAP
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int gb = b0 + cb + e;
      sb[e] = SWAP ? (gb < M ? xs[gb] : 0.f) : (gb < N ? ws[gb] : 0.f);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float f = __int2float_rn(int(acc[4 * i + 2 * h + e]));
        // (acc * xs[m]) * ws[n], the plain version's order
        v[e] = SWAP ? __fmul_rn(__fmul_rn(f, sb[e]), sa[h])
                    : __fmul_rn(__fmul_rn(f, sa[h]), sb[e]);
      }
      const int ra = r0 + 8 * h;
      if constexpr (SWAP) {  // two token rows of output column ra
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if constexpr (sizeof(OutT) == 4)
            put(stage + box_off(cb + e, ra), v[e]);
          else
            put_bf16(stage + box_off(cb + e, ra), v[e]);
        }
      } else {  // two adjacent columns of token row ra: one store
        put2(stage + box_off(ra, cb), v[0], v[1], OutT());
      }
    }
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync %0, 128;" ::"r"(2 + wg) : "memory");
  if (tid == 0) {
    const int n_base = SWAP ? a0 + wg * 64 : b0;
    const int m_base = SWAP ? b0 : a0 + wg * 64;
#pragma unroll
    for (int p = 0; p < COLS / NB; ++p)
      tma_store(&tm_o, box0 + p * BOX, n_base + p * NB, m_base, 0);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

template <typename T>
cudaError_t launch_quantize(const void* x, void* xq, void* xs, int M, int K,
                            cudaStream_t stream) {
  quantize_rows_kernel<T><<<unsigned(M), QTHREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(xq),
      static_cast<float*>(xs), K);
  return cudaGetLastError();
}

template <int BN, bool SWAP, typename OutT>
cudaError_t launch_gemm(const CUtensorMap& ta, const CUtensorMap& tb,
                        const CUtensorMap& to, const float* xs,
                        const float* ws, int M, int N, int K,
                        cudaStream_t stream) {
  using C = Cfg<BN>;
  const long long tiles =
      (long long)(((SWAP ? N : M) + A_ROWS - 1) / A_ROWS) *
      (((SWAP ? M : N) + BN - 1) / BN);
  if (tiles > 0x7fffffffll) return cudaErrorInvalidValue;
  const unsigned grid = unsigned(tiles);
  const cudaError_t e = cudaFuncSetAttribute(
      s8_gemm_kernel<BN, SWAP, OutT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::SMEM));
  if (e != cudaSuccess) return e;
  s8_gemm_kernel<BN, SWAP, OutT><<<grid, THREADS, C::SMEM, stream>>>(
      ta, tb, to, xs, ws, M, N, K);
  return cudaGetLastError();
}

// The tensor maps of xq (M, K), wq (N, K) (int8, boxes of 128 bytes of K by
// the block's rows) and out (M, N) (boxes of 128 bytes of columns by a
// warpgroup's token rows), then the launch of the planned tiles.
template <typename OutT>
cudaError_t gemm(const void* xq, const void* wq, const float* xs,
                 const float* ws, void* out, int M, int N, int K, bool swap,
                 int bt, cudaStream_t stream) {
  constexpr CUtensorMapDataType OT = sizeof(OutT) == 4
                                         ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (swap ? (bt != 8 && bt != 64) || M > bt : bt != 256)
    return cudaErrorInvalidValue;
  const uint64_t out_row = uint64_t(N) * sizeof(OutT);
  CUtensorMap tx, tw, to;
  if (!make_map_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_UINT8, xq, K, M, K, BK,
                   swap ? bt : A_ROWS, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, wq, K, N, K, BK,
                   swap ? A_ROWS : bt, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map_3d(&to, OT, out, N, M, 1, out_row, out_row * M,
                   128 / sizeof(OutT), swap ? bt : 64,
                   CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  if (!swap)
    return launch_gemm<256, false, OutT>(tx, tw, to, xs, ws, M, N, K, stream);
  if (bt == 64)
    return launch_gemm<64, true, OutT>(tw, tx, to, xs, ws, M, N, K, stream);
  return launch_gemm<8, true, OutT>(tw, tx, to, xs, ws, M, N, K, stream);
}

}  // namespace qx

}  // namespace

namespace seedvr2 {

// out (M, N) = (float(xq wq^T) * xs[m]) * ws[n], rounded once to bf16
// (out_f32 false) or fp32: xq (M, K) and wq (N, K) int8, xs (M,) and ws (N,)
// fp32, all contiguous, xq and wq 16-byte aligned, K % 32 == 0, N % 8 == 0.
// swap / bt: the tiles ops/int8_matmul.py `plan_qx` picks (false / 256, or
// true / 8 or 64 with M <= bt).
cudaError_t s8_gemm(const void* xq, const void* wq, const float* xs,
                    const float* ws, void* out, int M, int N, int K,
                    bool out_f32, bool swap, int bt, cudaStream_t stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  if (K <= 0 || K % 32 || N % 8) return cudaErrorInvalidValue;
  return out_f32 ? qx::gemm<float>(xq, wq, xs, ws, out, M, N, K, swap, bt,
                                   stream)
                 : qx::gemm<__nv_bfloat16>(xq, wq, xs, ws, out, M, N, K,
                                           swap, bt, stream);
}

}  // namespace seedvr2

// xq: (M, K) int8, wq: (N, K) int8, xs: (M,) fp32, ws: (N,) fp32, out:
// (M, N) bf16 (out_f32 = 0) or fp32; all contiguous and 16-byte aligned,
// K % 32 == 0, N % 8 == 0, swap / bt from `plan_qx`; checked by the Python
// wrapper (seedvr2_tpu_torch/ops/int8_matmul.py). Launches the s8 GEMM.
extern "C" int seedvr2_int8_matmul(const void* xq, const void* wq,
                                   const void* xs, const void* ws, void* out,
                                   int M, int N, int K, int out_f32, int swap,
                                   int bt, void* stream) {
  return int(seedvr2::s8_gemm(xq, wq, static_cast<const float*>(xs),
                              static_cast<const float*>(ws), out, M, N, K,
                              out_f32 != 0, swap != 0, bt,
                              static_cast<cudaStream_t>(stream)));
}

// x: (M, K) bf16 (x_f32 = 0) or fp32 (x_f32 = 1), wq: (N, K) int8, ws: (N,)
// fp32, xs: (M,) fp32 and xq: (M, K) int8 scratch that receive the row
// scales and the quantized rows, out: (M, N) bf16 (out_f32 = 0) or fp32; all
// contiguous and 16-byte aligned, K % 32 == 0, N % 8 == 0; swap / bt from
// `plan_qx`. Checked by the Python wrapper. Launches the quantize pass,
// then the s8 GEMM.
extern "C" int seedvr2_int8_matmul_qx(const void* x, const void* wq,
                                      const void* ws, void* xs, void* xq,
                                      void* out, int M, int N, int K,
                                      int x_f32, int out_f32, int swap,
                                      int bt, void* stream) {
  if (M == 0 || N == 0) return int(cudaSuccess);
  if (K <= 0 || K % 32 || N % 8) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      x_f32 ? qx::launch_quantize<float>(x, xq, xs, M, K, st)
            : qx::launch_quantize<__nv_bfloat16>(x, xq, xs, M, K, st);
  if (err != cudaSuccess) return int(err);
  return int(seedvr2::s8_gemm(xq, wq, static_cast<const float*>(xs),
                              static_cast<const float*>(ws), out, M, N, K,
                              out_f32 != 0, swap != 0, bt, st));
}
