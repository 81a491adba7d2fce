// int8 3x3x3 convolution of the VAE's --vae_quant int8 lane (kernel K11 of
// the port), an implicit GEMM on Hopper's TMA and `wgmma` (helpers in
// sm90.cuh).
//
// Replaces: the Pallas TPU kernel `_conv_kernel` behind `int8_conv3d`
// (comfyui-seedvr2_tpu/ops/int8_conv.py).
//
// Computes, for output frame t, row h, column w < W_out and channel co,
//   s   = float(sum_{dt,dh,dw,c} x[t+dt, h+dh, w+dw, c]
//                 * wk[co, ((dt*3 + dh)*3 + dw)*C + c])
//   out = bf16(s * (xs[t] * ws[co]))
// and, with a bias, bf16(float(out) + float(bias[co])): the bf16 add the VAE
// makes after the conv, folded into the store. x is x_ext (T+2, H+2, Wp, C)
// int8 channels-last (the causal head frames first, one zero pixel around,
// width padded to Wp); wk is (Co, 27*C) int8, K-contiguous. The int32 sums
// are exact, converted to fp32 once and scaled in the JAX kernel's order, so
// the output equals the plain version bit for bit. The output is stored
// through element strides (co, t, h, w) the caller gives: the VAE passes its
// NCDHW layout, the public JAX-layout function (T, H, W, Co).
//
// What bounds it on an H100: operations. At the 720p clip's last decoder
// stage (T = 5, 720 x 1280, C = Co = 128) a conv is 2*27*C*Co per pixel,
// 4.08e12 int8 ops (2.06 ms at 1979 TOP/s dense) against about 2.0 GB moved
// (0.6 ms at 3.35 TB/s).
//
// Design. GEMM rows (wgmma's M) are output channels, columns (N) output
// pixels, K = 27*C walked as the nine (dt, dh) rows of the window times C in
// 64-channel chunks, each stage serving the three dw taps.
//  - Pixels. A frame's output positions are numbered p = h*Wp + w over the
//    padded width, so x_ext[t+dt, h+dh, w+dw] is row p + dh*Wp + dw of the
//    frame's (H+2)*Wp rows: a tile takes 256 consecutive positions, the rows
//    of h it spans included, and the (dt, dh) strip of 258 rows serves all
//    three dw taps. The positions at w >= W_out are computed and not stored:
//    2.4 % of the work at 720 x 1280 (Wp = 1312), 17 % at 90 x 160 (Wp =
//    192), where 128-pixel tiles along w alone idle 37.5 %. `plan_conv`
//    (ops/int8_conv.py) counts the tiles.
//  - Loads. One producer warp keeps a ring of 4 mbarrier-guarded stages
//    full with TMA loads: the strip as boxes of 256 and 8 rows by 64
//    channels (64-byte swizzle) through a 3-D map over x_ext, and the three
//    dw taps' weights as 128-row boxes of 64 bytes of K (64-byte swizzle)
//    through a 2-D map over wk. Channels past C, rows past the frame and
//    output channels past Co are zero-filled.
//  - One strip for three taps. The swizzle is a function of the shared
//    address's bits, so a descriptor of the strip may start at row dw, 64
//    or 128 bytes into a 512-byte swizzle atom, with the base-offset field
//    0: the taps read one strip (bit-equal on the card; setting the field
//    to (addr >> 7) & 7 gave wrong sums). Two layouts measured slower at
//    the record shape in development builds: a strip without swizzle,
//    written by TMA in 16-byte rows (dims (16 channels, row, C/16, frame))
//    so that a descriptor could start at any row (many small TMA
//    requests), and three 64-byte-swizzled boxes at w0, w0+1, w0+2 (three
//    times the strip's bytes). So was N = 128 against N = 256, within
//    noise, and a persistent grid storing from the registers.
//  - Products. Two consumer warpgroups, 64 output channels each, issue
//    `wgmma.mma_async.m64n256k32.s32.s8.s8` over the tile's 256 pixels: per
//    stage 2 k32 steps x 3 taps, int32 accumulators in registers (128 a
//    thread), one stage's products in flight while the stage before is
//    handed back to the producer.
//  - Bytes. A stage reads 16.9 KB of strip and 24.6 KB of weights from L2
//    for 2*256*128*192 = 12.6 M operations: 13.8 GB at the record shape
//    (18 stages in each of 18450 tiles), below the tensor bound at ~8 TB/s.
//  - Bank conflicts. wgmma reads 64-byte-swizzled atoms (conflict-free by
//    the swizzle); the epilogue's staging rows are padded by 16 bytes, so
//    a warp's pair stores fall in 32 distinct banks and its 16-byte reads
//    are contiguous.
//  - Epilogue. Persistent blocks, one an SM: while a warpgroup scales,
//    rounds (with the bias) and stores a tile, the producer already loads
//    the next tile's stages. Each warpgroup stages half a tile at a time
//    (64 channels x 128 pixels, bf16) in its own rows, then stores it along
//    w: 16-byte stores of 8 pixels where the output row allows it (unit w
//    stride, 16-byte aligned, all 8 stored), elsewhere one element a
//    thread; other strides (the JAX layout) store one element a thread
//    along co. Output and x_ext offsets are 64-bit (a 4K decoder stage
//    holds more than 2^31 bytes).
// Requirements (checked by the wrapper): C % 16 == 0, Co % 8 == 0, T and H
// <= 65535, W_out <= Wp - 2, x_ext and wk 16-byte aligned.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace seedvr2::sm90;

constexpr int PIX = 256;                       // output positions a tile
constexpr int HALF = 128;                      // positions a staged half
constexpr int CK = 64;                         // channels a stage
constexpr int CO_T = 128;                      // output channels a tile
constexpr int CONSUMERS = 2;                   // warpgroups of 64 channels
constexpr int THREADS = CONSUMERS * 128 + 32;  // + one producer warp
constexpr uint32_t X_ROWS = PIX + 8;           // strip rows: two boxes
constexpr uint32_t X_REGION = X_ROWS * CK;     // 16896, 512-aligned boxes
constexpr uint32_t W_TAP = CO_T * CK;          // one dw tap's weight box
constexpr uint32_t STAGE = (X_REGION + 3 * W_TAP + 1023) / 1024 * 1024;
constexpr uint32_t STAGE_TX = X_REGION + 3 * W_TAP;  // bytes TMA brings
constexpr int STAGES = 4;
constexpr uint32_t SROW = HALF * 2 + 16;       // staging row, bytes
constexpr uint32_t SWG = 64 * SROW;            // a warpgroup's staging
constexpr size_t SMEM =
    size_t(STAGES) * STAGE + CONSUMERS * SWG + 2 * STAGES * 8 + 1024;
static_assert(SMEM <= 232448, "shared memory");
static_assert(X_REGION % 512 == 0 && PIX * CK % 512 == 0, "swizzle atoms");

// grid = min(tiles, SMs); block b takes tiles b, b + grid, ... (tile =
// (frame * pix_tiles + pixel tile) * co_tiles + co tile, co tiles fastest so
// the blocks that share a strip run together). The ring's stage count runs
// on across tiles, so the producer fills the next tile's stages while the
// consumers store the last one's outputs.
__global__ void __launch_bounds__(THREADS, 1)
int8_conv3d_kernel(const __grid_constant__ CUtensorMap tm_x,
                   const __grid_constant__ CUtensorMap tm_xh,
                   const __grid_constant__ CUtensorMap tm_w,
                   const float* __restrict__ xs, const float* __restrict__ ws,
                   const __nv_bfloat16* __restrict__ bias,
                   __nv_bfloat16* __restrict__ out, int H, int Wp, int C,
                   int Co, int W_out, int pix_tiles, int co_tiles, int T,
                   long long sc, long long st, long long sh, long long sw) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t full = base + STAGES * STAGE + CONSUMERS * SWG;
  const uint32_t empty = full + 8 * STAGES;
  const int tiles = T * pix_tiles * co_tiles;
  const int nck = (C + CK - 1) / CK;
  const int n_st = 9 * nck;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // producer: one thread keeps the ring full, tile after tile
    if (threadIdx.x == CONSUMERS * 128) {
      int it = 0;  // stages filled so far
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int co0 = (tile % co_tiles) * CO_T;
        const int rest = tile / co_tiles;
        const int p0 = (rest % pix_tiles) * PIX, t = rest / pix_tiles;
        for (int j = 0; j < n_st; ++j, ++it) {
          const int s = it % STAGES;
          const uint32_t stg = base + s * STAGE, bar = full + 8 * s;
          const int tap9 = j / nck, c0 = (j % nck) * CK;
          const int row = p0 + (tap9 % 3) * Wp, frame = t + tap9 / 3;
          mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(bar, STAGE_TX);
          tma_load(stg, &tm_x, bar, c0, row, frame);
          tma_load(stg + PIX * CK, &tm_xh, bar, c0, row + PIX, frame);
#pragma unroll
          for (int dw = 0; dw < 3; ++dw)
            tma_load_2d(stg + X_REGION + dw * W_TAP, &tm_w, bar,
                        (tap9 * 3 + dw) * C + c0, co0);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns output channels co0 + 64 wg .. + 63
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  // pixel columns 8i + 2q, 8i + 2q + 1 in acc[4i ..], rows g, g + 8
  uint32_t acc[128];  // the first product of a tile overwrites it
  int it = 0;         // stages consumed so far
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int co0 = (tile % co_tiles) * CO_T;
    const int rest = tile / co_tiles;
    const int p0 = (rest % pix_tiles) * PIX, t = rest / pix_tiles;
    for (int j = 0; j < n_st; ++j, ++it) {
      const int s = it % STAGES;
      const uint32_t stg = base + s * STAGE;
      mbar_wait(full + 8 * s, (it / STAGES) & 1);
      reg_fence(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < CK / 32; ++kk)
#pragma unroll
        for (int dw = 0; dw < 3; ++dw)
          // the strip from row dw: the swizzle follows the address bits,
          // so a descriptor may start at any 64-byte row of an atom
          wgmma_s8(acc,
                   sw64_desc(stg + X_REGION + dw * W_TAP + wg * 64 * CK +
                                 kk * 32,
                             512),
                   sw64_desc(stg + dw * CK + kk * 32, 512),
                   j > 0 || kk > 0 || dw > 0);
      wgmma_commit();
      wgmma_wait<1>();
      reg_fence(acc);
      if (j > 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));
    }
    wgmma_wait<0>();
    reg_fence(acc);
    mbar_arrive(empty + 8 * ((it - 1) % STAGES));

    // epilogue: bf16(float(acc) * (xs[t] * ws[co])) [+ bias, rounded
    // again], staged a half tile (64 channels x 128 pixels) at a time in
    // this warpgroup's [co][pixel] rows, then stored along w
    const float xst = xs[t];
    float scl[2], bv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int co = co0 + wg * 64 + warp * 16 + g + 8 * r;
      scl[r] = co < Co ? __fmul_rn(xst, ws[co]) : 0.f;
      bv[r] = (bias != nullptr && co < Co) ? __bfloat162float(bias[co]) : 0.f;
    }
    unsigned char* stg_out = smem_raw + (base - raw) + STAGES * STAGE +
                             wg * SWG;
    __nv_bfloat16* frame_out = out + (long long)t * st;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      asm volatile("bar.sync %0, 128;" ::"r"(2 + wg) : "memory");
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int i = 0; i < HALF / 8; ++i) {
          __nv_bfloat16 v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            v[e] = __float2bfloat16_rn(__fmul_rn(
                __int2float_rn(int(acc[4 * (hf * HALF / 8 + i) + 2 * r + e])),
                scl[r]));
            if (bias != nullptr)
              v[e] = __float2bfloat16_rn(
                  __fadd_rn(__bfloat162float(v[e]), bv[r]));
          }
          *reinterpret_cast<__nv_bfloat162*>(
              stg_out + (warp * 16 + g + 8 * r) * SROW + (8 * i + 2 * q) * 2) =
              __halves2bfloat162(v[0], v[1]);
        }
      asm volatile("bar.sync %0, 128;" ::"r"(2 + wg) : "memory");
      const int pb = p0 + hf * HALF;
      if (sw == 1) {  // a thread 8 pixels, 16 threads a channel's 128
        for (int idx = tid; idx < 64 * (HALF / 8); idx += 128) {
          const int cl = idx / (HALF / 8), pp = (idx % (HALF / 8)) * 8;
          const int co = co0 + wg * 64 + cl, p = pb + pp;
          const int h = p / Wp, w = p - h * Wp;  // Wp % 8 == 0: one row
          if (co >= Co || h >= H || w >= W_out) continue;
          const unsigned char* src = stg_out + cl * SROW + pp * 2;
          __nv_bfloat16* dst =
              frame_out + (long long)co * sc + (long long)h * sh + w;
          if (w + 8 <= W_out && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
            *reinterpret_cast<uint4*>(dst) =
                *reinterpret_cast<const uint4*>(src);
          } else {
            for (int e = 0; e < 8 && w + e < W_out; ++e)
              dst[e] = reinterpret_cast<const __nv_bfloat16*>(src)[e];
          }
        }
      } else {  // any other strides: one element a thread, along co
        for (int idx = tid; idx < 64 * HALF; idx += 128) {
          const int cl = idx % 64, p = pb + idx / 64;
          const int co = co0 + wg * 64 + cl, h = p / Wp, w = p - h * Wp;
          if (co >= Co || h >= H || w >= W_out) continue;
          frame_out[(long long)co * sc + (long long)h * sh +
                    (long long)w * sw] =
              *reinterpret_cast<const __nv_bfloat16*>(stg_out + cl * SROW +
                                                      (p - pb) * 2);
        }
      }
    }
  }
}

}  // namespace

// x: (T+2, H+2, Wp, C) int8, wk: (Co, 27*C) int8, xs: (T,) fp32, ws: (Co,)
// fp32, bias: (Co,) bf16 or null; out: bf16 addressed by the element strides
// sc, st, sh, sw of (co, t, h, w), w < W_out <= Wp - 2. pix_tiles and
// co_tiles: the tiles `plan_conv` counts (256 positions: a frame's
// ceil(H*Wp / 256); 128 channels: ceil(Co / 128)). Inputs contiguous and
// 16-byte aligned, C % 16 == 0, Wp % 8 == 0, T and H <= 65535: checked by
// the Python wrapper (seedvr2_tpu_torch/ops/int8_conv.py).
extern "C" int seedvr2_int8_conv3d(const void* x, const void* wk,
                                   const void* xs, const void* ws,
                                   const void* bias, void* out, int T, int H,
                                   int Wp, int C, int Co, int W_out,
                                   long long sc, long long st, long long sh,
                                   long long sw, int pix_tiles, int co_tiles,
                                   void* stream) {
  if (T == 0 || H == 0 || W_out <= 0 || Co == 0) return int(cudaSuccess);
  if (T > 65535 || H > 65535 || W_out > Wp - 2 || C <= 0 || C % 16 ||
      Wp % 8 || (long long)pix_tiles * PIX < (long long)H * Wp ||
      (long long)(pix_tiles - 1) * PIX >= (long long)H * Wp ||
      (long long)co_tiles * CO_T < Co || (co_tiles - 1) * CO_T >= Co)
    return int(cudaErrorInvalidValue);
  const long long tiles = (long long)T * pix_tiles * co_tiles;
  if (tiles > 0x7fffffffll) return int(cudaErrorInvalidValue);
  const uint64_t rows = uint64_t(H + 2) * Wp;
  // x_ext as (channel, row, frame): boxes of 64 channels by 256 and 8 rows
  CUtensorMap tx, txh, tw;
  if (!make_map_3d(&tx, CU_TENSOR_MAP_DATA_TYPE_UINT8, x, C, rows, T + 2, C,
                   rows * C, CK, PIX, CU_TENSOR_MAP_SWIZZLE_64B) ||
      !make_map_3d(&txh, CU_TENSOR_MAP_DATA_TYPE_UINT8, x, C, rows, T + 2, C,
                   rows * C, CK, X_ROWS - PIX, CU_TENSOR_MAP_SWIZZLE_64B) ||
      !make_map_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, wk, 27ull * C, Co,
                   27ull * C, CK, CO_T, CU_TENSOR_MAP_SWIZZLE_64B))
    return int(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(int8_conv3d_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(SMEM));
  if (err != cudaSuccess) return int(err);
  int8_conv3d_kernel<<<unsigned(tiles < sms ? tiles : sms), THREADS, SMEM,
                       static_cast<cudaStream_t>(stream)>>>(
      tx, txh, tw, static_cast<const float*>(xs),
      static_cast<const float*>(ws), static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(out), H, Wp, C, Co, W_out, pix_tiles,
      co_tiles, T, sc, st, sh, sw);
  return int(cudaGetLastError());
}
