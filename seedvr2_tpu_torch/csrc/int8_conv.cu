// int8 3x3x3 convolution of the VAE's --vae_quant int8 lane (kernel K11 of
// the port).
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
// Design, a right and simple first version: an implicit GEMM. A block owns
// 128 output pixels along w of one (t, h) and 128 output channels; 8 warps of
// 64 x 32 keep int32 accumulators in registers. K = 27*C is walked as the
// nine (dt, dh) rows of the window times C in 64-byte chunks: each stage
// loads, with `cp.async` (2 stages), the (128 + 2) x 64 strip of x that the
// three dw taps share and the three taps' 128 x 64 weight chunks. A dw tap is
// a row offset of 0, 1 or 2 into the strip, so x is read once per (dt, dh),
// not three times (the TPU body's lane concatenation and sublane rolls are
// layout tricks of the TPU and are not carried over). Products by
// `mma.sync.aligned.m16n8k32` s8 x s8 -> s32 as in K3; smem rows padded from
// 64 to 80 bytes so that the fragment loads fall in distinct banks. Columns
// past Wp and channels past C or Co are zero-filled on load. The epilogue
// writes the bf16 tile to shared memory and stores it along whichever of w
// and co has unit stride, so NCDHW stores are coalesced. Offsets into x and
// the output are 64-bit (a 4K decoder stage holds more than 2^31 bytes). No
// TMA, no wgmma: those are for the PRs that make it fast.

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
constexpr int AROWS = BM + 2;                    // strip rows: 2 halo columns
constexpr int A_BYTES = AROWS * SROW;
constexpr int B_BYTES = 3 * BN * SROW;           // the three dw taps
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;   // 41120, a multiple of 16
constexpr int STAGES = 2;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;
constexpr int OROW = BM + 8;                     // epilogue tile row, bf16
static_assert(BN * OROW * 2 <= SMEM_BYTES, "epilogue tile fits");
static_assert(STAGE_BYTES % 16 == 0, "stages stay 16-byte aligned");

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

// D(16x8, s32) += A(16x32, s8, row) * B(32x8, s8, col); fragments as in K3
// (csrc/int8_matmul.cu).
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// One stage: the x strip x[row, w0 .. w0+BM+2, c0 .. c0+BK] (`xrow` points at
// x[t+dt, h+dh, 0, 0]) and the weight chunks wk[n0 .. n0+BN, tap*C + c0 ..]
// of the three dw taps of this (dt, dh) (`wtap` = wk + (dt*3+dh)*3*C).
__device__ __forceinline__ void load_stage(int8_t* stage,
                                           const int8_t* __restrict__ xrow,
                                           const int8_t* __restrict__ wtap,
                                           int w0, int Wp, int C, int c0,
                                           int n0, int Co, long long K) {
  int8_t* As = stage;
  int8_t* Bs = stage + A_BYTES;
  constexpr int KC = BK / 16;
  for (int i = threadIdx.x; i < AROWS * KC; i += THREADS) {
    const int r = i / KC, kc = (i % KC) * 16;
    const bool valid = w0 + r < Wp && c0 + kc < C;
    const int8_t* g = valid ? xrow + (long long)(w0 + r) * C + c0 + kc : xrow;
    cp_async16(As + r * SROW + kc, g, valid ? 16 : 0);
  }
#pragma unroll
  for (int j = 0; j < 3 * BN * KC / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int dw = i / (BN * KC), rem = i % (BN * KC);
    const int n = rem / KC, kc = (rem % KC) * 16;
    const bool valid = n0 + n < Co && c0 + kc < C;
    const int8_t* g =
        valid ? wtap + (long long)(n0 + n) * K + dw * C + c0 + kc : wtap;
    cp_async16(Bs + (dw * BN + n) * SROW + kc, g, valid ? 16 : 0);
  }
}

__global__ void __launch_bounds__(THREADS, 2)
int8_conv3d_kernel(const int8_t* __restrict__ x,
                   const int8_t* __restrict__ wk,
                   const float* __restrict__ xs, const float* __restrict__ ws,
                   const __nv_bfloat16* __restrict__ bias,
                   __nv_bfloat16* __restrict__ out, int H, int Wp, int C,
                   int Co, int W_out, long long sc, long long st,
                   long long sh, long long sw) {
  extern __shared__ __align__(16) int8_t smem[];

  const int n_tiles = (Co + BN - 1) / BN;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int w0 = (blockIdx.x / n_tiles) * BM;
  const int h = blockIdx.y, t = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane / 4, q = lane % 4;
  const long long K = 27LL * C;
  const long long frame = (long long)(H + 2) * Wp * C;
  const long long row = (long long)Wp * C;

  int acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;

  const int kchunks = (C + BK - 1) / BK;
  const int iters = 9 * kchunks;
  auto issue = [&](int it, int stage) {
    const int tap9 = it / kchunks, c0 = (it % kchunks) * BK;
    const int dt = tap9 / 3, dh = tap9 % 3;
    load_stage(smem + stage * STAGE_BYTES,
               x + (t + dt) * frame + (h + dh) * row, wk + tap9 * 3LL * C, w0,
               Wp, C, c0, n0, Co, K);
    cp_async_commit();
  };

  issue(0, 0);
  for (int it = 0; it < iters; ++it) {
    const int stage = it & 1;
    if (it + 1 < iters) {
      issue(it + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int8_t* As = smem + stage * STAGE_BYTES;
    const int8_t* Bs = As + A_BYTES;
#pragma unroll
    for (int dw = 0; dw < 3; ++dw) {
      const int8_t* a_s = As + (wm * MI * 16 + g + dw) * SROW + q * 4;
      const int8_t* b_s = Bs + (dw * BN + wn * NI * 8 + g) * SROW + q * 4;
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
          for (int j = 0; j < NI; ++j)
            mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's load
  }

  // epilogue: bf16(float(acc) * (xs[t] * ws[co])) [+ bias, rounded again]
  // into a [BN][OROW] smem tile (the stages are free after the last sync)
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem);
  const float xst = xs[t];
#pragma unroll
  for (int j = 0; j < NI; ++j) {
#pragma unroll
    for (int c2 = 0; c2 < 2; ++c2) {
      const int nl = wn * NI * 8 + j * 8 + 2 * q + c2;
      const int n = n0 + nl;
      const float s = n < Co ? __fmul_rn(xst, ws[n]) : 0.f;
      const float bv =
          (bias != nullptr && n < Co) ? __bfloat162float(bias[n]) : 0.f;
#pragma unroll
      for (int i = 0; i < MI; ++i) {
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int ml = wm * MI * 16 + i * 16 + g + 8 * h2;
          __nv_bfloat16 r = __float2bfloat16_rn(
              __fmul_rn(__int2float_rn(acc[i][j][2 * h2 + c2]), s));
          if (bias != nullptr)
            r = __float2bfloat16_rn(__fadd_rn(__bfloat162float(r), bv));
          tile[nl * OROW + ml] = r;
        }
      }
    }
  }
  __syncthreads();

  __nv_bfloat16* base = out + (long long)t * st + (long long)h * sh;
  if (sw == 1) {  // NCDHW: consecutive threads along w
    for (int idx = threadIdx.x; idx < BM * BN; idx += THREADS) {
      const int nl = idx / BM, ml = idx % BM;
      const int w = w0 + ml, n = n0 + nl;
      if (w < W_out && n < Co) base[(long long)n * sc + w] = tile[nl * OROW + ml];
    }
  } else {  // channels-last: consecutive threads along co
    for (int idx = threadIdx.x; idx < BM * BN; idx += THREADS) {
      const int ml = idx / BN, nl = idx % BN;
      const int w = w0 + ml, n = n0 + nl;
      if (w < W_out && n < Co)
        base[(long long)w * sw + (long long)n * sc] = tile[nl * OROW + ml];
    }
  }
}

}  // namespace

// x: (T+2, H+2, Wp, C) int8, wk: (Co, 27*C) int8, xs: (T,) fp32, ws: (Co,)
// fp32, bias: (Co,) bf16 or null; out: bf16 addressed by the element strides
// sc, st, sh, sw of (co, t, h, w), w < W_out <= Wp - 2. Inputs contiguous and
// 16-byte aligned, C % 16 == 0, T and H <= 65535: checked by the Python
// wrapper (seedvr2_tpu_torch/ops/int8_conv.py).
extern "C" int seedvr2_int8_conv3d(const void* x, const void* wk,
                                   const void* xs, const void* ws,
                                   const void* bias, void* out, int T, int H,
                                   int Wp, int C, int Co, int W_out,
                                   long long sc, long long st, long long sh,
                                   long long sw, void* stream) {
  if (T == 0 || H == 0 || W_out <= 0 || Co == 0) return int(cudaSuccess);
  if (T > 65535 || H > 65535 || W_out > Wp - 2)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      int8_conv3d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return int(err);
  const long long gx =
      (long long)((Co + BN - 1) / BN) * ((W_out + BM - 1) / BM);
  if (gx > 2147483647LL) return int(cudaErrorInvalidValue);
  const dim3 grid{static_cast<unsigned>(gx), static_cast<unsigned>(H),
                  static_cast<unsigned>(T)};
  int8_conv3d_kernel<<<grid, THREADS, SMEM_BYTES,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(wk),
      static_cast<const float*>(xs), static_cast<const float*>(ws),
      static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(out), H, Wp, C, Co, W_out, sc, st, sh, sw);
  return int(cudaGetLastError());
}
