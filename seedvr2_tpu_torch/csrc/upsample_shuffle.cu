// The VAE decoder's upsample as one Hopper GEMM with a pixel-shuffle
// epilogue (TMA, `wgmma`; helpers in sm90.cuh): Upsample3D's 1x1x1
// widening conv, its bias, the MAGViT pixel shuffle, a first slice's
// duplicated-frame drop and the causal head of the 3x3x3 conv that follows,
// in one launch.
//
// Replaces no TPU kernel: the JAX package lowers this step as
// `lax.conv_transpose` (or a matmul plus `_pixel_shuffle_3d`), which XLA
// compiles; there is no Pallas kernel. It takes the place of cuDNN's
// transposed conv, whose output at the 1080p clip's last upsampler passes
// 2^31 elements, so cuDNN ran its int64 direct dgrad kernel (~9 s a
// decode), and of the plain form's copies of that output (matmul output,
// its shuffle into NCDHW, the frame drop, the head concatenation).
//
// Computes, for x (B, Ci, T, H, W) bf16 (frames `frame_stride` elements
// apart, >= H*W), the conv's weight w (4*tr*C, Ci) bf16, row r = ((xi*2 +
// yi)*tr + z)*C + c, and its bias (4*tr*C,) bf16:
//   out[b, c, off + f(t, z), 2h + xi, 2w + yi]
//     = bf16(sum_ci float(w[r, ci]) * float(x[b, ci, t, h, w]) + bias[r])
// the products summed in fp32, the bias added in fp32, rounded once.
// f(t, z) = t*tr + z, but with `drop` (a first slice's temporal upsample,
// JAX's remove_head) the output frame (t, z) = (0, 1) is neither computed
// nor stored and later frames move down one. The first `off` frames of each
// channel are left for the causal head of the conv that follows; with
// `rep`, output frame 0 is stored at each of them too (a first slice's
// head: frame 0 repeated), else the caller has filled them (a later slice's
// carried tail). out is (B, C, off + T*tr - drop, 2H, 2W), contiguous.
//
// What bounds it on an H100: at the 1080p clip's last upsampler (Ci = C =
// 256, tr = 1, 5 x 540 x 960) bytes: 7.43 GB of output with the two head
// frames against 1.33 GB of x, 2.62 ms at 3.35 TB/s, over 1.36 TFLOP (1.38
// ms at 989 TFLOP/s). At the two 512-channel upsamplers (tr = 2) operations:
// 1.36 TFLOP at 270 x 480 (1.38 ms), 0.27 at 135 x 240.
//
// Design. GEMM rows (M) are the weight's rows, columns (N) x's positions p =
// h*W + w of one frame, K = Ci.
//  - Units. A block takes one unit at a time: NT consecutive positions of
//    one frame (the rows of h they span included; NT = 256 at Ci <= 256,
//    128 at Ci <= 512, so the unit's x is at most 128 KB), loaded once by
//    TMA into shared memory, then every M tile of the unit in turn: both
//    temporal phases z (the tr output frames that read the same x), every
//    64-channel block, both xi (fastest: measured 4.64 against 5.00 ms at
//    the last upsampler with the channel blocks fastest), 128 weight rows
//    a tile. x is read from
//    device memory once and from L2 not again; the weight (at most 4 MB)
//    streams from L2.
//  - Operands. A (weight) K-major: phase yi's 64 rows are one contiguous
//    block of the weight, r = ((xi*2 + yi)*tr + z)*C + c0 .., one 64-row TMA
//    box, so the weight is read as the checkpoint holds it (no permuted
//    copy). B (x) is read in place as MN-major (Ci x positions) boxes of 64
//    positions (128 bytes) by 64 channels through a 3-D map (positions,
//    frame, b*Ci + ci), 128-byte swizzle; `wgmma.m64n{NT}k16` takes B
//    transposed through its descriptor (panels 8 KB apart, 8-row groups 1
//    KB apart), so x needs no layout copy. Positions past H*W are
//    zero-filled by TMA and not stored.
//  - Loop. One producer warp loads a unit's x in 64-channel chunks, each
//    with its own barriers, and keeps a ring of weight stages (both
//    phases' 64 x 64 boxes, 16 KB) full across M tiles and units; a chunk
//    of the next unit's x is loaded as soon as the last M tile's products
//    over it are done, under that tile's remaining products and its
//    epilogue. Two consumer warpgroups, warpgroup yi phase yi's 64 rows,
//    one stage's products in flight while the stage before is handed back.
//    Persistent blocks, one an SM, walk the units in order (batch, frame,
//    position), so neighbouring blocks read neighbouring x.
//  - Epilogue. Each warpgroup adds the bias in fp32, rounds once and
//    writes its phase into one staging buffer laid out as the output rows
//    are, (p, yi) at element 2p + yi of its channel's row; behind a
//    barrier of both, one thread a channel hands the TMA engine a bulk
//    copy (`cp.async.bulk`) of each row of h its positions touch, NT * 4
//    bytes in all, to row 2h + xi of the frame and, for output frame 0
//    under `rep`, of each head frame. The consumers go on to the next
//    tile's products while the copies drain; the next staging write waits
//    only until they have read the buffer. Where W % 4 != 0 a row's
//    bytes are not whole 16-byte pieces: then each thread stores (yi = 0,
//    yi = 1) pairs, 4 bytes at a time. Offsets are 64-bit (the output
//    passes 2^31 elements).
//  - Earlier designs, on an H100 80GB HBM3 at 700 W, at the 1080p clip's
//    three upsamplers (ms): 128 x 256 tiles streaming x and the weight, a
//    3-stage ring, each warpgroup's phase staged apart and interleaved by
//    byte permutes into 16-byte thread stores: 0.65 / 3.92 / 5.91; the
//    same in 4 stages staging 64 positions at a time behind 8 barriers a
//    tile: 0.76 / 4.30 / 7.05; each warpgroup 128 positions in both phases
//    (so the phases meet in registers) stored 8 bytes a thread from the
//    registers, 8 channels' 32-byte pieces a warp store: 0.86 / 4.95 /
//    9.40; x resident as here with the 16-byte thread stores: 0.60 / 3.77
//    / 5.98 (the thread stores alone, no products: 0.50 / 3.12 / 4.21, so
//    the stores, not L2, set the pace; the bulk copies alone 0.74 / 3.62 /
//    4.46, but they leave the consumers free).
// Requirements (checked by the Python wrapper, ops/upsample.py, and here):
// Ci % 64 == 0, Ci <= 512, C % 64 == 0, tr in {1, 2}, drop only with tr =
// 2, frame_stride % 8 == 0 (16-byte TMA strides), x and w 16-byte aligned.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace seedvr2::sm90;

constexpr int PANEL = 64;                      // positions a box (128 B)
constexpr int CK = 64;                         // input channels a chunk
constexpr int CB = 64;                         // output channels a tile
constexpr int CONSUMERS = 2;                   // warpgroup yi: phase yi
constexpr int THREADS = CONSUMERS * 128 + 32;  // + one producer warp
constexpr uint32_t BOX = 64 * 128;             // one 64 x 64 bf16 box
constexpr uint32_t A_STAGE = CONSUMERS * BOX;  // both phases' rows
constexpr uint32_t X_BYTES = 128 * 1024;       // a unit's x, at most

// NT positions a unit; AST weight stages; a staging row holds a channel's
// NT positions in both phases, padded by 16 bytes (a warp's 2-byte stores
// then meet at most two to a bank)
template <int NT>
struct Cfg {
  static constexpr int KC = X_BYTES / (NT * 2 * CK);  // x chunks, at most
  static constexpr int AST = NT == 256 ? 2 : 3;
  static constexpr uint32_t SROW = NT * 4 + 16;
  static constexpr uint32_t STAGING = CB * SROW;
  static constexpr uint32_t CHUNK = NT / PANEL * BOX;
  static constexpr size_t SMEM = X_BYTES + size_t(AST) * A_STAGE +
                                 STAGING + 8 * (2 * KC + 2 * AST) +
                                 1024;
  static_assert(SMEM <= 232448, "shared memory");
  static_assert(STAGING % 16 == 0 && X_BYTES % 1024 == 0, "alignment");
};

// bytes (a multiple of 16) from shared address src to global dst (both
// 16-byte aligned) by the TMA engine, in this thread's bulk group
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst), "r"(src), "r"(bytes)
               : "memory");
}

// M tile m of a unit as (z, channel block, xi), the last fastest, so a
// channel's rows 2h and 2h + 1 are written one after the other; a unit of
// input frame 0 under `drop` has the one phase z = 0.
__device__ __forceinline__ void m_tile(int m, int cblks, int& z, int& xi,
                                       int& cb) {
  xi = m & 1;
  cb = (m / 2) % cblks;
  z = m / (2 * cblks);
}

template <int NT>
__global__ void __launch_bounds__(THREADS, 1)
upsample_shuffle_kernel(const __grid_constant__ CUtensorMap tm_x,
                        const __grid_constant__ CUtensorMap tm_w,
                        const __nv_bfloat16* __restrict__ bias,
                        __nv_bfloat16* __restrict__ out, int Ci, int C,
                        int T, int H, int W, int tr, int drop, int off,
                        int rep, int Tout, int ptiles, int units) {
  using G = Cfg<NT>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t xs = base;                          // the unit's x
  const uint32_t as = base + X_BYTES;                // weight stages
  const uint32_t ss = as + G::AST * A_STAGE;         // staging
  const uint32_t x_full = ss + G::STAGING;           // barriers
  const uint32_t x_empty = x_full + 8 * G::KC;
  const uint32_t a_full = x_empty + 8 * G::KC;
  const uint32_t a_empty = a_full + 8 * G::AST;
  const int cblks = C / CB, kc = Ci / CK;

  if (threadIdx.x == 0) {
    for (int k = 0; k < G::KC; ++k) {
      mbar_init(x_full + 8 * k, 1);
      mbar_init(x_empty + 8 * k, CONSUMERS * 128);
    }
    for (int s = 0; s < G::AST; ++s) {
      mbar_init(a_full + 8 * s, 1);
      mbar_init(a_empty + 8 * s, CONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // producer: one thread loads each unit's x, then the weight stages of
    // its M tiles
    if (threadIdx.x == CONSUMERS * 128) {
      int ait = 0;  // weight stages filled so far
      for (int unit = blockIdx.x, gen = 0; unit < units;
           unit += gridDim.x, ++gen) {
        const int pt = unit % ptiles, bt = unit / ptiles;
        const int t = bt % T, b = bt / T;
        for (int k = 0; k < kc; ++k) {
          // the last unit's final M tile is done with chunk k
          if (gen > 0) mbar_wait(x_empty + 8 * k, (gen - 1) & 1);
          mbar_expect_tx(x_full + 8 * k, G::CHUNK);
#pragma unroll
          for (int q = 0; q < NT / PANEL; ++q)
            tma_load(xs + k * G::CHUNK + q * BOX, &tm_x, x_full + 8 * k,
                     pt * NT + q * PANEL, t, b * Ci + k * CK);
        }
        const int nm = ((drop && t == 0) ? 1 : tr) * 2 * cblks;
        for (int m = 0; m < nm; ++m) {
          int z, xi, cb;
          m_tile(m, cblks, z, xi, cb);
          const int row0 = (xi * 2 * tr + z) * C + cb * CB;
          for (int k = 0; k < kc; ++k, ++ait) {
            const int s = ait % G::AST;
            const uint32_t stg = as + s * A_STAGE, bar = a_full + 8 * s;
            mbar_wait(a_empty + 8 * s, ((ait / G::AST) & 1) ^ 1);
            mbar_expect_tx(bar, A_STAGE);
            // phase yi's rows start tr * C further (r's yi term)
#pragma unroll
            for (int yi = 0; yi < CONSUMERS; ++yi)
              tma_load_2d(stg + yi * BOX, &tm_w, bar, k * CK,
                          row0 + yi * tr * C);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns phase yi = wg's 64 rows of each M tile
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const int HW = H * W;
  const long long fsz = 4ll * HW;  // an output frame's elements
  // rows of whole 16-byte pieces, so each copy is 16-byte aligned
  const bool vec = (W % 4) == 0;
  unsigned char* staging = smem_raw + (ss - raw);
  // positions 8i + 2q, 8i + 2q + 1 in acc[4i ..], rows g, g + 8
  float acc[NT / 2];  // the first product of a tile overwrites it
  int ait = 0;        // weight stages consumed so far
  for (int unit = blockIdx.x, gen = 0; unit < units;
       unit += gridDim.x, ++gen) {
    const int pt = unit % ptiles, bt = unit / ptiles;
    const int t = bt % T, b = bt / T;
    const int nm = ((drop && t == 0) ? 1 : tr) * 2 * cblks;
    for (int m = 0; m < nm; ++m) {
      int z, xi, cb;
      m_tile(m, cblks, z, xi, cb);
      for (int k = 0; k < kc; ++k, ++ait) {
        if (m == 0) mbar_wait(x_full + 8 * k, gen & 1);
        const int s = ait % G::AST;
        const uint32_t stg = as + s * A_STAGE;
        mbar_wait(a_full + 8 * s, (ait / G::AST) & 1);
        reg_fence(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < CK / 16; ++kk)
          wgmma_ss_mn(acc, sw128_desc(stg + wg * BOX + kk * 32, 16, 1024),
                      sw128_desc(xs + k * G::CHUNK + kk * 16 * 128, BOX,
                                 1024),
                      k > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
        reg_fence(acc);
        if (k > 0) {
          mbar_arrive(a_empty + 8 * ((ait - 1) % G::AST));
          if (m == nm - 1) mbar_arrive(x_empty + 8 * (k - 1));
        }
      }
      wgmma_wait<0>();
      reg_fence(acc);
      mbar_arrive(a_empty + 8 * ((ait - 1) % G::AST));
      if (m == nm - 1) mbar_arrive(x_empty + 8 * (kc - 1));

      // epilogue: bf16(acc + bias) staged as the output rows are laid
      // out, (p, yi) at element 2 (p - p0) + yi of channel cl's row
      const int row = ((xi * 2 + wg) * tr + z) * C + cb * CB;
      float bv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        bv[r] = __bfloat162float(bias[row + warp * 16 + g + 8 * r]);
      // the last tile's copies have read the staging
      if (threadIdx.x < CB)
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      asm volatile("bar.sync 1, 256;" ::: "memory");
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int i = 0; i < NT / 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            *reinterpret_cast<__nv_bfloat16*>(
                staging + (warp * 16 + g + 8 * r) * G::SROW +
                ((8 * i + 2 * q + e) * 2 + wg) * 2) =
                __float2bfloat16_rn(__fadd_rn(acc[4 * i + 2 * r + e], bv[r]));
      // the copies read the staging through the async proxy
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("bar.sync 1, 256;" ::: "memory");
      const int f = t * tr + z - (t > 0 ? drop : 0);
      const int nrep = (rep && f == 0) ? off + 1 : 1;
      const int p0 = pt * NT, end = min(p0 + NT, HW);
      if (vec) {
        // one thread a channel: a bulk copy a row of h its positions
        // touch, to each frame it goes to
        if (threadIdx.x < CB) {
          const int cl = threadIdx.x;
          __nv_bfloat16* chan =
              out + ((long long)b * C + cb * CB + cl) * Tout * fsz;
          int pos = p0, hh = p0 / W, ww = p0 - (p0 / W) * W;
          while (pos < end) {
            const int seg = min(end - pos, W - ww);
            const uint32_t src = ss + cl * G::SROW + (pos - p0) * 4;
            for (int n = 0; n < nrep; ++n)
              bulk_store(chan + (long long)(n == nrep - 1 ? off + f : n) *
                                    fsz +
                             (long long)(2 * hh + xi) * (2 * W) + 2 * ww,
                         src, seg * 4);
            pos += seg;
            ++hh;
            ww = 0;
          }
          asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        }
      } else {
        // a row may end inside 16 bytes: a thread a (yi 0, yi 1) pair
        for (int idx = threadIdx.x; idx < CB * NT; idx += CONSUMERS * 128) {
          const int cl = idx / NT, pos = p0 + idx % NT;
          if (pos >= end) continue;
          const uint32_t pair = *reinterpret_cast<const uint32_t*>(
              staging + cl * G::SROW + (pos - p0) * 4);
          const int hh = pos / W, ww = pos - hh * W;
          __nv_bfloat16* chan =
              out + ((long long)b * C + cb * CB + cl) * Tout * fsz;
          for (int n = 0; n < nrep; ++n)
            *reinterpret_cast<uint32_t*>(
                chan + (long long)(n == nrep - 1 ? off + f : n) * fsz +
                (long long)(2 * hh + xi) * (2 * W) + 2 * ww) = pair;
        }
      }
    }
  }
  // the block's shared memory lives until its last copies have read it
  if (threadIdx.x < CB)
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

template <int NT>
cudaError_t launch(const CUtensorMap& tx, const CUtensorMap& tw,
                   const void* bias, void* out, int Ci, int C, int T, int H,
                   int W, int tr, int drop, int off, int rep, int Tout,
                   int ptiles, int units, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(upsample_shuffle_kernel<NT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(Cfg<NT>::SMEM));
  if (err != cudaSuccess) return err;
  upsample_shuffle_kernel<NT><<<unsigned(units < sms ? units : sms), THREADS,
                                Cfg<NT>::SMEM, stream>>>(
      tx, tw, static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(out), Ci, C, T, H, W, tr, drop, off, rep,
      Tout, ptiles, units);
  return cudaGetLastError();
}

}  // namespace

// x: (B, Ci, T, H, W) bf16, frames frame_stride elements apart (>= H*W,
// a multiple of 8; contiguous otherwise); w: (4*tr*C, Ci) bf16
// contiguous; bias: (4*tr*C,) bf16; out: (B, C, off + T*tr - drop, 2H, 2W)
// bf16 contiguous, its first `off` frames filled by the caller unless
// `rep`. Ci % 64 == 0, Ci <= 512, C % 64 == 0, tr in {1, 2}, drop only at
// tr = 2: checked by the Python wrapper (seedvr2_tpu_torch/ops/upsample.py)
// and here.
extern "C" int seedvr2_upsample_shuffle(const void* x, const void* w,
                                        const void* bias, void* out, int B,
                                        int Ci, int T, int H, int W,
                                        long long frame_stride, int C,
                                        int tr, int drop, int off, int rep,
                                        void* stream) {
  if (B == 0 || T == 0 || H == 0 || W == 0 || C == 0)
    return int(cudaSuccess);
  const long long HW = (long long)H * W;
  if (B < 0 || T < 0 || H < 0 || W < 0 || Ci <= 0 || Ci % CK || Ci > 512 ||
      C < 0 || C % CB || (tr != 1 && tr != 2) || (drop && tr != 2) ||
      off < 0 || frame_stride < HW || frame_stride % 8 ||
      4 * HW > 0x7fffffffll || (reinterpret_cast<uintptr_t>(x) & 15) ||
      (reinterpret_cast<uintptr_t>(w) & 15))
    return int(cudaErrorInvalidValue);
  const int nt = Ci <= 256 ? 256 : 128;  // a unit's x: at most 128 KB
  const long long ptiles = (HW + nt - 1) / nt;
  const long long units = (long long)B * T * ptiles;
  if (units > 0x7fffffffll || (long long)B * Ci > 0x7fffffffll)
    return int(cudaErrorInvalidValue);
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return int(cudaErrorInvalidValue);
  // x as (position, frame, b*Ci + ci): boxes of 64 positions by 64 channels
  CUtensorMap tx, tw;
  const cuuint64_t dims[3] = {cuuint64_t(HW), cuuint64_t(T),
                              cuuint64_t(B) * Ci};
  const cuuint64_t strides[2] = {cuuint64_t(frame_stride) * 2,
                                 cuuint64_t(frame_stride) * 2 * T};
  const cuuint32_t box[3] = {PANEL, 1, CK};
  const cuuint32_t elem[3] = {1, 1, 1};
  if (fn(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x),
         dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      !make_map_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w, Ci,
                   4ull * tr * C, 2ull * Ci, CK, CB,
                   CU_TENSOR_MAP_SWIZZLE_128B))
    return int(cudaErrorInvalidValue);
  const int Tout = off + T * tr - (drop ? 1 : 0);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return int(nt == 256
                 ? launch<256>(tx, tw, bias, out, Ci, C, T, H, W, tr,
                               drop ? 1 : 0, off, rep, Tout, int(ptiles),
                               int(units), st)
                 : launch<128>(tx, tw, bias, out, Ci, C, T, H, W, tr,
                               drop ? 1 : 0, off, rep, Tout, int(ptiles),
                               int(units), st));
}
