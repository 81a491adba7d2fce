// Dequantizing GEMMs of the quantised-checkpoint lanes (kernels K6 and K7 of
// the port): one Hopper kernel body (a template flag adds K7's min term), a
// pre-pass for K7's min term and a split-K reduction.
//
// Replaces: the Pallas TPU kernels `_qmm_kernel` behind `quant_matmul_q8`
// (K6) and `_aqmm_kernel` behind `quant_matmul_affine` (K7), both in
// comfyui-seedvr2_tpu/ops/quant_matmul.py.
//
// Computes, with x (M, K) bf16 activations, q (N, K) int8 weights
// (K-contiguous, the GGUF (out, in) order) and per-32-group fp32 tables
// (N, K/32):
//   K6: out[m, n] = bf16(sum_g s[n, g] * (x_g[m] . q_g[n]))
//   K7: out[m, n] = bf16(sum_g s[n, g] * (x_g[m] . q_g[n])
//                        - xg[m, g] * mn[n, g])
// where x_g . q_g is the 32-term dot of group g and xg[m, g] the fp32 sum of
// the 32 x values of row m in group g: w = q*s - m folded into a side term,
// as the JAX kernel does. The bias is not added here: the caller adds it
// after the bf16 rounding, as the JAX package does. With out_f32 the same
// sums are written unrounded in fp32: the epilogue of a row-sharded
// projection under tensor parallelism, whose partials are summed over the
// ranks before the one rounding (the fp32 store the split-K workspace
// already takes, on the output itself; the split-K reduction then writes
// fp32 too).
//
// Exactness: the Pallas body dequantises a tile to fp32 and takes an fp32
// dot. Dequantising to a bf16 tile here would round s*q to 8 mantissa bits,
// an error the JAX function does not have. Instead q is widened to bf16
// (exact for |q| <= 127), each group's two k16 products go into an fp32
// partial (the first with scale-d 0, so nothing zeroes it), and the partial
// is folded in with acc = fma(partial, s, acc); one rounding to bf16 at the
// end. K7's min term -xg . mn is a product over the K/32 groups, taken on
// the tensor cores with both factors split into bf16 hi + lo (hi*hi +
// hi*lo + lo*hi, fp32 accumulation): within about 2^-16 of each term, far
// below the output's bf16 half-ulp (2^-9).
//
// What bounds it on an H100:
//  - at the 3B DiT's video rows (M = 7200..32400) operations: 2*M*N*K on
//    the bf16 tensor cores (989 TFLOP/s dense), 0.324 ms for the q8 lane's
//    qkv at M = 8160; K7's min term adds 3*2*M*N*K/32 rounded up to 64
//    groups (about 10 %);
//  - the exact fold has a floor of its own on the CUDA cores: M*N*K/32 fp32
//    FMAs at 67 TFLOP/s, 0.150 ms at that shape, half the tensor bound, so
//    it has to run beside the products; so does the widening, one byte
//    permute and one bf16x2 fma per pair of weights (K6: two more logic
//    ops) once per 128 tokens;
//  - at M = 1 (time embedding) and M = 58 (text rows) bytes: the weights'
//    1.125 B (K6) or 1.25 B (K7) each over 3.35 TB/s, 6.6 us for the text
//    qkv; there the card is idle unless enough blocks stream the weights.
//
// Design:
//  - Operands swapped: a block computes out^T = W_tile . x_tile^T, 128
//    weight rows (64 per consumer warpgroup, the wgmma M) by BT tokens (the
//    wgmma N: 128 at the video rows, 64 for the text rows, 8 for M = 1). x
//    (M, K) K-contiguous is then the standard K-major B operand, read from
//    shared memory by descriptor; the int8 weights are the register A
//    operand, widened in registers. The tables become per-accumulator-row
//    values: 2 scales a thread a group.
//  - Widening: 4-byte shared loads of the TMA-loaded int8 tile (128-byte
//    swizzle, so the 8 rows of a warp hit distinct banks); a byte permute
//    puts two quants under bf16 128's exponent byte (128 + q), one bf16x2
//    fma takes 128 off (K7's quants in [0, 31]); K6's signed bytes go in as
//    128 + (q & 0x7F), less 128 or 256 by the sign bit. Exact, no I2F.
//  - A warp-specialised TMA ring: one producer thread (a warp of its own)
//    keeps 4 (BT = 128) to 8 (BT = 8) stages in flight, each holding 128 of
//    K (4 groups): the x box (bf16, 128-byte swizzle, two 64-column panels),
//    the raw int8 q box (128 bytes of K a row, one swizzle row) and the
//    scale box (16 bytes a row). TMA zero-fills the ragged M, N and K edges.
//    One mbarrier wait a stage, not a block-wide barrier a group.
//  - The fold overlapped: a warpgroup issues group g's two wgmmas, widens
//    group g+1's weights while they run, then folds; the two consumer
//    warpgroups share the tensor cores, so one's fold runs under the
//    other's products. (Two partial sets with wgmma.wait_group 1 were
//    slower on the card, PERF.md.)
//  - K7's min term: a pre-pass kernel writes xg and -mn once per call as
//    bf16 hi and lo planes; after the K loop a block takes (-mn) xg^T with
//    both operands in shared memory, their boxes streamed through the
//    ring's last slots, three a 64-group panel (so any K fits); the
//    splits of a split K share the panels out. With -mn split in
//    registers, before the K loop or into the fold's sums, ptxas ran the
//    128-token block short of registers and serialised every wgmma.
//  - Epilogue: the accumulator is staged through shared memory (the spent
//    ring) in a TMA box's 128-byte-swizzled layout, rounded once to bf16,
//    and written by TMA stores that clip M and N. Where the output's rows
//    are not 16-byte multiples (N % 8 != 0; the fp32 workspace: N % 4 !=
//    0), which a tensor map cannot describe, the threads store 4 or 8
//    bytes each instead, whole 128-byte row segments per warp.
//  - Small M: K is split across blocks (grid z) so that at least ~132
//    blocks stream the weights; each split writes fp32 partials into a
//    workspace, and a second kernel sums them in a fixed order (no atomics:
//    deterministic) and rounds to bf16. The wrapper picks the token width
//    and the split (ops/quant_matmul.py `plan_tiles`) and allocates the
//    workspace and K7's scratch.
// Requirements (checked by the wrapper): K % 32 == 0, N even, x and q
// 16-byte aligned, tables (N, G4) with G4 = K/32 rounded up to 4.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace seedvr2::sm90;

constexpr int BN = 128;                       // weight rows a block
constexpr int BK = 128;                       // K a stage
constexpr int GS = BK / 32;                   // groups a stage
constexpr int CONSUMERS = 2;                  // warpgroups of 64 weight rows
constexpr int THREADS = CONSUMERS * 128 + 32;  // + one producer warp
constexpr uint32_t Q_BYTES = BN * BK;         // int8, 128 bytes a row
constexpr uint32_t TAB_BYTES = BN * GS * 4;   // fp32, 16 bytes a row
constexpr int PANEL = 64;  // groups a box of K7's min-term planes

template <int BT>
struct Cfg {
  static constexpr uint32_t X_PANEL = BT * 128;  // BT rows x 64 bf16
  static constexpr uint32_t X_BYTES = 2 * X_PANEL;
  static constexpr uint32_t Q_OFF = X_BYTES;
  static constexpr uint32_t S_OFF = Q_OFF + Q_BYTES;
  // bytes one stage's TMA loads deliver
  static constexpr uint32_t TX = X_BYTES + Q_BYTES + TAB_BYTES;
  static constexpr uint32_t STAGE = (TX + 1023) / 1024 * 1024;
  static constexpr int STAGES = BT == 128 ? 4 : BT == 64 ? 5 : 8;
  // K7's min term streams through the ring, three slots a 64-group panel:
  // xg's hi and lo boxes (BT rows x 64 bf16 each), -mn's hi box, its lo
  // box (128 weight rows x 64 bf16 each)
  static constexpr uint32_t XG_BOX = BT * 128;
  static constexpr uint32_t MN_BOX = BN * 128;
  static_assert(2 * XG_BOX <= STAGE && MN_BOX <= STAGE, "min-term slots");
  static constexpr size_t SMEM =
      size_t(STAGES) * STAGE + 2 * STAGES * 8 + 1024;
  static_assert(SMEM <= 232448, "shared memory");
  // the epilogue's staging (fp32 rows of 64 values + 16 bytes of pad, so
  // the fragment stores hit distinct banks) fits in the spent ring
  static_assert(CONSUMERS * BT * 272 <= STAGES * STAGE, "staging");
};

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ float4 lds128f(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

// v's component u, u known at compile time
__device__ __forceinline__ float pick(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

__device__ __forceinline__ uint32_t bf16x2_fma(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}

// Two int8 quants of `w` (the bytes `sel` picks) -> a bf16 pair, exact.
// K7 (unsigned, q <= 127): bf16 0x4300 | q = 128 + q, less 128. K6 (signed,
// |q| <= 127): 128 + (q & 0x7F) less 128 (q >= 0) or 256 (q < 0, whose
// byte has bit 7 set), both bf16 integers in [128, 256]: exact.
template <bool AFFINE>
__device__ __forceinline__ uint32_t widen2(uint32_t w, uint32_t sel) {
  constexpr uint32_t E = 0x43434343u;  // bf16 128's high byte, 4 times
  if constexpr (AFFINE) {
    return bf16x2_fma(__byte_perm(w, E, sel), 0x3F803F80u, 0xC300C300u);
  } else {
    const uint32_t v = __byte_perm(w & 0x7F7F7F7Fu, E, sel);
    const uint32_t c = __byte_perm(w & 0x80808080u, E, sel);
    return bf16x2_fma(c, 0xBF80BF80u, v);  // v - c
  }
}

// The register A fragments of one group (two k16 steps) for this thread's
// weight rows r0 and r0 + 8 (r0 % 8 == g): A[g][2t, 2t+1], A[g+8][...],
// A[g][2t+8, 2t+9], A[g+8][...] of chunk c = 2u + h, the 16-byte chunk c of
// a swizzled row r at chunk c ^ (r % 8). Thread t reads words t/2 and
// 2 + t/2 of the chunk and keeps the byte pair t % 2.
template <bool AFFINE>
__device__ __forceinline__ void widen_group(uint32_t (&a)[2][4],
                                            uint32_t q_row0, int u, int g,
                                            int t, uint32_t sel) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t p = q_row0 + (((2 * u + h) ^ g) << 4) + 4 * (t >> 1);
    const uint32_t w00 = lds32(p), w01 = lds32(p + 8);
    const uint32_t w10 = lds32(p + 8 * 128), w11 = lds32(p + 8 * 128 + 8);
    a[h][0] = widen2<AFFINE>(w00, sel);
    a[h][1] = widen2<AFFINE>(w10, sel);
    a[h][2] = widen2<AFFINE>(w01, sel);
    a[h][3] = widen2<AFFINE>(w11, sel);
  }
}

// Issues (and commits, without waiting) one group's two k16 products into
// d, the first overwriting it: B = chunks 2u, 2u + 1 of the stage's x, 64
// of K a 128-byte swizzled panel of BT rows, 32 bytes a k16 step.
template <int NA>
__device__ __forceinline__ void issue_group(float (&d)[NA],
                                            const uint32_t (&a)[2][4],
                                            uint32_t stage, int u) {
  constexpr uint32_t X_PANEL = NA * 2 * 128;
  reg_fence(d);
  wgmma_fence();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = 2 * u + h;
    wgmma_rs<0>(d, a[h],
                sw128_desc(stage + (c / 4) * X_PANEL + (c % 4) * 32, 16,
                           1024),
                h);
  }
  wgmma_commit();
}

// Accumulator layout of a wgmma m64nBT tile (mma.sync's m16n8 C layout per
// warp): thread (warp w, lane 4g + t) holds, for each 8-token block i,
// d[4i], d[4i+1] at weight row 16w + g, tokens 8i + 2t, 8i + 2t + 1, and
// d[4i+2], d[4i+3] at weight row 16w + g + 8.
//
// grid: (N / 128, M / BT, splits); split z takes groups [z*gps, z*gps +
// gps). out: bf16 (M, N) when splits == 1 and !f32, else fp32: the
// workspace (splits, M, N), or the fp32 output (M, N) at one split. K7 (AFFINE) adds the min term, from the pre-pass's bf16
// hi and lo planes of xg (tm_xg: (2, M, XW)) and of -mn (tm_mn: (2, N,
// XW)), in 64-group panels; it is additive over the groups, so split z
// takes panels z, z + splits, ... of all K/32 groups.
template <int BT, bool AFFINE>
__global__ void __launch_bounds__(THREADS, 1)
qmm_kernel(const __grid_constant__ CUtensorMap tm_x,
           const __grid_constant__ CUtensorMap tm_q,
           const __grid_constant__ CUtensorMap tm_s,
           const __grid_constant__ CUtensorMap tm_xg,
           const __grid_constant__ CUtensorMap tm_mn,
           const __grid_constant__ CUtensorMap tm_o, void* __restrict__ out,
           int M, int N, int G, int gps, int tma_out, int f32) {
  using C = Cfg<BT>;
  constexpr int NA = BT / 2;  // accumulator registers a thread
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t full = base + C::STAGES * C::STAGE;
  const uint32_t empty = full + 8 * C::STAGES;

  const int n0 = blockIdx.x * BN;
  const int t0 = blockIdx.y * BT;
  const int g0 = blockIdx.z * gps;
  const int ng = min(gps, G - g0);  // groups of this split
  const int n_st = (ng + GS - 1) / GS;
  // K7's min term: this split's panels (three ring slots each), the i-th
  // at groups 64 (z + i * splits) ..
  const int all_panels = AFFINE ? (G + PANEL - 1) / PANEL : 0;
  const int z = blockIdx.z, splits = gridDim.z;
  const int panels = z < all_panels ? (all_panels - z + splits - 1) / splits
                                    : 0;

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
      for (int j = 0; j < n_st + 3 * panels; ++j) {
        const int s = j % C::STAGES;
        const uint32_t st = base + s * C::STAGE, bar = full + 8 * s;
        mbar_wait(empty + 8 * s, ((j / C::STAGES) & 1) ^ 1);
        if (j >= n_st) {  // K7's min term: slot c of the split's panel i
          const int i = (j - n_st) / 3, c = (j - n_st) % 3;
          const int k0 = (z + i * splits) * PANEL;
          if (c == 0) {
            mbar_expect_tx(bar, 2 * C::XG_BOX);
            tma_load(st, &tm_xg, bar, k0, t0, 0);
            tma_load(st + C::XG_BOX, &tm_xg, bar, k0, t0, 1);
          } else {
            mbar_expect_tx(bar, C::MN_BOX);
            tma_load(st, &tm_mn, bar, k0, n0, c - 1);
          }
          continue;
        }
        const int gc = g0 + GS * j, k0 = gc * 32;
        // a second x panel wholly past K is never read: it is not loaded
        const bool panel1 = k0 + 64 < G * 32;
        mbar_expect_tx(bar, C::TX - (panel1 ? 0 : C::X_PANEL));
        tma_load_2d(st, &tm_x, bar, k0, t0);
        if (panel1) tma_load_2d(st + C::X_PANEL, &tm_x, bar, k0 + 64, t0);
        tma_load_2d(st + C::Q_OFF, &tm_q, bar, k0, n0);
        tma_load_2d(st + C::S_OFF, &tm_s, bar, gc, n0);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns weight rows n0 + 64 wg .. + 63
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = wg * 64 + warp * 16 + g;  // block row; r0 + 8 the other
  // byte pair t % 2 of a word into the low bytes of two bf16 lanes
  const uint32_t sel = 0x4040u | (2 * (t & 1)) | ((2 * (t & 1) + 1) << 8);
  const uint32_t q_row = C::Q_OFF + r0 * 128;  // this thread's q row, stage 0

  float acc[NA], part[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = part[i] = 0.f;
  uint32_t a[2][2][4];  // [group parity][k16 step][register]

  // Group gi's products go into the partial from the weights widened into
  // a[gi % 2]; group gi + 1's weights are widened while they run, then
  // group gi is folded. GS is even, so gi's parity is its slot's.
  if (ng > 0) {
    mbar_wait(full, 0);
    widen_group<AFFINE>(a[0], base + q_row, 0, g, t, sel);
  }
  for (int j = 0; j < n_st; ++j) {
    const int s = j % C::STAGES;
    const uint32_t st = base + s * C::STAGE;
    const float4 s_lo = lds128f(st + C::S_OFF + r0 * 16);
    const float4 s_hi = lds128f(st + C::S_OFF + (r0 + 8) * 16);
#pragma unroll
    for (int u = 0; u < GS; ++u) {
      const int gi = j * GS + u;
      if (gi >= ng) break;  // the same for the whole block
      const int p = u & 1;
      issue_group(part, a[p], st, u);
      // widen the next group's weights while the products run
      if (gi + 1 < ng) {
        if (u == GS - 1) {
          const int jn = j + 1, sn = jn % C::STAGES;
          mbar_wait(full + 8 * sn, (jn / C::STAGES) & 1);
          widen_group<AFFINE>(a[p ^ 1], base + sn * C::STAGE + q_row, 0, g,
                              t, sel);
        } else {
          widen_group<AFFINE>(a[p ^ 1], st + q_row, u + 1, g, t, sel);
        }
      }
      wgmma_wait<0>();
      reg_fence(part);
      reg_fence(a[p][0]);
      reg_fence(a[p][1]);
      // the exact fold of group gi
      const float sc0 = pick(s_lo, u), sc1 = pick(s_hi, u);
#pragma unroll
      for (int i = 0; i < NA / 4; ++i) {
        acc[4 * i] = fmaf(part[4 * i], sc0, acc[4 * i]);
        acc[4 * i + 1] = fmaf(part[4 * i + 1], sc0, acc[4 * i + 1]);
        acc[4 * i + 2] = fmaf(part[4 * i + 2], sc1, acc[4 * i + 2]);
        acc[4 * i + 3] = fmaf(part[4 * i + 3], sc1, acc[4 * i + 3]);
      }
    }
    mbar_arrive(empty + 8 * s);  // this thread is done with stage s
  }

  if constexpr (AFFINE) {
    // the min term last, on the tensor cores with both operands in shared
    // memory: part = (-mn)_hi xg_hi^T + (-mn)_hi xg_lo^T + (-mn)_lo xg_hi^T,
    // k16 steps over the split's panels (past G both planes are zero),
    // then acc += part. (Taken before the K loop,
    // or into acc, or with -mn in registers, ptxas ran the 128-token block
    // short of registers and serialised every wgmma of the kernel.)
    for (int i = 0; i < panels; ++i) {
      uint32_t slot[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int j = n_st + 3 * i + c;
        slot[c] = base + (j % C::STAGES) * C::STAGE;
        mbar_wait(full + 8 * (j % C::STAGES), (j / C::STAGES) & 1);
      }
      reg_fence(part);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t xh = sw128_desc(slot[0] + kk * 32, 16, 1024);
        const uint64_t xl = sw128_desc(slot[0] + C::XG_BOX + kk * 32, 16,
                                       1024);
        const uint64_t mh = sw128_desc(slot[1] + wg * 8192 + kk * 32, 16,
                                       1024);
        const uint64_t ml = sw128_desc(slot[2] + wg * 8192 + kk * 32, 16,
                                       1024);
        wgmma_ss(part, mh, xh, i > 0 || kk > 0);
        wgmma_ss(part, mh, xl, 1);
        wgmma_ss(part, ml, xh, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(part);
#pragma unroll
      for (int c = 0; c < 3; ++c)
        mbar_arrive(empty + 8 * ((n_st + 3 * i + c) % C::STAGES));
    }
    if (panels > 0) {
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[i] += part[i];
    }
  }

  // epilogue: every consumer is past the ring, so it holds the staging.
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS * 128) : "memory");
  const bool split = f32 != 0;  // fp32 rows: workspace or fp32 output
  const int c0 = warp * 16 + g;  // this thread's columns c0, c0 + 8
  if (tma_out) {
    // Warpgroup wg's 64 columns x BT tokens as TMA boxes of 128-byte rows
    // (one token each), 128-byte swizzle (16-byte chunk c of row r at c ^
    // (r % 8): the 4 token rows a warp writes hit distinct banks): one box
    // of 64 bf16 columns, or two of 32 fp32 columns (workspace).
    const uint32_t box = base + wg * BT * 256;  // 1024-byte aligned
    unsigned char* stage = smem_raw + (box - raw);
#pragma unroll
    for (int i = 0; i < NA / 4; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tok = 8 * i + 2 * t + (e & 1);
        const int col = c0 + 8 * (e >> 1);
        const int cb = split ? (col % 32) * 4 : col * 2;  // byte in the row
        const uint32_t off = (split ? (col / 32) * BT * 128 : 0) +
                             tok * 128 + ((((cb >> 4) ^ (tok & 7)) << 4) |
                                          (cb & 15));
        if (split)
          *reinterpret_cast<float*>(stage + off) = acc[4 * i + e];
        else
          *reinterpret_cast<__nv_bfloat16*>(stage + off) =
              __float2bfloat16_rn(acc[4 * i + e]);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(2 + wg) : "memory");
    if (tid == 0) {
      const int n = n0 + wg * 64;
      if (split) {
        tma_store(&tm_o, box, n, t0, blockIdx.z);
        tma_store(&tm_o, box + BT * 128, n + 32, t0, blockIdx.z);
      } else {
        tma_store(&tm_o, box, n, t0, 0);
      }
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
    return;
  }
  // Rows a tensor map cannot describe: token-major rows of bf16 128 + 8
  // bytes, or fp32 256 + 16 bytes (workspace), then 32 threads a token row.
  const uint32_t pitch = split ? 272 : 136;
  unsigned char* stage = smem_raw + (base - raw) + wg * BT * 272;
#pragma unroll
  for (int i = 0; i < NA / 4; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int tok = 8 * i + 2 * t + (e & 1);
      const int col = c0 + 8 * (e >> 1);
      if (split)
        *reinterpret_cast<float*>(stage + tok * pitch + col * 4) =
            acc[4 * i + e];
      else
        *reinterpret_cast<__nv_bfloat16*>(stage + tok * pitch + col * 2) =
            __float2bfloat16_rn(acc[4 * i + e]);
    }
  }
  asm volatile("bar.sync %0, 128;" ::"r"(2 + wg) : "memory");
  const int n = n0 + wg * 64 + 2 * (tid % 32);
  if (n >= N) return;  // N even: both columns in or both out
  for (int tok = tid / 32; tok < BT; tok += 4) {
    const int m = t0 + tok;
    if (m >= M) break;
    if (split) {
      float* o = static_cast<float*>(out) +
                 ((long long)blockIdx.z * M + m) * N + n;
      *reinterpret_cast<float2*>(o) = *reinterpret_cast<const float2*>(
          stage + tok * pitch + (tid % 32) * 8);
    } else {
      __nv_bfloat16* o =
          static_cast<__nv_bfloat16*>(out) + (long long)m * N + n;
      *reinterpret_cast<uint32_t*>(o) = *reinterpret_cast<const uint32_t*>(
          stage + tok * pitch + (tid % 32) * 4);
    }
  }
}

__device__ __forceinline__ void store_pair(__nv_bfloat162* o, float2 a) {
  *o = __floats2bfloat162_rn(a.x, a.y);
}
__device__ __forceinline__ void store_pair(float2* o, float2 a) { *o = a; }

// out[i] = sum over splits of ws[s][i], the splits in order, rounded to
// bf16 (OutT __nv_bfloat162) or kept fp32 (float2).
template <typename OutT>
__global__ void split_reduce_kernel(const float2* __restrict__ ws,
                                    OutT* __restrict__ out, long long pairs,
                                    int splits) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < pairs; i += (long long)gridDim.x * blockDim.x) {
    float2 a = ws[i];
    for (int s = 1; s < splits; ++s) {
      const float2 b = ws[s * pairs + i];
      a.x += b.x;
      a.y += b.y;
    }
    store_pair(out + i, a);
  }
}

// K7's pre-pass, one thread a (row, group) of two jobs, g fastest, both
// written as two bf16 planes, hi = bf16(v) and lo = bf16(v - hi), 0 for G
// <= g < XW:
//  - xg (2, M, XW): v = the sum of x[m, 32g .. 32g + 31] in fp32, in order;
//  - mnp (2, N, XW): v = -mn[n, g], mn (N, G4) fp32.
__global__ void k7_prepass_kernel(const __nv_bfloat16* __restrict__ x,
                                  __nv_bfloat16* __restrict__ xg,
                                  const float* __restrict__ mn,
                                  __nv_bfloat16* __restrict__ mnp, int M,
                                  int N, int K, int G4, int XW) {
  long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const bool sums = idx < (long long)M * XW;
  if (!sums) idx -= (long long)M * XW;
  const int rows = sums ? M : N;
  if (idx >= (long long)rows * XW) return;
  const long long r = idx / XW;
  const int grp = int(idx % XW);
  float v = 0.f;
  if (grp * 32 < K) {
    if (sums) {
      const uint4* p = reinterpret_cast<const uint4*>(x + r * K + grp * 32);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint4 w = p[c];
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h[e]);
          v += f.x;
          v += f.y;
        }
      }
    } else {
      v = -mn[r * G4 + grp];
    }
  }
  __nv_bfloat16* dst = sums ? xg : mnp;
  const __nv_bfloat16 hi = __float2bfloat16_rn(v);
  dst[idx] = hi;
  dst[(long long)rows * XW + idx] =
      __float2bfloat16_rn(v - __bfloat162float(hi));
}

cudaError_t launch_split_reduce(const void* ws, void* out, long long pairs,
                                int splits, bool out_f32,
                                cudaStream_t stream) {
  const long long blocks = (pairs + 255) / 256;
  const unsigned grid = unsigned(blocks < 1056 ? blocks : 1056);
  const float2* src = static_cast<const float2*>(ws);
  if (out_f32)
    split_reduce_kernel<<<grid, 256, 0, stream>>>(
        src, static_cast<float2*>(out), pairs, splits);
  else
    split_reduce_kernel<<<grid, 256, 0, stream>>>(
        src, static_cast<__nv_bfloat162*>(out), pairs, splits);
  return cudaGetLastError();
}

cudaError_t launch_prepass(const void* x, void* xg, const void* mn,
                           void* mnp, int M, int N, int K, int G4, int XW,
                           cudaStream_t stream) {
  const long long n = ((long long)M + N) * XW;
  k7_prepass_kernel<<<unsigned((n + 255) / 256), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(xg),
      static_cast<const float*>(mn), static_cast<__nv_bfloat16*>(mnp), M, N,
      K, G4, XW);
  return cudaGetLastError();
}

template <int BT, bool AFFINE>
cudaError_t launch_bt(const CUtensorMap& tx, const CUtensorMap& tq,
                      const CUtensorMap& ts, const CUtensorMap& txg,
                      const CUtensorMap& tmn, const CUtensorMap& to,
                      bool tma_out, bool f32, void* out, int M, int N,
                      int G, int splits, cudaStream_t stream) {
  using C = Cfg<BT>;
  const cudaError_t e = cudaFuncSetAttribute(
      qmm_kernel<BT, AFFINE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(C::SMEM));
  if (e != cudaSuccess) return e;
  const int gps = G / splits;
  const dim3 grid(unsigned((N + BN - 1) / BN), unsigned((M + BT - 1) / BT),
                  unsigned(splits));
  qmm_kernel<BT, AFFINE><<<grid, THREADS, C::SMEM, stream>>>(
      tx, tq, ts, txg, tmn, to, out, M, N, G, gps, int(tma_out), int(f32));
  return cudaGetLastError();
}

// x (M, K) bf16, q (N, K) int8, s (N, G4) fp32, xg (2, M, XW) and mnp (2,
// N, XW) bf16 (K7's pre-pass outputs), ws (splits, M, N) fp32 when splits
// > 1, out (M, N) bf16, or fp32 with out_f32.
template <bool AFFINE>
int launch(const void* x, const void* q, const void* s, const void* xg,
           const void* mnp, void* ws, void* out, int M, int N, int K, int G4,
           int XW, int bt, int splits, bool out_f32, cudaStream_t stream) {
  if (M == 0 || N == 0) return int(cudaSuccess);
  const int G = K / 32;
  // a split starts on a whole stage: the table boxes' first column must
  // be 16-byte aligned
  if (K <= 0 || K % 32 || N % 2 || G4 < G || G4 % 4 || splits < 1 ||
      (splits > 1 && (G % splits || (G / splits) % GS || ws == nullptr)) ||
      (M + bt - 1) / bt > 65535 || (AFFINE && (XW < G || XW % 8)))
    return int(cudaErrorInvalidValue);
  CUtensorMap tx, tq, ts, txg, tmn;
  const bool ok =
      make_map_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M,
                  uint64_t(K) * 2, 64, bt, CU_TENSOR_MAP_SWIZZLE_128B) &&
      make_map_2d(&tq, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, K, N, K, BK, BN,
                  CU_TENSOR_MAP_SWIZZLE_128B) &&
      make_map_2d(&ts, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, s, G4, N,
                  uint64_t(G4) * 4, GS, BN, CU_TENSOR_MAP_SWIZZLE_NONE) &&
      (!AFFINE ||
       (make_map_3d(&txg, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, xg, XW, M, 2,
                    uint64_t(XW) * 2, uint64_t(XW) * 2 * M, PANEL, bt,
                    CU_TENSOR_MAP_SWIZZLE_128B) &&
        make_map_3d(&tmn, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, mnp, XW, N, 2,
                    uint64_t(XW) * 2, uint64_t(XW) * 2 * N, PANEL, BN,
                    CU_TENSOR_MAP_SWIZZLE_128B)));
  if (!ok) return int(cudaErrorInvalidValue);
  if (!AFFINE) txg = tmn = ts;  // unread
  // the output through TMA stores where its rows are 16-byte multiples:
  // bf16 (M, N) boxes of 64 columns, or fp32 rows in boxes of 32: the
  // workspace (splits, M, N), or the fp32 output (M, N) at one split
  CUtensorMap to = ts;  // unread without them
  const bool f32 = splits > 1 || out_f32;
  void* dst = splits > 1 ? ws : out;
  const bool tma_out = f32 ? N % 4 == 0 : N % 8 == 0;
  if (tma_out &&
      !(f32 ? make_map_3d(&to, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, dst, N, M,
                          splits, uint64_t(N) * 4, uint64_t(N) * 4 * M, 32,
                          bt, CU_TENSOR_MAP_SWIZZLE_128B)
            : make_map_3d(&to, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, out, N, M,
                          1, uint64_t(N) * 2, uint64_t(N) * 2 * M, 64, bt,
                          CU_TENSOR_MAP_SWIZZLE_128B)))
    return int(cudaErrorInvalidValue);
  cudaError_t e;
  if (bt == 128)
    e = launch_bt<128, AFFINE>(tx, tq, ts, txg, tmn, to, tma_out, f32, dst,
                               M, N, G, splits, stream);
  else if (bt == 64)
    e = launch_bt<64, AFFINE>(tx, tq, ts, txg, tmn, to, tma_out, f32, dst,
                              M, N, G, splits, stream);
  else if (bt == 8)
    e = launch_bt<8, AFFINE>(tx, tq, ts, txg, tmn, to, tma_out, f32, dst, M,
                             N, G, splits, stream);
  else
    return int(cudaErrorInvalidValue);
  if (e != cudaSuccess || splits == 1) return int(e);
  return int(launch_split_reduce(ws, out, (long long)M * N / 2, splits,
                                 out_f32, stream));
}

}  // namespace

// x: (M, K) bf16, q: (N, K) int8, scales: (N, G4) fp32 (K/32 groups, zero
// padded to G4 % 4 == 0), ws: (splits, M, N) fp32 scratch (null when
// splits == 1), out: (M, N) bf16 (out_f32 = 0) or fp32; all contiguous
// and 16-byte aligned, K % 32 == 0, N % 2 == 0, bt in {8, 64, 128}: checked
// by the Python wrapper (seedvr2_tpu_torch/ops/quant_matmul.py), which also
// picks bt and splits.
extern "C" int seedvr2_quant_matmul_q8(const void* x, const void* q,
                                       const void* scales, void* ws,
                                       void* out, int M, int N, int K, int G4,
                                       int bt, int splits, int out_f32,
                                       void* stream) {
  return launch<false>(x, q, scales, nullptr, nullptr, ws, out, M, N, K, G4,
                       0, bt, splits, out_f32 != 0,
                       static_cast<cudaStream_t>(stream));
}

// As above with q in [0, 31], the affine tables s, m: (N, G4) fp32, and
// the bf16 scratch xg: (2, M, XW) and mnp: (2, N, XW), XW = K/32 rounded
// up to 8. Launches the pre-pass into xg and mnp, the GEMM and, when
// splits > 1, the reduction.
extern "C" int seedvr2_quant_matmul_affine(const void* x, const void* q,
                                           const void* s, const void* m,
                                           void* xg, void* mnp, void* ws,
                                           void* out, int M, int N, int K,
                                           int G4, int XW, int bt, int splits,
                                           int out_f32, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M == 0 || N == 0) return int(cudaSuccess);
  if (K <= 0 || K % 32 || G4 < K / 32 || XW < K / 32 || XW % 8)
    return int(cudaErrorInvalidValue);
  const cudaError_t e = launch_prepass(x, xg, m, mnp, M, N, K, G4, XW, st);
  if (e != cudaSuccess) return int(e);
  return launch<true>(x, q, s, xg, mnp, ws, out, M, N, K, G4, XW, bt, splits,
                      out_f32 != 0, st);
}

// K7's pre-pass alone: xg (2, M, XW) bf16 from x (M, K) bf16 and mnp (2,
// N, XW) bf16 from m (N, G4) fp32 (M or N may be 0).
extern "C" int seedvr2_k7_prepass(const void* x, void* xg, const void* m,
                                  void* mnp, int M, int N, int K, int G4,
                                  int XW, void* stream) {
  if (M == 0 && N == 0) return int(cudaSuccess);
  if (K <= 0 || K % 32 || G4 < K / 32 || XW < K / 32 || XW % 8)
    return int(cudaErrorInvalidValue);
  return int(launch_prepass(x, xg, m, mnp, M, N, K, G4, XW,
                            static_cast<cudaStream_t>(stream)));
}

// The split-K reduction alone: out (pairs * 2) bf16 (out_f32 = 0) or fp32 =
// the sum of ws (splits, pairs * 2) fp32 over the splits, in order.
extern "C" int seedvr2_split_reduce(const void* ws, void* out,
                                    long long pairs, int splits, int out_f32,
                                    void* stream) {
  if (pairs == 0) return int(cudaSuccess);
  if (splits < 1) return int(cudaErrorInvalidValue);
  return int(launch_split_reduce(ws, out, pairs, splits, out_f32 != 0,
                                 static_cast<cudaStream_t>(stream)));
}
