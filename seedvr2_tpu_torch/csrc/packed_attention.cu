// Packed window attention for NaDiT (kernel K1 of the port), and the Hopper
// attention step it shares with K8 (dense flash attention) and K9 (windowed
// flash attention), both in flash_attention.cu.
//
// Replaces: the Pallas TPU kernel `_fa_packed_kernel` behind
// `flash_packed_attention` (comfyui-seedvr2_tpu/ops/flash_attention.py).
//
// Computes, per (window row b, head h): fp32 RMS qk-norm over D, interleaved
// rotate-half RoPE from four (S, D) fp32 tables that already carry the
// qk-norm weights and the baked text rope, then softmax(q k^T * scale) v in
// the exp2 domain (scale*log2e folded into q), masking key columns >= kv_len.
// q, k and v are read from ONE packed (B, S, 3*H*D) bf16 operand at column
// offsets h*D, (H+h)*D and (2H+h)*D; the output is (B, S, H*D) bf16.
//
// What bounds it on an H100: at the 3B window sizes (S = 512..3712, D = 128)
// the work is 4*S*kv_len*D flops per (b, h) against about 8*S*D bytes moved,
// so the tensor cores bound it from S ~ 1000 up; at S = 512 the card could
// move the bytes in about the time of the flops (both ~0.03 ms at the
// record shape). The pre-pass is bound by bytes alone. Measured on an
// H100 80GB HBM3 (700 W; chip_smoke.py): 0.16 ms at the record shape (B=12
// S=512 kv_len=463 H=20) against a 0.038 ms bound. What holds it there:
// the pre-pass, about 30 % of the call (q and k read, then written and
// read again as q-hat and k-hat), and the step's fixed cost a block (the
// q load, the epilogue's store) against only 8 key tiles a block; at S =
// 3712 the step reaches 430 TFLOP/s.
//
// Design, in two launches of one call:
//  1. `qk_prepass_kernel`: q and k are normalised and roped ONCE per
//     (b, row, h), q times scale*log2e, rounded to bf16 into a scratch
//     (2, B, S, H, D) the wrapper allocates. D/8 threads own a (b, row) and
//     walk its H heads, four 16-byte loads in flight, so the row's fp32
//     table values are read once for all heads; the norm's sum of squares
//     is reduced by shuffles inside a head's lanes. K9 gives it ids: batch
//     row b then takes table ids[b] of (nU, S, D) tables.
//  2. `attention_kernel` (FlashAttention-3's shape): a block owns 128 q rows
//     of one (b, h) and has three roles. One producer warp issues TMA loads
//     (cp.async.bulk.tensor, 128-byte swizzle, boxes of 64 rows x 64
//     columns, so D = 128 is two boxes) of q-hat once and of k-hat and v
//     tiles of 64 keys into a 4-stage ring guarded by full / empty
//     mbarriers; v is read in place from the packed operand through a
//     tensor map whose row stride is 3*H*D. Two consumer warpgroups of 64
//     q rows each compute S = q k^T with `wgmma.mma_async` (both operands
//     from shared memory, K-major), the online softmax in registers in the
//     exp2 domain, and O += P v with P taken from the S accumulator as bf16
//     register A fragments and v as an MN-major (transposed) shared operand,
//     so v is never transposed by hand (the tile products are in
//     attention_step.cuh, which K1's backward shares). Key tiles wholly
//     past kv_len are never loaded; the partial one is masked on the fp32
//     scores. K1's and K9's training launches
//     (`seedvr2_packed_attention_lse`, `seedvr2_flash_attention_lse`, the
//     template flag LSE) also store each row's m + log2(l), the lse the
//     backward's dq and dk/dv kernels read (attention_backward.cu); the
//     serving launches instantiate LSE = false. K9's
//     variant (template flag MASKED) takes its keys from a per-window
//     validity row picked by ids[b]: the block stages it as one 64-bit word
//     a key tile and walks only the tiles that hold a valid key, masking a
//     partly valid one on the fp32 scores. The output goes through the
//     warpgroup's spent q tile in the same swizzled layout and out by TMA
//     stores, which clip rows past Sq.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_sm90.cuh"
#include "attention_step.cuh"
#include "sm90.cuh"

namespace {

using seedvr2::PrepassSide;
using namespace seedvr2::sm90;
using namespace seedvr2::step;

// ---------------------------------------------------------------- pre-pass

constexpr int PRE_THREADS = 256;

// D/8 threads own one row (b, s) of H heads, 8 consecutive values of every
// head (whole interleaved pairs), so the row's table values are loaded once
// for all H heads. out = bf16((x_n * cos + rot(x_n) * sin) * mult), x_n =
// x * rsqrt(mean(x^2) + eps) over the head's D values when norm (else x),
// rot(x)[2i] = -x[2i+1], rot(x)[2i+1] = x[2i]; no rotation without a table
// or at rows >= table_rows; with ids, batch row b's table is ids[b]'s.
// blockIdx.y picks the side (0: q, 1: k).
template <int D>
__global__ void __launch_bounds__(PRE_THREADS)
qk_prepass_kernel(const PrepassSide q, const PrepassSide k, int B, int H,
                  int table_rows, int norm, float eps) {
  constexpr int TPR = D / 8;
  constexpr int U = 4;  // heads in flight a thread
  const bool is_q = blockIdx.y == 0;
  const __nv_bfloat16* src =
      static_cast<const __nv_bfloat16*>(is_q ? q.src : k.src);
  const long long stride = is_q ? q.src_stride : k.src_stride;
  const float* cos_t = is_q ? q.cos : k.cos;
  const float* sin_t = is_q ? q.sin : k.sin;
  const int* ids = is_q ? q.ids : k.ids;
  const long long t_stride = is_q ? q.table_stride : k.table_stride;
  __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(is_q ? q.dst : k.dst);
  const int rows = is_q ? q.rows : k.rows;
  const float mult = is_q ? q.mult : k.mult;

  const long long total = (long long)B * rows;
  long long row = (long long)blockIdx.x * (PRE_THREADS / TPR) +
                  threadIdx.x / TPR;
  const bool live = row < total;
  if (!live) row = total - 1;  // keeps the row's shuffles whole
  const int c = (threadIdx.x % TPR) * 8;
  const int s = int(row % rows);
  const bool rot = cos_t != nullptr && s < table_rows;
  float cs[8], sn[8];
  if (rot) {
    // K9: the batch row's own table, picked by its id
    const long long t0 = (ids != nullptr ? ids[row / rows] * t_stride : 0) +
                         (long long)s * D + c;
    const float4* cp = reinterpret_cast<const float4*>(cos_t + t0);
    const float4* sp = reinterpret_cast<const float4*>(sin_t + t0);
    const float4 c0 = cp[0], c1 = cp[1], s0 = sp[0], s1 = sp[1];
    cs[0] = c0.x; cs[1] = c0.y; cs[2] = c0.z; cs[3] = c0.w;
    cs[4] = c1.x; cs[5] = c1.y; cs[6] = c1.z; cs[7] = c1.w;
    sn[0] = s0.x; sn[1] = s0.y; sn[2] = s0.z; sn[3] = s0.w;
    sn[4] = s1.x; sn[5] = s1.y; sn[6] = s1.z; sn[7] = s1.w;
  }
  const __nv_bfloat16* x_row = src + row * stride + c;
  __nv_bfloat16* y_row = dst + row * H * D + c;

  for (int h0 = 0; h0 < H; h0 += U) {
    uint4 raw[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (h0 + u < H)
        raw[u] = *reinterpret_cast<const uint4*>(x_row + (h0 + u) * D);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (h0 + u >= H) break;  // the same for every lane
      const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&raw[u]);
      float x[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(xp[i]);
        x[2 * i] = f.x;
        x[2 * i + 1] = f.y;
      }
      if (norm) {
        float ss = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) ss += x[e] * x[e];
#pragma unroll
        for (int off = TPR / 2; off > 0; off >>= 1)
          ss += __shfl_xor_sync(0xffffffffu, ss, off);
        const float inv = rsqrtf(ss / float(D) + eps);
#pragma unroll
        for (int e = 0; e < 8; ++e) x[e] *= inv;
      }
      float y[8];
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        y[e] = rot ? x[e] * cs[e] - x[e + 1] * sn[e] : x[e];
        y[e + 1] = rot ? x[e + 1] * cs[e + 1] + x[e] * sn[e + 1] : x[e + 1];
      }
      uint4 packed;
      __nv_bfloat162* yp = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        yp[i] = __floats2bfloat162_rn(y[2 * i] * mult, y[2 * i + 1] * mult);
      if (live) *reinterpret_cast<uint4*>(y_row + (h0 + u) * D) = packed;
    }
  }
}

template <int D>
cudaError_t launch_prepass(const PrepassSide& q, const PrepassSide& k, int B,
                           int H, int table_rows, bool norm, float eps,
                           cudaStream_t stream) {
  constexpr int ROWS = PRE_THREADS / (D / 8);
  const long long total = (long long)B * (q.rows > k.rows ? q.rows : k.rows);
  if (total == 0) return cudaSuccess;
  const dim3 grid(unsigned((total + ROWS - 1) / ROWS), 2);
  qk_prepass_kernel<D><<<grid, PRE_THREADS, 0, stream>>>(
      q, k, B, H, table_rows, norm ? 1 : 0, eps);
  return cudaGetLastError();
}

// ----------------------------------------------------- the attention step

constexpr int BM = 64;         // q rows of one consumer warpgroup
constexpr int CONSUMERS = 2;   // consumer warpgroups a block
constexpr int STAGES = 4;      // depth of the k / v ring
constexpr int THREADS = CONSUMERS * 128 + 32;  // + one producer warp

template <int D>
constexpr size_t smem_bytes() {
  // q tiles, the k and v rings, the barriers, 1024 bytes of alignment slack
  return size_t(CONSUMERS + 2 * STAGES) * (D / BOX) * BOX_BYTES +
         (2 * STAGES + 1) * 8 + 1024;
}

__device__ __forceinline__ uint64_t lds64(uint32_t addr) {
  uint64_t v;
  asm volatile("ld.shared.u64 %0, [%1];" : "=l"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ int lds32(uint32_t addr) {
  int v;
  asm volatile("ld.shared.s32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

// Online softmax over one tile of fp32 scores, exp2 domain, for the rows g
// and g + 8 this thread holds: scores times score_scale (1 when q was
// pre-scaled), keys at or past kv_len masked (MASKED: the keys whose bit in
// the tile's validity word `bits` is 0), the running max clamped at -1e30 so
// that a row with no valid key yet leaves exp2(-inf - m) = 0 and no NaN.
// Leaves exp2(s - m) in sc, this thread's partial sums in l, and the factor
// O must be rescaled by in corr.
template <bool MASKED>
__device__ __forceinline__ void softmax_tile(float (&sc)[BN / 2], int k0,
                                             int kv_len, uint64_t bits,
                                             float score_scale, int t,
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2]) {
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sc[i] *= score_scale;
  if constexpr (MASKED) {
    if (~bits != 0) {
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int col = 8 * i + 2 * t;
        if (!((bits >> col) & 1)) sc[4 * i] = sc[4 * i + 2] = -INFINITY;
        if (!((bits >> (col + 1)) & 1))
          sc[4 * i + 1] = sc[4 * i + 3] = -INFINITY;
      }
    }
  } else if (k0 + BN > kv_len) {
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int col = k0 + 8 * i + 2 * t;
      if (col >= kv_len) sc[4 * i] = sc[4 * i + 2] = -INFINITY;
      if (col + 1 >= kv_len) sc[4 * i + 1] = sc[4 * i + 3] = -INFINITY;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // r = 0: row g, r = 1: row g + 8
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
      mx = fmaxf(mx, fmaxf(sc[4 * i + 2 * r], sc[4 * i + 2 * r + 1]));
    const float mn = fmaxf(fmaxf(m[r], quad_max(mx)), -1e30f);
    corr[r] = exp2f(m[r] - mn);
    m[r] = mn;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      sc[4 * i + 2 * r] = exp2f(sc[4 * i + 2 * r] - mn);
      sc[4 * i + 2 * r + 1] = exp2f(sc[4 * i + 2 * r + 1] - mn);
      sum += sc[4 * i + 2 * r] + sc[4 * i + 2 * r + 1];
    }
    l[r] = l[r] * corr[r] + sum;
  }
}

template <int D>
__device__ __forceinline__ void rescale(float (&o)[D / 2],
                                        const float (&corr)[2]) {
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    o[4 * i] *= corr[0];
    o[4 * i + 1] *= corr[0];
    o[4 * i + 2] *= corr[1];
    o[4 * i + 3] *= corr[1];
  }
}

// The accumulators follow attention_step.cuh's layout: two adjacent
// 8-column blocks of the score tile are the register A fragment of one
// 16-key step of P v.
//
// LSE (K1's and K9's training launches): each row's log-sum-exp of its
// scores, m + log2(l) in the exp2 domain, is also written into lse_out
// ((B, H, Sk) fp32, Sq == Sk) for every row below Sk; the serving launches
// instantiate LSE = false and never touch lse_out. The output of either
// instantiation is the same arithmetic, so a training launch's output is
// bit-equal to the serving launch's.
//
// MASKED (K9): batch row b's keys are those that row ids[b] of key_valid
// ((nU, Sk) bytes) marks. The block first stages that row as one 64-bit
// validity word a key tile, then the list of the tiles whose word is not 0,
// both in shared memory behind a barrier (attention_step.cuh
// stage_live_tiles): the producer and both consumer warpgroups walk that
// one list, so their mbarrier phases agree, and a tile with no valid key is
// never loaded or multiplied (each of its keys would add exp2(-inf) = 0).
template <int D, bool MASKED, bool LSE>
__global__ void __launch_bounds__(THREADS, 1)
attention_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_o, int kv_len,
                 float score_scale,
                 const unsigned char* __restrict__ key_valid,
                 const int* __restrict__ ids, int Sk,
                 float* __restrict__ lse_out) {
  constexpr int P = D / BOX;                 // 64-column panels of a tile
  constexpr uint32_t TILE = P * BOX_BYTES;   // one 64-row tile, D columns
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base;                       // CONSUMERS tiles
  const uint32_t sK = sQ + CONSUMERS * TILE;      // STAGES tiles
  const uint32_t sV = sK + STAGES * TILE;         // STAGES tiles
  const uint32_t full = sV + STAGES * TILE;       // STAGES barriers
  const uint32_t empty = full + 8 * STAGES;       // STAGES barriers
  const uint32_t qbar = empty + 8 * STAGES;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * (CONSUMERS * BM);
  // MASKED: after the barriers, the key tiles' validity words; then, in
  // order, the live tiles' words and indices, and their count
  const int all_tiles = MASKED ? (Sk + BN - 1) / BN : 0;
  const uint32_t live_words = qbar + 8 + 8 * all_tiles;
  const uint32_t live_tiles = live_words + 8 * all_tiles;
  uint64_t* words = reinterpret_cast<uint64_t*>(smem_raw + (qbar + 8 - raw));

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS * 128);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  int n_tiles = (kv_len + BN - 1) / BN;  // tiles past kv_len skipped
  if constexpr (MASKED)
    n_tiles = stage_live_tiles(words, key_valid + (long long)ids[b] * Sk, Sk);
  else
    __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // producer: one thread keeps the ring full
    if (threadIdx.x == CONSUMERS * 128) {
      mbar_expect_tx(qbar, CONSUMERS * TILE);
      for (int c = 0; c < CONSUMERS; ++c)
        for (int p = 0; p < P; ++p)
          tma_load(sQ + c * TILE + p * BOX_BYTES, &tm_q, qbar,
                   h * D + p * BOX, q0 + c * BM, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        const int k0 = (MASKED ? lds32(live_tiles + 4 * j) : j) * BN;
        mbar_wait(empty + 8 * s, ((j / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * TILE);
        for (int p = 0; p < P; ++p) {
          tma_load(sK + s * TILE + p * BOX_BYTES, &tm_k, full + 8 * s,
                   h * D + p * BOX, k0, b);
          tma_load(sV + s * TILE + p * BOX_BYTES, &tm_v, full + 8 * s,
                   h * D + p * BOX, k0, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns q rows q0 + 64 wg .. + 63
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const uint32_t q_tile = sQ + wg * TILE;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows g, g + 8
  float l[2] = {0.f, 0.f};              // this thread's partial sums
  float corr[2];
  float sc[BN / 2];
  uint32_t pa[BN / 16][4];

  // tile j's validity word (MASKED)
  auto bits = [&](int j) {
    return MASKED ? lds64(live_words + 8 * j) : ~uint64_t(0);
  };

  // Tile j's scores are issued together with tile j - 1's P v, and tile j's
  // softmax runs while that P v is still on the tensor cores; O is rescaled
  // once it has landed. A row with no live tile (MASKED) writes zeros, as
  // the TPU kernel's 0 / max(0, 1e-30).
  mbar_wait(qbar, 0);
  if (n_tiles > 0) {
    mbar_wait(full, 0);
    issue_scores<D>(sc, q_tile, sK);
    wgmma_wait<0>();
    reg_fence(sc);
    softmax_tile<MASKED>(sc, 0, kv_len, bits(0), score_scale, t, m, l, corr);
    pack_p(pa, sc);
    for (int j = 1; j < n_tiles; ++j) {
      const int s = j % STAGES;
      const int sp = (j - 1) % STAGES;
      mbar_wait(full + 8 * s, (j / STAGES) & 1);
      issue_scores<D>(sc, q_tile, sK + s * TILE);
      issue_pv<D>(o, pa, sV + sp * TILE);
      wgmma_wait<1>();  // the scores have landed
      reg_fence(sc);
      softmax_tile<MASKED>(sc, j * BN, kv_len, bits(j), score_scale, t, m, l,
                           corr);
      wgmma_wait<0>();  // P v has landed
      reg_fence(o);
      mbar_arrive(empty + 8 * sp);  // this thread is done with stage sp
      rescale<D>(o, corr);
      pack_p(pa, sc);
    }
    issue_pv<D>(o, pa, sV + ((n_tiles - 1) % STAGES) * TILE);
    wgmma_wait<0>();
    reg_fence(o);
  }

  // out = O / max(l, 1e-30) as bf16, written into the warpgroup's spent q
  // tile in the TMA box layout (16-byte chunk c of row r at chunk c ^ (r %
  // 8)), then stored by TMA, which drops rows past Sq
  const float d_lo = fmaxf(quad_sum(l[0]), 1e-30f);
  const float d_hi = fmaxf(quad_sum(l[1]), 1e-30f);
  unsigned char* out_tile = smem_raw + (q_tile - raw);
  const int r_lo = warp * 16 + g;  // r_lo % 8 == (r_lo + 8) % 8 == g
  if constexpr (LSE) {
    const int row = q0 + wg * BM + r_lo;
    float* dst = lse_out + ((long long)b * gridDim.y + h) * Sk + row;
    if (t == 0 && row < Sk) dst[0] = m[0] + log2f(d_lo);
    if (t == 0 && row + 8 < Sk) dst[8] = m[1] + log2f(d_hi);
  }
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const uint32_t off =
        (i / 8) * BOX_BYTES + r_lo * 128 + (((i % 8) ^ g) * 16) + 4 * t;
    *reinterpret_cast<__nv_bfloat162*>(out_tile + off) =
        __floats2bfloat162_rn(o[4 * i] / d_lo, o[4 * i + 1] / d_lo);
    *reinterpret_cast<__nv_bfloat162*>(out_tile + off + 8 * 128) =
        __floats2bfloat162_rn(o[4 * i + 2] / d_hi, o[4 * i + 3] / d_hi);
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
  if (tid == 0) {
    for (int p = 0; p < P; ++p)
      tma_store(&tm_o, q_tile + p * BOX_BYTES, h * D + p * BOX, q0 + wg * BM,
                b);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

// Tensor map of B batch rows of `rows` rows of H*D bf16 (row stride
// `row_stride` elements), boxes of 64 x 64 with the 128-byte swizzle; reads
// past a batch row's last row are zero-filled, writes there dropped.
bool make_map(CUtensorMap* map, const void* ptr, int B, int rows, int H,
              int D, long long row_stride) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {cuuint64_t(H) * D, cuuint64_t(rows),
                              cuuint64_t(B)};
  const cuuint64_t strides[2] = {cuuint64_t(row_stride) * 2,
                                 cuuint64_t(row_stride) * 2 * rows};
  const cuuint32_t box[3] = {BOX, BOX, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, bool MASKED, bool LSE = false>
cudaError_t launch_attention(const CUtensorMap& q, const CUtensorMap& k,
                             const CUtensorMap& v, const CUtensorMap& o,
                             int B, int Sq, int Sk, int H, int kv_len,
                             float score_scale,
                             const unsigned char* key_valid, const int* ids,
                             cudaStream_t stream, float* lse = nullptr) {
  // MASKED: two validity words and a list entry a key tile, and the count
  const size_t smem =
      smem_bytes<D>() + (MASKED ? size_t((Sk + BN - 1) / BN) * 20 + 16 : 0);
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<D, MASKED, LSE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + CONSUMERS * BM - 1) / (CONSUMERS * BM), H, B);
  attention_kernel<D, MASKED, LSE><<<grid, THREADS, smem, stream>>>(
      q, k, v, o, kv_len, score_scale, key_valid, ids, Sk, lse);
  return cudaGetLastError();
}

}  // namespace

namespace seedvr2 {

cudaError_t qk_prepass(int D, const PrepassSide& q, const PrepassSide& k,
                       int B, int H, int table_rows, bool norm, float eps,
                       cudaStream_t stream) {
  if (D == 128)
    return launch_prepass<128>(q, k, B, H, table_rows, norm, eps, stream);
  if (D == 64)
    return launch_prepass<64>(q, k, B, H, table_rows, norm, eps, stream);
  return cudaErrorInvalidValue;
}

cudaError_t attention_sm90(const void* q, long long q_stride, const void* k,
                           long long k_stride, const void* v,
                           long long v_stride, void* out, int B, int Sq,
                           int Sk, int H, int D, int kv_len,
                           float score_scale, cudaStream_t stream,
                           const unsigned char* key_valid, const int* ids,
                           float* lse) {
  if (B == 0 || Sq == 0) return cudaSuccess;
  const bool masked = key_valid != nullptr;
  if ((D != 64 && D != 128) || (masked && ids == nullptr) ||
      (!masked && (kv_len < 1 || kv_len > Sk)) ||
      (lse != nullptr && Sq != Sk))
    return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, to;
  if (!make_map(&tq, q, B, Sq, H, D, q_stride) ||
      !make_map(&tk, k, B, Sk, H, D, k_stride) ||
      !make_map(&tv, v, B, Sk, H, D, v_stride) ||
      !make_map(&to, out, B, Sq, H, D, (long long)H * D))
    return cudaErrorInvalidValue;
  if (lse != nullptr && masked)  // K9's training launch
    return D == 128 ? launch_attention<128, true, true>(
                          tq, tk, tv, to, B, Sq, Sk, H, kv_len, score_scale,
                          key_valid, ids, stream, lse)
                    : launch_attention<64, true, true>(
                          tq, tk, tv, to, B, Sq, Sk, H, kv_len, score_scale,
                          key_valid, ids, stream, lse);
  if (lse != nullptr)  // K1's training launch
    return D == 128 ? launch_attention<128, false, true>(
                          tq, tk, tv, to, B, Sq, Sk, H, kv_len, score_scale,
                          nullptr, nullptr, stream, lse)
                    : launch_attention<64, false, true>(
                          tq, tk, tv, to, B, Sq, Sk, H, kv_len, score_scale,
                          nullptr, nullptr, stream, lse);
  if (masked)
    return D == 128 ? launch_attention<128, true>(tq, tk, tv, to, B, Sq, Sk,
                                                  H, kv_len, score_scale,
                                                  key_valid, ids, stream)
                    : launch_attention<64, true>(tq, tk, tv, to, B, Sq, Sk, H,
                                                 kv_len, score_scale,
                                                 key_valid, ids, stream);
  return D == 128 ? launch_attention<128, false>(tq, tk, tv, to, B, Sq, Sk, H,
                                                 kv_len, score_scale, nullptr,
                                                 nullptr, stream)
                  : launch_attention<64, false>(tq, tk, tv, to, B, Sq, Sk, H,
                                                kv_len, score_scale, nullptr,
                                                nullptr, stream);
}

}  // namespace seedvr2

// qkv (B, S, 3*H*D) bf16, tables (S, D) fp32, scratch (2, B, S, H, D) bf16
// (q-hat, k-hat), out (B, S, H*D) bf16; all contiguous and 16-byte aligned,
// 1 <= kv_len <= S, D in {64, 128}: checked by the Python wrapper
// (seedvr2_tpu_torch/ops/flash_attention.py). Launches the pre-pass, then
// the attention step.
static int packed_attention(const void* qkv, const void* cos_q,
                            const void* sin_q, const void* cos_k,
                            const void* sin_k, void* scratch, void* out,
                            float* lse, int B, int S, int H, int D, int kv_len,
                            float eps, float qscale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long hd = (long long)H * D;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(qkv);
  __nv_bfloat16* q_hat = static_cast<__nv_bfloat16*>(scratch);
  __nv_bfloat16* k_hat = q_hat + (long long)B * S * hd;
  const PrepassSide q{x, 3 * hd, static_cast<const float*>(cos_q),
                      static_cast<const float*>(sin_q), q_hat, S, qscale};
  const PrepassSide k{x + hd, 3 * hd, static_cast<const float*>(cos_k),
                      static_cast<const float*>(sin_k), k_hat, S, 1.f};
  cudaError_t err = seedvr2::qk_prepass(D, q, k, B, H, S, true, eps, st);
  if (err != cudaSuccess) return int(err);
  return int(seedvr2::attention_sm90(q_hat, hd, k_hat, hd, x + 2 * hd, 3 * hd,
                                     out, B, S, S, H, D, kv_len, 1.f, st,
                                     nullptr, nullptr, lse));
}

extern "C" int seedvr2_packed_attention(const void* qkv, const void* cos_q,
                                        const void* sin_q, const void* cos_k,
                                        const void* sin_k, void* scratch,
                                        void* out, int B, int S, int H, int D,
                                        int kv_len, float eps, float qscale,
                                        void* stream) {
  return packed_attention(qkv, cos_q, sin_q, cos_k, sin_k, scratch, out,
                          nullptr, B, S, H, D, kv_len, eps, qscale, stream);
}

// K1's training launch: as seedvr2_packed_attention, and each row's
// log-sum-exp (exp2 domain of the pre-pass output's scores, over the keys
// below kv_len) into lse ((B, H, S) fp32, every row written), the lse that
// the dq and dk/dv kernels of K1's backward (attention_backward.cu) read.
extern "C" int seedvr2_packed_attention_lse(
    const void* qkv, const void* cos_q, const void* sin_q, const void* cos_k,
    const void* sin_k, void* scratch, void* out, void* lse, int B, int S,
    int H, int D, int kv_len, float eps, float qscale, void* stream) {
  return packed_attention(qkv, cos_q, sin_q, cos_k, sin_k, scratch, out,
                          static_cast<float*>(lse), B, S, H, D, kv_len, eps,
                          qscale, stream);
}

// The pre-pass alone: q_src (B, Sq, H, D) and k_src (B, Sk, H, D) bf16 at row
// strides q_stride / k_stride elements (heads and D contiguous), tables
// (table_rows, D) fp32 or null, or with ids (B int32, K9) (nU, table_rows,
// D) tables of which batch row b takes ids[b]'s, q_dst / k_dst contiguous
// bf16; checked by the Python wrapper.
extern "C" int seedvr2_qk_prepass(const void* q_src, long long q_stride,
                                  const void* k_src, long long k_stride,
                                  const void* cos_q, const void* sin_q,
                                  const void* cos_k, const void* sin_k,
                                  const void* ids, void* q_dst, void* k_dst,
                                  int B, int Sq, int Sk, int H, int D,
                                  int table_rows, int norm, float eps,
                                  float qscale, void* stream) {
  const int* id = static_cast<const int*>(ids);
  const long long t_stride = (long long)table_rows * D;
  const PrepassSide q{q_src, q_stride, static_cast<const float*>(cos_q),
                      static_cast<const float*>(sin_q), q_dst, Sq, qscale,
                      id, t_stride};
  const PrepassSide k{k_src, k_stride, static_cast<const float*>(cos_k),
                      static_cast<const float*>(sin_k), k_dst, Sk, 1.f, id,
                      t_stride};
  return int(seedvr2::qk_prepass(D, q, k, B, H, table_rows, norm != 0, eps,
                                 static_cast<cudaStream_t>(stream)));
}
