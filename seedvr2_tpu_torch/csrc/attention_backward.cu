// Backward of the packed window attention (kernel K1's gradient) and of
// the windowed attention (kernel K9's gradient).
//
// Replaces: no TPU kernel. The JAX package differentiates the jnp
// composition behind `flash_packed_attention`
// (comfyui-seedvr2_tpu/ops/flash_attention.py; ops/attention.py
// packed_attention) and has no backward kernel; the port's training path
// may not run that composition on the card, so K1's gradient is written
// here by hand. Driven by seedvr2_tpu_torch/ops/flash_attention.py
// (packed_window_attention_backward), which first relaunches K1's own
// pre-pass (packed_attention.cu) for q-hat (normed, roped, times
// scale*log2e) and k-hat in bf16, and takes each row's log-sum-exp (lse,
// exp2 domain) from K1's forward, whose training launch writes it.
//
// Three parts, one C entry each:
//  (a) `attn_bwd_dq_kernel`: a block owns 64 q rows of one (b, h) per
//      consumer warpgroup. It forms delta_i = sum_d dO_i * O_i, then sweeps
//      the key tiles below kv_len once: P = exp2(q-hat k-hat^T - lse), dS =
//      P * (dO v^T - delta), dQ-hat += dS k-hat. Writes dQ-hat (fp32) and
//      delta.
//  (b) `attn_bwd_dkdv_kernel`: a block owns 64 keys of one (b, h) and
//      walks the q tiles below kv_len: P^T and dS^T from lse and delta, dV
//      += P^T dO (written as bf16 into d qkv's v columns) and dK-hat +=
//      dS^T q-hat (fp32).
//  (c) `prepass_bwd_kernel`: per (b, row), D/8 threads walk the H heads as
//      the forward pre-pass does: the roped rows' gradient (dQ-hat times
//      ln2 * scale * log2e = scale for q, dK-hat times ln2 for k) goes back
//      through the rotation (rot^T = -rot) and the RMS norm with eps into
//      d qkv's q / k columns as bf16; the four fp32 table gradients
//      (d cos = g * n, d sin = g * rot(n)) are summed over the heads in
//      registers into per-(b, row) partials, and `table_fold_kernel` sums
//      those over b in order.
// Output rows at or past kv_len are the lane pad, which the caller
// discards: their dO counts as zero, so every row at or past kv_len gets
// zero gradient. No float atomics anywhere, and every output tile is
// written by one block: reruns are bit-identical.
//
// K9's gradient (the uniform window plan's windowed attention; the JAX
// package differentiates the jnp composition behind `_fa_rope_mask_kernel`
// (comfyui-seedvr2_tpu/ops/attention.py attention, table_ids branch) and
// has no backward kernel): the same step with a MASKED flag, driven by
// flash_windowed_attention_backward, which relaunches K9's pre-pass for
// q-hat / k-hat and takes lse from K9's training launch. A window row b's
// keys are those row ids[b] of the (nU, S) validity mask marks, in place of
// kv_len; every q row is live (the rows the caller crops carry dO = 0).
// (a) stages its row's validity as one 64-bit word a key tile and the list
// of live tiles in shared memory behind a barrier, as K9's forward step
// (stage_live_tiles), and walks only those tiles, masking a partly valid
// one on the fp32 scores; (b) votes once whether its 64 keys hold a valid
// key (a block of none writes zeros and exits) and gives masked keys P =
// 0; (d) `rope_bwd_kernel` is K9's pre-pass backward: rot^T of dQ-hat *
// scale and dK-hat * ln2 by the table ids[b] picks, into bf16 (the pre-pass
// only ropes, with the plan's constant tables: no norm, no table
// gradients). The conditionals of (a) and (b) stay outside the wgmma
// pipelines, as K1's do.
//
// What bounds it on an H100: (a) and (b) are products, 6 and 8 * S *
// kv_len * D flops per (b, h) (3 and 4 products of 2 * S * kv_len * D), on
// the tensor cores at 989 TFLOP/s; at the 3B's windows (S <= 512, D = 128)
// a (b, h) moves about 12 * S * D bytes against that, so bytes and
// operations are close, and what holds both kernels is latency: each
// 64-row tile's products depend on one another through the elementwise P
// and dS. The design is K1's forward step: TMA rings of 64-row tiles
// (128-byte swizzle) behind full / empty mbarriers fed by a producer warp,
// consumer warpgroups issuing every product as `wgmma.mma_async`
// (attention_step.cuh), P and dS in fp32 registers. The split into two
// kernels recomputes S and dP but needs no (key tiles x rows x D) fp32
// workspace for dQ, no second reduction pass and no atomics. Registers
// shape both: at 9 warps an SM (or 2 x 5) ptxas gives a thread 168, and
// `setmaxnreg` in a producer warpgroup did not raise what ptxas allocated
// for the consumers (it spilled). (a) keeps dS as register A fragments and
// lets a tile's products wait for each other, the overlap coming from the
// SM's two warpgroups (staging dS in shared memory to issue the next
// tile's S and dP first ran 15 % slower). (b) splits each q tile between
// its two warpgroups for S^T and dP^T, stages P^T and dS^T as bf16 A tiles
// in shared memory, and splits D between them for the dK-hat / dV
// products, so that each element is formed once and a warpgroup holds two
// 64 x 64 accumulators; it issues the next tile's S^T and dP^T before this
// tile's products. Both loops keep their conditionals outside the wgmma
// pipeline (a peeled last tile): under an `if`, ptxas serialised every
// wgmma (C7514 / C7518). Beside the cost a tile, each block pays a fixed
// cost several tiles long (ab_attention_backward.py's shapes with 8, 15
// and 29 tiles a block show it); a persistent variant, one block an SM
// loading the next item's resident tiles while one runs, did not remove
// it, so the grids stay one block a tile row. P and dS are rounded to
// bf16 where they become tensor-core operands, as in every tensor-core
// attention backward; P is split into bf16 hi + lo for dV so that dV keeps
// fp32-class accuracy (one bf16 P gives dV ~2.6e-3 relative L2). A host
// plan (backward_plan) picks 1 or 2 consumer warpgroups a dq block so that
// small groups (B = 2, S = 128) still spread over the SMs (1: two blocks an
// SM). (c) and (d) are bound by bytes: (c) reads qkv's q / k columns and
// the fp32 dQ-hat / dK-hat once and writes d qkv's q / k columns once; (d)
// reads dQ-hat / dK-hat (and one table row a row) once and writes bf16 dq /
// dk once. (d) could run in (a)'s and (b)'s epilogues instead (a thread's
// accumulator holds whole rotate-half pairs), saving the fp32 round trip;
// it is a launch of its own so that each part is checked alone.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_step.cuh"
#include "sm90.cuh"

namespace {

using namespace seedvr2::sm90;
using namespace seedvr2::step;

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p2[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// Ring depth for C consumer warpgroups a block: C = 2 runs one block an SM,
// C = 1 two (the host plan's small groups), each within its share of the
// SM's shared memory.
template <int C>
__host__ __device__ constexpr int stages() {
  return C == 2 ? 3 : 2;
}

// Bytes of one 64-row tile of D bf16 columns.
template <int D>
__host__ __device__ constexpr uint32_t tile_bytes() {
  return (D / BOX) * BOX_BYTES;
}

template <int D, int C>
constexpr size_t dq_smem_bytes() {
  // q-hat and dO tiles (C each), the k-hat / v ring, delta rows, the
  // barriers, 1024 bytes of alignment slack (K9 adds its live-tile list,
  // masked_list_bytes)
  return size_t(2 * C + 2 * stages<C>()) * tile_bytes<D>() + C * BN * 4 +
         (2 * stages<C>() + 1) * 8 + 1024;
}

// K9's key-tile words and live-tile list (stage_live_tiles) for S keys
inline size_t masked_list_bytes(int S) {
  return size_t((S + BN - 1) / BN) * 20 + 16;
}

constexpr int DKDV_STAGES = 3;  // depth of the dk/dv kernel's q-hat / dO ring

template <int D>
constexpr size_t dkdv_smem_bytes() {
  // k-hat and v tiles, the q-hat / dO ring, two sets of the P^T hi / lo and
  // dS^T A tiles, each stage's lse and delta rows, the barriers, slack
  return size_t(2 + 2 * DKDV_STAGES) * tile_bytes<D>() + 6 * BOX_BYTES +
         DKDV_STAGES * 2 * BN * 4 + (2 * DKDV_STAGES + 1) * 8 + 1024;
}

// Zeros rows r0 .. r0 + rows - 1 of head h of batch row b: fp32 (the
// (B, S, H, D) accumulator at f32, or null) and bf16 (rows at bf_stride, or
// null); a block's threads share the 16-byte stores.
template <int D>
__device__ void zero_rows(float* f32, __nv_bfloat16* bf, long long bf_stride,
                          int b, int S, int H, int h, int r0, int rows) {
  const long long hd = (long long)H * D;
  for (int i = threadIdx.x; i < rows * (D / 4); i += blockDim.x) {
    const long long row = (long long)b * S + r0 + i / (D / 4);
    const int c = (i % (D / 4)) * 4;
    if (f32 != nullptr)
      *reinterpret_cast<float4*>(f32 + row * hd + (long long)h * D + c) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    if (bf != nullptr && c % 8 == 0)
      *reinterpret_cast<uint4*>(bf + row * bf_stride + (long long)h * D + c) =
          make_uint4(0u, 0u, 0u, 0u);
  }
}

// Two bf16 values at row `row`, columns c, c + 1 (c even) of a 64 x 64
// bf16 A tile in shared memory with the 128-byte swizzle (16-byte chunk k
// of row r at chunk k ^ (r % 8)), as TMA would have written it.
__device__ __forceinline__ void st_a(unsigned char* tile, int row, int c,
                                     __nv_bfloat162 v) {
  *reinterpret_cast<__nv_bfloat162*>(
      tile + row * 128 + (((c >> 3) ^ (row & 7)) << 4) + (c & 7) * 2) = v;
}

// dS = P * (dP - delta) over one 64-key tile of the dq kernel, in place of
// the scores: P = exp2(s - lse) for the rows g / g + 8 this thread holds
// (lse and delta per row), 0 at keys past kv_len (the last tile's; MASKED:
// at the keys whose bit in the tile's validity word `bits` is 0) and in
// rows that get no gradient (at or past kv_len).
template <bool MASKED>
__device__ __forceinline__ void dq_ds(float (&sc)[BN / 2],
                                      const float (&dp)[BN / 2], int k0,
                                      int kv_len, uint64_t bits, int t,
                                      const float (&lse)[2],
                                      const float (&dl)[2],
                                      const bool (&live)[2]) {
  const bool edge = MASKED ? ~bits != 0 : k0 + BN > kv_len;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e / 2;
      const int c = 8 * i + 2 * t + e % 2;
      const bool key = MASKED ? ((bits >> c) & 1) != 0 : k0 + c < kv_len;
      const bool on = live[r] && (!edge || key);
      const float p = exp2f(sc[4 * i + e] - lse[r]);
      sc[4 * i + e] = on ? p * (dp[4 * i + e] - dl[r]) : 0.f;
    }
}

// (a) dq: grid (blocks, H, B), C consumer warpgroups of 64 q rows a block
// and one producer warp. q-hat and dO stay resident; the producer keeps the
// 64-key k-hat and v tiles below kv_len in flight in a ring of stages<C>()
// (v read in place from the packed qkv). Per key tile a warpgroup issues S
// = q-hat k-hat^T and dP = dO v^T (wgmma, both operands in shared memory),
// forms dS = exp2(S - lse) * (dP - delta) in fp32 registers, then issues
// dQ-hat += bf16(dS) k-hat (dS as register A fragments, k-hat MN-major, as
// the forward's P v). The tile's products wait for each other: S, dP, the
// dS fragments and the dQ-hat accumulator of two tiles at once would pass
// the 168 registers a thread has at 9 (or 2 x 5) warps an SM, so the
// overlap comes from the SM's two warpgroups. delta
// = rowsum(dO * O) is formed first and written for the dk/dv kernel, 0 at
// or past kv_len. lse comes from K1's forward (its LSE launch). A block
// wholly past kv_len writes zeros. MASKED (K9's backward; kv_len == S,
// every q row live): batch row b's keys are those row ids[b] of key_valid
// ((nU, S) bytes) marks; the block stages that row's validity words and
// live-tile list as K9's forward step does (stage_live_tiles), the
// producer loads only the live tiles, and a partly valid tile is masked on
// the fp32 scores.
template <int D, int C, bool MASKED>
__global__ void __launch_bounds__(C * 128 + 32, C == 1 ? 2 : 1)
attn_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_do,
                   const __nv_bfloat16* __restrict__ out,
                   const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse, float* __restrict__ dq,
                   float* __restrict__ delta, int S, int H, int kv_len,
                   const unsigned char* __restrict__ key_valid,
                   const int* __restrict__ ids) {
  constexpr uint32_t TILE = tile_bytes<D>();
  constexpr int P = D / BOX;
  constexpr int ST = stages<C>();
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * (C * BN);
  const long long hd = (long long)H * D;
  const long long bh = ((long long)b * H + h) * S;  // lse / delta rows
  if (q0 >= kv_len) {  // every row of the block gets zero gradient
    const int rows = min(C * BN, S - q0);
    zero_rows<D>(dq, nullptr, 0, b, S, H, h, q0, rows);
    for (int r = threadIdx.x; r < rows; r += blockDim.x)
      delta[bh + q0 + r] = 0.f;
    return;
  }
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base;                  // C tiles
  const uint32_t sDO = sQ + C * TILE;        // C tiles
  const uint32_t sK = sDO + C * TILE;        // ST tiles
  const uint32_t sV = sK + ST * TILE;        // ST tiles
  const uint32_t s_delta = sV + ST * TILE;   // C * 64 floats
  const uint32_t full = s_delta + C * BN * 4;
  const uint32_t empty = full + 8 * ST;
  const uint32_t qbar = empty + 8 * ST;
  float* delta_s = reinterpret_cast<float*>(smem_raw + (s_delta - raw));
  // MASKED: the key tiles' validity words, then the live tiles' words,
  // indices and count (stage_live_tiles)
  uint64_t* words = reinterpret_cast<uint64_t*>(smem_raw + (qbar + 8 - raw));
  const int all_tiles = MASKED ? (S + BN - 1) / BN : 0;
  const uint64_t* live_words = words + all_tiles;
  const int* live_tiles = reinterpret_cast<const int*>(live_words + all_tiles);

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, C * 128);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  int n_tiles = (kv_len + BN - 1) / BN;
  if constexpr (MASKED)
    n_tiles = stage_live_tiles(words, key_valid + (long long)ids[b] * S, S);
  else
    __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == C) {
    // producer: one thread keeps the ring full
    if (threadIdx.x == C * 128) {
      mbar_expect_tx(qbar, 2 * C * TILE);
      for (int c = 0; c < C; ++c)
        for (int p = 0; p < P; ++p) {
          tma_load(sQ + c * TILE + p * BOX_BYTES, &tm_q, qbar,
                   h * D + p * BOX, q0 + c * BN, b);
          tma_load(sDO + c * TILE + p * BOX_BYTES, &tm_do, qbar,
                   h * D + p * BOX, q0 + c * BN, b);
        }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % ST;
        const int k0 = (MASKED ? live_tiles[j] : j) * BN;
        mbar_wait(empty + 8 * s, ((j / ST) & 1) ^ 1);
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

  // consumers: warpgroup wg owns q rows r0 .. r0 + 63
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = q0 + wg * BN;
  {
    // delta: two threads a row, D / 2 columns each
    const int r = tid / 2;
    const int row = r0 + r;
    float acc = 0.f;
    if (row < kv_len) {
      const long long off = ((long long)b * S + row) * hd + (long long)h * D +
                            (tid % 2) * (D / 2);
#pragma unroll 4
      for (int e = 0; e < D / 2; e += 8) {
        float o[8], gr[8];
        load8(out + off + e, o);
        load8(dout + off + e, gr);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc = fmaf(o[i], gr[i], acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (tid % 2 == 0) {
      delta_s[wg * BN + r] = acc;
      if (row < S) delta[bh + row] = acc;
    }
  }
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
  const int r_lo = warp * 16 + g;
  float lse_r[2], dl[2];
  bool live[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + r_lo + 8 * r;
    lse_r[r] = row < S ? lse[bh + row] : 0.f;
    dl[r] = delta_s[wg * BN + r_lo + 8 * r];
    live[r] = row < kv_len;
  }
  const uint32_t q_tile = sQ + wg * TILE;
  const uint32_t do_tile = sDO + wg * TILE;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float sc[BN / 2], dp[BN / 2];
  uint32_t pa[BN / 16][4];

  mbar_wait(qbar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % ST;
    mbar_wait(full + 8 * s, (j / ST) & 1);
    issue_scores<D>(sc, q_tile, sK + s * TILE);
    issue_scores<D>(dp, do_tile, sV + s * TILE);
    wgmma_wait<0>();
    reg_fence(sc);
    reg_fence(dp);
    dq_ds<MASKED>(sc, dp, (MASKED ? live_tiles[j] : j) * BN, kv_len,
                  MASKED ? live_words[j] : 0, t, lse_r, dl, live);
    pack_p(pa, sc);
    issue_pv<D>(acc, pa, sK + s * TILE);
    wgmma_wait<0>();
    reg_fence(acc);
    mbar_arrive(empty + 8 * s);  // this thread is done with stage s
  }

  // dQ-hat rows as fp32, two values a store (rows at or past kv_len are 0)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + r_lo + 8 * r;
    if (row >= S) continue;
    float* dst = dq + ((long long)b * S + row) * hd + (long long)h * D + 2 * t;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<float2*>(dst + 8 * i) =
          make_float2(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
  }
}

// P^T (as bf16 hi and lo, hi = bf16(p), lo = bf16(p - hi), so that hi +
// lo carries P to about 16 bits) and dS^T of this warpgroup's HQ q columns
// (c0 .. c0 + HQ - 1 of the q tile at q0) into the shared A tiles at
// `tiles` (hi, lo, dS^T BOX_BYTES apart; 64 keys x 64 q rows, 128-byte
// swizzle: 16-byte chunk c of row r at chunk c ^ (r % 8)). The rows are
// keys, the columns q rows, so lse and delta vary along the columns (read
// from the stage's rows). 0 at keys past kv_len and at q rows past kv_len,
// whose dO arrives unmasked.
template <int HQ>
__device__ __forceinline__ void dkdv_store_p_ds(
    const float (&sc)[HQ / 2], const float (&dp)[HQ / 2],
    unsigned char* tiles, const float* rows, int q0, int c0, int kv_len,
    int t, int r_lo, const bool (&live)[2]) {
  const bool edge = q0 + BN > kv_len;
#pragma unroll
  for (int i = 0; i < HQ / 8; ++i) {
    const int c = c0 + 8 * i + 2 * t;
    const float2 ls = *reinterpret_cast<const float2*>(rows + c);
    const float2 dl = *reinterpret_cast<const float2*>(rows + BN + c);
    const bool on0 = !edge || q0 + c < kv_len;
    const bool on1 = !edge || q0 + c + 1 < kv_len;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float* s2 = sc + 4 * i + 2 * r;
      const float* d2 = dp + 4 * i + 2 * r;
      const bool a = live[r] && on0;
      const bool b = live[r] && on1;
      const float p0 = a ? exp2f(s2[0] - ls.x) : 0.f;
      const float p1 = b ? exp2f(s2[1] - ls.y) : 0.f;
      const float ds0 = a ? p0 * (d2[0] - dl.x) : 0.f;
      const float ds1 = b ? p1 * (d2[1] - dl.y) : 0.f;
      const int row = r_lo + 8 * r;
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
      st_a(tiles, row, c, hi);
      st_a(tiles + BOX_BYTES, row, c,
           __floats2bfloat162_rn(p0 - __low2float(hi), p1 - __high2float(hi)));
      st_a(tiles + 2 * BOX_BYTES, row, c, __floats2bfloat162_rn(ds0, ds1));
    }
  }
}

// Issues (and commits) dK-hat += dS^T q-hat and dV += (P^T hi + lo) dO on
// one 64-column panel, every operand in shared memory: the A tiles at
// `tiles` (hi, lo, dS^T) K-major, q-hat and dO's panel MN-major (a 16-row
// step 2048 bytes further).
__device__ __forceinline__ void issue_dk_dv(float (&dka)[BN / 2],
                                            float (&dva)[BN / 2],
                                            uint32_t tiles, uint32_t q_panel,
                                            uint32_t do_panel) {
  reg_fence(dka);
  reg_fence(dva);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < BN / 16; ++ks) {
    const uint64_t dq = sw128_desc(q_panel + ks * 2048, BOX_BYTES, 1024);
    const uint64_t ddo = sw128_desc(do_panel + ks * 2048, BOX_BYTES, 1024);
    wgmma_ss_mn(dka, sw128_desc(tiles + 2 * BOX_BYTES + ks * 32, 16, 1024),
                dq);
    wgmma_ss_mn(dva, sw128_desc(tiles + ks * 32, 16, 1024), ddo);
    wgmma_ss_mn(dva, sw128_desc(tiles + BOX_BYTES + ks * 32, 16, 1024), ddo);
  }
  wgmma_commit();
}

// (b) dk/dv: grid (blocks, H, B), a block owns 64 keys, with W = D / 64
// consumer warpgroups and one producer warp. k-hat and v stay resident;
// the producer keeps the q tiles below kv_len in flight: its lanes stage
// the tile's 64 lse and delta rows into the stage, one lane issues the
// q-hat and dO TMA loads. Warpgroup w forms S^T = k-hat q-hat^T and dP^T =
// v dO^T for its 64 / W q rows of a tile (SS), P^T and dS^T from them in
// fp32 registers, and stores them as bf16 A tiles (P^T as hi + lo) in
// shared memory; after a barrier of the W warpgroups, w accumulates
// dK-hat += dS^T q-hat and dV += (P^T hi + lo) dO over the whole q tile on
// its 64-column panel of D (SS, q-hat and dO MN-major). Each S^T / dP^T
// element is formed once (5 tile products a tile: S^T, dP^T, dK, dV hi,
// dV lo) and a warpgroup holds two 64 x 64 accumulators. The next tile's
// S^T and dP^T are issued before this tile's dK / dV products and formed
// into the other set of A tiles while they run. dK-hat goes out fp32, dV
// as bf16 into dv's rows. A block wholly past kv_len writes zeros.
// MASKED (K9's backward; kv_len == S, every q row live): the block's keys
// are valid where row ids[b] of key_valid ((nU, S) bytes) marks them; a
// block whose 64 keys hold no valid key writes zeros and exits (one
// barrier's vote, before any mbarrier), and a masked key inside a live
// block gets P = 0, so its dK-hat and dV rows stay zero.
template <int D, bool MASKED>
__global__ void __launch_bounds__((D / BOX) * 128 + 32, 1)
attn_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, long long dv_stride,
                     int S, int H, int kv_len,
                     const unsigned char* __restrict__ key_valid,
                     const int* __restrict__ ids) {
  constexpr uint32_t TILE = tile_bytes<D>();
  constexpr int W = D / BOX;  // consumer warpgroups, one a panel
  constexpr int HQ = BN / W;  // q rows of a tile whose S^T a group forms
  constexpr int ST = DKDV_STAGES;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = blockIdx.x * BN;
  const long long hd = (long long)H * D;
  const long long bh = ((long long)b * H + h) * S;
  const unsigned char* vrow =
      MASKED ? key_valid + (long long)ids[b] * S : nullptr;
  bool dead = k0 >= kv_len;  // keys that no row attends: zero gradient
  if constexpr (MASKED)
    dead = !__syncthreads_or(threadIdx.x < BN && k0 + int(threadIdx.x) < S &&
                             vrow[k0 + threadIdx.x] != 0);
  if (dead) {
    zero_rows<D>(dk, dv, dv_stride, b, S, H, h, k0, min(BN, S - k0));
    return;
  }
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sK = base;                   // 1 tile
  const uint32_t sV = sK + TILE;              // 1 tile
  const uint32_t sQ = sV + TILE;              // ST tiles
  const uint32_t sDO = sQ + ST * TILE;        // ST tiles
  const uint32_t s_pds = sDO + ST * TILE;     // 2 x (P^T hi, lo, dS^T)
  const uint32_t s_rows = s_pds + 6 * BOX_BYTES;  // ST x (64 lse, 64 delta)
  const uint32_t full = s_rows + ST * 2 * BN * 4;
  const uint32_t empty = full + 8 * ST;
  const uint32_t kvbar = empty + 8 * ST;
  float* rows_s = reinterpret_cast<float*>(smem_raw + (s_rows - raw));
  unsigned char* pds = smem_raw + (s_pds - raw);

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 32);  // the producer warp's lanes
      mbar_init(empty + 8 * s, W * 128);
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int n_q = (kv_len + BN - 1) / BN;
  const int wg = threadIdx.x / 128;
  if (wg == W) {
    // producer warp: lane 0 issues the loads, every lane stages rows
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      mbar_expect_tx(kvbar, 2 * TILE);
      for (int p = 0; p < W; ++p) {
        tma_load(sK + p * BOX_BYTES, &tm_k, kvbar, h * D + p * BOX, k0, b);
        tma_load(sV + p * BOX_BYTES, &tm_v, kvbar, h * D + p * BOX, k0, b);
      }
    }
    for (int j = 0; j < n_q; ++j) {
      const int s = j % ST;
      mbar_wait(empty + 8 * s, ((j / ST) & 1) ^ 1);
      float* rows = rows_s + s * 2 * BN;
      for (int r = lane; r < BN; r += 32) {
        const int row = j * BN + r;
        rows[r] = row < S ? lse[bh + row] : 0.f;
        rows[BN + r] = row < S ? delta[bh + row] : 0.f;
      }
      if (lane == 0) {
        mbar_expect_tx(full + 8 * s, 2 * TILE);
        for (int p = 0; p < W; ++p) {
          tma_load(sQ + s * TILE + p * BOX_BYTES, &tm_q, full + 8 * s,
                   h * D + p * BOX, j * BN, b);
          tma_load(sDO + s * TILE + p * BOX_BYTES, &tm_do, full + 8 * s,
                   h * D + p * BOX, j * BN, b);
        }
      } else {
        mbar_arrive(full + 8 * s);  // releases this lane's rows
      }
    }
    return;
  }

  // consumers: warpgroup wg forms S^T of q rows c0 .. c0 + HQ - 1 of each
  // tile and owns columns 64 wg .. 64 wg + 63 of the keys' gradients
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r_lo = warp * 16 + g;
  bool live[2];  // this thread's key rows r_lo, r_lo + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + r_lo + 8 * r;
    live[r] = MASKED ? key < S && vrow[key] != 0 : key < kv_len;
  }
  const uint32_t panel = wg * BOX_BYTES;
  const int c0 = wg * HQ;

  float dka[BN / 2], dva[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) dka[i] = dva[i] = 0.f;
  float sc[HQ / 2], dp[HQ / 2];

  mbar_wait(kvbar, 0);
  mbar_wait(full, 0);
  issue_scores<D, HQ>(sc, sK, sQ + c0 * 128);   // S^T
  issue_scores<D, HQ>(dp, sV, sDO + c0 * 128);  // dP^T
  wgmma_wait<0>();
  reg_fence(sc);
  reg_fence(dp);
  dkdv_store_p_ds<HQ>(sc, dp, pds, rows_s, 0, c0, kv_len, t, r_lo, live);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync 1, %0;" ::"n"(W * 128) : "memory");
  for (int j = 0; j + 1 < n_q; ++j) {
    // tile j + 1's S^T and dP^T first, then tile j's products
    const int s = j % ST;
    const int s1 = (j + 1) % ST;
    mbar_wait(full + 8 * s1, ((j + 1) / ST) & 1);
    issue_scores<D, HQ>(sc, sK, sQ + s1 * TILE + c0 * 128);
    issue_scores<D, HQ>(dp, sV, sDO + s1 * TILE + c0 * 128);
    issue_dk_dv(dka, dva, s_pds + (j % 2) * 3 * BOX_BYTES,
                sQ + s * TILE + panel, sDO + s * TILE + panel);
    wgmma_wait<1>();  // S^T and dP^T of tile j + 1 have landed
    reg_fence(sc);
    reg_fence(dp);
    dkdv_store_p_ds<HQ>(sc, dp, pds + ((j + 1) % 2) * 3 * BOX_BYTES,
                        rows_s + s1 * 2 * BN, (j + 1) * BN, c0, kv_len, t,
                        r_lo, live);
    wgmma_wait<0>();  // tile j's dK / dV products have landed
    reg_fence(dka);
    reg_fence(dva);
    mbar_arrive(empty + 8 * s);  // this thread is done with stage s
    // tile j + 1's A tiles are whole; tile j's are read
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync 1, %0;" ::"n"(W * 128) : "memory");
  }
  issue_dk_dv(dka, dva, s_pds + ((n_q - 1) % 2) * 3 * BOX_BYTES,
              sQ + ((n_q - 1) % ST) * TILE + panel,
              sDO + ((n_q - 1) % ST) * TILE + panel);
  wgmma_wait<0>();
  reg_fence(dka);
  reg_fence(dva);

  // dK-hat as fp32, dV as bf16, this warpgroup's 64 columns of each key
  // row (keys at or past kv_len are 0)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + r_lo + 8 * r;
    if (row >= S) continue;
    const int c = wg * BOX + 2 * t;
    float* kd = dk + ((long long)b * S + row) * hd + (long long)h * D + c;
    __nv_bfloat16* vd =
        dv + ((long long)b * S + row) * dv_stride + (long long)h * D + c;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      *reinterpret_cast<float2*>(kd + 8 * i) =
          make_float2(dka[4 * i + 2 * r], dka[4 * i + 2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(vd + 8 * i) =
          __floats2bfloat162_rn(dva[4 * i + 2 * r], dva[4 * i + 2 * r + 1]);
    }
  }
}

constexpr int PRE_THREADS = 256;

// (c): grid (ceil(B * S / rows a block), 2); blockIdx.y picks the side (0:
// q, 1: k). D/8 threads own one (b, row) and 8 columns of every head.
// partials (B, 4, S, D): tables 0, 1 (cos_q, sin_q) from side q, 2, 3 from
// side k.
template <int D>
__global__ void __launch_bounds__(PRE_THREADS)
prepass_bwd_kernel(const __nv_bfloat16* __restrict__ q_src,
                   const __nv_bfloat16* __restrict__ k_src,
                   long long src_stride, const float* __restrict__ cos_q,
                   const float* __restrict__ sin_q,
                   const float* __restrict__ cos_k,
                   const float* __restrict__ sin_k,
                   const float* __restrict__ dq_acc,
                   const float* __restrict__ dk_acc,
                   __nv_bfloat16* __restrict__ dq_dst,
                   __nv_bfloat16* __restrict__ dk_dst, long long dst_stride,
                   float* __restrict__ partials, int B, int S, int H,
                   float eps, float gq, float gk) {
  constexpr int TPR = D / 8;
  const bool is_q = blockIdx.y == 0;
  const __nv_bfloat16* src = is_q ? q_src : k_src;
  const float* cos_t = is_q ? cos_q : cos_k;
  const float* sin_t = is_q ? sin_q : sin_k;
  const float* acc = is_q ? dq_acc : dk_acc;
  __nv_bfloat16* dst = is_q ? dq_dst : dk_dst;
  const float gmul = is_q ? gq : gk;

  const long long total = (long long)B * S;
  long long row = (long long)blockIdx.x * (PRE_THREADS / TPR) +
                  threadIdx.x / TPR;
  const bool live = row < total;
  if (!live) row = total - 1;  // keeps the row's shuffles whole
  const int c = (threadIdx.x % TPR) * 8;
  const int s = int(row % S);
  const long long b = row / S;
  float cs[8], sn[8];
  {
    const long long t0 = (long long)s * D + c;
    const float4* cp = reinterpret_cast<const float4*>(cos_t + t0);
    const float4* sp = reinterpret_cast<const float4*>(sin_t + t0);
    const float4 c0 = cp[0], c1 = cp[1], s0 = sp[0], s1 = sp[1];
    cs[0] = c0.x; cs[1] = c0.y; cs[2] = c0.z; cs[3] = c0.w;
    cs[4] = c1.x; cs[5] = c1.y; cs[6] = c1.z; cs[7] = c1.w;
    sn[0] = s0.x; sn[1] = s0.y; sn[2] = s0.z; sn[3] = s0.w;
    sn[4] = s1.x; sn[5] = s1.y; sn[6] = s1.z; sn[7] = s1.w;
  }
  float pc[8], ps[8];  // this thread's table partials over the heads
#pragma unroll
  for (int e = 0; e < 8; ++e) pc[e] = ps[e] = 0.f;

  for (int h = 0; h < H; ++h) {
    float x[8];
    load8(src + row * src_stride + (long long)h * D + c, x);
    float ss = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) ss += x[e] * x[e];
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    const float r = rsqrtf(ss / float(D) + eps);
    float n[8], g[8], dn[8];
    const float4* ap = reinterpret_cast<const float4*>(
        acc + (row * H + h) * (long long)D + c);
    const float4 a0 = ap[0], a1 = ap[1];
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      n[e] = x[e] * r;
      g[e] = av[e] * gmul;
    }
    float dot = 0.f;
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      // the forward: y[e] = n[e] cs[e] - n[e+1] sn[e],
      // y[e+1] = n[e+1] cs[e+1] + n[e] sn[e+1]
      dn[e] = g[e] * cs[e] + g[e + 1] * sn[e + 1];
      dn[e + 1] = g[e + 1] * cs[e + 1] - g[e] * sn[e];
      pc[e] += g[e] * n[e];
      pc[e + 1] += g[e + 1] * n[e + 1];
      ps[e] -= g[e] * n[e + 1];
      ps[e + 1] += g[e + 1] * n[e];
      dot += dn[e] * n[e] + dn[e + 1] * n[e + 1];
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    const float mean = dot / float(D);
    uint4 packed;
    __nv_bfloat162* yp = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      yp[i] = __floats2bfloat162_rn(r * (dn[2 * i] - n[2 * i] * mean),
                                    r * (dn[2 * i + 1] - n[2 * i + 1] * mean));
    if (live)
      *reinterpret_cast<uint4*>(dst + row * dst_stride + (long long)h * D +
                                c) = packed;
  }
  if (live) {
    const int t0 = is_q ? 0 : 2;
    float* pcos = partials + ((b * 4 + t0) * S + s) * (long long)D + c;
    float* psin = pcos + (long long)S * D;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      pcos[e] = pc[e];
      psin[e] = ps[e];
    }
  }
}

// (d) K9's pre-pass backward, the rope backward by window id: grid (ceil(B
// * S / rows a block), 2); blockIdx.y picks the side (0: q, 1: k). D/8
// threads own one (b, row) and 8 columns of every head; the row's table
// values (table ids[b], picked as K9's pre-pass picks them) are read once
// for its H heads. K9's pre-pass only ropes, with plan-constant tables, so
// this is rot^T of the roped rows' gradient (dQ-hat times gq = scale, dK-hat
// times gk = ln2) into bf16 (B, S, H, D): no norm, no table gradients.
template <int D>
__global__ void __launch_bounds__(PRE_THREADS)
rope_bwd_kernel(const float* __restrict__ dq_acc,
                const float* __restrict__ dk_acc,
                const float* __restrict__ cos_t,
                const float* __restrict__ sin_t, const int* __restrict__ ids,
                __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
                int B, int S, int H, float gq, float gk) {
  constexpr int TPR = D / 8;
  const bool is_q = blockIdx.y == 0;
  const float* acc = is_q ? dq_acc : dk_acc;
  __nv_bfloat16* dst = is_q ? dq : dk;
  const float gmul = is_q ? gq : gk;
  const long long row = (long long)blockIdx.x * (PRE_THREADS / TPR) +
                        threadIdx.x / TPR;
  if (row >= (long long)B * S) return;
  const int c = (threadIdx.x % TPR) * 8;
  const long long t0 = ((long long)ids[row / S] * S + row % S) * D + c;
  const float4* cp = reinterpret_cast<const float4*>(cos_t + t0);
  const float4* sp = reinterpret_cast<const float4*>(sin_t + t0);
  const float4 c0 = cp[0], c1 = cp[1], s0 = sp[0], s1 = sp[1];
  const float cs[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
  const float sn[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll 4
  for (int h = 0; h < H; ++h) {
    const long long off = (row * H + h) * (long long)D + c;
    const float4* ap = reinterpret_cast<const float4*>(acc + off);
    const float4 a0 = ap[0], a1 = ap[1];
    const float g[8] = {a0.x * gmul, a0.y * gmul, a0.z * gmul, a0.w * gmul,
                        a1.x * gmul, a1.y * gmul, a1.z * gmul, a1.w * gmul};
    uint4 packed;
    __nv_bfloat162* yp = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int e = 0; e < 8; e += 2)
      // the forward: y[e] = x[e] cs[e] - x[e+1] sn[e],
      // y[e+1] = x[e+1] cs[e+1] + x[e] sn[e+1]
      yp[e / 2] = __floats2bfloat162_rn(g[e] * cs[e] + g[e + 1] * sn[e + 1],
                                        g[e + 1] * cs[e + 1] - g[e] * sn[e]);
    *reinterpret_cast<uint4*>(dst + off) = packed;
  }
}

// out[i] = sum over b, in order, of partials[b * n + i]
__global__ void __launch_bounds__(256)
table_fold_kernel(const float* __restrict__ partials, float* __restrict__ out,
                  int B, long long n) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  float a = 0.f;
  for (int b = 0; b < B; ++b) a += partials[b * n + i];
  out[i] = a;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes > 232448) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

// Tensor map of B batch rows of S rows of H*D bf16 (row stride `stride`
// elements), boxes of 64 x 64 with the 128-byte swizzle, as K1's forward
// maps its operands.
bool rows_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int D,
              long long stride) {
  return make_map_3d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr,
                     uint64_t(H) * D, uint64_t(S), uint64_t(B),
                     uint64_t(stride) * 2, uint64_t(stride) * 2 * S, BOX, BOX,
                     CU_TENSOR_MAP_SWIZZLE_128B);
}

// The four operands' tensor maps (q-hat, k-hat, v at v_stride, dO) and the
// host plan's grid: `blocks` blocks of `rows` rows must cover S, none of
// them wholly past it.
bool bwd_maps(CUtensorMap (&m)[4], const void* q_hat, const void* k_hat,
              const void* v, long long v_stride, const void* dout, int B,
              int S, int H, int D, int kv_len, int rows, int blocks) {
  const long long hd = (long long)H * D;
  return (D == 64 || D == 128) && kv_len >= 1 && kv_len <= S &&
         (long long)blocks * rows >= S && (long long)(blocks - 1) * rows < S &&
         rows_map(&m[0], q_hat, B, S, H, D, hd) &&
         rows_map(&m[1], k_hat, B, S, H, D, hd) &&
         rows_map(&m[2], v, B, S, H, D, v_stride) &&
         rows_map(&m[3], dout, B, S, H, D, hd);
}

// MASKED: K9's keys (valid, ids), kv_len == S
template <int D, int C, bool MASKED>
cudaError_t launch_dq(const CUtensorMap (&m)[4], const void* out,
                      const void* dout, const void* lse, void* dq,
                      void* delta, int B, int S, int H, int kv_len, int blocks,
                      const void* valid, const void* ids, cudaStream_t st) {
  const size_t smem =
      dq_smem_bytes<D, C>() + (MASKED ? masked_list_bytes(S) : 0);
  cudaError_t err = set_smem(attn_bwd_dq_kernel<D, C, MASKED>, smem);
  if (err != cudaSuccess) return err;
  attn_bwd_dq_kernel<D, C, MASKED>
      <<<dim3(blocks, H, B), C * 128 + 32, smem, st>>>(
          m[0], m[1], m[2], m[3], static_cast<const __nv_bfloat16*>(out),
          static_cast<const __nv_bfloat16*>(dout),
          static_cast<const float*>(lse), static_cast<float*>(dq),
          static_cast<float*>(delta), S, H, kv_len,
          static_cast<const unsigned char*>(valid),
          static_cast<const int*>(ids));
  return cudaGetLastError();
}

template <bool MASKED>
cudaError_t run_dq(const CUtensorMap (&m)[4], const void* out,
                   const void* dout, const void* lse, void* dq, void* delta,
                   int B, int S, int H, int D, int kv_len, int wg, int blocks,
                   const void* valid, const void* ids, cudaStream_t st) {
  if (D == 128)
    return wg == 2 ? launch_dq<128, 2, MASKED>(m, out, dout, lse, dq, delta,
                                               B, S, H, kv_len, blocks, valid,
                                               ids, st)
                   : launch_dq<128, 1, MASKED>(m, out, dout, lse, dq, delta,
                                               B, S, H, kv_len, blocks, valid,
                                               ids, st);
  return wg == 2 ? launch_dq<64, 2, MASKED>(m, out, dout, lse, dq, delta, B,
                                            S, H, kv_len, blocks, valid, ids,
                                            st)
                 : launch_dq<64, 1, MASKED>(m, out, dout, lse, dq, delta, B,
                                            S, H, kv_len, blocks, valid, ids,
                                            st);
}

template <int D, bool MASKED>
cudaError_t launch_dkdv(const CUtensorMap (&m)[4], const void* lse,
                        const void* delta, void* dk, void* dv,
                        long long dv_stride, int B, int S, int H, int kv_len,
                        int blocks, const void* valid, const void* ids,
                        cudaStream_t st) {
  constexpr size_t smem = dkdv_smem_bytes<D>();
  cudaError_t err = set_smem(attn_bwd_dkdv_kernel<D, MASKED>, smem);
  if (err != cudaSuccess) return err;
  attn_bwd_dkdv_kernel<D, MASKED>
      <<<dim3(blocks, H, B), (D / BOX) * 128 + 32, smem, st>>>(
          m[0], m[1], m[2], m[3], static_cast<const float*>(lse),
          static_cast<const float*>(delta), static_cast<float*>(dk),
          static_cast<__nv_bfloat16*>(dv), dv_stride, S, H, kv_len,
          static_cast<const unsigned char*>(valid),
          static_cast<const int*>(ids));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_prepass_bwd(const void* q_src, const void* k_src,
                               long long src_stride, const void* cos_q,
                               const void* sin_q, const void* cos_k,
                               const void* sin_k, const void* dq_acc,
                               const void* dk_acc, void* dq_dst, void* dk_dst,
                               long long dst_stride, void* partials,
                               void* tables, int B, int S, int H, float eps,
                               float gq, float gk, cudaStream_t st) {
  constexpr int ROWS = PRE_THREADS / (D / 8);
  const long long total = (long long)B * S;
  const dim3 grid(unsigned((total + ROWS - 1) / ROWS), 2);
  prepass_bwd_kernel<D><<<grid, PRE_THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q_src),
      static_cast<const __nv_bfloat16*>(k_src), src_stride,
      static_cast<const float*>(cos_q), static_cast<const float*>(sin_q),
      static_cast<const float*>(cos_k), static_cast<const float*>(sin_k),
      static_cast<const float*>(dq_acc), static_cast<const float*>(dk_acc),
      static_cast<__nv_bfloat16*>(dq_dst), static_cast<__nv_bfloat16*>(dk_dst),
      dst_stride, static_cast<float*>(partials), B, S, H, eps, gq, gk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = 4LL * S * D;
  table_fold_kernel<<<unsigned((n + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(partials), static_cast<float*>(tables), B, n);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_rope_bwd(const void* dq_acc, const void* dk_acc,
                            const void* cos, const void* sin, const void* ids,
                            void* dq, void* dk, int B, int S, int H, float gq,
                            float gk, cudaStream_t st) {
  constexpr int ROWS = PRE_THREADS / (D / 8);
  const long long total = (long long)B * S;
  rope_bwd_kernel<D><<<dim3(unsigned((total + ROWS - 1) / ROWS), 2),
                       PRE_THREADS, 0, st>>>(
      static_cast<const float*>(dq_acc), static_cast<const float*>(dk_acc),
      static_cast<const float*>(cos), static_cast<const float*>(sin),
      static_cast<const int*>(ids), static_cast<__nv_bfloat16*>(dq),
      static_cast<__nv_bfloat16*>(dk), B, S, H, gq, gk);
  return cudaGetLastError();
}

}  // namespace

// q_hat, k_hat (B, S, H, D) bf16 contiguous; v (B, S, H, D) bf16 rows at
// v_stride elements (the packed qkv's v columns); out, dout (B, S, H * D)
// bf16; lse (B, H, S) fp32 from K1's LSE launch; dq (B, S, H, D) fp32;
// delta (B, H, S) fp32, every row written; wg consumer warpgroups a block
// and `blocks` blocks along S from the host plan (backward_plan in
// seedvr2_tpu_torch/ops/flash_attention.py). Every pointer 16-byte aligned,
// 1 <= kv_len <= S, D in {64, 128}: checked by the Python wrapper.
extern "C" int seedvr2_attn_bwd_dq(const void* q_hat, const void* k_hat,
                                   const void* v, long long v_stride,
                                   const void* out, const void* dout,
                                   const void* lse, void* dq, void* delta,
                                   int B, int S, int H, int D, int kv_len,
                                   int wg, int blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || S == 0) return int(cudaSuccess);
  CUtensorMap m[4];
  if ((wg != 1 && wg != 2) ||
      !bwd_maps(m, q_hat, k_hat, v, v_stride, dout, B, S, H, D, kv_len,
                wg * BN, blocks))
    return int(cudaErrorInvalidValue);
  return int(run_dq<false>(m, out, dout, lse, dq, delta, B, S, H, D, kv_len,
                           wg, blocks, nullptr, nullptr, st));
}

// As above; lse from K1's LSE launch, delta from seedvr2_attn_bwd_dq; dk
// (B, S, H, D) fp32; dv bf16 rows at dv_stride elements (d qkv's v
// columns); `blocks` blocks of 64 keys, D / 64 warpgroups each.
extern "C" int seedvr2_attn_bwd_dkdv(const void* q_hat, const void* k_hat,
                                     const void* v, long long v_stride,
                                     const void* dout, const void* lse,
                                     const void* delta, void* dk, void* dv,
                                     long long dv_stride, int B, int S, int H,
                                     int D, int kv_len, int blocks,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || S == 0) return int(cudaSuccess);
  CUtensorMap m[4];
  if (!bwd_maps(m, q_hat, k_hat, v, v_stride, dout, B, S, H, D, kv_len, BN,
                blocks))
    return int(cudaErrorInvalidValue);
  if (D == 128)
    return int(launch_dkdv<128, false>(m, lse, delta, dk, dv, dv_stride, B, S,
                                       H, kv_len, blocks, nullptr, nullptr,
                                       st));
  return int(launch_dkdv<64, false>(m, lse, delta, dk, dv, dv_stride, B, S, H,
                                    kv_len, blocks, nullptr, nullptr, st));
}

// q_src / k_src: the q / k columns of the packed bf16 qkv (rows at
// src_stride elements); tables (S, D) fp32; dq_acc / dk_acc (B, S, H, D)
// fp32; dq_dst / dk_dst bf16 rows at dst_stride elements; partials (B, 4,
// S, D) fp32 scratch; tables_out (4, S, D) fp32: d cos_q, d sin_q, d cos_k,
// d sin_k. Checked by the Python wrapper.
extern "C" int seedvr2_prepass_bwd(const void* q_src, const void* k_src,
                                   long long src_stride, const void* cos_q,
                                   const void* sin_q, const void* cos_k,
                                   const void* sin_k, const void* dq_acc,
                                   const void* dk_acc, void* dq_dst,
                                   void* dk_dst, long long dst_stride,
                                   void* partials, void* tables_out, int B,
                                   int S, int H, int D, float eps, float gq,
                                   float gk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || S == 0) return int(cudaSuccess);
  if (D == 128)
    return int(launch_prepass_bwd<128>(q_src, k_src, src_stride, cos_q, sin_q,
                                       cos_k, sin_k, dq_acc, dk_acc, dq_dst,
                                       dk_dst, dst_stride, partials,
                                       tables_out, B, S, H, eps, gq, gk, st));
  if (D == 64)
    return int(launch_prepass_bwd<64>(q_src, k_src, src_stride, cos_q, sin_q,
                                      cos_k, sin_k, dq_acc, dk_acc, dq_dst,
                                      dk_dst, dst_stride, partials,
                                      tables_out, B, S, H, eps, gq, gk, st));
  return int(cudaErrorInvalidValue);
}

// K9's backward (the uniform window plan's windowed attention). q_hat,
// k_hat, v, out, dout (B, S, H, D) bf16 contiguous (q-hat and k-hat from
// K9's pre-pass); lse (B, H, S) fp32 from K9's training launch
// (seedvr2_flash_attention_lse); valid (nU, S) bytes and ids (B,) int32 <
// nU: batch row b's keys are those row ids[b] of valid marks, and every q
// row is live (the caller's pad rows carry dO = 0). dq (B, S, H, D) fp32,
// delta (B, H, S) fp32; wg and blocks from the host plan (backward_plan(B,
// S, H, S)). Checked by the Python wrapper.
extern "C" int seedvr2_win_bwd_dq(const void* q_hat, const void* k_hat,
                                  const void* v, const void* out,
                                  const void* dout, const void* lse,
                                  const void* valid, const void* ids, void* dq,
                                  void* delta, int B, int S, int H, int D,
                                  int wg, int blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || S == 0) return int(cudaSuccess);
  CUtensorMap m[4];
  if ((wg != 1 && wg != 2) || valid == nullptr || ids == nullptr ||
      !bwd_maps(m, q_hat, k_hat, v, (long long)H * D, dout, B, S, H, D, S,
                wg * BN, blocks))
    return int(cudaErrorInvalidValue);
  return int(run_dq<true>(m, out, dout, lse, dq, delta, B, S, H, D, S, wg,
                          blocks, valid, ids, st));
}

// As above; delta from seedvr2_win_bwd_dq; dk (B, S, H, D) fp32, dv (B, S,
// H, D) bf16 contiguous; `blocks` blocks of 64 keys, D / 64 warpgroups
// each; a block of no valid key writes zeros.
extern "C" int seedvr2_win_bwd_dkdv(const void* q_hat, const void* k_hat,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    const void* valid, const void* ids,
                                    void* dk, void* dv, int B, int S, int H,
                                    int D, int blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || S == 0) return int(cudaSuccess);
  const long long hd = (long long)H * D;
  CUtensorMap m[4];
  if (valid == nullptr || ids == nullptr ||
      !bwd_maps(m, q_hat, k_hat, v, hd, dout, B, S, H, D, S, BN, blocks))
    return int(cudaErrorInvalidValue);
  if (D == 128)
    return int(launch_dkdv<128, true>(m, lse, delta, dk, dv, hd, B, S, H, S,
                                      blocks, valid, ids, st));
  return int(launch_dkdv<64, true>(m, lse, delta, dk, dv, hd, B, S, H, S,
                                   blocks, valid, ids, st));
}

// K9's pre-pass backward: dq_acc / dk_acc (B, S, H, D) fp32 from the two
// kernels above, tables (nU, S, D) fp32 (the plan's), ids (B,) int32 < nU;
// dq / dk (B, S, H, D) bf16 = rot^T(gq dq_acc), rot^T(gk dk_acc) by the
// table ids[b] picks. Checked by the Python wrapper.
extern "C" int seedvr2_win_rope_bwd(const void* dq_acc, const void* dk_acc,
                                    const void* cos, const void* sin,
                                    const void* ids, void* dq, void* dk,
                                    int B, int S, int H, int D, float gq,
                                    float gk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || S == 0) return int(cudaSuccess);
  if (D == 128)
    return int(launch_rope_bwd<128>(dq_acc, dk_acc, cos, sin, ids, dq, dk, B,
                                    S, H, gq, gk, st));
  if (D == 64)
    return int(launch_rope_bwd<64>(dq_acc, dk_acc, cos, sin, ids, dq, dk, B,
                                   S, H, gq, gk, st));
  return int(cudaErrorInvalidValue);
}
