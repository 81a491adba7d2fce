// Dense and windowed flash attention (kernels K8 and K9 of the port).
//
// Replaces: the Pallas TPU kernels behind `flash_attention` (`_fa_kernel`,
// `_fa_rope_kernel`; K8) and `flash_windowed_attention`
// (`_fa_rope_mask_kernel`; K9) in comfyui-seedvr2_tpu/ops/flash_attention.py.
//
// Computes, per (batch row b, head h): q and k rotated by interleaved
// rotate-half RoPE from fp32 (S, D) tables, q scaled by scale*log2e, both
// rounded to bf16, then softmax(q k^T) v in the exp2 domain over the valid
// keys, rounded to bf16:
//  - K8, dense: one shared table (rows at or past its length pass through
//    unrotated) or none; key columns >= kv_len masked; Sq may differ from Sk
//    when there is no table.
//  - K9, windowed (the DiT's uniform window plan): window b's table and key
//    validity row are picked by ids[b] from (nU, S, D) tables and an (nU, S)
//    mask; Sq == Sk. A front-clipped shifted window puts its pad slots
//    first, so a row's first key tiles can hold no valid key at all: the
//    running max is clamped (flash_tile.cuh) and the sum divided as
//    max(l, 1e-30), as the TPU kernel does.
// q (B, Sq, H, D), k and v (B, Sk, H, D) and out (B, Sq, H, D) are bf16 and
// contiguous, read in place (row stride H*D). S need not be a multiple of
// 64, so the TPU wrapper's pad to 512 rows has no counterpart here.
//
// What bounds them on an H100: at the uniform plan's windows (S = 405 video
// + 58 text = 463, D = 128) a (b, h) does 4*S*S*D flops against 4*S*D*2
// bytes of q, k, v and out, ~230 flop/byte, just under the ~295 flop/byte
// ridge, so the least time is set by bytes.
//
// K8 runs on the Hopper step K1 shares (packed_attention.cu; 0.16 ms at
// B=12 S=463 H=20 with a table on an H100 80GB HBM3, 700 W, about 2x
// SDPA, held by the same pre-pass and per-block costs): with a table,
// the pre-pass ropes q and k once into a scratch the wrapper allocates (q
// times scale*log2e) and the step reads q-hat, k-hat and v by TMA; without
// one, the step reads q and k as they are and scales the fp32 scores. The
// TMA's zero fill past a batch row's last row replaces zero rows written by
// hand, and its clipped stores keep rows past Sq unwritten.
//
// K9 is the first design, not yet moved onto that step: a block of 4 warps
// per (64-row q tile, head, window), register-resident `mma.sync.m16n8k16`
// bf16 fragments, one 64-row k tile and transposed v tile in shared memory
// (about 52 KB for D = 128), the tile's key validity staged beside them as
// 64 bytes (flash_tile.cuh). Every tile up to S is computed, fully masked
// ones included. Rows past S are zero in shared memory and never stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_sm90.cuh"
#include "flash_tile.cuh"

namespace {

using namespace flash;

// One warp ropes one row of D values into shared memory: lane l owns the
// D/32 consecutive values from l*D/32 (whole interleaved pairs).
// dst = bf16((x * cos + rot(x) * sin) * mult), rot(x)[2i] = -x[2i+1],
// rot(x)[2i+1] = x[2i]; no rotation where cos_t is null. A null src writes
// a zero row.
template <int D>
__device__ __forceinline__ void rope_row(const __nv_bfloat16* __restrict__ src,
                                         const float* __restrict__ cos_t,
                                         const float* __restrict__ sin_t,
                                         float mult, __nv_bfloat16* dst,
                                         int lane) {
  constexpr int EPL = D / 32;
  static_assert(EPL % 2 == 0, "each lane must own whole pairs");
  const int c0 = lane * EPL;
#pragma unroll
  for (int e = 0; e < EPL; e += 2) {
    float a = 0.f, b = 0.f;
    if (src != nullptr) {
      a = __bfloat162float(src[c0 + e]);
      b = __bfloat162float(src[c0 + e + 1]);
    }
    float ra = a, rb = b;
    if (cos_t != nullptr) {
      ra = a * cos_t[c0 + e] - b * sin_t[c0 + e];
      rb = b * cos_t[c0 + e + 1] + a * sin_t[c0 + e + 1];
    }
    dst[c0 + e] = __float2bfloat16(ra * mult);
    dst[c0 + e + 1] = __float2bfloat16(rb * mult);
  }
}

// K9: window b's table and key validity row are ids[b]'s.
template <int D>
__global__ void __launch_bounds__(NTHREADS)
windowed_attention_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const float* __restrict__ cos,
                          const float* __restrict__ sin,
                          const uint8_t* __restrict__ valid,
                          const int* __restrict__ ids,
                          __nv_bfloat16* __restrict__ out, int S, int H,
                          float qscale) {
  constexpr int QS = D + PAD;  // row stride of Qs and Ks
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + BQ * QS;
  __nv_bfloat16* Vt = Ks + BK * QS;
  uint8_t* key_ok = reinterpret_cast<uint8_t*>(Vt + D * (BK + PAD));

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = warp * 16;
  const size_t row_stride = size_t(H) * D;
  const __nv_bfloat16* qb = q + size_t(b) * S * row_stride + size_t(h) * D;
  const __nv_bfloat16* kb = k + size_t(b) * S * row_stride + size_t(h) * D;
  const __nv_bfloat16* vb = v + size_t(b) * S * row_stride + size_t(h) * D;
  const size_t u = size_t(ids[b]);
  const float* cos_t = cos + u * S * D;
  const float* sin_t = sin + u * S * D;
  const uint8_t* valid_row = valid + u * S;

  // q: rope + scale*log2e, staged as bf16, then A fragments in registers
  for (int r = r0; r < r0 + 16; ++r) {
    const int row = q0 + r;
    const bool in = row < S;
    rope_row<D>(in ? qb + size_t(row) * row_stride : nullptr,
                in ? cos_t + size_t(row) * D : nullptr,
                in ? sin_t + size_t(row) * D : nullptr, qscale, Qs + r * QS,
                lane);
  }
  __syncwarp();
  Rows<D> rows;
  rows.begin(Qs, r0, g, t);

  const int n_tiles = (S + BK - 1) / BK;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();  // every warp is done with the previous k/v tile
    for (int r = r0; r < r0 + 16; ++r) {
      const int row = k0 + r;
      const bool in = row < S;
      rope_row<D>(in ? kb + size_t(row) * row_stride : nullptr,
                  in ? cos_t + size_t(row) * D : nullptr,
                  in ? sin_t + size_t(row) * D : nullptr, 1.f, Ks + r * QS,
                  lane);
    }
    load_v_tile<D>(vb + size_t(k0) * row_stride, row_stride, S - k0, Vt);
    if (threadIdx.x < BK) {
      const int col = k0 + threadIdx.x;
      key_ok[threadIdx.x] = col < S && valid_row[col] != 0;
    }
    __syncthreads();

    float s[BK / 8][4];
    rows.scores(s, Ks, g, t);
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb) {
      const int c = nb * 8 + 2 * t;
      if (!key_ok[c]) s[nb][0] = s[nb][2] = -INFINITY;
      if (!key_ok[c + 1]) s[nb][1] = s[nb][3] = -INFINITY;
    }
    rows.update(s, Vt, g, t);
  }

  const int lo = q0 + r0 + g;
  rows.store(out + (size_t(b) * S + lo) * row_stride + size_t(h) * D + 2 * t,
             row_stride, lo, S);
}

template <int D>
cudaError_t launch_windowed(const void* q, const void* k, const void* v,
                            const void* cos, const void* sin,
                            const void* valid, const void* ids, void* out,
                            int B, int S, int H, float qscale,
                            cudaStream_t stream) {
  const size_t smem = smem_bytes<D>() + BK;
  cudaError_t err = cudaFuncSetAttribute(
      windowed_attention_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  windowed_attention_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(cos),
      static_cast<const float*>(sin), static_cast<const uint8_t*>(valid),
      static_cast<const int*>(ids), static_cast<__nv_bfloat16*>(out), S, H,
      qscale);
  return cudaGetLastError();
}

}  // namespace

// K8 when ids is null: cos/sin one (table_rows, D) fp32 table or null (then
// Sq may differ from Sk), keys < kv_len; with a table, scratch holds
// (2, B, S, H, D) bf16 for q-hat and k-hat. K9 otherwise: cos/sin (nU, Sk,
// D), valid (nU, Sk) bytes, ids (B,) int32 < nU, Sq == Sk, no scratch.
// Shapes, types, alignment and the ids' range are validated by the Python
// wrappers (seedvr2_tpu_torch/ops/flash_attention.py).
extern "C" int seedvr2_flash_attention(const void* q, const void* k,
                                       const void* v, const void* cos,
                                       const void* sin, const void* valid,
                                       const void* ids, void* scratch,
                                       void* out, int B, int Sq, int Sk,
                                       int H, int D, int kv_len,
                                       int table_rows, float qscale,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || Sq == 0) return int(cudaSuccess);
  if (ids != nullptr) {
    if (D == 128)
      return int(launch_windowed<128>(q, k, v, cos, sin, valid, ids, out, B,
                                      Sq, H, qscale, st));
    if (D == 64)
      return int(launch_windowed<64>(q, k, v, cos, sin, valid, ids, out, B,
                                     Sq, H, qscale, st));
    return int(cudaErrorInvalidValue);
  }
  const long long hd = (long long)H * D;
  if (cos == nullptr)
    return int(seedvr2::attention_sm90(q, hd, k, hd, v, hd, out, B, Sq, Sk, H,
                                       D, kv_len, qscale, st));
  __nv_bfloat16* q_hat = static_cast<__nv_bfloat16*>(scratch);
  __nv_bfloat16* k_hat = q_hat + (long long)B * Sq * hd;
  const float* c = static_cast<const float*>(cos);
  const float* s = static_cast<const float*>(sin);
  const seedvr2::PrepassSide qs{q, hd, c, s, q_hat, Sq, qscale};
  const seedvr2::PrepassSide ks{k, hd, c, s, k_hat, Sk, 1.f};
  cudaError_t err =
      seedvr2::qk_prepass(D, qs, ks, B, H, table_rows, false, 0.f, st);
  if (err != cudaSuccess) return int(err);
  return int(seedvr2::attention_sm90(q_hat, hd, k_hat, hd, v, hd, out, B, Sq,
                                     Sk, H, D, kv_len, 1.f, st));
}
