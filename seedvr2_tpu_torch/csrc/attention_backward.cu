// Backward of the packed window attention (kernel K1's gradient).
//
// Replaces: no TPU kernel. The JAX package differentiates the jnp
// composition behind `flash_packed_attention`
// (comfyui-seedvr2_tpu/ops/flash_attention.py; ops/attention.py
// packed_attention) and has no backward kernel; the port's training path
// may not run that composition on the card, so K1's gradient is written
// here by hand. Driven by seedvr2_tpu_torch/ops/flash_attention.py
// (packed_window_attention_backward), which first relaunches K1's own
// pre-pass (packed_attention.cu) for q-hat (normed, roped, times
// scale*log2e) and k-hat in bf16.
//
// Three parts, one C entry each:
//  (a) `attn_bwd_dq_kernel`: a block owns 64 q rows of one (b, h). It
//      forms delta_i = sum_d dO_i * O_i, sweeps the key tiles below kv_len
//      once for the row logsumexp (log2 domain), then again for P =
//      exp2(q-hat k-hat^T - lse), dS = P * (dO v^T - delta) and dQ-hat +=
//      dS k-hat. Writes dQ-hat (fp32), lse and delta.
//  (b) `attn_bwd_dkdv_kernel`: a block owns 64 keys of one (b, h) and walks
//      the q tiles below kv_len: P and dS again from lse and delta, dV +=
//      P^T dO (written as bf16 into d qkv's v columns) and dK-hat += dS^T
//      q-hat (fp32).
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
// zero gradient. No float atomics anywhere: reruns are bit-identical.
//
// What bounds it on an H100: (a) and (b) are products, 6 and 8 * S *
// kv_len * D flops per (b, h), tensor-core work in principle; this first
// version computes them with fp32 FMAs from shared memory (67 TFLOP/s
// peak outside the tensor cores), every operand widened to fp32 in
// shared memory once per tile: 4 x 4 outputs a thread, one float4 of each
// operand per step, 256 threads and one block an SM (up to 211 KB of
// shared memory at D = 128). (c) is bound by bytes: qkv's q / k columns
// and the fp32 dQ-hat / dK-hat read once, d qkv's q / k columns written
// once. Its redesign for Hopper (wgmma, the forward saving the lse) is
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BWD_THREADS = 256;
constexpr int TILE = 64;  // rows of a q tile and of a key tile
constexpr int PAD = 4;    // floats added to a natural-layout row

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

// Rows r0 .. r0 + 63 of batch row b (row r at base + (b * S + r) * stride,
// head h at column h * D) widened to fp32 into a transposed [D][64] array
// `t` and / or a natural [64][D + PAD] array `n` (either may be null); rows
// at or past `valid` are zero. Thread i takes row i % 64 of a 16-byte
// column chunk, so a warp's transposed stores fall in 32 banks.
template <int D>
__device__ void load_tile(const __nv_bfloat16* base, long long stride, int b,
                          int S, int h, int r0, int valid, float* t,
                          float* n) {
  constexpr int CH = D / 8;
  for (int id = threadIdx.x; id < TILE * CH; id += BWD_THREADS) {
    const int j = id % TILE;
    const int c = (id / TILE) * 8;
    const int r = r0 + j;
    float x[8];
    if (r < valid) {
      load8(base + ((long long)b * S + r) * stride + (long long)h * D + c, x);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = 0.f;
    }
    if (t != nullptr) {
#pragma unroll
      for (int e = 0; e < 8; ++e) t[(c + e) * TILE + j] = x[e];
    }
    if (n != nullptr) {
      float4* q = reinterpret_cast<float4*>(n + j * (D + PAD) + c);
      q[0] = make_float4(x[0], x[1], x[2], x[3]);
      q[1] = make_float4(x[4], x[5], x[6], x[7]);
    }
  }
}

// acc[i][j] = sum_d A[d][a0 + i] * Bm[d][b0 + j] over two transposed
// [D][64] tiles.
template <int D>
__device__ __forceinline__ void tile_product(const float* A, const float* Bm,
                                             int a0, int b0,
                                             float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float4 a = *reinterpret_cast<const float4*>(A + d * TILE + a0);
    const float4 bb = *reinterpret_cast<const float4*>(Bm + d * TILE + b0);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][e] += sum_r W[r][w0 + i] * N[r][n0 + e] over the 64 rows r of a
// [64][64] array W and a natural [64][D + PAD] array N, DC = D / 16 columns.
template <int D>
__device__ __forceinline__ void accumulate(const float* W, const float* N,
                                           int w0, int n0,
                                           float (&acc)[4][D / 16]) {
  constexpr int DC = D / 16;
#pragma unroll 4
  for (int r = 0; r < TILE; ++r) {
    const float4 w = *reinterpret_cast<const float4*>(W + r * TILE + w0);
    const float wv[4] = {w.x, w.y, w.z, w.w};
    float nv[DC];
#pragma unroll
    for (int e = 0; e < DC; e += 4) {
      const float4 q =
          *reinterpret_cast<const float4*>(N + r * (D + PAD) + n0 + e);
      nv[e] = q.x;
      nv[e + 1] = q.y;
      nv[e + 2] = q.z;
      nv[e + 3] = q.w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < DC; ++e) acc[i][e] = fmaf(wv[i], nv[e], acc[i][e]);
  }
}

// Reductions over the 16 lanes that share a thread's rows (lane % 16 is
// the column group).
__device__ __forceinline__ float max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // Qt, dOt, Kt, Vt [D][64]; Kn [64][D + PAD]; dS^T [64][64]; lse, delta
  return (size_t(4) * D * TILE + TILE * (D + PAD) + TILE * TILE + 2 * TILE) *
         sizeof(float);
}

template <int D>
constexpr size_t dkdv_smem_bytes() {
  // Kt, Vt, Qt, dOt [D][64]; Qn, dOn [64][D + PAD]; P / dS [64][64]; lse,
  // delta
  return (size_t(4) * D * TILE + 2 * TILE * (D + PAD) + TILE * TILE +
          2 * TILE) *
         sizeof(float);
}

// (a): grid (ceil(S / 64), H, B). q_hat, k_hat (B, S, H, D) bf16; v rows at
// v_stride; out, dout (B, S, H * D) bf16; dq (B, S, H, D) fp32; lse, delta
// (B, H, S) fp32, every row written: delta is 0 at or past kv_len; lse is
// the row's log-sum-exp over the keys below kv_len, 0 in a tile wholly past
// kv_len (no part reads a pad row's lse).
template <int D>
__global__ void __launch_bounds__(BWD_THREADS, 1)
attn_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q_hat,
                   const __nv_bfloat16* __restrict__ k_hat,
                   const __nv_bfloat16* __restrict__ v, long long v_stride,
                   const __nv_bfloat16* __restrict__ out,
                   const __nv_bfloat16* __restrict__ dout,
                   float* __restrict__ dq, float* __restrict__ lse_out,
                   float* __restrict__ delta_out, int S, int H, int kv_len) {
  constexpr int DC = D / 16;
  extern __shared__ float4 smem4[];
  float* sQt = reinterpret_cast<float*>(smem4);
  float* sDOt = sQt + D * TILE;
  float* sKt = sDOt + D * TILE;
  float* sVt = sKt + D * TILE;
  float* sKn = sVt + D * TILE;
  float* sDS = sKn + TILE * (D + PAD);  // [key][q row]
  float* sLse = sDS + TILE * TILE;
  float* sDelta = sLse + TILE;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * TILE;
  const long long hd = (long long)H * D;
  const int tid = threadIdx.x;
  const int r0 = (tid / 16) * 4;  // this thread's 4 q rows
  const int c0 = (tid % 16) * 4;  // its 4 keys of a score tile
  const int d0 = (tid % 16) * DC; // its DC columns of dQ

  if (q0 >= kv_len) {  // every row of the tile gets zero gradient
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + r0 + i;
      if (row >= S) break;
      float* dst = dq + ((long long)b * S + row) * hd + (long long)h * D + d0;
#pragma unroll
      for (int e = 0; e < DC; ++e) dst[e] = 0.f;
      if (tid % 16 == 0) {  // delta 0 as below kv_len's pad rows; lse unread
        lse_out[((long long)b * H + h) * S + row] = 0.f;
        delta_out[((long long)b * H + h) * S + row] = 0.f;
      }
    }
    return;
  }

  // delta: four threads a row, D / 4 columns each
  {
    const int r = tid / 4;
    const int part = tid % 4;
    const int row = q0 + r;
    float acc = 0.f;
    if (row < kv_len) {
      const long long off = ((long long)b * S + row) * hd + (long long)h * D +
                            part * (D / 4);
      for (int e = 0; e < D / 4; e += 8) {
        float o[8], g[8];
        load8(out + off + e, o);
        load8(dout + off + e, g);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc = fmaf(o[i], g[i], acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) sDelta[r] = acc;
  }
  load_tile<D>(q_hat, hd, b, S, h, q0, S, sQt, nullptr);
  load_tile<D>(dout, hd, b, S, h, q0, kv_len, sDOt, nullptr);
  __syncthreads();

  const int n_tiles = (kv_len + TILE - 1) / TILE;
  // pass 1: the row logsumexp over the keys below kv_len (every tile
  // visited holds at least one, so each row's max is finite)
  float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  float l[4] = {0.f, 0.f, 0.f, 0.f};
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * TILE;
    load_tile<D>(k_hat, hd, b, S, h, k0, S, sKt, nullptr);
    __syncthreads();
    float sc[4][4];
    tile_product<D>(sQt, sKt, r0, c0, sc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k0 + c0 + j < kv_len) mx = fmaxf(mx, sc[i][j]);
      const float mn = fmaxf(m[i], max16(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k0 + c0 + j < kv_len) sum += exp2f(sc[i][j] - mn);
      l[i] = l[i] * exp2f(m[i] - mn) + sum;
      m[i] = mn;
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lse = m[i] + log2f(sum16(l[i]));
    if (tid % 16 == 0) {
      sLse[r0 + i] = lse;
      const int row = q0 + r0 + i;
      if (row < S) {
        lse_out[((long long)b * H + h) * S + row] = lse;
        delta_out[((long long)b * H + h) * S + row] = sDelta[r0 + i];
      }
    }
  }
  __syncthreads();

  // pass 2: dS and dQ-hat
  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < DC; ++e) acc[i][e] = 0.f;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * TILE;
    load_tile<D>(k_hat, hd, b, S, h, k0, S, sKt, sKn);
    load_tile<D>(v, v_stride, b, S, h, k0, S, sVt, nullptr);
    __syncthreads();
    float sc[4][4], dp[4][4];
    tile_product<D>(sQt, sKt, r0, c0, sc);
    tile_product<D>(sDOt, sVt, r0, c0, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float lse = sLse[r0 + i];
      const float dl = sDelta[r0 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p =
            k0 + c0 + j < kv_len ? exp2f(sc[i][j] - lse) : 0.f;
        sDS[(c0 + j) * TILE + r0 + i] = p * (dp[i][j] - dl);
      }
    }
    __syncthreads();
    accumulate<D>(sDS, sKn, r0, d0, acc);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + r0 + i;
    if (row >= S) break;
    float* dst = dq + ((long long)b * S + row) * hd + (long long)h * D + d0;
#pragma unroll
    for (int e = 0; e < DC; ++e) dst[e] = acc[i][e];
  }
}

// (b): grid (ceil(S / 64), H, B). dk (B, S, H, D) fp32; dv rows at
// dv_stride (bf16, head h at column h * D).
template <int D>
__global__ void __launch_bounds__(BWD_THREADS, 1)
attn_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q_hat,
                     const __nv_bfloat16* __restrict__ k_hat,
                     const __nv_bfloat16* __restrict__ v, long long v_stride,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, long long dv_stride,
                     int S, int H, int kv_len) {
  constexpr int DC = D / 16;
  extern __shared__ float4 smem4[];
  float* sKt = reinterpret_cast<float*>(smem4);
  float* sVt = sKt + D * TILE;
  float* sQt = sVt + D * TILE;
  float* sDOt = sQt + D * TILE;
  float* sQn = sDOt + D * TILE;
  float* sDOn = sQn + TILE * (D + PAD);
  float* sP = sDOn + TILE * (D + PAD);  // [q row][key]
  float* sLse = sP + TILE * TILE;
  float* sDelta = sLse + TILE;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = blockIdx.x * TILE;
  const long long hd = (long long)H * D;
  const int tid = threadIdx.x;
  const int j0 = (tid / 16) * 4;   // this thread's 4 keys
  const int i0 = (tid % 16) * 4;   // its 4 q rows of a score tile
  const int d0 = (tid % 16) * DC;  // its DC columns of dK and dV

  float dka[4][DC], dva[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < DC; ++e) dka[i][e] = dva[i][e] = 0.f;

  if (k0 < kv_len) {
    load_tile<D>(k_hat, hd, b, S, h, k0, S, sKt, nullptr);
    load_tile<D>(v, v_stride, b, S, h, k0, S, sVt, nullptr);
    const int n_q = (kv_len + TILE - 1) / TILE;
    const float* lse_row = lse + ((long long)b * H + h) * S;
    const float* delta_row = delta + ((long long)b * H + h) * S;
    for (int qt = 0; qt < n_q; ++qt) {
      const int q0 = qt * TILE;
      __syncthreads();  // the previous q tile's reads are done
      load_tile<D>(q_hat, hd, b, S, h, q0, S, sQt, sQn);
      load_tile<D>(dout, hd, b, S, h, q0, kv_len, sDOt, sDOn);
      for (int r = tid; r < TILE; r += BWD_THREADS) {
        const int row = q0 + r;
        sLse[r] = row < S ? lse_row[row] : 0.f;
        sDelta[r] = row < S ? delta_row[row] : 0.f;
      }
      __syncthreads();
      float sc[4][4], dp[4][4];
      tile_product<D>(sKt, sQt, j0, i0, sc);   // sc[key][q row]
      tile_product<D>(sVt, sDOt, j0, i0, dp);
      float ds[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool live = k0 + j0 + j < kv_len;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = live ? exp2f(sc[j][i] - sLse[i0 + i]) : 0.f;
          ds[j][i] = p * (dp[j][i] - sDelta[i0 + i]);
          sP[(i0 + i) * TILE + j0 + j] = p;
        }
      }
      __syncthreads();
      accumulate<D>(sP, sDOn, j0, d0, dva);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) sP[(i0 + i) * TILE + j0 + j] = ds[j][i];
      __syncthreads();
      accumulate<D>(sP, sQn, j0, d0, dka);
    }
  }
  // keys at or past kv_len (and whole tiles past it) write zeros
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int row = k0 + j0 + j;
    if (row >= S) break;
    float* k_dst = dk + ((long long)b * S + row) * hd + (long long)h * D + d0;
    __nv_bfloat16* v_dst =
        dv + ((long long)b * S + row) * dv_stride + (long long)h * D + d0;
#pragma unroll
    for (int e = 0; e < DC; ++e) {
      k_dst[e] = dka[j][e];
      v_dst[e] = __float2bfloat16_rn(dva[j][e]);
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

template <int D>
cudaError_t launch_dq(const void* q_hat, const void* k_hat, const void* v,
                      long long v_stride, const void* out, const void* dout,
                      void* dq, void* lse, void* delta, int B, int S, int H,
                      int kv_len, cudaStream_t st) {
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaError_t err = set_smem(attn_bwd_dq_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + TILE - 1) / TILE, H, B);
  attn_bwd_dq_kernel<D><<<grid, BWD_THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q_hat),
      static_cast<const __nv_bfloat16*>(k_hat),
      static_cast<const __nv_bfloat16*>(v), v_stride,
      static_cast<const __nv_bfloat16*>(out),
      static_cast<const __nv_bfloat16*>(dout), static_cast<float*>(dq),
      static_cast<float*>(lse), static_cast<float*>(delta), S, H, kv_len);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkdv(const void* q_hat, const void* k_hat, const void* v,
                        long long v_stride, const void* dout, const void* lse,
                        const void* delta, void* dk, void* dv,
                        long long dv_stride, int B, int S, int H, int kv_len,
                        cudaStream_t st) {
  constexpr size_t smem = dkdv_smem_bytes<D>();
  cudaError_t err = set_smem(attn_bwd_dkdv_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + TILE - 1) / TILE, H, B);
  attn_bwd_dkdv_kernel<D><<<grid, BWD_THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q_hat),
      static_cast<const __nv_bfloat16*>(k_hat),
      static_cast<const __nv_bfloat16*>(v), v_stride,
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<__nv_bfloat16*>(dv), dv_stride, S,
      H, kv_len);
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

}  // namespace

// q_hat, k_hat (B, S, H, D) bf16 contiguous; v (B, S, H, D) bf16 rows at
// v_stride elements (the packed qkv's v columns); out, dout (B, S, H * D)
// bf16; dq (B, S, H, D) fp32; lse, delta (B, H, S) fp32; every pointer
// 16-byte aligned, 1 <= kv_len <= S, D in {64, 128}: checked by the Python
// wrapper (seedvr2_tpu_torch/ops/flash_attention.py).
extern "C" int seedvr2_attn_bwd_dq(const void* q_hat, const void* k_hat,
                                   const void* v, long long v_stride,
                                   const void* out, const void* dout,
                                   void* dq, void* lse, void* delta, int B,
                                   int S, int H, int D, int kv_len,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || S == 0) return int(cudaSuccess);
  if (D == 128)
    return int(launch_dq<128>(q_hat, k_hat, v, v_stride, out, dout, dq, lse,
                              delta, B, S, H, kv_len, st));
  if (D == 64)
    return int(launch_dq<64>(q_hat, k_hat, v, v_stride, out, dout, dq, lse,
                             delta, B, S, H, kv_len, st));
  return int(cudaErrorInvalidValue);
}

// As above; lse and delta from seedvr2_attn_bwd_dq; dk (B, S, H, D) fp32;
// dv bf16 rows at dv_stride elements (d qkv's v columns).
extern "C" int seedvr2_attn_bwd_dkdv(const void* q_hat, const void* k_hat,
                                     const void* v, long long v_stride,
                                     const void* dout, const void* lse,
                                     const void* delta, void* dk, void* dv,
                                     long long dv_stride, int B, int S, int H,
                                     int D, int kv_len, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || S == 0) return int(cudaSuccess);
  if (D == 128)
    return int(launch_dkdv<128>(q_hat, k_hat, v, v_stride, dout, lse, delta,
                                dk, dv, dv_stride, B, S, H, kv_len, st));
  if (D == 64)
    return int(launch_dkdv<64>(q_hat, k_hat, v, v_stride, dout, lse, delta,
                               dk, dv, dv_stride, B, S, H, kv_len, st));
  return int(cudaErrorInvalidValue);
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
