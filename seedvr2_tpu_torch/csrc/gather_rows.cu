// Row gather for NaDiT's window-order transitions (kernel K2 of the port).
//
// Replaces: the Pallas TPU kernel `_gather_kernel` behind `gather_rows`
// (comfyui-seedvr2_tpu/ops/gather.py), which copies runs of rows with DMAs
// and, at NaDiT widths, falls back to XLA's gather because of a TPU tiling
// rule. Hopper has no such rule, so this is the gather itself:
//   out[b, j, :] = x[b, idx[j], :]   for bf16 rows of any width D.
//
// What bounds it on an H100: pure data movement, 2*B*L2*D*2 bytes (one read
// and one write of every row) against 3.35 TB/s of device memory.
//
// Design: one warp per output row, the row copied with 16-byte vector loads
// and stores when D*2 % 16 == 0 (every NaDiT width), neighbouring lanes on
// neighbouring addresses, so each row is a handful of fully coalesced
// transactions; a 2-byte element loop covers any other D. The index vector
// is uploaded once per DiT plan and bounds-checked on the host.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS_PER_BLOCK = 8;

template <typename T>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
gather_rows_kernel(const T* __restrict__ x, const int* __restrict__ idx,
                   T* __restrict__ out, int L, int L2, int width,
                   long long total_rows) {
  const long long row =
      (long long)blockIdx.x * WARPS_PER_BLOCK + threadIdx.x / 32;
  if (row >= total_rows) return;
  const int lane = threadIdx.x % 32;
  const long long b = row / L2;
  const int j = int(row - b * L2);
  const T* src = x + (b * L + idx[j]) * (long long)width;
  T* dst = out + row * (long long)width;
  for (int c = lane; c < width; c += 32) dst[c] = src[c];
}

}  // namespace

// x: (B, L, D) bf16, idx: (L2,) int32 in [0, L), out: (B, L2, D) bf16; all
// contiguous, checked by the Python wrapper (seedvr2_tpu_torch/ops/gather.py).
extern "C" int seedvr2_gather_rows(const void* x, const void* idx, void* out,
                                   int B, int L, int L2, int D,
                                   void* stream) {
  const long long rows = (long long)B * L2;
  if (rows == 0) return int(cudaSuccess);
  const unsigned blocks =
      unsigned((rows + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((D * 2) % 16 == 0) {
    gather_rows_kernel<uint4><<<blocks, WARPS_PER_BLOCK * 32, 0, st>>>(
        static_cast<const uint4*>(x), static_cast<const int*>(idx),
        static_cast<uint4*>(out), L, L2, D * 2 / 16, rows);
  } else {
    gather_rows_kernel<uint16_t><<<blocks, WARPS_PER_BLOCK * 32, 0, st>>>(
        static_cast<const uint16_t*>(x), static_cast<const int*>(idx),
        static_cast<uint16_t*>(out), L, L2, D, rows);
  }
  return int(cudaGetLastError());
}
