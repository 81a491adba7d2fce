// Hopper (sm_90a) building blocks shared by the port's TMA + wgmma kernels:
// K1/K8/K9's attention step (packed_attention.cu, attention_step.cuh) and
// K1's backward (attention_backward.cu), K6/K7's dequantizing
// GEMMs (quant_matmul.cu), K3/K10's s8 GEMM (int8_matmul.cu), K11's
// implicit-GEMM conv (int8_conv.cu) and the decoder's upsample GEMM
// (upsample_shuffle.cu).
// Shared-memory addresses are 32-bit `.shared` addresses (smem_u32).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace seedvr2 {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Returns once the phase of parity `parity` has completed. A wait of 2^34
// clocks (about 9 s) means a lost arrival, never a slow tile: the kernel
// traps, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

// ------------------------------------------------------------------- TMA

// One box at (c0, c1, c2) of a 3-D tensor map into shared memory,
// completing `bar`'s transaction bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// As tma_load, for a 2-D tensor map.
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ----------------------------------------------------------------- wgmma

// Shared-memory matrix descriptor of a 128-byte-swizzled operand (layout
// type 1): start address, leading and stride byte offsets, all >> 4. The
// swizzle atoms (8 rows of 128 bytes) must start 1024-byte aligned.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (uint64_t(1) << 62);
}

// The same for a 64-byte-swizzled operand (layout type 2): rows of 64
// bytes in atoms of 8 rows that TMA writes 512-byte aligned. The swizzle
// follows the shared address's bits, so a descriptor may start at any row
// of an atom (base offset 0).
__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr, uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(sbo >> 4) << 32) | (uint64_t(2) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Waits until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns (its accumulator, or its register A operand)
// across the point where this is placed.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define SEEDVR2_F8(i)                                                 \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),         \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define SEEDVR2_D32                                                   \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31"
#define SEEDVR2_D64                                                   \
  SEEDVR2_D32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "  \
              "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, " \
              "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"

// d(64 x N, fp32) (+)= A(64 x 16) B(16 x N), both bf16 K-major in shared
// memory, N = 8, 32, 64 or 128. d is overwritten when `accumulate` is 0.
__device__ __forceinline__ void wgmma_ss(float (&d)[4], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, "
      "p, 1, 1, 0, 0;\n}\n"
      : SEEDVR2_F8(0), SEEDVR2_F8(8)
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" SEEDVR2_D32
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : SEEDVR2_F8(0), SEEDVR2_F8(8), SEEDVR2_F8(16), SEEDVR2_F8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" SEEDVR2_D64
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : SEEDVR2_F8(0), SEEDVR2_F8(8), SEEDVR2_F8(16), SEEDVR2_F8(24),
        SEEDVR2_F8(32), SEEDVR2_F8(40), SEEDVR2_F8(48), SEEDVR2_F8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d(64 x N, fp32) += A(64 x 16) B(16 x N), bf16 in shared memory, A
// K-major, B MN-major (transposed).
__device__ __forceinline__ void wgmma_ss_mn(float (&d)[32], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" SEEDVR2_D32
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : SEEDVR2_F8(0), SEEDVR2_F8(8), SEEDVR2_F8(16), SEEDVR2_F8(24)
      : "l"(da), "l"(db), "r"(1));
}

// The same for N = 128; d is overwritten when `accumulate` is 0.
__device__ __forceinline__ void wgmma_ss_mn(float (&d)[64], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" SEEDVR2_D64
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : SEEDVR2_F8(0), SEEDVR2_F8(8), SEEDVR2_F8(16), SEEDVR2_F8(24),
        SEEDVR2_F8(32), SEEDVR2_F8(40), SEEDVR2_F8(48), SEEDVR2_F8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d(64 x N, fp32) (+)= A(64 x 16, bf16 registers, the m16k16 A fragment of
// mma.sync per warp) B(16 x N, bf16 in shared memory), N = 8, 64 or 128.
// TRANS_B = 1: B MN-major (transposed); 0: K-major. d is overwritten when
// `accumulate` is 0.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[4], const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, %10;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" SEEDVR2_D32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : SEEDVR2_F8(0), SEEDVR2_F8(8), SEEDVR2_F8(16), SEEDVR2_F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" SEEDVR2_D64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : SEEDVR2_F8(0), SEEDVR2_F8(8), SEEDVR2_F8(16), SEEDVR2_F8(24),
        SEEDVR2_F8(32), SEEDVR2_F8(40), SEEDVR2_F8(48), SEEDVR2_F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate), "n"(TRANS_B));
}

#define SEEDVR2_R8(i)                                                 \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),         \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define SEEDVR2_D128                                                    \
  SEEDVR2_D64 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, " \
              "%75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "   \
              "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, "   \
              "%97, %98, %99, %100, %101, %102, %103, %104, %105, %106, " \
              "%107, %108, %109, %110, %111, %112, %113, %114, %115, "    \
              "%116, %117, %118, %119, %120, %121, %122, %123, %124, "    \
              "%125, %126, %127"

// d(64 x N, s32) (+)= A(64 x 32) B(32 x N), both s8 and K-major in shared
// memory (the only layout 8-bit wgmma takes), N = 8, 64 or 256; a k32 step
// is 32 bytes, as a bf16 k16 step, so the descriptors are the same. The
// int32 sums are exact. d is overwritten when `accumulate` is 0.
__device__ __forceinline__ void wgmma_s8(uint32_t (&d)[4], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
      "{%0, %1, %2, %3}, %4, %5, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_s8(uint32_t (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {" SEEDVR2_D32
      "}, %32, %33, p;\n}\n"
      : SEEDVR2_R8(0), SEEDVR2_R8(8), SEEDVR2_R8(16), SEEDVR2_R8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_s8(uint32_t (&d)[128], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {" SEEDVR2_D128
      "}, %128, %129, p;\n}\n"
      : SEEDVR2_R8(0), SEEDVR2_R8(8), SEEDVR2_R8(16), SEEDVR2_R8(24),
        SEEDVR2_R8(32), SEEDVR2_R8(40), SEEDVR2_R8(48), SEEDVR2_R8(56),
        SEEDVR2_R8(64), SEEDVR2_R8(72), SEEDVR2_R8(80), SEEDVR2_R8(88),
        SEEDVR2_R8(96), SEEDVR2_R8(104), SEEDVR2_R8(112), SEEDVR2_R8(120)
      : "l"(da), "l"(db), "r"(accumulate));
}

// The MN-major product of wgmma_ss_mn for N = 256; d is overwritten when
// `accumulate` is 0.
__device__ __forceinline__ void wgmma_ss_mn(float (&d)[128], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" SEEDVR2_D128
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : SEEDVR2_F8(0), SEEDVR2_F8(8), SEEDVR2_F8(16), SEEDVR2_F8(24),
        SEEDVR2_F8(32), SEEDVR2_F8(40), SEEDVR2_F8(48), SEEDVR2_F8(56),
        SEEDVR2_F8(64), SEEDVR2_F8(72), SEEDVR2_F8(80), SEEDVR2_F8(88),
        SEEDVR2_F8(96), SEEDVR2_F8(104), SEEDVR2_F8(112), SEEDVR2_F8(120)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef SEEDVR2_F8
#undef SEEDVR2_R8
#undef SEEDVR2_D32
#undef SEEDVR2_D64
#undef SEEDVR2_D128

// ------------------------------------------------------------ host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// link against libcuda).
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &res);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &res);
#endif
    return res == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                              : nullptr;
  }();
  return fn;
}

// Tensor map of a row-major 2-D tensor: `rows` rows of `cols` elements,
// `row_bytes` apart (a multiple of 16), boxes of box_cols x box_rows; reads
// past an edge are zero-filled.
inline bool make_map_2d(CUtensorMap* map, CUtensorMapDataType type,
                        const void* ptr, uint64_t cols, uint64_t rows,
                        uint64_t row_bytes, uint32_t box_cols,
                        uint32_t box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// As make_map_2d for `planes` such tensors `plane_bytes` apart (a 3-D map,
// boxes one plane deep).
inline bool make_map_3d(CUtensorMap* map, CUtensorMapDataType type,
                        const void* ptr, uint64_t cols, uint64_t rows,
                        uint64_t planes, uint64_t row_bytes,
                        uint64_t plane_bytes, uint32_t box_cols,
                        uint32_t box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {cols, rows, planes};
  const cuuint64_t strides[2] = {row_bytes, plane_bytes};
  const cuuint32_t box[3] = {box_cols, box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
}  // namespace seedvr2
