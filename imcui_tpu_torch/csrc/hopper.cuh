// Shared by tap_matmul.cu, qtiled_attention.cu and stage_conv.cuh: the
// Hopper pieces of a warp-specialised kernel that loads tiles by TMA into
// a ring of shared-memory stages guarded by mbarriers and multiplies them
// with wgmma.
//
//   * mbarrier init / arrive / expect_tx / parity wait;
//   * TMA tile loads (2-D and 3-D boxes) that complete on an mbarrier;
//   * wgmma descriptors of 128-byte-swizzled tiles (K-major and MN-major),
//     the fence / commit / wait trio, and a fence that keeps the compiler
//     from moving accumulator accesses across the asynchronous products;
//   * the m64n128k16 and m64n64k16 bf16 products with both operands in
//     shared memory;
//   * host side: cuTensorMapEncodeTiled taken from the driver at run time
//     (cudaGetDriverEntryPointByVersion, no -lcuda) and the encoders of the
//     tensor maps the kernels use, 128-byte swizzle, zero fill past the
//     bounds on load.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

static_assert(CUDART_VERSION >= 12050,
              "the TMA kernels need CUDA 12.5 or later "
              "(cudaGetDriverEntryPointByVersion)");

namespace {

// ---------------------------------------------------------------- PTX

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// wgmma descriptor of a K-major tile with 128-byte swizzle: 8-row groups
// 1024 B apart; the start address moves along K inside the swizzle atom.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t(1) << 62) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 16) | uint64_t((addr & 0x3FFFF) >> 4);
}

// wgmma descriptor of an MN-major tile of 64 bf16 columns (one 128-byte
// swizzled row per K index), as TMA lays out a row-major (K, 64) box: the
// 8-row groups along K are 1024 B apart. The offset between 64-column
// groups along MN is never used at a width of 64, and is set to the same
// 1024 B, so either reading of the two offset fields gives this layout.
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) {
  return (uint64_t(1) << 62) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1024 >> 4) << 16) | uint64_t((addr & 0x3FFFF) >> 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator accesses across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The same for A operands in registers: a wgmma reads them after it is
// issued, so they stay live until its wait.
template <int N>
__device__ __forceinline__ void fence_acc(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define ACC8(C, d, i)                                                  \
  C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3]), C(d[i + 4]),         \
      C(d[i + 5]), C(d[i + 6]), C(d[i + 7])
#define ACC32(C, d) ACC8(C, d, 0), ACC8(C, d, 8), ACC8(C, d, 16), ACC8(C, d, 24)
#define ACC64(C, d)                                                    \
  ACC8(C, d, 0), ACC8(C, d, 8), ACC8(C, d, 16), ACC8(C, d, 24),        \
      ACC8(C, d, 32), ACC8(C, d, 40), ACC8(C, d, 48), ACC8(C, d, 56)
#define REGS32                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
  "%28, %29, %30, %31}"
#define REGS64                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "   \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "   \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (+)= A (64 x 16, K-major) * B (16 x 128, K-major), bf16 in, f32 sums;
// scale 0 drops d.
__device__ __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b,
                                    int scale) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : ACC64("+f", d)
      : "l"(a), "l"(b), "r"(scale));
}

// d (+)= A (64 x 16, K-major) * B (16 x 64, K-major), both in shared
// memory (either layout the descriptors describe); scale 0 drops d.
__device__ __forceinline__ void mma_n64(float (&d)[32], uint64_t a,
                                        uint64_t b, int scale) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : ACC32("+f", d)
      : "l"(a), "l"(b), "r"(scale));
}

// Two neighbouring outputs as bf16x2, the lower column in the low half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---------------------------------------------------------------- host

PFN_cuTensorMapEncodeTiled encoder() {
  static const PFN_cuTensorMapEncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A tensor of `rank` dimensions, innermost first (dims[0] elements of
// 128 bytes a row), read or written in boxes of `box`, 128-byte swizzle;
// elements past the bounds zero-filled on load and clipped on store.
// strides[i] is the byte stride of dimension i + 1.
bool encode_tiled(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
                  int rank, const cuuint64_t* dims, const cuuint64_t* strides,
                  const cuuint32_t* box) {
  const PFN_cuTensorMapEncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map, type, rank, const_cast<void*>(ptr), dims, strides, box,
            step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A row-major (rows, cols) matrix in (box_rows, box_cols) boxes.
bool encode(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
            uint64_t rows, uint64_t cols, uint64_t row_bytes,
            uint32_t box_rows, uint32_t box_cols) {
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  return encode_tiled(map, type, ptr, 2, dims, strides, box);
}

}  // namespace
