// Shared by stage_tail.cu and stem_tail.cu: the tensor-core half of a
// SuperPoint VGG stage,
//     out = maxpool2x2(relu(conv3x3(t; W_b) + b_b)),
// on one (16+2) x (32+2) x 64 bf16 input tile `t` that the caller has put
// into shared memory with its halo (zeros outside the image). C = 64 in and
// out, f32 accumulation, NHWC bf16 output.
//
//   * WMMA bf16 16x16x16 fragments (mma.sync on the tensor cores), f32
//     accumulators; each warp owns 2 conv rows x 16 pixels x 64 channels, so
//     every B fragment feeds two products and every A fragment four;
//   * W_b (72 KB) is staged into shared memory once per block by
//     load_weights(); the callers run a persistent grid (one block per SM);
//   * the epilogue (bias, relu, 2x2 max) runs on each warp's accumulators
//     through a small per-warp scratch, and only the pooled bf16 output is
//     written: the full-resolution conv output never reaches HBM.
// Pixel rows in shared memory are padded to 80 bf16 (160 B) so fragment
// pointers stay 32-byte aligned while rows spread over the banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int C = 64;
constexpr int TH = 16;               // conv rows per tile
constexpr int TW = 32;               // conv columns per tile
constexpr int IN_H = TH + 2;
constexpr int IN_W = TW + 2;
constexpr int PIX = 80;              // smem stride of one input pixel (bf16)
constexpr int WROW = 72;             // smem stride of one W_b row (bf16)
constexpr int WARPS = (TH / 2) * (TW / 16);
constexpr int THREADS = WARPS * 32;  // 512
constexpr size_t SMEM_IN = size_t(IN_H) * IN_W * PIX * 2;
constexpr size_t SMEM_W = size_t(9) * C * WROW * 2;
constexpr size_t SMEM_SCR = size_t(WARPS) * 2 * 256 * 4;

// W_b: (3, 3, 64, 64) = 576 rows of 64 output channels, 8 per uint4.
__device__ __forceinline__ void load_weights(__nv_bfloat16* wsm,
                                             const __nv_bfloat16* __restrict__ wb) {
  for (int i = threadIdx.x; i < 9 * C * (C / 8); i += THREADS) {
    const int row = i / (C / 8), chunk = i % (C / 8);
    *reinterpret_cast<uint4*>(wsm + row * WROW + chunk * 8) =
        *reinterpret_cast<const uint4*>(wb + row * C + chunk * 8);
  }
}

// Tile with first conv pixel (r0, c0) of image b; `tile` and `wsm` must be
// complete (a __syncthreads() after their writers) before the call.
__device__ __forceinline__ void conv_pool_tile(
    const __nv_bfloat16* tile, const __nv_bfloat16* wsm, float* scratch,
    const float* __restrict__ bb, __nv_bfloat16* __restrict__ out, int b,
    int r0, int c0, int H, int W) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rp = warp / (TW / 16);          // conv rows 2rp, 2rp+1 of the tile
  const int cb = (warp % (TW / 16)) * 16;   // first conv column of the warp
  float* scr = scratch + warp * 512;
  const int Ho = H / 2, Wo = W / 2;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int n = 0; n < 4; ++n) wmma::fill_fragment(acc[r][n], 0.f);

#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int ky = tap / 3, kx = tap % 3;
#pragma unroll
    for (int kc = 0; kc < C / 16; ++kc) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a0, a1;
      wmma::load_matrix_sync(
          a0, tile + ((2 * rp + ky) * IN_W + cb + kx) * PIX + kc * 16, PIX);
      wmma::load_matrix_sync(
          a1, tile + ((2 * rp + 1 + ky) * IN_W + cb + kx) * PIX + kc * 16, PIX);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
        wmma::load_matrix_sync(bf, wsm + (tap * C + kc * 16) * WROW + n * 16, WROW);
        wmma::mma_sync(acc[0][n], a0, bf, acc[0][n]);
        wmma::mma_sync(acc[1][n], a1, bf, acc[1][n]);
      }
    }
  }

  // epilogue: rows (2rp, 2rp+1) x 16 pixels -> 8 pooled pixels per n-chunk
  const int orow = (r0 + 2 * rp) / 2;
  const int p = lane / 4, cq = (lane % 4) * 4;
  const int ocol = (c0 + cb) / 2 + p;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    wmma::store_matrix_sync(scr, acc[0][n], 16, wmma::mem_row_major);
    wmma::store_matrix_sync(scr + 256, acc[1][n], 16, wmma::mem_row_major);
    __syncwarp();
    if (orow < Ho && ocol < Wo) {
      __align__(8) __nv_bfloat16 o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ch = cq + j;
        const float m = fmaxf(
            fmaxf(scr[(2 * p) * 16 + ch], scr[(2 * p + 1) * 16 + ch]),
            fmaxf(scr[256 + (2 * p) * 16 + ch], scr[256 + (2 * p + 1) * 16 + ch]));
        // relu(a + b) is monotone in a: pooling before it is exact
        o[j] = __float2bfloat16_rn(fmaxf(m + bb[n * 16 + ch], 0.f));
      }
      *reinterpret_cast<uint2*>(
          out + ((size_t(b) * Ho + orow) * Wo + ocol) * C + n * 16 + cq) =
          *reinterpret_cast<const uint2*>(o);
    }
    __syncwarp();
  }
}

// Blocks of a persistent launch over all tiles: one per SM, or fewer.
inline int persistent_grid(int B, int H, int W) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int n_tiles = ((W + TW - 1) / TW) * ((H + TH - 1) / TH) * B;
  return n_tiles < sms ? n_tiles : sms;
}

}  // namespace
