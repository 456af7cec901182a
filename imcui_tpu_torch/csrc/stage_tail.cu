// SuperPoint VGG stage tail, fused:
//     out = maxpool2x2(relu(conv3x3(relu(y + b_a); W_b) + b_b))
// y is the previous conv's output WITHOUT its bias (conv_a stays a library
// convolution). NHWC bf16 in and out, C = 64, f32 accumulation.
//
// Replaces: imcui_tpu/ops/pallas_stage1.py:stage_tail (kernel _kernel), which
// runs the same function width-folded (B, H, W/2, 128) to fill the TPU's
// 128-lane MXU. Here the unfolded C = 64 function is computed directly.
//
// What bounds it on an H100: the 3x3x64x64 convolution, 2*9*64*64 flop per
// pixel (stage 1 at 8x1024^2: 618 GFLOP, 0.63 ms at the 989 TFLOP/s bf16
// tensor-core peak, against 0.40 ms of compulsory HBM traffic). So the
// design keeps the tensor cores fed from shared memory:
//   * WMMA bf16 16x16x16 fragments (mma.sync on the tensor cores), f32
//     accumulators; each warp owns 2 conv rows x 16 pixels x 64 channels, so
//     every B fragment feeds two products and every A fragment four;
//   * a persistent grid (one block per SM): W_b (72 KB) is staged into shared
//     memory once per block, not once per tile;
//   * one (16+2) x (32+2) x 64 input tile with its halo per step, with the
//     prologue relu(y + b_a) applied while loading and the out-of-image halo
//     zeroed AFTER it (relu(0 + b_a) != 0, pallas_stage1.py:110-118);
//   * the epilogue (bias, relu, 2x2 max) runs on each warp's accumulators
//     through a small per-warp scratch, and only the pooled bf16 output is
//     written: the full-resolution conv_b output never reaches HBM.
// Pixel rows in shared memory are padded to 80 bf16 (160 B) so fragment
// pointers stay 32-byte aligned while rows spread over the banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

using namespace nvcuda;

namespace {

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
constexpr size_t SMEM = SMEM_IN + SMEM_W + SMEM_SCR;

__global__ void __launch_bounds__(THREADS, 1)
stage_tail_kernel(const __nv_bfloat16* __restrict__ y,
                  const float* __restrict__ ba,
                  const __nv_bfloat16* __restrict__ wb,
                  const float* __restrict__ bb,
                  __nv_bfloat16* __restrict__ out, int B, int H, int W) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* wsm = reinterpret_cast<__nv_bfloat16*>(smem + SMEM_IN);
  float* scratch = reinterpret_cast<float*>(smem + SMEM_IN + SMEM_W);

  // W_b: (3, 3, 64, 64) = 576 rows of 64 output channels, 8 per uint4.
  for (int i = threadIdx.x; i < 9 * C * (C / 8); i += THREADS) {
    const int row = i / (C / 8), chunk = i % (C / 8);
    *reinterpret_cast<uint4*>(wsm + row * WROW + chunk * 8) =
        *reinterpret_cast<const uint4*>(wb + row * C + chunk * 8);
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rp = warp / (TW / 16);          // conv rows 2rp, 2rp+1 of the tile
  const int cb = (warp % (TW / 16)) * 16;   // first conv column of the warp
  float* scr = scratch + warp * 512;

  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  const int n_tiles = tiles_w * tiles_h * B;
  const int Ho = H / 2, Wo = W / 2;

  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int b = t / (tiles_w * tiles_h);
    const int r0 = ((t / tiles_w) % tiles_h) * TH;
    const int c0 = (t % tiles_w) * TW;
    const __nv_bfloat16* yb = y + size_t(b) * H * W * C;

    __syncthreads();  // previous tile's readers are done with `tile`
    for (int i = threadIdx.x; i < IN_H * IN_W * (C / 8); i += THREADS) {
      const int chunk = i % (C / 8), pix = i / (C / 8);
      const int gr = r0 - 1 + pix / IN_W, gc = c0 - 1 + pix % IN_W;
      __align__(16) __nv_bfloat16 v[8];
      if (gr >= 0 && gr < H && gc >= 0 && gc < W) {
        uint4 raw = *reinterpret_cast<const uint4*>(
            yb + (size_t(gr) * W + gc) * C + chunk * 8);
        const __nv_bfloat16* rv = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          // bf16 + bf16 rounded to bf16, then relu, as the bf16 graph does
          const float bias = __bfloat162float(__float2bfloat16_rn(ba[chunk * 8 + j]));
          const __nv_bfloat16 s = __float2bfloat16_rn(__bfloat162float(rv[j]) + bias);
          v[j] = __bfloat162float(s) > 0.f ? s : __float2bfloat16_rn(0.f);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = __float2bfloat16_rn(0.f);
      }
      *reinterpret_cast<uint4*>(tile + pix * PIX + chunk * 8) =
          *reinterpret_cast<const uint4*>(v);
    }
    __syncthreads();

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
}

}  // namespace

extern "C" int stage_tail_bf16(const void* y, const void* ba, const void* wb,
                               const void* bb, void* out, int B, int H, int W,
                               void* stream) {
  cudaFuncSetAttribute(stage_tail_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM));
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int n_tiles = ((W + TW - 1) / TW) * ((H + TH - 1) / TH) * B;
  const int grid = n_tiles < sms ? n_tiles : sms;
  stage_tail_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(y), static_cast<const float*>(ba),
      static_cast<const __nv_bfloat16*>(wb), static_cast<const float*>(bb),
      static_cast<__nv_bfloat16*>(out), B, H, W);
  return static_cast<int>(cudaGetLastError());
}
