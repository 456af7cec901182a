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
// design keeps the tensor cores fed from shared memory (stage_conv.cuh: WMMA
// bf16 tiles, W_b staged once per persistent block, pooled epilogue), and
// loads one (16+2) x (32+2) x 64 input tile with its halo per step, with the
// prologue relu(y + b_a) applied while loading and the out-of-image halo
// zeroed AFTER it (relu(0 + b_a) != 0, pallas_stage1.py:110-118).

#include "stage_conv.cuh"

namespace {

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

  load_weights(wsm, wb);

  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  const int n_tiles = tiles_w * tiles_h * B;

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

    conv_pool_tile(tile, wsm, scratch, bb, out, b, r0, c0, H, W);
  }
}

}  // namespace

extern "C" int stage_tail_bf16(const void* y, const void* ba, const void* wb,
                               const void* bb, void* out, int B, int H, int W,
                               void* stream) {
  cudaFuncSetAttribute(stage_tail_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM));
  const int grid = persistent_grid(B, H, W);
  stage_tail_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(y), static_cast<const float*>(ba),
      static_cast<const __nv_bfloat16*>(wb), static_cast<const float*>(bb),
      static_cast<__nv_bfloat16*>(out), B, H, W);
  return static_cast<int>(cudaGetLastError());
}
