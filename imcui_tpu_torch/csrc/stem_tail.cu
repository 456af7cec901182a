// SuperPoint's stem, fused from the raw image:
//     out = maxpool2x2(relu(conv3x3(relu(conv3x3(img; W_a) + b_a); W_b) + b_b))
// img is (B, H, W) f32 or bf16 with one channel; conv_a is 1 -> 64, conv_b
// 64 -> 64; out is (B, H/2, W/2, 64) bf16 NHWC. Both convolutions pad with
// zeros: outside the image conv_b reads 0, not relu(b_a).
//
// Replaces: imcui_tpu/ops/pallas_stage1.py:stem_tail (kernel _stem_kernel,
// bf16 folded image in) and imcui_tpu/ops/pallas_conv.py:
// superpoint_stem_fused (kernel _stem_kernel, f32 image in), which compute
// this one function. Its arithmetic is that of pallas_conv.py:_stem_xla:
// bf16 operands, f32 accumulation, bias and relu in f32, conv_a's output
// rounded to bf16.
//
// What bounds it on an H100: conv_b's 2*9*64*64 flop per pixel on the tensor
// cores (618 GFLOP at 8x1024^2: 0.63 ms at 989 TFLOP/s); the bytes are the
// image in and the pooled output out (0.29 GB: 0.09 ms), since conv_a's
// 64-channel full-resolution output, which the unfused route writes to and
// reads from device memory, stays in shared memory. conv_a itself is 9 FMAs
// per pixel and channel on the FMA units, 1/64 of conv_b's work. Each
// persistent block loads a (16+4) x (32+4) image tile (2-pixel halo),
// computes conv_a + bias + relu for the (16+2) x (32+2) pixels conv_b needs
// straight into the bf16 tile of stage_conv.cuh, zeroing pixels outside the
// image, and hands over to the shared tensor-core code.

#include "stage_conv.cuh"

namespace {

constexpr int IM_H = TH + 4;
constexpr int IM_W = TW + 4;
constexpr size_t SMEM_IMG = size_t(IM_H) * IM_W * 4;
constexpr size_t SMEM_WA = size_t(9) * C * 4;
constexpr size_t SMEM_BA = size_t(C) * 4;
constexpr size_t SMEM = SMEM_IN + SMEM_W + SMEM_SCR + SMEM_IMG + SMEM_WA + SMEM_BA;

// the image value as conv_a's bf16 operand, held in f32
__device__ __forceinline__ float operand(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float operand(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// wa: (9, 64) f32 holding bf16-rounded values, tap-major; ba, bb: (64,) f32;
// wb: (3, 3, 64, 64) bf16.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
stem_tail_kernel(const T* __restrict__ image, const float* __restrict__ wa,
                 const float* __restrict__ ba,
                 const __nv_bfloat16* __restrict__ wb,
                 const float* __restrict__ bb, __nv_bfloat16* __restrict__ out,
                 int B, int H, int W) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* wsm = reinterpret_cast<__nv_bfloat16*>(smem + SMEM_IN);
  float* scratch = reinterpret_cast<float*>(smem + SMEM_IN + SMEM_W);
  float* img = reinterpret_cast<float*>(smem + SMEM_IN + SMEM_W + SMEM_SCR);
  float* was = img + IM_H * IM_W;
  float* bas = was + 9 * C;

  load_weights(wsm, wb);
  for (int i = threadIdx.x; i < 9 * C; i += THREADS) was[i] = wa[i];
  for (int i = threadIdx.x; i < C; i += THREADS) bas[i] = ba[i];

  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  const int n_tiles = tiles_w * tiles_h * B;

  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int b = t / (tiles_w * tiles_h);
    const int r0 = ((t / tiles_w) % tiles_h) * TH;
    const int c0 = (t % tiles_w) * TW;
    const T* ib = image + size_t(b) * H * W;

    __syncthreads();  // previous tile's readers are done with `tile`, `img`
    for (int i = threadIdx.x; i < IM_H * IM_W; i += THREADS) {
      const int gr = r0 - 2 + i / IM_W, gc = c0 - 2 + i % IM_W;
      img[i] = gr >= 0 && gr < H && gc >= 0 && gc < W
                   ? operand(ib[size_t(gr) * W + gc]) : 0.f;
    }
    __syncthreads();

    // conv_a at pixel (r0 - 1 + pr, c0 - 1 + pc): its tap (ky, kx) is image
    // pixel (r0 - 2 + pr + ky, c0 - 2 + pc + kx) = img[pr + ky][pc + kx]
    for (int i = threadIdx.x; i < IN_H * IN_W * (C / 8); i += THREADS) {
      const int chunk = i % (C / 8), pix = i / (C / 8);
      const int pr = pix / IN_W, pc = pix % IN_W;
      const int gr = r0 - 1 + pr, gc = c0 - 1 + pc;
      __align__(16) __nv_bfloat16 v[8];
      if (gr >= 0 && gr < H && gc >= 0 && gc < W) {
        // the thread's 8 channels of one tap are two float4 reads that the
        // lanes sharing a chunk receive as one broadcast
        float a[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) a[j] = 0.f;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const float x = img[(pr + tap / 3) * IM_W + pc + tap % 3];
          const float4 w0 = *reinterpret_cast<const float4*>(was + tap * C + chunk * 8);
          const float4 w1 = *reinterpret_cast<const float4*>(was + tap * C + chunk * 8 + 4);
          a[0] = fmaf(x, w0.x, a[0]);
          a[1] = fmaf(x, w0.y, a[1]);
          a[2] = fmaf(x, w0.z, a[2]);
          a[3] = fmaf(x, w0.w, a[3]);
          a[4] = fmaf(x, w1.x, a[4]);
          a[5] = fmaf(x, w1.y, a[5]);
          a[6] = fmaf(x, w1.z, a[6]);
          a[7] = fmaf(x, w1.w, a[7]);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[j] = __float2bfloat16_rn(fmaxf(a[j] + bas[chunk * 8 + j], 0.f));
      } else {
        // conv_b's zero padding: no relu(b_a) outside the image
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

template <typename T>
int launch(const void* image, const void* wa, const void* ba, const void* wb,
           const void* bb, void* out, int B, int H, int W, void* stream) {
  cudaFuncSetAttribute(stem_tail_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM));
  const int grid = persistent_grid(B, H, W);
  stem_tail_kernel<T><<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(image), static_cast<const float*>(wa),
      static_cast<const float*>(ba), static_cast<const __nv_bfloat16*>(wb),
      static_cast<const float*>(bb), static_cast<__nv_bfloat16*>(out), B, H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 != 0: the image is __nv_bfloat16, else float.
extern "C" int stem_tail_fwd(const void* image, const void* wa, const void* ba,
                             const void* wb, const void* bb, void* out, int B,
                             int H, int W, int bf16, void* stream) {
  return bf16 ? launch<__nv_bfloat16>(image, wa, ba, wb, bb, out, B, H, W, stream)
              : launch<float>(image, wa, ba, wb, bb, out, B, H, W, stream);
}
