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
// image in and the pooled output out (0.2 GB: 0.06 ms), since conv_a's
// 64-channel full-resolution output, which the unfused route writes to and
// reads from device memory, stays in shared memory. conv_a is 9 FMAs per
// pixel and channel, 1/64 of conv_b's work, on the FMA units.
//
// The tensor-core half is stage_conv.cuh's implicit GEMM on wgmma; this
// file is its prologue. For each step (4 rows of the CTA's strip, 64 + 2
// pixels wide) the producer warpgroups copy the (4+2) x (64+4) image window
// (zeros outside the image: the copies of those 4-byte units read nothing)
// by cp.async into one of two staging buffers, two steps ahead, then
// compute conv_a + b_a + relu for the step's pixels, rounded to bf16,
// straight into the plane layout of the ring slot, with zeros for pixels
// outside the image (conv_b's padding). A thread keeps its 8 channels' 72
// weights and biases in registers and sums each pixel's taps in order, in
// f32 FMAs. The strip walk computes each conv_a row once: 1.03 pixels of
// conv_a per output pixel, against 1.55 for tiles with their own halo.
//
// conv_a stays off the tensor cores: a K = 16 product over a 9-tap im2col
// took a quarter less time at 8 x 1024^2, but the tensor cores' f32 sums
// round conv_a's output to bf16 across a rounding boundary more often than
// FMAs do, and about one output in 10^8 then left the tolerance (1e-3 +
// 2^-7 |plain|) at full size; recomputing the values near a boundary with
// FMAs restores the FMA result, but the warp-divergent recomputation cost
// more than the tensor cores saved (PERF.md, section 6).

#include "stage_conv.cuh"


namespace {

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// the image value as conv_a's bf16 operand, held in f32
__device__ __forceinline__ float operand(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float operand(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
struct StemPrologue {
  struct Args {
    const T* image;
    const float* wa;  // (9, 64): tap-major, bf16-rounded values
    const float* ba;
  };
  static constexpr int IM_H = TH + 2, IM_W = TW + 4;
  static constexpr int STAGE = (IM_H * IM_W * int(sizeof(T)) + 127) / 128 * 128;
  static constexpr int SMEM = 2 * STAGE;
  static constexpr int UNIT = 4 / int(sizeof(T));  // elements a copy moves
  static constexpr int UNITS = IM_H * IM_W / UNIT;

  const T* image;
  int H, W, chunk, p0;
  float w[9][8], bias[8];  // W_a and b_a of the thread's 8 channels

  __device__ StemPrologue(const Args& a, int H_, int W_)
      : image(a.image), H(H_), W(W_), chunk(threadIdx.x % 8),
        p0(threadIdx.x / 8) {
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
#pragma unroll
      for (int j = 0; j < 8; ++j) w[tap][j] = a.wa[tap * C + chunk * 8 + j];
#pragma unroll
    for (int j = 0; j < 8; ++j) bias[j] = a.ba[chunk * 8 + j];
  }

  // The window of the k-th step (image rows r0 - 1 ... r0 + 4, columns c0 -
  // 2 ... c0 + 65) into staging buffer k % 2, as one cp.async group (empty
  // past the last step, so the group count stays regular).
  __device__ void copy(const Region& x, const Sched& sched, int k) {
    if (sched.has(k) && !(skipped(SKIP_LOADS, k) && k >= 2)) {
      const Step t = sched.at(k);
      const T* ib = image + size_t(t.b) * H * W;
      for (int u = threadIdx.x; u < UNITS; u += PRODUCERS) {
        const int r = u / (IM_W / UNIT), c = u % (IM_W / UNIT) * UNIT;
        const int gr = t.r0 - 1 + r, gc = t.c0 - 2 + c;
        const bool in = gr >= 0 && gr < H && gc >= 0 && gc < W;
        cp_async4(x.addr + (k & 1) * STAGE + (r * IM_W + c) * int(sizeof(T)),
                  in ? ib + size_t(gr) * W + gc : image, in ? 4 : 0);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  __device__ void begin(const Region& x, const Sched& sched) {
    copy(x, sched, 0);
    copy(x, sched, 1);
  }

  // the k-th window has landed (all but the newest group are complete)
  __device__ void load(const Region&, const Sched&, int) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    producer_sync();
  }

  // conv_a at pixel (r0 + pr, c0 - 1 + pc): its tap (ky, kx) is image pixel
  // (r0 - 1 + pr + ky, c0 - 2 + pc + kx) = img[pr + ky][pc + kx]
  __device__ void store(const Region& x, uint32_t a, const Sched& sched,
                        int k) {
    const Step t = sched.at(k);
    const T* img = reinterpret_cast<const T*>(x.ptr + (k & 1) * STAGE);
#pragma unroll 1
    for (int p = p0; p < STEP_PIX; p += 32) {
      const int pr = p / IN_W, pc = p % IN_W;
      const int gr = t.r0 + pr, gc = t.c0 - 1 + pc;
      uint4 o = make_uint4(0, 0, 0, 0);  // conv_b's zero padding
      if (gr >= 0 && gr < H && gc >= 0 && gc < W &&
          !skipped(SKIP_PROLOGUE, k)) {
        float acc[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] = 0.f;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const float v = operand(img[(pr + tap / 3) * IM_W + pc + tap % 3]);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[j] = fmaf(v, w[tap][j], acc[j]);
        }
        o = make_uint4(relu_pack(acc[0], acc[1], bias[0], bias[1]),
                       relu_pack(acc[2], acc[3], bias[2], bias[3]),
                       relu_pack(acc[4], acc[5], bias[4], bias[5]),
                       relu_pack(acc[6], acc[7], bias[6], bias[7]));
      }
      st_shared(a + chunk * PLANE + p * 16, o);
    }
    producer_sync();  // every thread is done with this staging buffer
    copy(x, sched, k + 2);
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    stem_tail_kernel(const __grid_constant__ CUtensorMap wmap,
                     const T* __restrict__ image, const float* __restrict__ wa,
                     const float* __restrict__ ba,
                     const float* __restrict__ bb,
                     __nv_bfloat16* __restrict__ out, int B, int H, int W,
                     Sched sched) {
  conv_tiles<StemPrologue<T>>(&wmap, {image, wa, ba}, bb, out, B, H, W, sched);
}

template <typename T>
int launch(const void* image, const void* wa, const void* ba, const void* wb,
           const void* bb, void* out, int B, int H, int W, void* stream) {
  if (!takes(B, H, W)) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(image) % 4 ||
      reinterpret_cast<uintptr_t>(wb) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int sms = prepare<StemPrologue<T>>(
      reinterpret_cast<const void*>(stem_tail_kernel<T>));
  if (sms < 0) return -sms;
  CUtensorMap wmap;
  if (!encode_weights(&wmap, wb)) return IMCUI_TENSOR_MAP_ERROR;
  const Sched sched = Sched::of(B, H, W, sms);
  stem_tail_kernel<T><<<sched.n < sms ? sched.n : sms, THREADS,
                        smem_bytes<StemPrologue<T>>(),
                        static_cast<cudaStream_t>(stream)>>>(
      wmap, static_cast<const T*>(image), static_cast<const float*>(wa),
      static_cast<const float*>(ba), static_cast<const float*>(bb),
      static_cast<__nv_bfloat16*>(out), B, H, W, sched);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 != 0: the image is __nv_bfloat16, else float; 4-byte aligned. wa:
// (9, 64) f32; ba, bb: (64,) f32; wb: (3, 3, 64, 64) bf16 as (ky, kx, cout,
// cin); out: (B, H/2, W/2, 64) bf16. H, W even.
extern "C" int stem_tail_fwd(const void* image, const void* wa, const void* ba,
                             const void* wb, const void* bb, void* out, int B,
                             int H, int W, int bf16, void* stream) {
  return bf16 ? launch<__nv_bfloat16>(image, wa, ba, wb, bb, out, B, H, W, stream)
              : launch<float>(image, wa, ba, wb, bb, out, B, H, W, stream);
}
