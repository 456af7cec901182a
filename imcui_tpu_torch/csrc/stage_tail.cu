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
// pixel (stage 2 at 8x512^2: 155 GFLOP, 0.156 ms at the 989 TFLOP/s bf16
// tensor-core peak, against 0.34 GB of compulsory traffic, 0.10 ms). The
// tensor-core half is stage_conv.cuh's implicit GEMM on wgmma; this file
// is its prologue: for each step (4 rows of 64 + 2 pixels x 64 channels of
// the CTA's strip) each producer thread loads its 16-byte chunks straight
// into registers (before the ring slot is free, so the loads' latency
// overlaps the consumers' products), applies relu(y + b_a) rounded as the
// bf16 graph rounds it, zeroes pixels outside the image AFTER it (relu(0 +
// b_a) != 0, pallas_stage1.py:110-118), and stores the chunks into the
// plane layout of the ring slot.

#include "stage_conv.cuh"

namespace {

struct TailPrologue {
  struct Args {
    const __nv_bfloat16* y;
    const float* ba;
  };
  static constexpr int SMEM = 0;

  const __nv_bfloat16* y;
  int H, W, chunk, p0;
  float bias[8];  // b_a of the thread's chunk, rounded to bf16
  uint4 v[ITEMS];

  __device__ TailPrologue(const Args& a, int H_, int W_)
      : y(a.y), H(H_), W(W_), chunk(threadIdx.x % 8), p0(threadIdx.x / 8) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      bias[j] = __bfloat162float(__float2bfloat16_rn(a.ba[chunk * 8 + j]));
  }

  // pixel p of step t: in the image, at element `at` of y
  __device__ bool inside(const Step& t, int p, size_t* at) const {
    const int gr = t.r0 + p / IN_W, gc = t.c0 - 1 + p % IN_W;
    *at = ((size_t(t.b) * H + gr) * W + gc) * C + chunk * 8;
    return gr >= 0 && gr < H && gc >= 0 && gc < W;
  }

  __device__ void begin(const Region&, const Sched&) {}

  __device__ void load(const Region&, const Sched& sched, int k) {
    if (skipped(SKIP_LOADS, k)) return;
    const Step t = sched.at(k);
#pragma unroll
    for (int n = 0; n < ITEMS; ++n) {
      const int p = p0 + 32 * n;
      size_t at;
      v[n] = make_uint4(0, 0, 0, 0);
      if (p < STEP_PIX && inside(t, p, &at))
        v[n] = __ldg(reinterpret_cast<const uint4*>(y + at));
    }
  }

  // bf16 + bf16 rounded to bf16, then relu, as the bf16 graph does
  __device__ uint32_t prologue(uint32_t raw, int j) const {
    const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&raw);
    const __nv_bfloat162 s = __floats2bfloat162_rn(
        __low2float(x) + bias[2 * j], __high2float(x) + bias[2 * j + 1]);
    const __nv_bfloat162 r = __hmax2(s, __float2bfloat162_rn(0.f));
    return *reinterpret_cast<const uint32_t*>(&r);
  }

  __device__ void store(const Region&, uint32_t a, const Sched& sched,
                        int k) {
    const Step t = sched.at(k);
#pragma unroll
    for (int n = 0; n < ITEMS; ++n) {
      const int p = p0 + 32 * n;
      if (p >= STEP_PIX) break;
      size_t at;
      uint4 o = make_uint4(0, 0, 0, 0);  // conv_b's zero padding
      if (inside(t, p, &at)) {
        o = v[n];
        if (!skipped(SKIP_PROLOGUE, k))
          o = make_uint4(prologue(o.x, 0), prologue(o.y, 1), prologue(o.z, 2),
                         prologue(o.w, 3));
      }
      st_shared(a + chunk * PLANE + p * 16, o);
    }
  }
};

__global__ void __launch_bounds__(THREADS, 1)
    stage_tail_kernel(const __grid_constant__ CUtensorMap wmap,
                      const __nv_bfloat16* __restrict__ y,
                      const float* __restrict__ ba,
                      const float* __restrict__ bb,
                      __nv_bfloat16* __restrict__ out, int B, int H, int W,
                      Sched sched) {
  conv_tiles<TailPrologue>(&wmap, {y, ba}, bb, out, B, H, W, sched);
}

}  // namespace

// y: (B, H, W, 64) bf16, 16-byte aligned; ba, bb: (64,) f32; wb: (3, 3, 64,
// 64) bf16 as (ky, kx, cout, cin); out: (B, H/2, W/2, 64) bf16. H, W even.
extern "C" int stage_tail_bf16(const void* y, const void* ba, const void* wb,
                               const void* bb, void* out, int B, int H, int W,
                               void* stream) {
  if (!takes(B, H, W)) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(y) % 16 || reinterpret_cast<uintptr_t>(wb) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int sms = prepare<TailPrologue>(
      reinterpret_cast<const void*>(stage_tail_kernel));
  if (sms < 0) return -sms;
  CUtensorMap wmap;
  if (!encode_weights(&wmap, wb)) return IMCUI_TENSOR_MAP_ERROR;
  const Sched sched = Sched::of(B, H, W, sms);
  stage_tail_kernel<<<sched.n < sms ? sched.n : sms, THREADS,
                      smem_bytes<TailPrologue>(),
                      static_cast<cudaStream_t>(stream)>>>(
      wmap, static_cast<const __nv_bfloat16*>(y), static_cast<const float*>(ba),
      static_cast<const float*>(bb), static_cast<__nv_bfloat16*>(out), B, H, W,
      sched);
  return static_cast<int>(cudaGetLastError());
}

// The launch plan of either kernel at (B, H, W), for the records: out[0..6]
// = conv rows and columns of a tile, strips (B x column strips), segments
// a strip, tiles a segment, CTAs, SMs on the card.
extern "C" int stage_conv_plan(int B, int H, int W, void* out) {
  if (!takes(B, H, W)) return static_cast<int>(cudaErrorInvalidValue);
  const int sms = prepare<TailPrologue>(
      reinterpret_cast<const void*>(stage_tail_kernel));
  if (sms < 0) return -sms;
  const Sched sched = Sched::of(B, H, W, sms);
  int* o = static_cast<int*>(out);
  o[0] = TH;
  o[1] = TW;
  o[2] = B * sched.strips_w;
  o[3] = sched.segs;
  o[4] = sched.len;
  o[5] = sched.n < sms ? sched.n : sms;
  o[6] = sms;
  return 0;
}
