// Shared by stage_tail.cu (K1) and stem_tail.cu (K6/K7): the tensor-core
// half of a SuperPoint VGG stage,
//     out = maxpool2x2(relu(conv3x3(t; W_b) + b_b)),
// over a 64-channel bf16 input t that a prologue of the caller's computes
// row by row into shared memory (zeros outside the image: conv_b's SAME
// padding). C = 64 in and out, f32 sums, NHWC bf16 output.
//
// Hopper design, an implicit GEMM on wgmma:
// - A tile is TH = 4 conv rows x TW = 64 conv columns of one image. Each
//   conv row is one product: M = its 64 pixels, N = the 64 output channels,
//   K = 9 taps x 64 input channels, 36 wgmma m64n64k16.
// - A needs no im2col copy. The prologue writes t's rows, 64 + 2 pixels
//   wide, in the core-matrix layout of a K-major operand without swizzle,
//   the 8-channel chunks as planes: [8 chunks][row][pixel][8 channels].
//   A's row m for tap (ky, kx) is pixel m + kx of input row r + ky, 16 B
//   on from row m - 1, so every shifted start is a legal descriptor start:
//   SBO = 128 B between 8-pixel core matrices, LBO = the plane stride
//   between the two 8-channel halves of a k16 step. Planes are padded to
//   16 mod 128 B, so the 8 chunks of one pixel are written to distinct
//   banks.
// - A CTA walks down a 64-column strip of an image (a segment of it, so
//   that the grid fills the card) and keeps a ring of input rows: a step
//   adds 4 rows (conv rows 4j - 1 ... 4j + 2 of the strip for step j), tile
//   j reads steps j and j + 1, so each input row is computed once, not
//   1.5 times as by tiles with their own halo rows, and the prologue (the
//   stem's conv_a) does a third less work. The ring holds RING steps.
// - B is W_b, laid out by the wrapper as (tap, cout, cin): K-major rows of
//   128 B. Each persistent CTA loads it once by TMA with 128-byte swizzle
//   (72 KB) and keeps it.
// - Roles: two producer warpgroups run the prologue (the stem's conv_a,
//   K1's relu(y + b_a)) up to RING steps ahead of two consumer warpgroups
//   running wgmma; full and empty mbarriers, one pair a ring slot, hand the
//   steps over. Consumer warpgroup cw owns conv rows 2cw and 2cw + 1 of the
//   tile: two m64n64 f32 accumulators.
// - The epilogue stays in registers: wgmma's accumulator layout gives a
//   thread the same pixel and channel of both rows (the vertical max is
//   in-thread), and the pixel's horizontal neighbour is 4 lanes away (one
//   __shfl_xor_sync); then bias, relu (exact after the max: relu(a + b) is
//   monotone in a) and bf16. Only the pooled output reaches device memory,
//   in 16-byte stores after a transpose of words within each lane quad.
//
// Shared memory: W_b 72 KB + a ring of 4 steps (132 KB) + the prologue's
// own (the stem's two image windows) = 208 KB; 512 threads, one CTA an SM.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <mutex>

#include "errors.cuh"
#include "hopper.cuh"

// Builds for measurement only (tools/conv_times.py --skip): each set bit
// skips one part on every tile but the CTA's first, so that part's results
// stay live. 1: the prologue's arithmetic (the stem's conv_a, K1's relu(y +
// b_a)); 2: conv_b's wgmma; 4: the prologue's loads from device memory; 8:
// the epilogue. 0 is the kernel.
#ifndef STAGE_CONV_SKIP
#define STAGE_CONV_SKIP 0
#endif

namespace {

constexpr int SKIP_PROLOGUE = 1, SKIP_WGMMA = 2, SKIP_LOADS = 4,
              SKIP_EPILOGUE = 8;

// Whether a skip build leaves out `part` on the CTA's i-th tile (or step).
__device__ __forceinline__ bool skipped(int part, int i) {
  return (STAGE_CONV_SKIP & part) && i > 0;
}

constexpr int C = 64;
constexpr int TH = 4;                 // conv rows of a tile, input rows a step
constexpr int TW = 64;                // conv columns of a tile: wgmma's M
constexpr int IN_W = TW + 2;          // pixels of an input row
constexpr int RING = 4;               // steps the ring holds
constexpr int STEP_PIX = TH * IN_W;   // input pixels a step adds
constexpr int PLANE = (RING * STEP_PIX * 16 + 127) / 128 * 128 + 16;
constexpr int A_BYTES = 8 * PLANE;    // the ring
constexpr int W_TAP = C * C * 2;      // one tap of W_b
constexpr int W_BYTES = 9 * W_TAP;
constexpr int PRODUCERS = 256;        // two warpgroups
constexpr int THREADS = 512;          // producers + two consumer warpgroups
constexpr int CONSUMER_WARPS = 8;
// A producer thread's items of a step, (pixel, chunk) pairs: chunk tid % 8
// of pixels tid / 8 + 32 k, k < ITEMS.
constexpr int ITEMS = (STEP_PIX * 8 + PRODUCERS - 1) / PRODUCERS;
static_assert(PLANE % 128 == 16 && (PLANE >> 4) < (1 << 14), "plane stride");

// Rows of input a step adds: image b, rows r0 ... r0 + TH - 1 (r0 = 4j - 1
// for step j of a strip; rows outside the image are zeros), pixels c0 - 1
// ... c0 + TW of the strip whose first conv column is c0.
struct Step {
  int b, r0, c0;
};

// The launch's segments: each 64-column strip of each image is cut into
// `segs` segments of `len` tiles (the last may run past the image; those
// tiles read zeros and write nothing). A segment of tiles j0 ... j0 + len -
// 1 takes len + 1 steps. CTA x takes segments x, x + grid, ...; its k-th
// step is step k % (len + 1) of its (k / (len + 1))-th segment.
struct Sched {
  int strips_w, segs, len, n;  // strips an image, segments a strip, tiles
                               // a segment, segments in all
  __host__ __device__ static Sched of(int B, int H, int W, int sms) {
    Sched s;
    s.strips_w = (W + TW - 1) / TW;
    const int tiles_h = (H + TH - 1) / TH, strips = B * s.strips_w;
    int segs = sms / strips;
    segs = segs < 1 ? 1 : segs > tiles_h ? tiles_h : segs;
    s.len = (tiles_h + segs - 1) / segs;
    s.segs = (tiles_h + s.len - 1) / s.len;
    s.n = strips * s.segs;
    return s;
  }
  __device__ int segment(int k) const {
    return int(blockIdx.x) + k / (len + 1) * int(gridDim.x);
  }
  __device__ bool has(int k) const { return segment(k) < n; }
  __device__ Step at(int k) const {
    const int g = segment(k), strip = g / segs;
    return {strip / strips_w, (g % segs * len + k % (len + 1)) * TH - 1,
            strip % strips_w * TW};
  }
};

// Shared memory of the prologue's own: its generic pointer and address.
struct Region {
  unsigned char* ptr;
  uint32_t addr;
};

// wgmma descriptor of a K-major operand without swizzle in the plane
// layout: 8-row core matrices of 16 B rows, 128 B apart along M (SBO), the
// next 8 channels one plane on (LBO).
__device__ __forceinline__ uint64_t desc_planes(uint32_t addr) {
  return (uint64_t(128 >> 4) << 32) | (uint64_t(PLANE >> 4) << 16) |
         uint64_t((addr & 0x3FFFF) >> 4);
}

__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(PRODUCERS) : "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// Channels 2j, 2j + 1 of an item as bf16x2: relu(a + b), rounded once.
__device__ __forceinline__ uint32_t relu_pack(float a0, float a1, float b0,
                                              float b1) {
  return pack(fmaxf(a0 + b0, 0.f), fmaxf(a1 + b1, 0.f));
}

// The pooled output of consumer warpgroup cw's two conv rows, acc0 (row
// 2cw) and acc1 (2cw + 1). Thread (warp, lane) holds rows (pixels) 16 warp
// + lane / 4 (+ 8) and columns (channels) 8 j + 2 (lane % 4) (+ 1).
__device__ __forceinline__ void epilogue(const float (&acc0)[32],
                                         const float (&acc1)[32],
                                         const float (&bias)[16],
                                         __nv_bfloat16* __restrict__ out,
                                         Step tile, int cw, int H, int W) {
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int Ho = H / 2, Wo = W / 2;
  // lanes l and l ^ 4 hold horizontal neighbours: after the exchange both
  // hold both pooled pixels, and the odd one writes the pixel of rows + 8
  const bool high = lane & 4;
  const int orow = tile.r0 / 2 + cw;
  const int ocol = tile.c0 / 2 + warp * 8 + lane / 8 + (high ? 4 : 0);
  uint32_t w[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float m = fmaxf(acc0[4 * j + e], acc1[4 * j + e]);
      v[e] = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));
    }
    w[j] = high ? relu_pack(v[2], v[3], bias[2 * j], bias[2 * j + 1])
                : relu_pack(v[0], v[1], bias[2 * j], bias[2 * j + 1]);
  }
  // The 4 lanes of a quad hold one pooled pixel, lane q channels 8 j + 2q
  // (+ 1): two 4 x 4 transposes of words within the quad (on lane bit b and
  // word bit b in turn) leave lane q channels 8q ... 8q + 7 and 32 + 8q ...,
  // stored as two 16-byte words.
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    const bool up = (lane >> b) & 1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if ((j >> b) & 1) continue;
      const int jj = j | (1 << b);
      const uint32_t got = __shfl_xor_sync(0xffffffffu, up ? w[j] : w[jj],
                                           1 << b);
      if (up)
        w[j] = got;
      else
        w[jj] = got;
    }
  }
  if (orow < Ho && ocol < Wo) {
    uint4* o = reinterpret_cast<uint4*>(
        out + ((size_t(tile.b) * Ho + orow) * Wo + ocol) * C + 8 * (lane % 4));
    o[0] = make_uint4(w[0], w[1], w[2], w[3]);
    o[4] = make_uint4(w[4], w[5], w[6], w[7]);
  }
}

template <class Prologue>
constexpr int smem_bytes() {
  return 1024 + W_BYTES + A_BYTES + Prologue::SMEM + (2 * RING + 1) * 8;
}

// The kernel's body. Prologue, built by each producer thread from `args`,
// has begin(x, sched) before the first step, load(x, sched, k) before the
// k-th step's ring slot is free, and store(x, a, sched, k) writing that
// slot's first row at address a (rows IN_W * 16 B apart, planes PLANE
// apart); x is its own shared memory.
template <class Prologue>
__device__ __forceinline__ void conv_tiles(
    const CUtensorMap* wmap, const typename Prologue::Args& args,
    const float* __restrict__ bb, __nv_bfloat16* __restrict__ out, int B,
    int H, int W, Sched sched) {
  extern __shared__ unsigned char raw[];
  const uint32_t base = (smem_addr(raw) + 1023) & ~1023u;  // swizzle atoms
  const uint32_t ws = base, as = base + W_BYTES;
  const Region x = {raw + (base - smem_addr(raw)) + W_BYTES + A_BYTES,
                    as + A_BYTES};
  const uint32_t full = x.addr + Prologue::SMEM, empty = full + 8 * RING;
  const uint32_t w_full = empty + 8 * RING;
  constexpr int SLOT = STEP_PIX * 16;  // bytes of a ring slot in a plane

  if (threadIdx.x == 0) {
    for (int s = 0; s < RING; ++s) {
      mbar_init(full + 8 * s, PRODUCERS);
      mbar_init(empty + 8 * s, CONSUMER_WARPS);
    }
    mbar_init(w_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < PRODUCERS) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(w_full, W_BYTES);
      for (int tap = 0; tap < 9; ++tap)
        tma_load(ws + tap * W_TAP, wmap, 0, tap * C, w_full);
    }
    Prologue pro(args, H, W);
    pro.begin(x, sched);
    for (int k = 0; sched.has(k); ++k) {
      const int s = k % RING;
      pro.load(x, sched, k);
      mbar_wait(empty + 8 * s, ((k / RING) & 1) ^ 1);
      pro.store(x, as + s * SLOT, sched, k);
      // the slot's generic-proxy writes before wgmma (async proxy) reads
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(full + 8 * s);
    }
    return;
  }

  const int cw = threadIdx.x / 128 - 2;  // conv rows 2cw, 2cw + 1
  const int lane = threadIdx.x % 32;
  float bias[16];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    bias[2 * j] = bb[8 * j + 2 * (lane % 4)];
    bias[2 * j + 1] = bb[8 * j + 2 * (lane % 4) + 1];
  }
  float acc0[32], acc1[32];
  mbar_wait(w_full, 0);
  int i = 0;  // tiles done, for the skip builds
  for (int k = 0; sched.has(k); ++k) {
    if (k % (sched.len + 1) == sched.len) {  // a segment's last step: free it
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * (k % RING));
      continue;
    }
    // tile j of the segment reads steps k and k + 1 (steps arrive in order)
    const int s1 = (k + 1) % RING;
    mbar_wait(full + 8 * s1, ((k + 1) / RING & 1));
    // input rows 2cw + h of the tile, h < 4: rows of step k, then of k + 1
    uint32_t row[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int r = 2 * cw + h;
      row[h] = as + (r < TH ? k % RING : s1) * SLOT + r % TH * IN_W * 16;
    }
    if (!skipped(SKIP_WGMMA, i)) {
      fence_acc(acc0);
      fence_acc(acc1);
      wgmma_fence();
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) {  // channels 16 kc ... 16 kc + 15
          const uint64_t bd = desc(ws + tap * W_TAP + kc * 32);
          const uint32_t off = 2 * kc * PLANE + tap % 3 * 16;
          const int scale = (tap | kc) != 0;
          mma_n64(acc0, desc_planes(row[tap / 3] + off), bd, scale);
          mma_n64(acc1, desc_planes(row[tap / 3 + 1] + off), bd, scale);
        }
      wgmma_commit();
      fence_acc(acc0);
      fence_acc(acc1);
      wgmma_wait<0>();
      fence_acc(acc0);
      fence_acc(acc1);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (k % RING));  // step k is done
    Step tile = sched.at(k);
    tile.r0 += 1;  // conv rows 4j ... of tile j
    if (!skipped(SKIP_EPILOGUE, i))
      epilogue(acc0, acc1, bias, out, tile, cw, H, W);
    ++i;
  }
}

// SMs of the current device, after the shared-memory limit of `kernel`
// (whose prologue is Prologue) is raised there (once per device); a
// negative cudaError_t on failure.
template <class Prologue>
int prepare(const void* kernel) {
  static std::mutex mu;
  static int sms[64] = {};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return -int(e);
  if (device < 0 || device >= 64) return -int(cudaErrorInvalidDevice);
  std::lock_guard<std::mutex> lock(mu);
  if (sms[device] == 0) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes<Prologue>());
    int n = 0;
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return -int(e);
    sms[device] = n;
  }
  return sms[device];
}

// Whether the kernels take a (B, H, W) input: H and W even, and the ring's
// steps of every CTA countable in an int.
inline bool takes(int B, int H, int W) {
  if (B < 1 || H < 2 || W < 2 || H % 2 || W % 2) return false;
  const long long strips = (long long)B * ((W + TW - 1) / TW);
  const long long tiles = strips * ((H + TH - 1) / TH);
  return tiles + strips * 256 < INT_MAX;
}

// W_b as (tap, cout, cin) bf16: 576 rows of 128 B, one 64-row box a tap.
bool encode_weights(CUtensorMap* map, const void* wb) {
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, wb, 9 * C, C, C * 2,
                C, C);
}

}  // namespace
