// SuperPoint post-processing in one pass over the heatmap:
//   radius-r max-NMS with 2 suppression rounds (== ops/nms.py simple_nms,
//   -inf padding at the image edge only), then the border / valid_wh mask,
//   then for every 4x4 cell the max score and its in-cell position 4*dy+dx.
//   Ties inside a cell go to the first column holding the max, then to the
//   first row in that column, and the position is 0 where the max is 0.
//
// Replaces: imcui_tpu/ops/pallas_nms.py:nms_cellmax (kernel _kernel).
//
// What bounds it on an H100: at 8x1024^2 it must read 16.8 MB of bf16 heat
// and write 4.2 MB of cell maps (6.3 us at 3.35 TB/s); the suppression
// chain is five separable (2r+1)^2 window passes (three window maxes of
// values, two dilations of masks) plus the compares, about 42 maxes,
// compares and mask operations a pixel at r = 4 with the window method
// below (tools/nms_times.py::work), 5.3 us at the packed-bf16 rate. So the
// bytes bound it on paper; but every window needs its neighbours, so the
// chain runs out of shared memory and registers, and the instructions that
// do it with the halos (about twice the count above) are what it spends.
// The design:
//   * values stay bf16, two to a 32-bit word (max.bf16x2 and bf16x2
//     equality: every operation of the chain is a max or a compare of the
//     heat's own values, so the answers are the float32 plain version's);
//     masks are bits, eight pixels a byte;
//   * a block owns 64 rows x 192 columns of the output and loads a region
//     of 256 columns (a 32-column halo, >= 5r for r <= 6) by (64 + 10r)
//     rows. A warp holds one region row, a lane 8 pixels (16 bytes), so
//     the horizontal windows run in registers across lanes (one shuffle
//     per word and side) and the region needs no horizontal scratch plane;
//   * every stage runs only on the rows its successors read: the window
//     max of the heat on the tile +- 4r rows, the first dilation on +- 3r,
//     the second window max on +- 2r, the second dilation on +- r, the
//     last window max on the tile;
//   * a warp takes two rows at a time, so the two vertical windows share
//     2r of their 2r + 2 rows; horizontally a window of 2r + 1 is r pair
//     maxes shared between the lane's four words plus one; a dilation of
//     bits is runs of 2, 4, 8 by doubling;
//   * a 4x4 cell is a max of 8 words, one compare a row against it, and
//     the first column, then row, of the 16 equality bits;
//   * the image edge is -inf pixels (values) and 0 bits (masks) in the
//     region, so every window is the reduce_window(SAME) of the plain
//     version; a region column or row beyond the image is such a pixel;
//   * 16-byte global loads (8-byte where W is not a multiple of 8);
//   * the shared-memory limit and the SM count are set and read once per
//     device.
// NMS_SKIP (a compile-time bit mask, default 0) leaves parts out on every
// block but the grid's first, for measurement only: 1 the global loads,
// 2 the value windows, 4 the mask dilations, 8 the cell reduction.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

#ifndef NMS_SKIP
#define NMS_SKIP 0
#endif

namespace {

constexpr int LANES = 32;
constexpr int CHUNK = 8;                 // pixels a lane holds (16 bytes)
constexpr int RW = LANES * CHUNK;        // region columns, 256
constexpr int HALO_C = 32;               // region columns on each side
constexpr int TW = RW - 2 * HALO_C;      // output columns a block, 192
constexpr int TH = 64;                   // output rows a block
constexpr int WARPS = 16;
constexpr int THREADS = WARPS * LANES;
constexpr int MIN_R = 3, MAX_R = 6;
constexpr uint32_t NEG_INF2 = 0xFF80FF80u;  // two bf16 -inf

template <int R>
struct Geometry {
  static constexpr int HALO_R = 5 * R;  // the chain's receptive field
  static constexpr int ROWS = TH + 2 * HALO_R;
  // heat and suppressed-heat planes (bf16), max-mask and suppression-mask
  // planes (a byte per lane: 8 pixels)
  static constexpr size_t SMEM = size_t(ROWS) * LANES * (2 * 16 + 2);
};

__device__ __forceinline__ uint32_t bmax(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint4 bmax4(uint4 a, uint4 b) {
  return make_uint4(bmax(a.x, b.x), bmax(a.y, b.y), bmax(a.z, b.z),
                    bmax(a.w, b.w));
}

// Bit i set iff pixel i of a equals pixel i of b as a value (-0 == +0).
// bf16x2 equality gives 1.0 (0x3F80) in each equal half, so byte 0 or 2
// of its word is 0x80: gather those bytes of the four words, take their
// top bit to bit 0 of each byte, and multiply by 0x01020408, which moves
// the four bytes' bits to bits 24..27 of the product without carries.
__device__ __forceinline__ uint32_t eq_bits(uint4 a, uint4 b) {
  const uint32_t aw[4] = {a.x, a.y, a.z, a.w}, bw[4] = {b.x, b.y, b.z, b.w};
  uint32_t e[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 r =
        __heq2(*reinterpret_cast<const __nv_bfloat162*>(&aw[j]),
               *reinterpret_cast<const __nv_bfloat162*>(&bw[j]));
    e[j] = *reinterpret_cast<const uint32_t*>(&r);
  }
  const uint32_t lo = (__byte_perm(e[0], e[1], 0x6420) >> 7) & 0x01010101u;
  const uint32_t hi = (__byte_perm(e[2], e[3], 0x6420) >> 7) & 0x01010101u;
  return ((lo * 0x01020408u) >> 24) | (((hi * 0x01020408u) >> 20) & 0xF0u);
}

// Pixels whose bit is set in s become 0.
__device__ __forceinline__ uint4 suppress(uint4 x, uint32_t s) {
  uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t m = (s >> (2 * j)) & 3u;
    w[j] &= ~((m & 1u) * 0xFFFFu | (m >> 1) * 0xFFFF0000u);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Max over +-R pixels along the row of every pixel of this lane's chunk;
// the neighbours' chunks come by shuffle (lane 0 and 31 see their own: the
// halo absorbs it). Words w[0..11] hold pixels -8..15; view(q) is the word
// of pixels q, q+1; the window of word j is views 2j-R .. 2j+R, that is R
// pair maxes pm[j..j+R-1] and view(2j+R).
template <int R>
__device__ __forceinline__ uint4 hmax(uint4 v) {
  uint32_t w[12];
  w[0] = __shfl_up_sync(~0u, v.x, 1);
  w[1] = __shfl_up_sync(~0u, v.y, 1);
  w[2] = __shfl_up_sync(~0u, v.z, 1);
  w[3] = __shfl_up_sync(~0u, v.w, 1);
  w[4] = v.x, w[5] = v.y, w[6] = v.z, w[7] = v.w;
  w[8] = __shfl_down_sync(~0u, v.x, 1);
  w[9] = __shfl_down_sync(~0u, v.y, 1);
  w[10] = __shfl_down_sync(~0u, v.z, 1);
  w[11] = __shfl_down_sync(~0u, v.w, 1);
  auto view = [&](int q) -> uint32_t {
    const int p = q + CHUNK;
    return (p & 1) ? __byte_perm(w[p >> 1], w[(p >> 1) + 1], 0x5432)
                   : w[p >> 1];
  };
  uint32_t pm[R + 3];
#pragma unroll
  for (int i = 0; i < R + 3; ++i)
    pm[i] = bmax(view(-R + 2 * i), view(-R + 2 * i + 1));
  uint32_t o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t m = view(2 * j + R);
#pragma unroll
    for (int k = 0; k < R; ++k) m = bmax(m, pm[j + k]);
    o[j] = m;
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// OR over +-R pixels along the row of this lane's 8 mask bits: runs of
// P pixels by doubling (P the largest power of 2 <= 2R + 1), then the
// window as two runs of P that overlap.
template <int R>
__device__ __forceinline__ uint32_t hdilate(uint32_t v, int lane) {
  constexpr int P = 2 * R + 1 >= 8 ? 8 : 4;
  uint32_t l = __shfl_up_sync(~0u, v, 1), r = __shfl_down_sync(~0u, v, 1);
  if (lane == 0) l = 0;
  if (lane == LANES - 1) r = 0;
  uint32_t t = l | (v << 8) | (r << 16);  // pixels -8..15
  t |= t >> 1;
  t |= t >> 2;
  if (P == 8) t |= t >> 4;  // bit p: pixels p..p+P-1
  return ((t >> (8 - R)) | (t >> (9 + R - P))) & 0xFFu;
}

template <int R>
__global__ void __launch_bounds__(THREADS, 2)
nms_cellmax_kernel(const uint16_t* __restrict__ heat,
                   const int* __restrict__ valid_wh,
                   float* __restrict__ cmax, float* __restrict__ csub,
                   int H, int W, int border, int align) {
  using G = Geometry<R>;
  constexpr int ROWS = G::ROWS;
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* xs = reinterpret_cast<uint4*>(smem);  // the heat
  uint4* ss = xs + ROWS * LANES;               // the suppressed heat
  uint8_t* mb = reinterpret_cast<uint8_t*>(ss + ROWS * LANES);  // max mask
  uint8_t* sb = mb + ROWS * LANES;                              // suppressed

  const int lane = threadIdx.x % LANES, warp = threadIdx.x / LANES;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * TH, c0 = blockIdx.x * TW;
  const int top = r0 - G::HALO_R;                  // image row of region row 0
  const int gc = c0 - HALO_C + lane * CHUNK;       // image column of pixel 0
  // W is a multiple of 4 and gc of 8: a chunk is in, out, or half in
  const uint32_t col_in =
      (gc < 0 || gc >= W) ? 0u : (gc + CHUNK <= W ? 0xFFu : 0x0Fu);
  auto in_image = [&](int y) {
    const int gy = top + y;
    return (gy >= 0 && gy < H) ? col_in : 0u;
  };
  const bool first = blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0;
  auto skip = [&](int part) { return (NMS_SKIP & part) && !first; };

  // -- the region, -inf outside the image
  if (!skip(1)) {
    const uint16_t* hb = heat + size_t(b) * H * W;
    constexpr int BATCH = 4;  // loads in flight a lane
    for (int y0 = warp; y0 < ROWS; y0 += BATCH * WARPS) {
      uint4 v[BATCH];
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        v[i] = make_uint4(NEG_INF2, NEG_INF2, NEG_INF2, NEG_INF2);
        const int y = y0 + i * WARPS;
        if (y < ROWS && in_image(y)) {
          const uint16_t* p = hb + size_t(top + y) * W + gc;
          if (align == 16) {
            v[i] = __ldg(reinterpret_cast<const uint4*>(p));
          } else if (align == 8) {
            const uint2 lo = __ldg(reinterpret_cast<const uint2*>(p));
            v[i].x = lo.x, v[i].y = lo.y;
            if (col_in == 0xFFu) {
              const uint2 hi = __ldg(reinterpret_cast<const uint2*>(p + 4));
              v[i].z = hi.x, v[i].w = hi.y;
            }
          } else {
            uint32_t q[4] = {NEG_INF2, NEG_INF2, NEG_INF2, NEG_INF2};
            for (int k = 0; k < CHUNK && gc + k < W; ++k) {
              const uint32_t h = __ldg(p + k);
              q[k / 2] = (k & 1) ? (q[k / 2] & 0xFFFFu) | (h << 16)
                                 : (q[k / 2] & 0xFFFF0000u) | h;
            }
            v[i] = make_uint4(q[0], q[1], q[2], q[3]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < BATCH; ++i)
        if (y0 + i * WARPS < ROWS) xs[(y0 + i * WARPS) * LANES + lane] = v[i];
    }
  }
  __syncthreads();

  // A window-max stage on rows [lo, hi) of plane p: the pixels equal to
  // their window max (and, after a dilation, not suppressed) join the max
  // mask. Rows go in pairs: rows y-R+1..y+R are both windows' core.
  auto window_stage = [&](const uint4* p, int lo, int hi, bool after) {
    for (int y = lo + 2 * warp; y < hi; y += 2 * WARPS) {
      const uint4* col = p + (y - R) * LANES + lane;
      uint4 core = col[LANES], c0v = core, c1v = core;
      if (!skip(2)) {
#pragma unroll
        for (int i = 2; i <= 2 * R; ++i) {
          const uint4 t = col[i * LANES];
          if (i == R) c0v = t;
          if (i == R + 1) c1v = t;
          core = bmax4(core, t);
        }
      } else {
        c0v = col[R * LANES], c1v = col[(R + 1) * LANES];
      }
      uint4 h0 = c0v, h1 = c1v;
      if (!skip(2)) {
        h0 = hmax<R>(bmax4(core, col[0]));
        h1 = hmax<R>(bmax4(core, col[(2 * R + 1) * LANES]));
      }
      uint32_t m0 = eq_bits(c0v, h0) & in_image(y);
      uint32_t m1 = eq_bits(c1v, h1) & in_image(y + 1);
      if (after) {
        m0 = (m0 & ~uint32_t(sb[y * LANES + lane])) | mb[y * LANES + lane];
        m1 = (m1 & ~uint32_t(sb[(y + 1) * LANES + lane])) |
             mb[(y + 1) * LANES + lane];
      }
      mb[y * LANES + lane] = uint8_t(m0);
      mb[(y + 1) * LANES + lane] = uint8_t(m1);
    }
  };

  // A dilation stage on rows [lo, hi): the suppression mask (the max mask
  // dilated by the window, inside the image) and the heat with those
  // pixels zeroed.
  auto dilate_stage = [&](int lo, int hi) {
    for (int y = lo + 2 * warp; y < hi; y += 2 * WARPS) {
      const uint8_t* col = mb + (y - R) * LANES + lane;
      uint32_t d0 = col[R * LANES], d1 = col[(R + 1) * LANES];
      if (!skip(4)) {
        uint32_t core = col[LANES];
#pragma unroll
        for (int i = 2; i <= 2 * R; ++i) core |= col[i * LANES];
        d0 = hdilate<R>(core | col[0], lane);
        d1 = hdilate<R>(core | col[(2 * R + 1) * LANES], lane);
      }
      d0 &= in_image(y);
      d1 &= in_image(y + 1);
      sb[y * LANES + lane] = uint8_t(d0);
      sb[(y + 1) * LANES + lane] = uint8_t(d1);
      ss[y * LANES + lane] = suppress(xs[y * LANES + lane], d0);
      ss[(y + 1) * LANES + lane] = suppress(xs[(y + 1) * LANES + lane], d1);
    }
  };

  window_stage(xs, R, ROWS - R, false);  // max_mask = x == max_pool(x)
  __syncthreads();
  dilate_stage(2 * R, ROWS - 2 * R);
  __syncthreads();
  window_stage(ss, 3 * R, ROWS - 3 * R, true);
  __syncthreads();
  dilate_stage(4 * R, ROWS - 4 * R);
  __syncthreads();
  window_stage(ss, 5 * R, ROWS - 5 * R, true);
  __syncthreads();

  // -- cells: a thread takes a lane's chunk over 4 rows, two cells
  if (skip(8)) return;
  const int vw = valid_wh[2 * b], vh = valid_wh[2 * b + 1];
  const int Hc = H / 4, Wc = W / 4;
  constexpr int CHUNKS = TW / CHUNK;
  for (int t = threadIdx.x; t < (TH / 4) * CHUNKS; t += THREADS) {
    const int cr = t / CHUNKS, ch = HALO_C / CHUNK + t % CHUNKS;
    const int cy = r0 / 4 + cr, gx0 = c0 + CHUNK * (t % CHUNKS);
    if (cy >= Hc || gx0 >= W) continue;
    uint32_t colv = 0;
#pragma unroll
    for (int i = 0; i < CHUNK; ++i)
      colv |= uint32_t(gx0 + i >= border && gx0 + i < vw - border) << i;
    uint32_t xw[4][4];
#pragma unroll
    for (int dy = 0; dy < 4; ++dy) {
      const int y = G::HALO_R + 4 * cr + dy, gy = r0 + 4 * cr + dy;
      const uint32_t keep = (gy >= border && gy < vh - border)
                                ? mb[y * LANES + ch] & colv : 0u;
      const uint4 v = suppress(xs[y * LANES + ch], ~keep & 0xFFu);
      xw[dy][0] = v.x, xw[dy][1] = v.y, xw[dy][2] = v.z, xw[dy][3] = v.w;
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      // the cell's max, then the first column holding it, then the first
      // row in that column: eq bits at 4*dy + dx
      uint32_t m2 = bmax(bmax(bmax(xw[0][2 * c], xw[0][2 * c + 1]),
                              bmax(xw[1][2 * c], xw[1][2 * c + 1])),
                         bmax(bmax(xw[2][2 * c], xw[2][2 * c + 1]),
                              bmax(xw[3][2 * c], xw[3][2 * c + 1])));
      m2 = bmax(m2, __byte_perm(m2, 0, 0x1032));
      m2 = __byte_perm(m2, 0, 0x1010);  // the max in both halves
      uint32_t bits = 0;
#pragma unroll
      for (int dy = 0; dy < 4; ++dy)
        bits |= (eq_bits(make_uint4(xw[dy][2 * c], xw[dy][2 * c + 1], 0, 0),
                         make_uint4(m2, m2, 0, 0)) & 0xFu) << (4 * dy);
      const uint32_t cols = (bits | bits >> 4 | bits >> 8 | bits >> 12) & 0xFu;
      const int dx = __ffs(cols) - 1;
      const int dy = (__ffs((bits >> dx) & 0x1111u) - 1) / 4;
      const float best = __uint_as_float((m2 & 0xFFFFu) << 16);
      const int cx = gx0 / 4 + c;
      if (cx < Wc) {
        const size_t o = (size_t(b) * Hc + cy) * Wc + cx;
        cmax[o] = best;
        csub[o] = best > 0.f ? float(dy * 4 + dx) : 0.f;
      }
    }
  }
}

template <int R>
cudaError_t fit(int* per_sm) {
  auto kernel = nms_cellmax_kernel<R>;
  constexpr size_t SMEM = Geometry<R>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, THREADS,
                                                      SMEM);
  return e;
}

// Per device, once: the shared-memory limits raised, the SM count and the
// blocks an SM holds at each radius.
struct Card {
  int sms = 0;
  int per_sm[MAX_R - MIN_R + 1] = {};
};

cudaError_t prepare(Card* card) {
  static std::mutex mu;
  static Card cards[64];
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  Card& c = cards[device];
  if (c.sms == 0) {
    Card fresh;
    e = cudaDeviceGetAttribute(&fresh.sms, cudaDevAttrMultiProcessorCount,
                               device);
    if (e == cudaSuccess) e = fit<3>(&fresh.per_sm[0]);
    if (e == cudaSuccess) e = fit<4>(&fresh.per_sm[1]);
    if (e == cudaSuccess) e = fit<5>(&fresh.per_sm[2]);
    if (e == cudaSuccess) e = fit<6>(&fresh.per_sm[3]);
    if (e != cudaSuccess) return e;
    c = fresh;
  }
  *card = c;
  return cudaSuccess;
}

bool valid_shape(int B, int H, int W, int radius) {
  return B > 0 && H > 0 && W > 0 && H % 4 == 0 && W % 4 == 0 &&
         radius >= MIN_R && radius <= MAX_R;
}

dim3 grid_of(int B, int H, int W) {
  return dim3((W + TW - 1) / TW, (H + TH - 1) / TH, B);
}

template <int R>
cudaError_t launch(const void* heat, const void* valid_wh, void* cmax,
                   void* csub, int B, int H, int W, int border, int align,
                   cudaStream_t stream) {
  nms_cellmax_kernel<R><<<grid_of(B, H, W), THREADS, Geometry<R>::SMEM,
                          stream>>>(
      static_cast<const uint16_t*>(heat), static_cast<const int*>(valid_wh),
      static_cast<float*>(cmax), static_cast<float*>(csub), H, W, border,
      align);
  return cudaGetLastError();
}

size_t smem_of(int radius) {
  switch (radius) {
    case 3: return Geometry<3>::SMEM;
    case 4: return Geometry<4>::SMEM;
    case 5: return Geometry<5>::SMEM;
    default: return Geometry<6>::SMEM;
  }
}

}  // namespace

extern "C" int nms_cellmax_f32(const void* heat, const void* valid_wh,
                               void* cmax, void* csub, int B, int H, int W,
                               int radius, int border, void* stream) {
  if (!valid_shape(B, H, W, radius)) return int(cudaErrorInvalidValue);
  Card card;
  cudaError_t e = prepare(&card);
  if (e != cudaSuccess) return int(e);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(heat);
  const int align = (addr % 16 == 0 && W % 8 == 0) ? 16
                    : (addr % 8 == 0)              ? 8
                                                   : 2;
  auto s = static_cast<cudaStream_t>(stream);
  switch (radius) {
    case 3: e = launch<3>(heat, valid_wh, cmax, csub, B, H, W, border, align, s); break;
    case 4: e = launch<4>(heat, valid_wh, cmax, csub, B, H, W, border, align, s); break;
    case 5: e = launch<5>(heat, valid_wh, cmax, csub, B, H, W, border, align, s); break;
    default: e = launch<6>(heat, valid_wh, cmax, csub, B, H, W, border, align, s); break;
  }
  return int(e);
}

// The launch plan at (B, H, W, radius): out[0..7] = output rows and columns
// a block, region rows, blocks, blocks an SM holds, SMs, rounds (blocks
// over what the card holds at once, rounded up), shared memory a block.
extern "C" int nms_cellmax_plan(int B, int H, int W, int radius, void* out) {
  if (!valid_shape(B, H, W, radius)) return int(cudaErrorInvalidValue);
  Card card;
  const cudaError_t e = prepare(&card);
  if (e != cudaSuccess) return int(e);
  const dim3 g = grid_of(B, H, W);
  const int blocks = int(g.x * g.y * g.z);
  const int per_sm = card.per_sm[radius - MIN_R];
  const int slots = per_sm * card.sms;
  int* o = static_cast<int*>(out);
  o[0] = TH;
  o[1] = TW;
  o[2] = TH + 10 * radius;
  o[3] = blocks;
  o[4] = per_sm;
  o[5] = card.sms;
  o[6] = slots > 0 ? (blocks + slots - 1) / slots : 0;
  o[7] = int(smem_of(radius));
  return 0;
}
