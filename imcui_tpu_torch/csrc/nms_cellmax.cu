// SuperPoint post-processing in one pass over the heatmap:
//   radius-r max-NMS with 2 suppression rounds (== ops/nms.py simple_nms,
//   -inf padding at the image edge only), then the border / valid_wh mask,
//   then for every 4x4 cell the max score and its in-cell position 4*dy+dx.
//   Ties inside a cell go to the first column holding the max, then to the
//   first row in that column, and the position is 0 where the max is 0.
//
// Replaces: imcui_tpu/ops/pallas_nms.py:nms_cellmax (kernel _kernel).
//
// What bounds it on an H100: memory. At 8x1024^2 it reads 16.8 MB of bf16
// heat and writes 4.2 MB of cell maps (about 6 us at 3.35 TB/s); its
// arithmetic is ~10 window-max passes of comparisons. The design keeps
// every intermediate of the suppression chain in shared memory:
//   * one block per (image, 64 x 64 tile), loaded once with a 20-pixel
//     halo on every side, (2*iterations+1)*r = 5*4 (the TPU's rounding to
//     24 rows was for sublane alignment and does not carry over);
//   * the window maxes are separable (a row pass into a scratch plane, then a
//     column pass fused with the comparison that consumes it), clipped to the
//     loaded region: at the image edge that is exactly the -inf padding, and
//     inside the image the clipped values stay in the halo, which the chain's
//     receptive field never carries into the central tile;
//   * the suppressed scores are formed on the fly from the heat and the
//     suppression mask, so the planes are the heat and one scratch plane in
//     f32 and two byte masks (108 KB at radius 4: two blocks per SM);
//   * 32 x 16 threads walk the region in rows, so neighbouring lanes touch
//     neighbouring words in every pass;
//   * only the 16 x 16 cells of the central tile are written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TILE = 64;      // rows and columns of the central tile
constexpr int HALO_MAX = 32;  // largest (2*iterations+1)*radius accepted
constexpr int TX = 32, TY = 16;

struct Region {
  int R0, C0, rh, rw, stride;
};

// dst[y][x] = max of src(y, x') over |x' - x| <= r inside the region.
template <typename Src>
__device__ __forceinline__ void row_max(Src src, float* dst, const Region& g,
                                        int r) {
  for (int y = threadIdx.y; y < g.rh; y += TY) {
    for (int x = threadIdx.x; x < g.rw; x += TX) {
      const int lo = max(0, x - r), hi = min(g.rw - 1, x + r);
      float m = src(y, lo);
      for (int j = lo + 1; j <= hi; ++j) m = fmaxf(m, src(y, j));
      dst[y * g.stride + x] = m;
    }
  }
}

__device__ __forceinline__ float col_max(const float* src, const Region& g,
                                         int y, int x, int r) {
  const int lo = max(0, y - r), hi = min(g.rh - 1, y + r);
  float m = src[lo * g.stride + x];
  for (int j = lo + 1; j <= hi; ++j) m = fmaxf(m, src[j * g.stride + x]);
  return m;
}

__global__ void __launch_bounds__(TX * TY)
nms_cellmax_kernel(const __nv_bfloat16* __restrict__ heat,
                   const int* __restrict__ valid_wh,
                   float* __restrict__ cmax, float* __restrict__ csub,
                   int H, int W, int radius, int iterations, int border) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int halo = (2 * iterations + 1) * radius;
  const int stride = TILE + 2 * halo;
  const int plane = stride * stride;
  float* x = reinterpret_cast<float*>(smem);
  float* tmp = x + plane;
  uint8_t* keep = reinterpret_cast<uint8_t*>(tmp + plane);  // the max mask
  uint8_t* supp = keep + plane;

  const int b = blockIdx.z;
  const int r0 = blockIdx.y * TILE, c0 = blockIdx.x * TILE;
  Region g;
  g.R0 = max(0, r0 - halo);
  g.C0 = max(0, c0 - halo);
  g.rh = min(H, r0 + TILE + halo) - g.R0;
  g.rw = min(W, c0 + TILE + halo) - g.C0;
  g.stride = stride;
  const __nv_bfloat16* hb = heat + size_t(b) * H * W;

  for (int y = threadIdx.y; y < g.rh; y += TY)
    for (int xx = threadIdx.x; xx < g.rw; xx += TX)
      x[y * stride + xx] =
          __bfloat162float(hb[size_t(g.R0 + y) * W + g.C0 + xx]);
  __syncthreads();

  // max_mask = x == window_max(x)
  row_max([&](int y, int xx) { return x[y * stride + xx]; }, tmp, g, radius);
  __syncthreads();
  for (int y = threadIdx.y; y < g.rh; y += TY)
    for (int xx = threadIdx.x; xx < g.rw; xx += TX)
      keep[y * stride + xx] = x[y * stride + xx] == col_max(tmp, g, y, xx, radius);
  __syncthreads();

  for (int it = 0; it < iterations; ++it) {
    // supp = window_max(max_mask) > 0
    row_max([&](int y, int xx) { return float(keep[y * stride + xx]); }, tmp,
            g, radius);
    __syncthreads();
    for (int y = threadIdx.y; y < g.rh; y += TY)
      for (int xx = threadIdx.x; xx < g.rw; xx += TX)
        supp[y * stride + xx] = col_max(tmp, g, y, xx, radius) > 0.f;
    __syncthreads();
    // s = supp ? 0 : x;  max_mask |= (s == window_max(s)) & ~supp
    row_max([&](int y, int xx) {
              const int p = y * stride + xx;
              return supp[p] ? 0.f : x[p];
            }, tmp, g, radius);
    __syncthreads();
    for (int y = threadIdx.y; y < g.rh; y += TY)
      for (int xx = threadIdx.x; xx < g.rw; xx += TX) {
        const int p = y * stride + xx;
        if (!supp[p] && x[p] == col_max(tmp, g, y, xx, radius)) keep[p] = 1;
      }
    __syncthreads();
  }

  const int vw = valid_wh[2 * b], vh = valid_wh[2 * b + 1];
  const int Hc = H / 4, Wc = W / 4;
  const int t = threadIdx.y * TX + threadIdx.x;
  constexpr int CELLS = TILE / 4;
  if (t < CELLS * CELLS) {
    const int cy = r0 / 4 + t / CELLS, cx = c0 / 4 + t % CELLS;
    if (cy < Hc && cx < Wc) {
      float best = 0.f;
      int sub = 0;
      for (int dx = 0; dx < 4; ++dx) {      // column-major scan: first column
        for (int dy = 0; dy < 4; ++dy) {    // holding the max, then first row
          const int gy = cy * 4 + dy, gx = cx * 4 + dx;
          const int p = (gy - g.R0) * stride + (gx - g.C0);
          const bool valid = gx >= border && gx < vw - border &&
                             gy >= border && gy < vh - border;
          const float v = (keep[p] && valid) ? x[p] : 0.f;
          if ((dx == 0 && dy == 0) || v > best) {
            best = v;
            sub = dy * 4 + dx;
          }
        }
      }
      const size_t o = (size_t(b) * Hc + cy) * Wc + cx;
      cmax[o] = best;
      csub[o] = best > 0.f ? float(sub) : 0.f;
    }
  }
}

}  // namespace

extern "C" int nms_cellmax_f32(const void* heat, const void* valid_wh,
                               void* cmax, void* csub, int B, int H, int W,
                               int radius, int border, void* stream) {
  const int iterations = 2;
  const int halo = (2 * iterations + 1) * radius;
  if (halo > HALO_MAX || H % 4 || W % 4) return int(cudaErrorInvalidValue);
  const size_t plane = size_t(TILE + 2 * halo) * (TILE + 2 * halo);
  const size_t smem = plane * (2 * sizeof(float) + 2);
  cudaFuncSetAttribute(nms_cellmax_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
  nms_cellmax_kernel<<<grid, dim3(TX, TY), smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(heat),
      static_cast<const int*>(valid_wh), static_cast<float*>(cmax),
      static_cast<float*>(csub), H, W, radius, iterations, border);
  return static_cast<int>(cudaGetLastError());
}
