// Q-tiled, single-pass softmax attention for ViT blocks, bf16 in and out:
//     out = softmax(Q K^T / sqrt(64)) V   per head, no key masked.
//
//   qtiled_attention_bf16  replaces tools/try_vit_attn.py:qtiled_attention
//                          (the body of imcui_tpu/ops/attention.py:
//                          _flash_attn_kernel run with blk_k = nk, n_k = 1),
//                          the attention DINOv2 ViT-L/14 runs in each of its
//                          24 blocks: 16 heads x 1601 tokens x 64 at a 560^2
//                          input.
//
// Contract, read off that kernel: q, k, v are bf16 and are widened exactly;
// s = q k^T / 8 in f32; m = max(-1e9, max_k s); p = exp(s - m) in f32;
// l = sum_k p in f32; out = (p v) / max(l, 1e-20), rounded once to bf16. Nq
// and Nk are independent. The TPU pads 1601 tokens to 1664 and masks the
// padding; here the ragged sizes are taken as they are: keys past the end
// weigh 0 and query rows past the end are not written.
//
// One deviation, stated: for the readout on the tensor cores p is rounded to
// bf16 (relative error 2^-9 per weight; the sum l is taken from the f32
// values). The readout is then off by at most 2^-9 * max|v| from the f32
// one, beside the 2^-9 relative rounding of the bf16 output.
//
// What bounds it on an H100: operations. 4 * H * Nq * Nk * 64 flop (10.5
// GFLOP at 16 x 1601 x 1601: 0.011 ms at 989 TFLOP/s bf16) against 13 MB of
// compulsory traffic (0.004 ms). Since the inputs are bf16, q k^T on the
// tensor cores with f32 accumulation is exact to the contract, which the f32
// kernels K3 and K5 (FMA units, 67 TFLOP/s) cannot use.
//
// Design. "One pass over all keys" is a block that owns a tile of queries of
// one head and keeps their whole logit rows in shared memory, with an exact
// two-pass softmax there and no running rescale: that is the difference from
// K5's online form. The tile is 32 queries where their f32 logits fit one
// SM (up to 1744 keys: 32 x 1620 x 4 B = 207 KB at 1601 keys, sixteen warps,
// one block per SM), else 16 queries (eight warps, two blocks per SM where
// they fit). Three phases:
//   A. S = Q K^T / 8: each warp takes every WARPS-th 16-key tile, WMMA bf16
//      16x16x16 with the K fragments read straight from global memory (K and
//      V of all heads, 6.6 MB, stay in L2) and used for every 16-query row
//      tile of the block, and stores the f32 tiles to shared memory.
//   B. Each warp owns two rows: row max, then p = exp(s - m) summed in f32
//      and written back in place as bf16 (chunk c of 32 bf16 lands inside
//      f32 chunk c/2, which has been read by then).
//   C. O = P V: each warp multiplies its key tiles into 16x16 f32
//      accumulators; the warps' partial sums meet in shared memory, are
//      divided by l and written as bf16.
// The ragged last key tile of K and of V is staged through shared memory
// with zero rows; every other fragment needs no staging. With 16-query tiles
// each product pulled K or V of a head from L2 once per 16 queries (0.33 GB
// per product and launch at 16 x 1601 x 1601), and on an H100 that traffic,
// not the tensor cores, set their time; the 32-query tile halves it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int D = 64;          // head dim
constexpr int LDT = D + 8;     // smem stride of the Q tile and the tail tile
constexpr float NEG = -1e9f;

__host__ __device__ inline int keys_padded(int nk) { return (nk + 15) / 16 * 16; }
__host__ __device__ inline int logit_stride(int nk) { return keys_padded(nk) + 4; }

// Bytes of the logits of a tile of 16 * ROWT queries, or of the partial
// outputs of its 8 * ROWT warps if those need more.
template <int ROWT>
__host__ __device__ inline size_t logits_bytes(int nk) {
  const size_t s = size_t(16 * ROWT) * logit_stride(nk) * sizeof(float);
  const size_t partials = size_t(8 * ROWT) * (16 * ROWT) * D * sizeof(float);
  return s < partials ? partials : s;
}

// logits, Q tile, tail tile, row sums
template <int ROWT>
inline size_t smem_bytes(int nk) {
  return logits_bytes<ROWT>(nk) +
         size_t(16 * ROWT + 16) * LDT * sizeof(__nv_bfloat16) +
         16 * ROWT * sizeof(float);
}

// rows [r0, r0 + rows) of a (n, 64) bf16 matrix into a rows x LDT tile, zero
// rows past n; one uint4 per thread and step
__device__ inline void stage_rows(__nv_bfloat16* tile,
                                  const __nv_bfloat16* __restrict__ src,
                                  int r0, int n, int rows) {
  for (int i = threadIdx.x; i < rows * (D / 8); i += blockDim.x) {
    const int r = i / (D / 8), c = i % (D / 8);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n)
      val = *reinterpret_cast<const uint4*>(src + size_t(r0 + r) * D + c * 8);
    *reinterpret_cast<uint4*>(tile + r * LDT + c * 8) = val;
  }
}

// grid (ceil(Nq / (16 * ROWT)), H), 256 * ROWT threads
template <int ROWT>
__global__ void __launch_bounds__(256 * ROWT, ROWT == 1 ? 2 : 1)
qtiled_attention_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        __nv_bfloat16* __restrict__ out, int nq, int nk) {
  constexpr int BQ = 16 * ROWT;      // queries per block
  constexpr int WARPS = 8 * ROWT;
  constexpr int THREADS = 32 * WARPS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int lds = logit_stride(nk);
  const int nkp = keys_padded(nk);
  float* S = reinterpret_cast<float*>(smem_raw);
  __nv_bfloat16* Qs =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + logits_bytes<ROWT>(nk));
  __nv_bfloat16* Ts = Qs + BQ * LDT;                       // tail tile
  float* Ls = reinterpret_cast<float*>(Ts + 16 * LDT);     // row sums

  const int head = blockIdx.y, q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  q += size_t(head) * nq * D;
  out += size_t(head) * nq * D;
  k += size_t(head) * nk * D;
  v += size_t(head) * nk * D;
  const int full = nk / 16;              // key tiles that are complete
  const int tiles = nkp / 16;            // full, plus the ragged one if any

  stage_rows(Qs, q, q0, nq, BQ);
  if (tiles > full) stage_rows(Ts, k, full * 16, nk, 16);
  __syncthreads();

  // ---- A: S = Q K^T / 8 ------------------------------------------------
  for (int t = warp; t < tiles; t += WARPS) {
    const __nv_bfloat16* kt = t < full ? k + size_t(t) * 16 * D : Ts;
    const int ldk = t < full ? D : LDT;
    // B(d, key) = K[key][d]: K's rows are B's columns
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kb[D / 16];
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
      wmma::load_matrix_sync(kb[kc], kt + kc * 16, ldk);
#pragma unroll
    for (int rt = 0; rt < ROWT; ++rt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qa;
        wmma::load_matrix_sync(qa, Qs + rt * 16 * LDT + kc * 16, LDT);
        wmma::mma_sync(acc, qa, kb[kc], acc);
      }
#pragma unroll
      for (int i = 0; i < acc.num_elements; ++i) acc.x[i] *= 0.125f;  // 1/sqrt(64)
      wmma::store_matrix_sync(S + size_t(rt) * 16 * lds + t * 16, acc, lds,
                              wmma::mem_row_major);
    }
  }
  __syncthreads();
  if (tiles > full) stage_rows(Ts, v, full * 16, nk, 16);  // K's tail is consumed

  // ---- B: exact softmax statistics, p to bf16 in place -------------------
  for (int r = warp; r < BQ; r += WARPS) {
    float* srow = S + size_t(r) * lds;
    __nv_bfloat16* prow = reinterpret_cast<__nv_bfloat16*>(srow);
    float mx = NEG;
    for (int j = lane; j < nk; j += 32) mx = fmaxf(mx, srow[j]);
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int c0 = 0; c0 < nkp; c0 += 32) {
      const int j = c0 + lane;
      const float p = j < nk ? expf(srow[j] - mx) : 0.f;
      sum += p;
      __syncwarp();  // every lane has read chunk c0 before it is overwritten
      if (j < nkp) prow[j] = __float2bfloat16_rn(p);
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) Ls[r] = sum;
  }
  __syncthreads();

  // ---- C: O = P V ----------------------------------------------------------
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[ROWT][D / 16];
#pragma unroll
  for (int rt = 0; rt < ROWT; ++rt)
#pragma unroll
    for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(oacc[rt][n], 0.f);
  const __nv_bfloat16* P = reinterpret_cast<const __nv_bfloat16*>(S);
  for (int t = warp; t < tiles; t += WARPS) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pa[ROWT];
#pragma unroll
    for (int rt = 0; rt < ROWT; ++rt)
      wmma::load_matrix_sync(pa[rt], P + size_t(rt) * 16 * 2 * lds + t * 16,
                             2 * lds);
    const __nv_bfloat16* vt = t < full ? v + size_t(t) * 16 * D : Ts;
    const int ldv = t < full ? D : LDT;
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vb;
      wmma::load_matrix_sync(vb, vt + n * 16, ldv);
#pragma unroll
      for (int rt = 0; rt < ROWT; ++rt)
        wmma::mma_sync(oacc[rt][n], pa[rt], vb, oacc[rt][n]);
    }
  }
  __syncthreads();  // P is consumed: its room takes the partial outputs
  float* part = S + size_t(warp) * BQ * D;
#pragma unroll
  for (int rt = 0; rt < ROWT; ++rt)
#pragma unroll
    for (int n = 0; n < D / 16; ++n)
      wmma::store_matrix_sync(part + rt * 16 * D + n * 16, oacc[rt][n], D,
                              wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < BQ * D; i += THREADS) {
    const int r = i / D;
    if (q0 + r >= nq) continue;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) o += S[size_t(w) * BQ * D + i];
    out[size_t(q0 + r) * D + i % D] =
        __float2bfloat16_rn(o / fmaxf(Ls[r], 1e-20f));
  }
}

template <int ROWT>
int launch(const void* q, const void* k, const void* v, void* out, int H,
           int Nq, int Nk, size_t smem, cudaStream_t stream) {
  cudaFuncSetAttribute(qtiled_attention_kernel<ROWT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  dim3 grid((Nq + 16 * ROWT - 1) / (16 * ROWT), H);
  qtiled_attention_kernel<ROWT><<<grid, 256 * ROWT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      Nq, Nk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out: (H, Nq, 64) bf16; k, v: (H, Nk, 64) bf16; all contiguous and
// 32-byte aligned. Nk is bounded by the shared memory of one block.
extern "C" int qtiled_attention_bf16(const void* q, const void* k,
                                     const void* v, void* out, int H, int Nq,
                                     int Nk, void* stream) {
  if (H < 1 || Nq < 1 || Nk < 1) return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) % 32)
    return static_cast<int>(cudaErrorMisalignedAddress);
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 32-query tiles where their logits fit and there are that many queries
  if (Nq > 16 && smem_bytes<2>(Nk) <= size_t(max_smem))
    return launch<2>(q, k, v, out, H, Nq, Nk, smem_bytes<2>(Nk), st);
  if (smem_bytes<1>(Nk) <= size_t(max_smem))
    return launch<1>(q, k, v, out, H, Nq, Nk, smem_bytes<1>(Nk), st);
  return static_cast<int>(cudaErrorInvalidValue);
}
