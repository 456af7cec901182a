// LightGlue attention, f32: masked softmax(Q K^T / sqrt(dh)) V per head.
//
//   fused_attention_f32  replaces imcui_tpu/ops/attention.py:_fused_attn_pallas
//                        (kernel _fused_attn_kernel): self-attention, one
//                        launch for every head of every image.
//   bidir_attention_f32  replaces imcui_tpu/ops/attention.py:_bidir_pallas
//                        (kernel _bidir_attn_kernel): S = A0 A1^T / sqrt(dh),
//                        a row softmax masked by m1 gives O0 = P V1 and a
//                        column softmax masked by m0 gives O1 = P^T V0. The
//                        column softmax of S is the row softmax of
//                        S^T = A1 A0^T, so grid dimension z = 2 picks the
//                        direction and both share the self-attention tile
//                        code; S is recomputed per direction (a third more
//                        flops than the minimum) and never written to memory.
//
// Masked logits are -1e9, not -inf (attention.py:22): a query whose keys are
// all masked gets the mean of V, as jax.nn.softmax gives on a -1e9 row.
//
// What bounds it on an H100: f32 arithmetic. Inputs are f32 (the serving
// path runs LightGlue in f32) and this kernel computes in f32 on the FMA
// units, 4*N^2*dh flop per head (8.6 GFLOP per self-attention launch at
// 32 heads x 1024 keypoints: 0.13 ms at 67 TFLOP/s); TF32 tensor cores
// would change the numbers and are a separate decision. The design is a
// flash-style online softmax: one block per (head, 64-query tile) streams
// 64-key tiles of K and V through shared memory, so the N x N logits never
// reach device memory; each thread owns a 4x4 patch of the logit tile and
// of the output, row statistics are reduced with warp shuffles.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int D = 64;        // head dim
constexpr int BQ = 64;       // queries per block
constexpr int BK = 64;       // keys per step
constexpr int THREADS = 256; // 16 x 16
constexpr int LD = D + 1;    // padded row of Q, K and P tiles
constexpr size_t SMEM = (size_t(BQ) * LD + size_t(BK) * LD + size_t(BK) * D +
                         size_t(BQ) * (BK + 1)) * sizeof(float);
constexpr float NEG = -1e9f;

// out[q0 : q0+BQ] = attention of q[q0 : q0+BQ] over (k, v) with key mask.
__device__ void attend(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v,
                       const uint8_t* __restrict__ kmask,
                       float* __restrict__ out, int nq, int nk, int q0,
                       float* smem) {
  float* Qs = smem;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * D;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float scale = 1.f / sqrtf(float(D));  // exact for D = 64

  for (int i = threadIdx.x; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    Qs[r * LD + c] = q0 + r < nq ? q[size_t(q0 + r) * D + c] : 0.f;
  }

  float acc[4][4], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < nk; k0 += BK) {
    __syncthreads();  // previous step's readers of Ks/Vs/Ps are done
    for (int i = threadIdx.x; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < nk;
      Ks[r * LD + c] = in ? k[size_t(k0 + r) * D + c] : 0.f;
      Vs[r * D + c] = in ? v[size_t(k0 + r) * D + c] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        // keys past nk do not exist; masked keys take the finite -1e9
        s[i][j] = key >= nk ? -INFINITY : (kmask[key] ? s[i][j] * scale : NEG);
        tmax = fmaxf(tmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off /= 2)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_new = fmaxf(m[i], tmax);
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rsum += p;
        Ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off /= 2)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int key = 0; key < BK; ++key) {
      float pa[4], vb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = Ps[(ty + 16 * i) * (BK + 1) + key];
#pragma unroll
      for (int j = 0; j < 4; ++j) vb[j] = Vs[key * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pa[i], vb[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r < nq) {
#pragma unroll
      for (int j = 0; j < 4; ++j) out[size_t(r) * D + tx + 16 * j] = acc[i][j] / l[i];
    }
  }
}

// grid (ceil(N / BQ), BH): head-sequence bh reads mask row bh / heads.
__global__ void __launch_bounds__(THREADS)
fused_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v,
                       const uint8_t* __restrict__ mask,
                       float* __restrict__ out, int N, int heads) {
  extern __shared__ __align__(16) float smem[];
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  if (q0 >= N) return;
  const size_t off = size_t(bh) * N * D;
  attend(q + off, k + off, v + off, mask + size_t(bh / heads) * N, out + off,
         N, N, q0, smem);
}

// grid (ceil(max(N, M) / BQ), BH, 2): z = 0 gives O0 (N rows), z = 1 O1.
__global__ void __launch_bounds__(THREADS)
bidir_attention_kernel(const float* __restrict__ a0, const float* __restrict__ a1,
                       const float* __restrict__ v0, const float* __restrict__ v1,
                       const uint8_t* __restrict__ m0,
                       const uint8_t* __restrict__ m1, float* __restrict__ o0,
                       float* __restrict__ o1, int N, int M, int heads) {
  extern __shared__ __align__(16) float smem[];
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ, pair = bh / heads;
  if (blockIdx.z == 0) {
    if (q0 >= N) return;
    attend(a0 + size_t(bh) * N * D, a1 + size_t(bh) * M * D,
           v1 + size_t(bh) * M * D, m1 + size_t(pair) * M,
           o0 + size_t(bh) * N * D, N, M, q0, smem);
  } else {
    if (q0 >= M) return;
    attend(a1 + size_t(bh) * M * D, a0 + size_t(bh) * N * D,
           v0 + size_t(bh) * N * D, m0 + size_t(pair) * N,
           o1 + size_t(bh) * M * D, M, N, q0, smem);
  }
}

}  // namespace

extern "C" int fused_attention_f32(const void* q, const void* k, const void* v,
                                   const void* mask, void* out, int BH, int N,
                                   int heads, void* stream) {
  cudaFuncSetAttribute(fused_attention_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM));
  dim3 grid((N + BQ - 1) / BQ, BH);
  fused_attention_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const uint8_t*>(mask),
      static_cast<float*>(out), N, heads);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bidir_attention_f32(const void* a0, const void* a1,
                                   const void* v0, const void* v1,
                                   const void* m0, const void* m1, void* o0,
                                   void* o1, int BH, int N, int M, int heads,
                                   void* stream) {
  cudaFuncSetAttribute(bidir_attention_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM));
  const int nmax = N > M ? N : M;
  dim3 grid((nmax + BQ - 1) / BQ, BH, 2);
  bidir_attention_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a0), static_cast<const float*>(a1),
      static_cast<const float*>(v0), static_cast<const float*>(v1),
      static_cast<const uint8_t*>(m0), static_cast<const uint8_t*>(m1),
      static_cast<float*>(o0), static_cast<float*>(o1), N, M, heads);
  return static_cast<int>(cudaGetLastError());
}
