// Blockwise (flash) attention with a key mask:
//     out = softmax(Q K^T / sqrt(dh) masked by the key mask) V   per head.
//
//   flash_attention_fwd  replaces imcui_tpu/ops/attention.py:_flash_pallas
//                        (kernel _flash_attn_kernel), the route LightGlue's
//                        self-attention takes above 2048 keypoints.
//
// Its contract differs from fused_attention_f32 (attention.cu) where the
// Pallas kernels differ: Nq and Nk are independent; the head dim is 64 or
// 128; inputs are f32 or bf16, loaded to f32, with the output in the input
// type; the running max starts at the finite -1e9 (not -inf) and the
// denominator is max(l, 1e-20). Masked logits are the finite -1e9, so a
// query whose keys are all masked gets the mean of V.
//
// What bounds it on an H100: f32 arithmetic on the FMA units, 4*Nq*Nk*dh
// flop per head-sequence (34.4 GFLOP for the 8 head-sequences of one pair at
// 4096 keypoints: 0.51 ms at 67 TFLOP/s), far above its bytes. The design is
// the online softmax the Pallas kernel runs over 256-key blocks in VMEM, cut
// to what an SM holds: one block per (head-sequence, 64-query tile) streams
// 64-key tiles of K and V through shared memory, each thread owns a 4x4 patch
// of the logit tile and a 4 x (dh/16) patch of the output, and row statistics
// are reduced with warp shuffles. The Nq x Nk logits never reach device
// memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int BQ = 64;        // queries per block
constexpr int BK = 64;        // keys per step
constexpr int THREADS = 256;  // 16 x 16
constexpr float NEG = -1e9f;

template <int D>
constexpr size_t smem_bytes() {
  return (size_t(BQ) * (D + 1) + size_t(BK) * (D + 1) + size_t(BK) * D +
          size_t(BQ) * (BK + 1)) * sizeof(float);
}

__device__ inline float to_f32(float x) { return x; }
__device__ inline float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ inline void from_f32(float& dst, float x) { dst = x; }
__device__ inline void from_f32(__nv_bfloat16& dst, float x) {
  dst = __float2bfloat16_rn(x);
}

// grid (ceil(Nq / BQ), BH): head-sequence bh reads mask row bh / heads.
template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const uint8_t* __restrict__ mask, T* __restrict__ out,
                       int nq, int nk, int heads) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LD = D + 1;   // padded row of the Q and K tiles
  constexpr int DJ = D / 16;  // output columns per thread
  float* Qs = smem;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * D;
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  if (q0 >= nq) return;
  q += size_t(bh) * nq * D;
  out += size_t(bh) * nq * D;
  k += size_t(bh) * nk * D;
  v += size_t(bh) * nk * D;
  const uint8_t* kmask = mask + size_t(bh / heads) * nk;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float scale = 1.f / sqrtf(float(D));

  for (int i = threadIdx.x; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    Qs[r * LD + c] = q0 + r < nq ? to_f32(q[size_t(q0 + r) * D + c]) : 0.f;
  }

  float acc[4][DJ], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < nk; k0 += BK) {
    __syncthreads();  // previous step's readers of Ks/Vs/Ps are done
    for (int i = threadIdx.x; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < nk;
      Ks[r * LD + c] = in ? to_f32(k[size_t(k0 + r) * D + c]) : 0.f;
      Vs[r * D + c] = in ? to_f32(v[size_t(k0 + r) * D + c]) : 0.f;
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
      float tmax = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        // keys past nk do not exist (weight 0); masked keys take -1e9
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
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int key = 0; key < BK; ++key) {
      float pa[4], vb[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = Ps[(ty + 16 * i) * (BK + 1) + key];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vb[j] = Vs[key * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pa[i], vb[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r < nq) {
      const float inv = 1.f / fmaxf(l[i], 1e-20f);
#pragma unroll
      for (int j = 0; j < DJ; ++j)
        from_f32(out[size_t(r) * D + tx + 16 * j], acc[i][j] * inv);
    }
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, const void* mask,
           void* out, int BH, int Nq, int Nk, int heads, cudaStream_t stream) {
  constexpr size_t SMEM = smem_bytes<D>();
  cudaFuncSetAttribute(flash_attention_kernel<D, T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM));
  dim3 grid((Nq + BQ - 1) / BQ, BH);
  flash_attention_kernel<D, T><<<grid, THREADS, SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(mask),
      static_cast<T*>(out), Nq, Nk, heads);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out: (BH, Nq, dh); k, v: (BH, Nk, dh); mask: (BH / heads, Nk) bytes.
// dh is 64 or 128; bf16 != 0 selects __nv_bfloat16 tensors, else float.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* mask, void* out, int BH, int Nq,
                                   int Nk, int heads, int dh, int bf16,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh == 64 && !bf16)
    return launch<64, float>(q, k, v, mask, out, BH, Nq, Nk, heads, st);
  if (dh == 64)
    return launch<64, __nv_bfloat16>(q, k, v, mask, out, BH, Nq, Nk, heads, st);
  if (dh == 128 && !bf16)
    return launch<128, float>(q, k, v, mask, out, BH, Nq, Nk, heads, st);
  if (dh == 128)
    return launch<128, __nv_bfloat16>(q, k, v, mask, out, BH, Nq, Nk, heads, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
