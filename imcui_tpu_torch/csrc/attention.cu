// LightGlue attention, f32 and bf16: masked softmax(Q K^T / sqrt(dh)) V per head.
//
//   fused_attention_f32  replaces imcui_tpu/ops/attention.py:_fused_attn_pallas
//                        (kernel _fused_attn_kernel): self-attention, one
//                        launch for every head of every image.
//   bidir_attention_f32  replaces imcui_tpu/ops/attention.py:_bidir_pallas
//                        (kernel _bidir_attn_kernel): S = A0 A1^T / sqrt(dh),
//                        a row softmax masked by m1 gives O0 = P V1 and a
//                        column softmax masked by m0 gives O1 = P^T V0. The
//                        column softmax of S is the row softmax of
//                        S^T = A1 A0^T, so each block takes one direction and
//                        both share the tile code; S is recomputed per
//                        direction (a third more flops than the minimum) and
//                        never written to memory.
//   fused_attention_bf16, bidir_attention_bf16
//                        the same two on bfloat16 q, k and v (LightGlue
//                        with precision="bf16"): a second instance of the
//                        tile that widens the inputs on load, normalises P
//                        in float32 after a first pass over the keys, rounds
//                        it once to bf16 as the JAX kernels do (p.astype(
//                        q.dtype)), sums P V in float32 and rounds the
//                        output once to bf16. The first pass recomputes
//                        Q K^T, so a bf16 launch does about 1.5x the float32
//                        launch's flops; no tensor core is used.
//   flash_attention_f32  the float32 variants of K5, imcui_tpu/ops/
//                        attention.py:_flash_pallas (kernel
//                        _flash_attn_kernel), through flash_attention.cu's
//                        entry point: self-attention's kernel with Nq and Nk
//                        independent, at a head dim of 64 or 128.
//
// Masked logits are -1e9, not -inf (attention.py:22): a query whose keys are
// all masked gets the mean of V, as jax.nn.softmax gives on a -1e9 row. Keys
// past the end are -inf. A null mask means every key is valid.
//
// What bounds it on an H100: f32 arithmetic on the FMA units, 4*N^2*dh flop
// per head (8.6 GFLOP per self-attention launch at 32 heads x 1024
// keypoints: 0.13 ms at 67 TFLOP/s). Inputs, arithmetic and output are f32
// with no TF32 (the port's contract for LightGlue and the f32 ViT), so no
// tensor-core route exists. The design keeps the FMA units fed:
//
// - Register tiles fed by 16-byte shared loads. A block is 4 warps; a warp
//   is 4 query groups x 8 key groups, and each thread owns QR query rows
//   (rows g, g+4, ...) of the logit tile against 8 keys (k, k+8, ..., k+56)
//   and the same rows of the output against 8 of the 64 columns. Q, K, V
//   rows are padded to 68 floats and P rows to 72, so every float4 read of
//   a warp touches distinct banks: one wavefront serves 4 or 8 distinct
//   16-byte addresses, broadcast to the other lanes. Per 4-deep chunk a
//   thread issues QR + 8 LDS.128 for 32*QR FFMA, in Q K^T and in P V: at
//   QR = 8, 16 FFMA per load, against 2 in the first design's scalar 4x4
//   body. A warp-wide LDS.128 returns 512 B at 128 B a clock, so 16 FFMA a
//   load is where shared memory and the FMA units take the same time.
// - Asynchronous copies of 64-key tiles (cp.async.cg, 16 bytes a thread).
//   The shared memory of two stages of both does not leave room for two
//   blocks an SM, so K and V have one buffer each, staggered: K of tile
//   t+1 lands during tile t's P V, V of tile t+1 during tile t+1's Q K^T.
//   Q is loaded once per block. Rows past the end are zero-filled by the
//   copy itself, and the ragged key tile is masked in the softmax. P goes
//   through shared memory rows that belong to one warp; three __syncthreads
//   a key tile.
// - Online softmax in base 2 (logits scaled by log2(e)/8), rescaled once
//   per key tile; each lane keeps a partial row sum, reduced at the end.
// - A grid sized to the card. The query-tile height BQ = 16*QR is picked
//   per launch from 128, 112 and 64 to minimise ceil(blocks / SMs) * BQ,
//   the rows the busiest SM walks. Shared memory holds 2 blocks on an SM
//   at BQ 128 and 112 (106 496 B at 128), 3 at 64. At the path's shapes, on
//   132 SMs, every launch is one round:
//     K3 16 x 1601 (dense f32 ViT):  BQ 112, 15 tiles x 16 = 240 blocks
//     K3 32 x 1024 (turbo):          BQ 128, 8 x 32 = 256 blocks
//     K4 16 x 1024^2 (turbo):        BQ 128, (8 + 8) x 16 = 256 blocks
//     K4 4 x 4096^2 (general):       BQ 128, (32 + 32) x 4 = 256 blocks
//     K5 8 x 4096^2 (general, f32):  BQ 128, 32 x 8 = 256 blocks
//   and 64 rows serve launches of fewer than 132 taller tiles (the general
//   path at 1024 keypoints: 128 blocks).
// - The shared-memory limits are raised and the SM count read once per
//   device, not per launch.
//
// - A head dim of 128 (K5 only) doubles each thread's output columns (16)
//   and every row: at 64-row query tiles and 32-key K/V tiles the shared
//   memory (77 824 B) still holds two blocks an SM.
//
// What bounds this design (imcui_tpu_torch/tools/attention_times.py on
// builds that skip one part; PERF.md): the two product loops, each alone
// well under the FMA peak, overlapping only in part.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>
#include <initializer_list>
#include <mutex>
#include <type_traits>

namespace {

constexpr int THREADS = 128;  // 4 warps of 4 query groups x 8 key groups
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG2 = -1e9f * LOG2E;     // the masked logit, in base 2
constexpr int NQR = 3;
constexpr int QRS[NQR] = {8, 7, 4};  // query rows per thread, head dim 64
constexpr int BK128 = 32;            // keys per tile at head dim 128
constexpr int QR128 = 4;             // query rows per thread at head dim 128

// A block's tiles at QR query rows a thread, head dim D and BK keys a tile.
template <int QR, int D, int BK>
struct Tile {
  static constexpr int BQ = 16 * QR;
  static constexpr int LDQ = D + 4;   // padded row of Q, K and V
  static constexpr int LDP = BK + 8;  // padded row of P
  // log2(e) / sqrt(D)
  static constexpr float SCALE2 = LOG2E * (D == 64 ? 0.125f : 0.08838834764831845f);
  static constexpr size_t SMEM =
      (size_t(BQ) * LDQ + 2 * size_t(BK) * LDQ + size_t(BQ) * LDP) *
      sizeof(float);
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float lane_of(const float4& f, int i) {
  return i == 0 ? f.x : i == 1 ? f.y : i == 2 ? f.z : f.w;
}

// bf16 element i (0 or 1) of a 32-bit pair, widened exactly.
__device__ __forceinline__ float bf16_at(unsigned u, int i) {
  return __uint_as_float(i == 0 ? u << 16 : u & 0xffff0000u);
}

// out[q0 : q0+BQ] = attention of q[q0 : q0+BQ] over (k, v) with key mask
// (null: all valid).
//
// float32 (T = float): one pass, online softmax. The running maximum
// starts at -inf, where K5's contract starts it at the finite -1e9: the
// two give the same result. Key k0 exists, so after the first tile
// m >= that tile's largest logit, which is at least -1e9 (a masked logit;
// a real logit below -1e9 needs inputs of norm ~1e5), and the first
// tile's rescale exp2(-inf - m) = 0 meets l = 0 and o = 0 either way. A
// row whose keys are all masked then has m = NEG2 (-1e9 in base 2) and
// weighs each key exp2(0) = 1: the mean of V.
//
// bfloat16 (T = __nv_bfloat16): q, k and v are widened to float32 as they
// are loaded (plain 16-byte loads; the cp.async ring is float32's), and
// the JAX kernel's rounding points are kept: P is normalised in float32
// and rounded once to bf16 before P V (attention.py:256, :352, :361),
// whose sums are float32, and the output is rounded once to bf16. A
// first pass over the key tiles finds each row's maximum and sum; the
// second recomputes the logits, writes bf16(exp2(s - m) / l) and reads V.
template <int QR, int D, int BK, typename T>
__device__ void attend(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const uint8_t* __restrict__ kmask,
                       T* __restrict__ out, int nq, int nk, int q0,
                       float* smem) {
  constexpr bool BF = std::is_same<T, __nv_bfloat16>::value;
  using Tl = Tile<QR, D, BK>;
  constexpr int BQ = Tl::BQ, LDQ = Tl::LDQ, LDP = Tl::LDP;
  constexpr float SCALE2 = Tl::SCALE2;
  constexpr int KJ = BK / 8;  // keys per thread in the logit tile
  constexpr int G = D / 32;   // float4 groups of a thread's output columns
  float* Qs = smem;
  float* Ks = Qs + BQ * LDQ;
  float* Vs = Ks + BK * LDQ;
  float* Ps = Vs + BK * LDQ;
  const int tid = threadIdx.x, lane = tid % 32;
  const int qg = lane / 8, kg = lane % 8;
  const int row0 = (tid / 32) * 4 * QR + qg;  // this thread's rows: row0 + 4i

  // rows [r0, r0 + rows) of x (n rows) into dst; rows past n zero-filled
  auto load = [&](float* dst, const T* x, int r0, int rows, int n) {
    if constexpr (BF) {
      for (int c = tid; c < rows * (D / 8); c += THREADS) {
        const int r = c / (D / 8), col = (c % (D / 8)) * 8;
        uint4 u = make_uint4(0u, 0u, 0u, 0u);
        if (r0 + r < n)
          u = *reinterpret_cast<const uint4*>(x + size_t(r0 + r) * D + col);
        float* d = dst + r * LDQ + col;
        *reinterpret_cast<float4*>(d) = make_float4(
            bf16_at(u.x, 0), bf16_at(u.x, 1), bf16_at(u.y, 0), bf16_at(u.y, 1));
        *reinterpret_cast<float4*>(d + 4) = make_float4(
            bf16_at(u.z, 0), bf16_at(u.z, 1), bf16_at(u.w, 0), bf16_at(u.w, 1));
      }
    } else {
      for (int c = tid; c < rows * (D / 4); c += THREADS) {
        const int r = c / (D / 4), col = (c % (D / 4)) * 4;
        const bool in = r0 + r < n;
        cp_async16(dst + r * LDQ + col, x + size_t(in ? r0 + r : 0) * D + col,
                   in);
      }
    }
  };

  // s = Q K^T of this thread's rows against its keys of the tile in Ks
  auto logits = [&](float (&s)[QR][KJ]) {
#pragma unroll
    for (int i = 0; i < QR; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = 0.f;
    // one chunk at a time: unrolled, the 8 x 8 logit tile, the output and
    // two chunks of fragments fill all 255 registers and run slower
#pragma unroll 1
    for (int c = 0; c < D; c += 4) {
      float4 kf[KJ];
#pragma unroll
      for (int j = 0; j < KJ; ++j)
        kf[j] = *reinterpret_cast<const float4*>(Ks + (kg + 8 * j) * LDQ + c);
#pragma unroll
      for (int i = 0; i < QR; ++i) {
        const float4 qf =
            *reinterpret_cast<const float4*>(Qs + (row0 + 4 * i) * LDQ + c);
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          s[i][j] = fmaf(qf.x, kf[j].x, s[i][j]);
          s[i][j] = fmaf(qf.y, kf[j].y, s[i][j]);
          s[i][j] = fmaf(qf.z, kf[j].z, s[i][j]);
          s[i][j] = fmaf(qf.w, kf[j].w, s[i][j]);
        }
      }
    }
  };

  // row i's logits of key tile k0 in base 2: keys past nk do not exist,
  // masked keys take the finite -1e9; returns the tile's row maximum
  // (over the 8 lanes of the row)
  auto scaled = [&](auto with_mask, float (&s)[QR][KJ], int i, int k0) {
    constexpr bool MASK = decltype(with_mask)::value;
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const int key = k0 + kg + 8 * j;
      s[i][j] = key >= nk                  ? -INFINITY
                : (!MASK || kmask[key]) ? s[i][j] * SCALE2
                                           : NEG2;
      tmax = fmaxf(tmax, s[i][j]);
    }
#pragma unroll
    for (int off = 1; off < 8; off *= 2)
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
    return tmax;
  };

  float o[QR][4 * G], m[QR], l[QR];
#pragma unroll
  for (int i = 0; i < QR; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 4 * G; ++e) o[i][e] = 0.f;
  }
  const int tiles = (nk + BK - 1) / BK;

  if constexpr (BF) {
    // first pass: each row's maximum and sum over every key tile
    load(Qs, q, q0, BQ, nq);
    for (int t = 0; t < tiles; ++t) {
      const int k0 = t * BK;
      __syncthreads();  // the last tile's readers are done with Ks
      load(Ks, k, k0, BK, nk);
      __syncthreads();
      float s[QR][KJ];
      logits(s);
      auto stats = [&](auto with_mask) {
#pragma unroll
        for (int i = 0; i < QR; ++i) {
          const float m_new = fmaxf(m[i], scaled(with_mask, s, i, k0));
          float rsum = 0.f;
#pragma unroll
          for (int j = 0; j < KJ; ++j) rsum += exp2f(s[i][j] - m_new);
          l[i] = l[i] * exp2f(m[i] - m_new) + rsum;
          m[i] = m_new;
        }
      };
      if (kmask != nullptr)
        stats(std::true_type{});
      else
        stats(std::false_type{});
    }
#pragma unroll
    for (int i = 0; i < QR; ++i)
#pragma unroll
      for (int off = 1; off < 8; off *= 2)
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    __syncthreads();  // Ks is free again
    load(Ks, k, 0, BK, nk);
    load(Vs, v, 0, BK, nk);
  } else {
    load(Qs, q, q0, BQ, nq);
    load(Ks, k, 0, BK, nk);
    cp_async_commit();  // group: Q and K of tile 0
    load(Vs, v, 0, BK, nk);
    cp_async_commit();  // group: V of tile 0
  }

  // K and V have one buffer each: K of tile t+1 lands during tile t's P V,
  // V of tile t+1 during tile t+1's Q K^T.
  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * BK;
    cp_async_wait<1>();  // K of tile t (V of tile t may be in flight)
    __syncthreads();

    float s[QR][KJ];
    logits(s);

    // The row softmax, in two copies: with a key mask and without. The
    // mask's null test is hoisted by hand: left to the compiler, it was
    // hoisted in K3's kernel and not in K4's, whose per-key test cost 7 %.
    auto softmax = [&](auto with_mask) {
#pragma unroll
      for (int i = 0; i < QR; ++i) {
        [[maybe_unused]] const float tmax = scaled(with_mask, s, i, k0);
        if constexpr (BF) {
          // the first pass's maximum and sum: normalised, then bf16
#pragma unroll
          for (int j = 0; j < KJ; ++j)
            Ps[(row0 + 4 * i) * LDP + kg + 8 * j] = __bfloat162float(
                __float2bfloat16_rn(__fdiv_rn(exp2f(s[i][j] - m[i]), l[i])));
        } else {
          // key k0 exists, so m_new is finite; exp2f(-inf) = 0 on the
          // first tile
          const float m_new = fmaxf(m[i], tmax);
          const float alpha = exp2f(m[i] - m_new);
          float rsum = 0.f;
#pragma unroll
          for (int j = 0; j < KJ; ++j) {
            const float p = exp2f(s[i][j] - m_new);
            rsum += p;
            Ps[(row0 + 4 * i) * LDP + kg + 8 * j] = p;
          }
          l[i] = l[i] * alpha + rsum;  // this lane's share of the row sum
          m[i] = m_new;
#pragma unroll
          for (int e = 0; e < 4 * G; ++e) o[i][e] *= alpha;
        }
      }
    };
    if (kmask != nullptr)
      softmax(std::true_type{});
    else
      softmax(std::false_type{});

    cp_async_wait<0>();  // V of tile t
    __syncthreads();     // K is free, V visible; P rows belong to one warp
    if (t + 1 < tiles) load(Ks, k, k0 + BK, BK, nk);
    cp_async_commit();

#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float4 pf[QR];
#pragma unroll
      for (int i = 0; i < QR; ++i)
        pf[i] = *reinterpret_cast<const float4*>(Ps + (row0 + 4 * i) * LDP + c);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float4 vf[G];  // columns 32 g + 4 kg ... + 3 of key c + kk
#pragma unroll
        for (int g = 0; g < G; ++g)
          vf[g] = *reinterpret_cast<const float4*>(Vs + (c + kk) * LDQ +
                                                   32 * g + 4 * kg);
#pragma unroll
        for (int i = 0; i < QR; ++i) {
          const float p = lane_of(pf[i], kk);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            o[i][4 * g + 0] = fmaf(p, vf[g].x, o[i][4 * g + 0]);
            o[i][4 * g + 1] = fmaf(p, vf[g].y, o[i][4 * g + 1]);
            o[i][4 * g + 2] = fmaf(p, vf[g].z, o[i][4 * g + 2]);
            o[i][4 * g + 3] = fmaf(p, vf[g].w, o[i][4 * g + 3]);
          }
        }
      }
    }
    __syncthreads();  // V and P are free
    if (t + 1 < tiles) load(Vs, v, k0 + BK, BK, nk);
    cp_async_commit();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < QR; ++i) {
    const int r = q0 + row0 + 4 * i;
    if constexpr (BF) {
      if (r < nq) {
        __nv_bfloat16* dst = out + size_t(r) * D + 4 * kg;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const __nv_bfloat162 lo =
              __floats2bfloat162_rn(o[i][4 * g], o[i][4 * g + 1]);
          const __nv_bfloat162 hi =
              __floats2bfloat162_rn(o[i][4 * g + 2], o[i][4 * g + 3]);
          *reinterpret_cast<uint2*>(dst + 32 * g) =
              make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                         *reinterpret_cast<const unsigned*>(&hi));
        }
      }
    } else {
      float sum = l[i];
#pragma unroll
      for (int off = 1; off < 8; off *= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (r < nq) {
        float* dst = out + size_t(r) * D + 4 * kg;
#pragma unroll
        for (int g = 0; g < G; ++g)
          *reinterpret_cast<float4*>(dst + 32 * g) =
              make_float4(o[i][4 * g] / sum, o[i][4 * g + 1] / sum,
                          o[i][4 * g + 2] / sum, o[i][4 * g + 3] / sum);
      }
    }
  }
}

// One block per (head-sequence, query tile), head-sequence major; bh reads
// mask row bh / heads. K3 (nq = nk, D 64) and K5's float32 variants.
template <int QR, int D, int BK, typename T = float>
__global__ void __launch_bounds__(THREADS, 2)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const uint8_t* __restrict__ mask,
                 T* __restrict__ out, int nq, int nk, int heads,
                 int tiles) {
  extern __shared__ __align__(16) float smem[];
  const int bh = blockIdx.x / tiles;
  const int q0 = (blockIdx.x % tiles) * Tile<QR, D, BK>::BQ;
  attend<QR, D, BK, T>(q + size_t(bh) * nq * D, k + size_t(bh) * nk * D,
                       v + size_t(bh) * nk * D,
                       mask ? mask + size_t(bh / heads) * nk : nullptr,
                       out + size_t(bh) * nq * D, nq, nk, q0, smem);
}

// Blocks [0, BH * tiles0) give O0 (N rows), the rest O1 (M rows).
template <int QR, typename T = float>
__global__ void __launch_bounds__(THREADS, 2)
bidir_attention_kernel(const T* __restrict__ a0, const T* __restrict__ a1,
                       const T* __restrict__ v0, const T* __restrict__ v1,
                       const uint8_t* __restrict__ m0,
                       const uint8_t* __restrict__ m1, T* __restrict__ o0,
                       T* __restrict__ o1, int N, int M, int heads,
                       int tiles0, int tiles1, int BH) {
  extern __shared__ __align__(16) float smem[];
  // one call site, so the tile's code is in the kernel once
  const bool first = blockIdx.x < unsigned(BH * tiles0);
  const int item = first ? blockIdx.x : blockIdx.x - BH * tiles0;
  const int tiles = first ? tiles0 : tiles1;
  const int bh = item / tiles, q0 = (item % tiles) * Tile<QR, 64, 64>::BQ;
  const int nq = first ? N : M, nk = first ? M : N;
  const uint8_t* km = first ? m1 : m0;
  attend<QR, 64, 64, T>((first ? a0 : a1) + size_t(bh) * nq * 64,
                        (first ? a1 : a0) + size_t(bh) * nk * 64,
                        (first ? v1 : v0) + size_t(bh) * nk * 64,
                        km ? km + size_t(bh / heads) * nk : nullptr,
                        (first ? o0 : o1) + size_t(bh) * nq * 64, nq, nk, q0,
                        smem);
}

// Raises the kernel's shared-memory limit and reads the blocks an SM holds.
template <typename Kernel>
cudaError_t fit(Kernel kernel, size_t smem, int* per_sm) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, THREADS,
                                                      smem);
  return e;
}

// Both types' kernels at one height; per_sm is float32's K3.
template <int QR>
cudaError_t fit_dh64(int* per_sm) {
  using BF = __nv_bfloat16;
  int unused = 0;
  constexpr size_t SMEM = Tile<QR, 64, 64>::SMEM;
  cudaError_t e = fit(bidir_attention_kernel<QR>, SMEM, &unused);
  if (e == cudaSuccess) e = fit(bidir_attention_kernel<QR, BF>, SMEM, &unused);
  if (e == cudaSuccess)
    e = fit(attention_kernel<QR, 64, 64, BF>, SMEM, &unused);
  return e == cudaSuccess ? fit(attention_kernel<QR, 64, 64>, SMEM, per_sm)
                          : e;
}

// Per device, once: the kernels' shared-memory limits raised, the SM count
// and the blocks an SM holds at each tile height (head dim 64) and at head
// dim 128.
struct Card {
  int sms = 0;
  int per_sm[NQR] = {};
  int per_sm128 = 0;
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
    if (e == cudaSuccess) e = fit_dh64<8>(&fresh.per_sm[0]);
    if (e == cudaSuccess) e = fit_dh64<7>(&fresh.per_sm[1]);
    if (e == cudaSuccess) e = fit_dh64<4>(&fresh.per_sm[2]);
    if (e == cudaSuccess)
      e = fit(attention_kernel<QR128, 128, BK128>,
              Tile<QR128, 128, BK128>::SMEM, &fresh.per_sm128);
    if (e != cudaSuccess) return e;
    c = fresh;
  }
  *card = c;
  return cudaSuccess;
}

struct Plan {
  int qr, tiles0, tiles1;  // tiles1 = 0 for self-attention
  long long blocks;
};

// The tile height whose busiest SM walks the fewest query rows; ties go to
// the taller tile (fewer K/V passes). N queries (and M for the second
// direction).
Plan choose(int BH, int N, int M, bool bidir, int sms) {
  Plan best{QRS[0], 0, 0, 0};
  long long best_cost = LLONG_MAX;
  for (int i = 0; i < NQR; ++i) {
    const int bq = 16 * QRS[i];
    const int t0 = (N + bq - 1) / bq, t1 = bidir ? (M + bq - 1) / bq : 0;
    const long long blocks = (long long)BH * (t0 + t1);
    const long long cost = (blocks + sms - 1) / sms * bq;
    if (cost < best_cost) {
      best_cost = cost;
      best = {QRS[i], t0, t1, blocks};
    }
  }
  return best;
}

// K5's plan: at head dim 64 K3's choice, at 128 one height.
Plan choose_flash(int BH, int Nq, int dh, int sms) {
  if (dh == 64) return choose(BH, Nq, 0, false, sms);
  const int t0 = (Nq + 16 * QR128 - 1) / (16 * QR128);
  return {QR128, t0, 0, (long long)BH * t0};
}

bool misaligned(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return true;
  return false;
}

template <int QR, int D, int BK, typename T = float>
void launch_self(const Plan& p, const void* q, const void* k, const void* v,
                 const void* mask, void* out, int nq, int nk, int heads,
                 cudaStream_t stream) {
  attention_kernel<QR, D, BK, T><<<unsigned(p.blocks), THREADS,
                                   Tile<QR, D, BK>::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(mask),
      static_cast<T*>(out), nq, nk, heads, p.tiles0);
}

template <int QR, typename T = float>
void launch_bidir(const Plan& p, const void* a0, const void* a1,
                  const void* v0, const void* v1, const void* m0,
                  const void* m1, void* o0, void* o1, int BH, int N, int M,
                  int heads, cudaStream_t stream) {
  bidir_attention_kernel<QR, T><<<unsigned(p.blocks), THREADS,
                                  Tile<QR, 64, 64>::SMEM, stream>>>(
      static_cast<const T*>(a0), static_cast<const T*>(a1),
      static_cast<const T*>(v0), static_cast<const T*>(v1),
      static_cast<const uint8_t*>(m0), static_cast<const uint8_t*>(m1),
      static_cast<T*>(o0), static_cast<T*>(o1), N, M, heads, p.tiles0,
      p.tiles1, BH);
}

// Self-attention of BH head-sequences at head dim dh (64 or 128; 64 only
// in bf16), Nq queries over Nk keys; the plan's height for dh 64.
template <typename T = float>
int launch_self_any(const Plan& p, const void* q, const void* k,
                    const void* v, const void* mask, void* out, int nq,
                    int nk, int heads, int dh, cudaStream_t s) {
  if (dh == 128)
    launch_self<QR128, 128, BK128>(p, q, k, v, mask, out, nq, nk, heads, s);
  else if (p.qr == 8)
    launch_self<8, 64, 64, T>(p, q, k, v, mask, out, nq, nk, heads, s);
  else if (p.qr == 7)
    launch_self<7, 64, 64, T>(p, q, k, v, mask, out, nq, nk, heads, s);
  else
    launch_self<4, 64, 64, T>(p, q, k, v, mask, out, nq, nk, heads, s);
  return static_cast<int>(cudaGetLastError());
}

// K3: mask may be null (every key valid).
template <typename T>
int fused(const void* q, const void* k, const void* v, const void* mask,
          void* out, int BH, int N, int heads, void* stream) {
  if (BH < 1 || N < 1) return 0;
  if (misaligned({q, k, v, out}))
    return static_cast<int>(cudaErrorMisalignedAddress);
  Card card;
  cudaError_t e = prepare(&card);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Plan p = choose(BH, N, N, false, card.sms);
  if (p.blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  return launch_self_any<T>(p, q, k, v, mask, out, N, N, heads, 64,
                            static_cast<cudaStream_t>(stream));
}

// K4: m0 and m1 may be null (every key valid).
template <typename T>
int bidir(const void* a0, const void* a1, const void* v0, const void* v1,
          const void* m0, const void* m1, void* o0, void* o1, int BH, int N,
          int M, int heads, void* stream) {
  if (BH < 1 || N < 1 || M < 1) return 0;
  if (misaligned({a0, a1, v0, v1, o0, o1}))
    return static_cast<int>(cudaErrorMisalignedAddress);
  Card card;
  cudaError_t e = prepare(&card);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Plan p = choose(BH, N, M, true, card.sms);
  if (p.blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  switch (p.qr) {
    case 8: launch_bidir<8, T>(p, a0, a1, v0, v1, m0, m1, o0, o1, BH, N, M, heads, s); break;
    case 7: launch_bidir<7, T>(p, a0, a1, v0, v1, m0, m1, o0, o1, BH, N, M, heads, s); break;
    default: launch_bidir<4, T>(p, a0, a1, v0, v1, m0, m1, o0, o1, BH, N, M, heads, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fused_attention_f32(const void* q, const void* k, const void* v,
                                   const void* mask, void* out, int BH, int N,
                                   int heads, void* stream) {
  return fused<float>(q, k, v, mask, out, BH, N, heads, stream);
}

extern "C" int fused_attention_bf16(const void* q, const void* k,
                                    const void* v, const void* mask, void* out,
                                    int BH, int N, int heads, void* stream) {
  return fused<__nv_bfloat16>(q, k, v, mask, out, BH, N, heads, stream);
}

extern "C" int bidir_attention_f32(const void* a0, const void* a1,
                                   const void* v0, const void* v1,
                                   const void* m0, const void* m1, void* o0,
                                   void* o1, int BH, int N, int M, int heads,
                                   void* stream) {
  return bidir<float>(a0, a1, v0, v1, m0, m1, o0, o1, BH, N, M, heads,
                      stream);
}

extern "C" int bidir_attention_bf16(const void* a0, const void* a1,
                                    const void* v0, const void* v1,
                                    const void* m0, const void* m1, void* o0,
                                    void* o1, int BH, int N, int M, int heads,
                                    void* stream) {
  return bidir<__nv_bfloat16>(a0, a1, v0, v1, m0, m1, o0, o1, BH, N, M,
                              heads, stream);
}

// K5 in float32 (flash_attention.cu's entry point): q, out (BH, Nq, dh); k,
// v (BH, Nk, dh); mask (BH / heads, Nk) bytes or null; dh 64 or 128.
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   const void* mask, void* out, int BH, int Nq,
                                   int Nk, int heads, int dh, void* stream) {
  if (BH < 1 || Nq < 1 || Nk < 1 || (dh != 64 && dh != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  if (misaligned({q, k, v, out}))
    return static_cast<int>(cudaErrorMisalignedAddress);
  Card card;
  cudaError_t e = prepare(&card);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Plan p = choose_flash(BH, Nq, dh, card.sms);
  if (p.blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  return launch_self_any(p, q, k, v, mask, out, Nq, Nk, heads, dh,
                         static_cast<cudaStream_t>(stream));
}

namespace {

int write_plan(const Plan& p, int per_sm, int sms, void* out) {
  int* o = static_cast<int*>(out);
  o[0] = 16 * p.qr;
  o[1] = p.blocks > INT_MAX ? INT_MAX : int(p.blocks);
  o[2] = per_sm;
  o[3] = sms;
  return 0;
}

int per_sm_at(const Card& card, int qr) {
  int idx = 0;
  while (idx < NQR - 1 && QRS[idx] != qr) ++idx;
  return card.per_sm[idx];
}

}  // namespace

// The launch plan of either entry point (bidir 0 or 1), for the records:
// out[0..3] = query-tile height, blocks, blocks an SM holds at that height,
// SMs on the card.
extern "C" int attention_f32_plan(int BH, int N, int M, int bidir, void* out) {
  Card card;
  cudaError_t e = prepare(&card);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Plan p = choose(BH, N, M, bidir != 0, card.sms);
  return write_plan(p, per_sm_at(card, p.qr), card.sms, out);
}

// K5's float32 plan, as attention_f32_plan reports it.
extern "C" int flash_attention_f32_plan(int BH, int Nq, int dh, void* out) {
  Card card;
  cudaError_t e = prepare(&card);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Plan p = choose_flash(BH, Nq, dh, card.sms);
  return write_plan(p, dh == 128 ? card.per_sm128 : per_sm_at(card, p.qr),
                    card.sms, out);
}
