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
//                        S^T = A1 A0^T, so each block takes one direction and
//                        both share the tile code; S is recomputed per
//                        direction (a third more flops than the minimum) and
//                        never written to memory.
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
//   and 64 rows serve launches of fewer than 132 taller tiles (the general
//   path at 1024 keypoints: 128 blocks).
// - The shared-memory limits are raised and the SM count read once per
//   device, not per launch.
//
// What bounds this design (imcui_tpu_torch/tools/attention_times.py on
// builds that skip one part; PERF.md): the two product loops, each alone
// well under the FMA peak, overlapping only in part.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>
#include <initializer_list>
#include <mutex>

namespace {

constexpr int D = 64;         // head dim
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 128;  // 4 warps of 4 query groups x 8 key groups
constexpr int LDQ = D + 4;    // padded row of Q, K and V
constexpr int LDP = BK + 8;   // padded row of P
constexpr float LOG2E = 1.4426950408889634f;
constexpr float SCALE2 = 0.125f * LOG2E;  // log2(e) / sqrt(64)
constexpr float NEG2 = -1e9f * LOG2E;     // the masked logit, in base 2
constexpr int NQR = 3;
constexpr int QRS[NQR] = {8, 7, 4};  // query rows per thread

template <int QR>
struct Tile {
  static constexpr int BQ = 16 * QR;
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

// out[q0 : q0+BQ] = attention of q[q0 : q0+BQ] over (k, v) with key mask
// (null: all valid).
template <int QR>
__device__ void attend(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v,
                       const uint8_t* __restrict__ kmask,
                       float* __restrict__ out, int nq, int nk, int q0,
                       float* smem) {
  constexpr int BQ = Tile<QR>::BQ;
  constexpr int KJ = BK / 8;  // keys per thread in the logit tile
  float* Qs = smem;
  float* Ks = Qs + BQ * LDQ;
  float* Vs = Ks + BK * LDQ;
  float* Ps = Vs + BK * LDQ;
  const int tid = threadIdx.x, lane = tid % 32;
  const int qg = lane / 8, kg = lane % 8;
  const int row0 = (tid / 32) * 4 * QR + qg;  // this thread's rows: row0 + 4i

  // rows [r0, r0 + rows) of x (n rows) into dst; rows past n zero-filled
  auto load = [&](float* dst, const float* x, int r0, int rows, int n) {
    for (int c = tid; c < rows * 16; c += THREADS) {
      const int r = c / 16, col = (c % 16) * 4;
      const bool in = r0 + r < n;
      cp_async16(dst + r * LDQ + col, x + size_t(in ? r0 + r : 0) * D + col,
                 in);
    }
  };
  load(Qs, q, q0, BQ, nq);
  load(Ks, k, 0, BK, nk);
  cp_async_commit();  // group: Q and K of tile 0
  load(Vs, v, 0, BK, nk);
  cp_async_commit();  // group: V of tile 0

  float o[QR][8], m[QR], l[QR];
#pragma unroll
  for (int i = 0; i < QR; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) o[i][e] = 0.f;
  }

  // K and V have one buffer each: K of tile t+1 lands during tile t's P V,
  // V of tile t+1 during tile t+1's Q K^T.
  const int tiles = (nk + BK - 1) / BK;
  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * BK;
    cp_async_wait<1>();  // K of tile t (V of tile t may be in flight)
    __syncthreads();

    float s[QR][KJ];
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

#pragma unroll
    for (int i = 0; i < QR; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        // keys past nk do not exist; masked keys take the finite -1e9
        const int key = k0 + kg + 8 * j;
        s[i][j] = key >= nk ? -INFINITY
                  : (kmask == nullptr || kmask[key]) ? s[i][j] * SCALE2
                                                     : NEG2;
        tmax = fmaxf(tmax, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off *= 2)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      // key k0 exists, so m_new is finite; exp2f(-inf) = 0 on the first tile
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
      for (int e = 0; e < 8; ++e) o[i][e] *= alpha;
    }

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
        const float4 va =
            *reinterpret_cast<const float4*>(Vs + (c + kk) * LDQ + 4 * kg);
        const float4 vb =
            *reinterpret_cast<const float4*>(Vs + (c + kk) * LDQ + 32 + 4 * kg);
#pragma unroll
        for (int i = 0; i < QR; ++i) {
          const float p = lane_of(pf[i], kk);
          o[i][0] = fmaf(p, va.x, o[i][0]);
          o[i][1] = fmaf(p, va.y, o[i][1]);
          o[i][2] = fmaf(p, va.z, o[i][2]);
          o[i][3] = fmaf(p, va.w, o[i][3]);
          o[i][4] = fmaf(p, vb.x, o[i][4]);
          o[i][5] = fmaf(p, vb.y, o[i][5]);
          o[i][6] = fmaf(p, vb.z, o[i][6]);
          o[i][7] = fmaf(p, vb.w, o[i][7]);
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
    float sum = l[i];
#pragma unroll
    for (int off = 1; off < 8; off *= 2)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const int r = q0 + row0 + 4 * i;
    if (r < nq) {
      float* dst = out + size_t(r) * D + 4 * kg;
      *reinterpret_cast<float4*>(dst) =
          make_float4(o[i][0] / sum, o[i][1] / sum, o[i][2] / sum, o[i][3] / sum);
      *reinterpret_cast<float4*>(dst + 32) =
          make_float4(o[i][4] / sum, o[i][5] / sum, o[i][6] / sum, o[i][7] / sum);
    }
  }
}

// One block per (head-sequence, query tile), head-sequence major; bh reads
// mask row bh / heads.
template <int QR>
__global__ void __launch_bounds__(THREADS, 2)
fused_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v,
                       const uint8_t* __restrict__ mask,
                       float* __restrict__ out, int N, int heads, int tiles) {
  extern __shared__ __align__(16) float smem[];
  const int bh = blockIdx.x / tiles;
  const int q0 = (blockIdx.x % tiles) * Tile<QR>::BQ;
  const size_t off = size_t(bh) * N * D;
  attend<QR>(q + off, k + off, v + off,
             mask ? mask + size_t(bh / heads) * N : nullptr, out + off, N, N,
             q0, smem);
}

// Blocks [0, BH * tiles0) give O0 (N rows), the rest O1 (M rows).
template <int QR>
__global__ void __launch_bounds__(THREADS, 2)
bidir_attention_kernel(const float* __restrict__ a0, const float* __restrict__ a1,
                       const float* __restrict__ v0, const float* __restrict__ v1,
                       const uint8_t* __restrict__ m0,
                       const uint8_t* __restrict__ m1, float* __restrict__ o0,
                       float* __restrict__ o1, int N, int M, int heads,
                       int tiles0, int tiles1, int BH) {
  extern __shared__ __align__(16) float smem[];
  // one call site, so the tile's code is in the kernel once
  const bool first = blockIdx.x < unsigned(BH * tiles0);
  const int item = first ? blockIdx.x : blockIdx.x - BH * tiles0;
  const int tiles = first ? tiles0 : tiles1;
  const int bh = item / tiles, q0 = (item % tiles) * Tile<QR>::BQ;
  const int nq = first ? N : M, nk = first ? M : N;
  const uint8_t* km = first ? m1 : m0;
  attend<QR>((first ? a0 : a1) + size_t(bh) * nq * D,
             (first ? a1 : a0) + size_t(bh) * nk * D,
             (first ? v1 : v0) + size_t(bh) * nk * D,
             km ? km + size_t(bh / heads) * nk : nullptr,
             (first ? o0 : o1) + size_t(bh) * nq * D, nq, nk, q0, smem);
}

template <int QR>
cudaError_t raise_smem() {
  cudaError_t e = cudaFuncSetAttribute(
      fused_attention_kernel<QR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(Tile<QR>::SMEM));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(bidir_attention_kernel<QR>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(Tile<QR>::SMEM));
  return e;
}

template <int QR>
cudaError_t blocks_per_sm(int* n) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      n, fused_attention_kernel<QR>, THREADS, Tile<QR>::SMEM);
}

// Per device, once: the kernels' shared-memory limits raised, the SM count
// and the blocks an SM holds at each tile height.
struct Card {
  int sms = 0;
  int per_sm[NQR] = {};
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
    if (e == cudaSuccess) e = raise_smem<8>();
    if (e == cudaSuccess) e = raise_smem<7>();
    if (e == cudaSuccess) e = raise_smem<4>();
    if (e == cudaSuccess) e = blocks_per_sm<8>(&fresh.per_sm[0]);
    if (e == cudaSuccess) e = blocks_per_sm<7>(&fresh.per_sm[1]);
    if (e == cudaSuccess) e = blocks_per_sm<4>(&fresh.per_sm[2]);
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
// the taller tile (fewer K/V passes).
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

bool misaligned(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return true;
  return false;
}

template <int QR>
void launch_fused(const Plan& p, const void* q, const void* k, const void* v,
                  const void* mask, void* out, int N, int heads,
                  cudaStream_t stream) {
  fused_attention_kernel<QR><<<unsigned(p.blocks), THREADS, Tile<QR>::SMEM,
                               stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const uint8_t*>(mask),
      static_cast<float*>(out), N, heads, p.tiles0);
}

template <int QR>
void launch_bidir(const Plan& p, const void* a0, const void* a1,
                  const void* v0, const void* v1, const void* m0,
                  const void* m1, void* o0, void* o1, int BH, int N, int M,
                  int heads, cudaStream_t stream) {
  bidir_attention_kernel<QR><<<unsigned(p.blocks), THREADS, Tile<QR>::SMEM,
                               stream>>>(
      static_cast<const float*>(a0), static_cast<const float*>(a1),
      static_cast<const float*>(v0), static_cast<const float*>(v1),
      static_cast<const uint8_t*>(m0), static_cast<const uint8_t*>(m1),
      static_cast<float*>(o0), static_cast<float*>(o1), N, M, heads,
      p.tiles0, p.tiles1, BH);
}

}  // namespace

// mask may be null (every key valid).
extern "C" int fused_attention_f32(const void* q, const void* k, const void* v,
                                   const void* mask, void* out, int BH, int N,
                                   int heads, void* stream) {
  if (BH < 1 || N < 1) return 0;
  if (misaligned({q, k, v, out}))
    return static_cast<int>(cudaErrorMisalignedAddress);
  Card card;
  cudaError_t e = prepare(&card);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Plan p = choose(BH, N, N, false, card.sms);
  if (p.blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  switch (p.qr) {
    case 8: launch_fused<8>(p, q, k, v, mask, out, N, heads, s); break;
    case 7: launch_fused<7>(p, q, k, v, mask, out, N, heads, s); break;
    default: launch_fused<4>(p, q, k, v, mask, out, N, heads, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// m0 and m1 may be null (every key valid).
extern "C" int bidir_attention_f32(const void* a0, const void* a1,
                                   const void* v0, const void* v1,
                                   const void* m0, const void* m1, void* o0,
                                   void* o1, int BH, int N, int M, int heads,
                                   void* stream) {
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
    case 8: launch_bidir<8>(p, a0, a1, v0, v1, m0, m1, o0, o1, BH, N, M, heads, s); break;
    case 7: launch_bidir<7>(p, a0, a1, v0, v1, m0, m1, o0, o1, BH, N, M, heads, s); break;
    default: launch_bidir<4>(p, a0, a1, v0, v1, m0, m1, o0, o1, BH, N, M, heads, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// The launch plan of either entry point (bidir 0 or 1), for the records:
// out[0..3] = query-tile height, blocks, blocks an SM holds at that height,
// SMs on the card.
extern "C" int attention_f32_plan(int BH, int N, int M, int bidir, void* out) {
  Card card;
  cudaError_t e = prepare(&card);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Plan p = choose(BH, N, M, bidir != 0, card.sms);
  int idx = 0;
  while (idx < NQR - 1 && QRS[idx] != p.qr) ++idx;
  int* o = static_cast<int*>(out);
  o[0] = 16 * p.qr;
  o[1] = p.blocks > INT_MAX ? INT_MAX : int(p.blocks);
  o[2] = card.per_sm[idx];
  o[3] = card.sms;
  return 0;
}
