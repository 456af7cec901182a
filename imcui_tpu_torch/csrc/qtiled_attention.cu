// Q-tiled softmax attention for ViT blocks, bf16 in and out:
//     out = softmax(Q K^T / sqrt(64)) V   per head, no key masked.
//
//   qtiled_attention_bf16  replaces tools/try_vit_attn.py:qtiled_attention
//                          (the body of imcui_tpu/ops/attention.py:
//                          _flash_attn_kernel run with blk_k = nk, n_k = 1),
//                          the attention DINOv2 ViT-L/14 runs in each of its
//                          24 blocks: 16 heads x 1601 tokens x 64 at a 560^2
//                          input.
//   flash_attention_bf16   the bf16 variants of K5, imcui_tpu/ops/
//                          attention.py:_flash_pallas (head dim 64 or 128,
//                          a key mask), through flash_attention.cu's entry
//                          point: the same body, templated (below).
//
// Contract, read off that kernel: q, k, v are bf16 and are widened exactly;
// s = q k^T / 8 in f32; m = max(-1e9, max_k s); p = exp(s - m) in f32;
// l = sum_k p in f32; out = (p v) / max(l, 1e-20), rounded once to bf16. Nq
// and Nk are independent. The TPU pads 1601 tokens to 1664 and masks the
// padding; here the ragged sizes are taken as they are: keys past the end
// weigh 0 and query rows past the end are not written.
//
// Two deviations, stated:
// - The softmax is online over 128-key tiles (the same body with blk_k =
//   128 and n_k > 1): the running maximum rescales the f32 sum l and the f32
//   accumulator by exp(m_old - m_new) at each tile. Every term is the
//   single-pass one times a factor that cancels in the division, up to f32
//   rounding.
// - For the readout on the tensor cores p is rounded to bf16 (relative
//   error 2^-9 per weight; l is summed from the f32 values). The readout is
//   then off by at most 2^-9 * max|v| from the f32 one, beside the 2^-9
//   relative rounding of the bf16 output.
// Both stay inside 2^-7 * max(1, |plain|) + 2^-9 * max|v| of the plain
// version (tests/test_torch_port_vit.py holds the JAX body with n_k > 1 to
// it on the CPU).
//
// What bounds it on an H100: operations. 4 * H * Nq * Nk * 64 flop (10.5
// GFLOP at 16 x 1601 x 1601: 0.011 ms at 989 TFLOP/s bf16) against 13 MB of
// compulsory traffic (0.004 ms). At a head dim of 64 the exponentials take
// as long as the products: 64 x 128 of them a tile at 16 a clock on an SM
// (MUFU.EX2) is 512 clocks, and so are the tile's two products at 4096 flop
// a clock; the tensor cores stay busy only while one warpgroup's softmax
// runs beside another's products.
//
// Design (FlashAttention-3's structure, cut to one head dim):
// - A CTA owns 64 query rows of one head, one consumer warpgroup, and walks
//   all keys of that head; one thread of a producer warpgroup loads the
//   CTA's Q once, then streams K and V tiles (128 keys x 64 bf16, 16 KB,
//   128-byte swizzle) by TMA into two rings of STAGES stages with full and
//   empty mbarriers. setmaxnreg moves the producer's registers to the
//   consumer (24 and 232 a thread, within the 128 x 256 the launch gives a
//   CTA): without it the consumer spills at 128.
// - The consumer warpgroup computes S = Q K^T with four wgmma m64n128k16 (Q
//   and K K-major from shared memory), the online softmax in registers
//   (base 2, log2(e)/8 folded into one FMA; keys >= Nk set to -inf in the
//   last tile), converts P to bf16 in registers (the m64 f32 accumulator's
//   layout is the A-register layout of the next k16 product) and adds P V
//   with eight wgmma m64n64k16, P from registers and V from shared memory
//   MN-major (V's rows are the keys, so B is transposed); the A registers
//   stay live until the product's wait, since it reads them after issue.
// - Two CTAs an SM (73 KB of shared memory each) run one's softmax beside
//   the other's products; being separate CTAs, they drift apart rather than
//   wait on the same barriers in step.
// - The epilogue divides by l, rounds to bf16 and stores each thread's
//   pairs of columns straight from registers, rows < Nq only.
// - At 16 x 1601 that is 416 CTAs, 1.58 rounds on 132 SMs; with 64-row
//   tiles no split of 1601 rows (25 x 64 + 1) gives the busiest SM fewer
//   than 4 x 64 rows.
// Measured against it on an H100 (PERF.md, section 6), none faster: CTAs
// of two or three consumer warpgroups sharing each K/V tile (128 or 192
// rows, one CTA an SM), with FlashAttention-3's overlaps (S_{j+1} issued
// beside P_j V_j inside a warpgroup; warpgroups taking turns by named
// barriers); a third stage in the rings; three CTAs an SM, or a lone
// producer warp; a quarter or an eighth of the exponentials by polynomial
// on the FMA units; four partial maxima and sums a row.
//
// Traps, each named where it is handled:
// - Head boundaries: the tensor maps are 3-D (64, N, H), so TMA zero-fills
//   the ragged last key tile of a head instead of reading the next head's
//   first rows; those zero keys would weigh exp(0 - m), so the last tile's
//   logits past Nk are set to -inf.
// - The ragged last query tile: its rows past Nq are zero-filled on load,
//   computed, and never written (stores are per row, masked).
// - TMA needs 16-byte-aligned bases and strides: the rows are 128 bytes,
//   and the entry point refuses bases that are not 32-byte aligned.
// - ptxas drops wgmma whose results are never read: a build that skips one
//   part must keep the products' results live.
//
// K5's bf16 variants, instances of the same template with K5 = true, keep
// the Pallas body's contract (flash_attention.cu), where three things
// differ from K14:
// - A key mask, row bh / heads of (BH / heads, Nk) bytes. Not by TMA (a
//   byte map needs Nk % 16 == 0): each consumer lane loads the bytes of
//   BK/32 keys of the tile before the tile's Q K^T, which hides their
//   latency, and ballots give every thread the bits of its columns.
//   Keys not live are -inf for the maximum; masked ones then weigh
//   2^(FLOOR2 - m), their logit being -1e9 after scaling, exactly the floor
//   of m. (A raw logit of -1e9 would be -1.8e8 after the 1/8 scale, and a
//   row whose keys are all masked would no longer get the mean of V.) A
//   thread whose columns are all live skips both passes.
// - P in f32: the Pallas body keeps p in f32, and K5's tolerance has no
//   2^-9 * max|v| term. P goes in as a bf16 high part and a bf16 low part,
//   two products of P V into one accumulator (the second costs a third of
//   the tile's tensor-core work).
// - Head dim 128: a row is two 64-column boxes (256 bytes, beyond the
//   128-byte swizzle), loaded as two TMA boxes into one barrier. With
//   64-key tiles (S = Q K^T as eight m64n64k16, O as two m64n64 halves: 32 +
//   64 accumulator registers) a CTA takes 81 KB and two still fit an SM.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>
#include <mutex>

#include "errors.cuh"
#include "hopper.cuh"

namespace {

constexpr int BOX = 128;              // bytes of a box row: 64 bf16 columns
constexpr int BQ = 64;                // query rows of a CTA
constexpr int STAGES = 2;             // depth of the K and the V ring
constexpr int THREADS = 256;          // producer + consumer warpgroup
constexpr int BLOCKS = 2;             // CTAs an SM
constexpr int PRODUCER_REGS = 24;     // a thread, after setmaxnreg
constexpr int CONSUMER_REGS = 232;
static_assert(BLOCKS * 128 * (PRODUCER_REGS + CONSUMER_REGS) <= 65536,
              "registers");
constexpr float LOG2E = 1.4426950408889634f;
constexpr float FLOOR2 = -1e9f * LOG2E;   // the floor of m, base 2

// The tiles of one instance: head dim D (64 or 128: one or two 64-column
// boxes a row) and BK keys a K or V tile. Q at 0, then the K and the V
// ring, then q_full, k_full[S], k_empty[S], v_full[S], v_empty[S]; 1024 B
// to align the swizzle atoms.
template <int D, int BK>
struct Cfg {
  static constexpr int NB = D / 64;             // boxes a row
  static constexpr int Q_BYTES = BQ * 2 * D;
  static constexpr int KV_BYTES = BK * 2 * D;   // one K or V tile
  static constexpr int SMEM_K = Q_BYTES;
  static constexpr int SMEM_V = SMEM_K + STAGES * KV_BYTES;
  static constexpr int SMEM_BARS = SMEM_V + STAGES * KV_BYTES;
  static constexpr int SMEM_BYTES = SMEM_BARS + (1 + 4 * STAGES) * 8 + 1024;
  // 1/sqrt(D), base 2
  static constexpr float SCALE2 = LOG2E * (D == 64 ? 0.125f : 0.08838834764831845f);
  static_assert(BLOCKS * (SMEM_BYTES + 1024) <= 233472, "shared memory");
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// d += A (64 x 16, bf16 in registers) * B (16 x 64, MN-major in shared
// memory: 16 key rows of 64 values).
__device__ __forceinline__ void mma_pv(float (&d)[32], const uint32_t* a,
                                       uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : ACC32("+f", d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// S = Q K^T, raw logits: D/16 products of k16 (m64n128 at BK 128, m64n64
// at 64) over the boxes of Q and K, committed as one group.
template <int D, int BK>
__device__ __forceinline__ void qk(float (&s)[BK / 2], uint32_t q,
                                   uint32_t k) {
#pragma unroll
  for (int kb = 0; kb < D / 16; ++kb) {  // 16 of the D dims a product
    const uint32_t a = q + kb / 4 * BQ * BOX + kb % 4 * 32;
    const uint32_t b = k + kb / 4 * BK * BOX + kb % 4 * 32;
    if constexpr (BK == 128)
      mma(s, desc(a), desc(b), kb);
    else
      mma_n64(s, desc(a), desc(b), kb);
  }
  wgmma_commit();
}

// O += P V over one tile: BK/16 k16 products into each 64-column half of
// O, P's keys 16t ... 16t + 15 in p[4t ... 4t + 3]. Not committed.
template <int D, int BK>
__device__ __forceinline__ void pv(float (&o)[D / 64][32],
                                   const uint32_t (&p)[BK / 4], uint32_t v) {
#pragma unroll
  for (int h = 0; h < D / 64; ++h)
#pragma unroll
    for (int t = 0; t < BK / 16; ++t)
      mma_pv(o[h], p + 4 * t, desc_mn(v + h * BK * BOX + t * 16 * BOX));
}

// The bits of the tile's live keys (and of its masked ones) at this
// thread's columns, from one ballot for each of a lane's BK/32 keys. Lane
// l's key i is column key(l, i) of the tile, chosen so that the columns of
// thread t = lane % 4, 8j + 2t + x, are bit 4 (j % 8) of word x + 2 (j / 8)
// after a shift by t: every word index is known at compile time.
template <int BK>
struct KeyBits {
  static constexpr int KPL = BK / 32;
  static constexpr uint32_t ALL = 0x11111111u;  // bits 4k, k < 8
  uint32_t live[KPL], masked[KPL];

  __device__ __forceinline__ static int key(int lane, int i) {
    return 8 * (lane / 4 + 8 * (i / 2)) + 2 * (lane % 4) + i % 2;
  }

  // mask: this lane's bytes of keys key(lane, i) + k0 (non-zero: valid;
  // keys past nk do not exist)
  __device__ __forceinline__ KeyBits(const uint8_t (&mask)[KPL], int k0,
                                     int nk, int lane) {
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
      const bool exists = k0 + key(lane, i) < nk;
      live[i] = __ballot_sync(0xffffffffu, exists && mask[i] != 0) >> lane % 4;
      masked[i] =
          __ballot_sync(0xffffffffu, exists && mask[i] == 0) >> lane % 4;
    }
  }

  // entry n of the accumulator (column 8j + 2t + x, j = n / 4, x = n % 2)
  __device__ __forceinline__ static bool bit(const uint32_t (&w)[KPL],
                                             int n) {
    return w[n % 2 + 2 * (n / 32)] >> (4 * (n / 4 % 8)) & 1;
  }

  __device__ __forceinline__ bool all_live() const {
    uint32_t a = ALL;
#pragma unroll
    for (int i = 0; i < KPL; ++i) a &= live[i];
    return a == ALL;
  }

  __device__ __forceinline__ bool any_masked() const {
    uint32_t a = 0;
#pragma unroll
    for (int i = 0; i < KPL; ++i) a |= masked[i];
    return (a & ALL) != 0;
  }
};

// The online softmax of one tile of raw logits, base 2, in place: s becomes
// p = 2^(s log2(e) / sqrt(D) - m), m the running maximum of the row (never
// below the floor); l gains the tile's sum after it is rescaled by alpha =
// 2^(m_old - m_new), which the caller applies to O. Keys from `valid` on
// (the zero-filled ones past Nk in the last tile) weigh nothing. With key
// bits (K5), keys that are not live weigh nothing either, except masked
// ones, whose logit is the floor after scaling: they weigh 2^(FLOOR2 - m),
// which is 1 while every key of the row so far is masked and 0 once a live
// one is seen (the -1e9 of the contract, as the floor of m).
// Accumulator layout of m64nN: s[4j + 2e + x] is row 16 warp + lane/4 + 8e,
// column 8j + 2 (lane % 4) + x. Each thread holds two rows, e = 0 and 1.
template <int D, int BK>
__device__ __forceinline__ void softmax(float (&s)[BK / 2], float (&m)[2],
                                        float (&l)[2], float (&alpha)[2],
                                        int valid, int lane,
                                        const KeyBits<BK>* bits) {
  constexpr int NS = BK / 2;
  constexpr float SCALE2 = Cfg<D, BK>::SCALE2;
  bool any_masked = false;
  if (bits != nullptr) {
    if (!bits->all_live()) {
#pragma unroll
      for (int i = 0; i < NS; ++i)
        if (!KeyBits<BK>::bit(bits->live, i)) s[i] = -INFINITY;
    }
    any_masked = bits->any_masked();
  } else if (valid < BK) {
#pragma unroll
    for (int i = 0; i < NS; ++i)
      if ((i / 4) * 8 + (lane % 4) * 2 + (i % 2) >= valid) s[i] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NS; ++i) mx[i / 2 % 2] = fmaxf(mx[i / 2 % 2], s[i]);
#pragma unroll
  for (int e = 0; e < 2; ++e) {  // the four lanes of a row
    mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
    mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
    const float m_new = fmaxf(m[e], mx[e] * SCALE2);
    alpha[e] = ex2(m[e] - m_new);
    m[e] = m_new;
  }
  float pm[2] = {0.f, 0.f};  // the weight of a masked key
  if (any_masked) {
    pm[0] = ex2(FLOOR2 - m[0]);
    pm[1] = ex2(FLOOR2 - m[1]);
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    s[i] = ex2(fmaf(s[i], SCALE2, -m[i / 2 % 2]));
    if (any_masked && KeyBits<BK>::bit(bits->masked, i)) s[i] = pm[i / 2 % 2];
    sum[i / 2 % 2] += s[i];
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) l[e] = l[e] * alpha[e] + sum[e];
}

// P as the A registers of the k16 products: keys 16t ... 16t + 15 are the
// accumulator's columns 8 (2t) ... and 8 (2t + 1) ..., so register 4t + r
// packs s[8t + 2r] and s[8t + 2r + 1]. With lo (K5), P = hi + lo: hi is P
// rounded to bf16 and lo the rest (exact in f32) rounded to bf16, so the
// two products carry P to about 2^-17 of each weight.
template <int N>
__device__ __forceinline__ void to_bf16(uint32_t (&hi)[N / 2],
                                        const float (&s)[N],
                                        uint32_t (*lo)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    hi[i] = pack(s[2 * i], s[2 * i + 1]);
    if (lo != nullptr)
      (*lo)[i] = pack(s[2 * i] - __uint_as_float(hi[i] << 16),
                      s[2 * i + 1] - __uint_as_float(hi[i] & 0xffff0000u));
  }
}

// grid: head-sequences x query tiles, tiles inner; warpgroup 0 loads, 1
// consumes. K14 is <64, 128, false>; K5's bf16 variants <64, 128, true>
// and <128, 64, true>, which read key mask row bh / heads (null: every key
// valid) and carry P as hi + lo.
template <int D, int BK, bool K5>
__global__ void __launch_bounds__(THREADS, BLOCKS)
    qtiled_attention_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            __nv_bfloat16* __restrict__ out,
                            const uint8_t* __restrict__ mask, int nq, int nk,
                            int q_tiles, int heads) {
  using C = Cfg<D, BK>;
  extern __shared__ unsigned char raw[];
  const uint32_t base = (smem_addr(raw) + 1023) & ~1023u;  // swizzle atoms
  const uint32_t qs = base, ks = base + C::SMEM_K, vs = base + C::SMEM_V;
  const uint32_t q_full = base + C::SMEM_BARS, k_full = q_full + 8;
  const uint32_t k_empty = k_full + 8 * STAGES;
  const uint32_t v_full = k_empty + 8 * STAGES;
  const uint32_t v_empty = v_full + 8 * STAGES;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 4);  // lane 0 of every consumer warp
      mbar_init(v_full + 8 * s, 1);
      mbar_init(v_empty + 8 * s, 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int head = blockIdx.x / q_tiles;
  const int q0 = blockIdx.x % q_tiles * BQ;
  const int tiles = (nk + BK - 1) / BK;

  if (threadIdx.x < 128) {  // the producer warpgroup: one thread issues
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS)
                 : "memory");
    if (threadIdx.x == 0) {
      // rows past Nq and keys past Nk of this head come back as zeros
      mbar_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
      for (int b = 0; b < C::NB; ++b)
        tma_load_3d(qs + b * BQ * BOX, &qmap, 64 * b, q0, head, q_full);
      int stage = 0, phase = 0;
      for (int j = 0; j < tiles; ++j) {
        mbar_wait(k_empty + 8 * stage, phase ^ 1);
        mbar_expect_tx(k_full + 8 * stage, C::KV_BYTES);
#pragma unroll
        for (int b = 0; b < C::NB; ++b)
          tma_load_3d(ks + stage * C::KV_BYTES + b * BK * BOX, &kmap, 64 * b,
                      j * BK, head, k_full + 8 * stage);
        mbar_wait(v_empty + 8 * stage, phase ^ 1);
        mbar_expect_tx(v_full + 8 * stage, C::KV_BYTES);
#pragma unroll
        for (int b = 0; b < C::NB; ++b)
          tma_load_3d(vs + stage * C::KV_BYTES + b * BK * BOX, &vmap, 64 * b,
                      j * BK, head, v_full + 8 * stage);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // the consumer warpgroup: query rows q0 ... q0 + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS)
               : "memory");
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  constexpr int KPL = BK / 32;
  const uint8_t* mrow =
      K5 && mask != nullptr ? mask + size_t(head / heads) * nk : nullptr;
  float s[BK / 2], o[D / 64][32], m[2] = {FLOOR2, FLOOR2}, l[2] = {0.f, 0.f};
  float alpha[2];
  uint32_t p[BK / 4], p_lo[BK / 4];
#pragma unroll
  for (int h = 0; h < D / 64; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[h][i] = 0.f;
  mbar_wait(q_full, 0);
  int stage = 0, phase = 0;
  for (int j = 0; j < tiles; ++j) {
    // K5: the mask bytes of this lane's keys of the tile, loaded before the
    // product so that it hides their latency
    uint8_t mb[KPL];
    if constexpr (K5) {
#pragma unroll
      for (int i = 0; i < KPL; ++i) {
        const int key = j * BK + KeyBits<BK>::key(lane, i);
        mb[i] = mrow != nullptr && key < nk ? mrow[key] : 1;
      }
    }
    mbar_wait(k_full + 8 * stage, phase);
    wgmma_fence();
    qk<D, BK>(s, qs, ks + stage * C::KV_BYTES);
    wgmma_wait<0>();
    fence_acc(s);
    if (lane == 0) mbar_arrive(k_empty + 8 * stage);
    if constexpr (K5) {
      const KeyBits<BK> bits(mb, j * BK, nk, lane);
      softmax<D, BK>(s, m, l, alpha, nk - j * BK, lane, &bits);
    } else {
      softmax<D, BK>(s, m, l, alpha, nk - j * BK, lane, nullptr);
    }
#pragma unroll
    for (int h = 0; h < D / 64; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[h][i] *= alpha[i / 2 % 2];
    to_bf16<BK / 2>(p, s, K5 ? &p_lo : nullptr);
    mbar_wait(v_full + 8 * stage, phase);
    wgmma_fence();
    pv<D, BK>(o, p, vs + stage * C::KV_BYTES);
    if constexpr (K5) pv<D, BK>(o, p_lo, vs + stage * C::KV_BYTES);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < D / 64; ++h) fence_acc(o[h]);
    fence_acc(p);  // the products read p from registers until their wait
    if constexpr (K5) fence_acc(p_lo);
    if (lane == 0) mbar_arrive(v_empty + 8 * stage);
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  // ---- epilogue: rows < Nq only ----
  const int row = q0 + 16 * warp + lane / 4;
  __nv_bfloat16* dst = out + (size_t(head) * nq + row) * D + (lane % 4) * 2;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 1);
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 2);
    const float div = fmaxf(l[e], 1e-20f);
    if (row + 8 * e < nq) {
#pragma unroll
      for (int h = 0; h < D / 64; ++h)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          *reinterpret_cast<uint32_t*>(dst + 8 * e * D + 64 * h + 8 * jj) =
              pack(o[h][4 * jj + 2 * e] / div, o[h][4 * jj + 2 * e + 1] / div);
    }
  }
}

// ---------------------------------------------------------------- host

struct Card {
  int sms = 0;
  int per_sm[3] = {};  // CTAs an SM holds: K14, K5 at 64, K5 at 128
};

template <typename Kernel>
cudaError_t fit(Kernel kernel, int smem, int* per_sm) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, THREADS,
                                                      smem);
  return e;
}

// The card's SMs and the CTAs an SM holds, after the kernels' shared-memory
// limits are raised (once per device).
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
    if (e == cudaSuccess)
      e = fit(qtiled_attention_kernel<64, 128, false>, Cfg<64, 128>::SMEM_BYTES, &fresh.per_sm[0]);
    if (e == cudaSuccess)
      e = fit(qtiled_attention_kernel<64, 128, true>, Cfg<64, 128>::SMEM_BYTES, &fresh.per_sm[1]);
    if (e == cudaSuccess)
      e = fit(qtiled_attention_kernel<128, 64, true>, Cfg<128, 64>::SMEM_BYTES, &fresh.per_sm[2]);
    if (e != cudaSuccess) return e;
    c = fresh;
  }
  *card = c;
  return cudaSuccess;
}

// (D, N, H) per tensor, in boxes of 64 columns and `box_rows` rows of one
// head: a box never crosses into the next head.
bool encode_heads(CUtensorMap* map, const void* ptr, int H, int n, int d,
                  int box_rows) {
  const cuuint64_t dims[3] = {cuuint64_t(d), cuuint64_t(n), cuuint64_t(H)};
  const cuuint64_t strides[2] = {cuuint64_t(2 * d), cuuint64_t(n) * 2 * d};
  const cuuint32_t box[3] = {64, cuuint32_t(box_rows), 1};
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr, 3, dims,
                      strides, box);
}

bool misaligned(const void* q, const void* k, const void* v, const void* out) {
  return (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) %
         32;
}

template <int D, int BK, bool K5>
int launch(const void* q, const void* k, const void* v, const void* mask,
           void* out, int H, int Nq, int Nk, int heads, void* stream) {
  const int q_tiles = (Nq + BQ - 1) / BQ;
  if ((long long)H * q_tiles > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  Card card;
  const cudaError_t e = prepare(&card);
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap qmap, kmap, vmap;
  if (!encode_heads(&qmap, q, H, Nq, D, BQ) ||
      !encode_heads(&kmap, k, H, Nk, D, BK) ||
      !encode_heads(&vmap, v, H, Nk, D, BK))
    return IMCUI_TENSOR_MAP_ERROR;
  qtiled_attention_kernel<D, BK, K5>
      <<<H * q_tiles, THREADS, Cfg<D, BK>::SMEM_BYTES,
         static_cast<cudaStream_t>(stream)>>>(
          qmap, kmap, vmap, static_cast<__nv_bfloat16*>(out),
          static_cast<const uint8_t*>(mask), Nq, Nk, q_tiles, heads);
  return static_cast<int>(cudaGetLastError());
}

int write_plan(int H, int Nq, int which, void* out) {
  Card card;
  const cudaError_t e = prepare(&card);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long ctas = (long long)H * ((Nq + BQ - 1) / BQ);
  int* o = static_cast<int*>(out);
  o[0] = BQ;
  o[1] = ctas > INT_MAX ? INT_MAX : int(ctas);
  o[2] = card.per_sm[which];
  o[3] = card.sms;
  return 0;
}

}  // namespace

// q, out: (H, Nq, 64) bf16; k, v: (H, Nk, 64) bf16; all contiguous and
// 32-byte aligned.
extern "C" int qtiled_attention_bf16(const void* q, const void* k,
                                     const void* v, void* out, int H, int Nq,
                                     int Nk, void* stream) {
  if (H < 1 || Nq < 1 || Nk < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (misaligned(q, k, v, out))
    return static_cast<int>(cudaErrorMisalignedAddress);
  return launch<64, 128, false>(q, k, v, nullptr, out, H, Nq, Nk, 1, stream);
}

// K5 in bf16 (flash_attention.cu's entry point): q, out (BH, Nq, dh); k, v
// (BH, Nk, dh); mask (BH / heads, Nk) bytes or null; dh 64 or 128; all
// contiguous, the tensors 32-byte aligned.
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, const void* mask,
                                    void* out, int BH, int Nq, int Nk,
                                    int heads, int dh, void* stream) {
  if (BH < 1 || Nq < 1 || Nk < 1 || heads < 1 || (dh != 64 && dh != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  if (misaligned(q, k, v, out))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (dh == 64)
    return launch<64, 128, true>(q, k, v, mask, out, BH, Nq, Nk, heads,
                                 stream);
  return launch<128, 64, true>(q, k, v, mask, out, BH, Nq, Nk, heads, stream);
}

// The launch plan at this shape, for the records: out[0..3] = query rows a
// CTA, CTAs, CTAs an SM holds, SMs on the card.
extern "C" int qtiled_attention_plan(int H, int Nq, int Nk, void* out) {
  if (H < 1 || Nq < 1 || Nk < 1) return static_cast<int>(cudaErrorInvalidValue);
  return write_plan(H, Nq, 0, out);
}

// K5's bf16 plan, as qtiled_attention_plan reports it.
extern "C" int flash_attention_bf16_plan(int BH, int Nq, int dh, void* out) {
  if (BH < 1 || Nq < 1 || (dh != 64 && dh != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  return write_plan(BH, Nq, dh == 64 ? 1 : 2, out);
}
