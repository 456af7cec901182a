// Q-tiled softmax attention for ViT blocks, bf16 in and out:
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

constexpr int D = 64;                 // head dim: one 128-byte row
constexpr int ROW = 2 * D;            // bytes of a row
constexpr int BQ = 64;                // query rows of a CTA
constexpr int BK = 128;               // keys of a K or V tile
constexpr int STAGES = 2;             // depth of the K and the V ring
constexpr int THREADS = 256;          // producer + consumer warpgroup
constexpr int BLOCKS = 2;             // CTAs an SM
constexpr int PRODUCER_REGS = 24;     // a thread, after setmaxnreg
constexpr int CONSUMER_REGS = 232;
static_assert(BLOCKS * 128 * (PRODUCER_REGS + CONSUMER_REGS) <= 65536,
              "registers");
constexpr int Q_BYTES = BQ * ROW;
constexpr int KV_BYTES = BK * ROW;    // one K or V tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float SCALE2 = LOG2E / 8.0f;    // 1/sqrt(64), base 2
constexpr float FLOOR2 = -1e9f * LOG2E;   // the floor of m, base 2

// Q at 0, then the K and the V ring, then q_full, k_full[S], k_empty[S],
// v_full[S], v_empty[S]; 1024 B to align the swizzle atoms.
constexpr int SMEM_K = Q_BYTES;
constexpr int SMEM_V = SMEM_K + STAGES * KV_BYTES;
constexpr int SMEM_BARS = SMEM_V + STAGES * KV_BYTES;
constexpr int SMEM_BYTES = SMEM_BARS + (1 + 4 * STAGES) * 8 + 1024;
static_assert(BLOCKS * (SMEM_BYTES + 1024) <= 233472, "shared memory");

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

// S = Q K^T, raw logits: four m64n128k16 over the 64 dims, committed as
// one group.
__device__ __forceinline__ void qk(float (&s)[64], uint32_t q, uint32_t k) {
#pragma unroll
  for (int kb = 0; kb < ROW / 32; ++kb)  // 16 of the 64 dims a product
    mma(s, desc(q + kb * 32), desc(k + kb * 32), kb);
  wgmma_commit();
}

// O += P V over one tile: eight k16 products, committed as one group.
__device__ __forceinline__ void pv(float (&o)[32], const uint32_t (&p)[32],
                                   uint32_t v) {
#pragma unroll
  for (int t = 0; t < BK / 16; ++t)
    mma_pv(o, p + 4 * t, desc_mn(v + t * 16 * ROW));
  wgmma_commit();
}

// The online softmax of one tile of raw logits, base 2, in place: s becomes
// p = 2^(s log2(e) / 8 - m), m the running maximum of the row (never below
// the floor); l gains the tile's sum after it is rescaled by alpha =
// 2^(m_old - m_new), which the caller applies to O. Keys from `valid` on
// (the zero-filled ones past Nk in the last tile) weigh nothing.
// Accumulator layout of m64nN: s[4j + 2e + x] is row 16 warp + lane/4 + 8e,
// column 8j + 2 (lane % 4) + x. Each thread holds two rows, e = 0 and 1.
__device__ __forceinline__ void softmax(float (&s)[64], float (&m)[2],
                                        float (&l)[2], float (&alpha)[2],
                                        int valid, int lane) {
  if (valid < BK) {
#pragma unroll
    for (int i = 0; i < 64; ++i)
      if ((i / 4) * 8 + (lane % 4) * 2 + (i % 2) >= valid) s[i] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) mx[i / 2 % 2] = fmaxf(mx[i / 2 % 2], s[i]);
#pragma unroll
  for (int e = 0; e < 2; ++e) {  // the four lanes of a row
    mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
    mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
    const float m_new = fmaxf(m[e], mx[e] * SCALE2);
    alpha[e] = ex2(m[e] - m_new);
    m[e] = m_new;
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    s[i] = ex2(fmaf(s[i], SCALE2, -m[i / 2 % 2]));
    sum[i / 2 % 2] += s[i];
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) l[e] = l[e] * alpha[e] + sum[e];
}

// P as the A registers of the k16 products: keys 16t ... 16t + 15 are the
// accumulator's columns 8 (2t) ... and 8 (2t + 1) ..., so register 4t + r
// packs s[8t + 2r] and s[8t + 2r + 1].
__device__ __forceinline__ void to_bf16(uint32_t (&p)[32],
                                        const float (&s)[64]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) p[i] = pack(s[2 * i], s[2 * i + 1]);
}

// grid: heads x query tiles, tiles inner; warpgroup 0 loads, 1 consumes
__global__ void __launch_bounds__(THREADS, BLOCKS)
    qtiled_attention_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            __nv_bfloat16* __restrict__ out, int nq, int nk,
                            int q_tiles) {
  extern __shared__ unsigned char raw[];
  const uint32_t base = (smem_addr(raw) + 1023) & ~1023u;  // swizzle atoms
  const uint32_t qs = base, ks = base + SMEM_K, vs = base + SMEM_V;
  const uint32_t q_full = base + SMEM_BARS, k_full = q_full + 8;
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
      mbar_expect_tx(q_full, Q_BYTES);
      tma_load_3d(qs, &qmap, 0, q0, head, q_full);
      int stage = 0, phase = 0;
      for (int j = 0; j < tiles; ++j) {
        mbar_wait(k_empty + 8 * stage, phase ^ 1);
        mbar_expect_tx(k_full + 8 * stage, KV_BYTES);
        tma_load_3d(ks + stage * KV_BYTES, &kmap, 0, j * BK, head,
                    k_full + 8 * stage);
        mbar_wait(v_empty + 8 * stage, phase ^ 1);
        mbar_expect_tx(v_full + 8 * stage, KV_BYTES);
        tma_load_3d(vs + stage * KV_BYTES, &vmap, 0, j * BK, head,
                    v_full + 8 * stage);
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
  float s[64], o[32], m[2] = {FLOOR2, FLOOR2}, l[2] = {0.f, 0.f};
  float alpha[2];
  uint32_t p[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  mbar_wait(q_full, 0);
  int stage = 0, phase = 0;
  for (int j = 0; j < tiles; ++j) {
    mbar_wait(k_full + 8 * stage, phase);
    wgmma_fence();
    qk(s, qs, ks + stage * KV_BYTES);
    wgmma_wait<0>();
    fence_acc(s);
    if (lane == 0) mbar_arrive(k_empty + 8 * stage);
    softmax(s, m, l, alpha, nk - j * BK, lane);
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] *= alpha[i / 2 % 2];
    to_bf16(p, s);
    mbar_wait(v_full + 8 * stage, phase);
    wgmma_fence();
    pv(o, p, vs + stage * KV_BYTES);
    wgmma_wait<0>();
    fence_acc(o);
    fence_acc(p);  // the product read p from registers until its wait
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
      for (int jj = 0; jj < D / 8; ++jj)
        *reinterpret_cast<uint32_t*>(dst + 8 * e * D + 8 * jj) =
            pack(o[4 * jj + 2 * e] / div, o[4 * jj + 2 * e + 1] / div);
    }
  }
}

// ---------------------------------------------------------------- host

struct Card {
  int sms = 0;
  int per_sm = 0;  // CTAs an SM holds
};

// The card's SMs and the CTAs an SM holds, after the kernel's shared-memory
// limit is raised (once per device).
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
      e = cudaFuncSetAttribute(qtiled_attention_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &fresh.per_sm, qtiled_attention_kernel, THREADS, SMEM_BYTES);
    if (e != cudaSuccess) return e;
    c = fresh;
  }
  *card = c;
  return cudaSuccess;
}

// (64, N, H) per tensor, in boxes of `box_rows` rows of one head: a box
// never crosses into the next head.
bool encode_heads(CUtensorMap* map, const void* ptr, int H, int n,
                  int box_rows) {
  const cuuint64_t dims[3] = {D, cuuint64_t(n), cuuint64_t(H)};
  const cuuint64_t strides[2] = {ROW, cuuint64_t(n) * ROW};
  const cuuint32_t box[3] = {D, cuuint32_t(box_rows), 1};
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr, 3, dims,
                      strides, box);
}

}  // namespace

// q, out: (H, Nq, 64) bf16; k, v: (H, Nk, 64) bf16; all contiguous and
// 32-byte aligned.
extern "C" int qtiled_attention_bf16(const void* q, const void* k,
                                     const void* v, void* out, int H, int Nq,
                                     int Nk, void* stream) {
  if (H < 1 || Nq < 1 || Nk < 1) return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) % 32)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int q_tiles = (Nq + BQ - 1) / BQ;
  if ((long long)H * q_tiles > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  Card card;
  const cudaError_t e = prepare(&card);
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap qmap, kmap, vmap;
  if (!encode_heads(&qmap, q, H, Nq, BQ) ||
      !encode_heads(&kmap, k, H, Nk, BK) ||
      !encode_heads(&vmap, v, H, Nk, BK))
    return IMCUI_TENSOR_MAP_ERROR;
  qtiled_attention_kernel<<<H * q_tiles, THREADS, SMEM_BYTES,
                            static_cast<cudaStream_t>(stream)>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(out), Nq, Nk, q_tiles);
  return static_cast<int>(cudaGetLastError());
}

// The launch plan at this shape, for the records: out[0..3] = query rows a
// CTA, CTAs, CTAs an SM holds, SMs on the card.
extern "C" int qtiled_attention_plan(int H, int Nq, int Nk, void* out) {
  if (H < 1 || Nq < 1 || Nk < 1) return static_cast<int>(cudaErrorInvalidValue);
  Card card;
  const cudaError_t e = prepare(&card);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long ctas = (long long)H * ((Nq + BQ - 1) / BQ);
  int* o = static_cast<int*>(out);
  o[0] = BQ;
  o[1] = ctas > INT_MAX ? INT_MAX : int(ctas);
  o[2] = card.per_sm;
  o[3] = card.sms;
  return 0;
}
