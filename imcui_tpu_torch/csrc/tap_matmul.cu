// Tap-sum matrix product, bf16 or int8 in, bf16 out:
//     out[m, n] = bf16( sum_r sum_k x[m, k] * w_r[k, n] ),   K = 128,
// summed in f32 (bf16 inputs) or int32 (int8 inputs) and rounded once to
// bf16, round-to-nearest-even (an int32 sum through float where it fits
// float's mantissa, else through double: either holds it exactly).
//
//   tap_matmul_bf16, tap_matmul_s8  replace the six stage-tail probes of
//   the JAX package's tools/ (K8-K13): try_nscaling.py:bench,
//   try_tail_mini.py:k, try_tail_mini2.py:mk (k2d, k2d_concat),
//   try_int8_tail.py:bench (bf16/f32 and int8/int32), try_tail_variants.py:
//   run (k_chain, k_concat) and try_widen.py:mk (k_chain, k_wide). Each
//   body computes this one function (the shifts of a true 3x3 conv are
//   ignored, try_tail_variants.py:1-3: every tap reads the same x); what
//   differs between them is TPU layout: 9 chained K=128 dots, a lane
//   concatenation to K=384 or K=1152, one wide (128, 1152) dot with lane-
//   slice sums, the wc and T tiles. On Hopper the sum over taps is the K
//   loop of the product, so one kernel serves all six.
//
// w arrives K-major, wt (R, N, 128) with wt[r, n, k] = w_r[k, n]: the
// wrapper transposes either layout of w into it (one copy of R N 128
// elements), because wgmma reads an int8 B only K-major.
//
// What bounds it on an H100: operations at the stage-tail shape (M = 4 Mi
// rows, R = 9, N = 128: 1237 GFLOP, 1.251 ms at 989 TFLOP/s bf16, 0.625 ms
// at 1979 TOPS int8, against 2.15 / 1.61 GB of compulsory traffic, 0.64 /
// 0.48 ms at 3.35 TB/s); bytes for K8's products with N >= 512 (the bf16
// output: 2 N bytes a row against 256 read), so there the output's stores
// must overlap the products.
//
// Design (Hopper's warp-specialised GEMM, cut to K = 128):
// - Work items are (256-row tile, 128-column tile) pairs, columns inner.
//   A persistent grid of one CTA per SM gives each CTA one contiguous run
//   of items, so a CTA reloads x only when its row tile changes (once per
//   item at N = 128, once per N / 128 items at K8's wide N).
// - One producer warp streams w tiles (128 columns x 128 deep, one tap)
//   through a ring of shared-memory stages guarded by mbarriers (full:
//   TMA's byte count; empty: the consumers' release); a second producer
//   warp loads each 256-row x tile once into a single buffer, which the
//   consumers release after the last product of its rows. The w producer
//   prefetches the next row tile's x into L2 when it reaches the last item
//   of the present one, and the output is stored with an evict-first L2
//   policy, so the prefetched x (and w) stay in L2 while the output
//   streams through it. All loads are TMA with 128-byte swizzle; rows
//   past M are zero-filled by TMA, so nothing is masked. A bf16 row
//   (256 B) is two 64-element boxes, an int8 row one.
// - Two consumer warpgroups (setmaxnreg moves registers to them from the
//   producer warpgroup) own 128 rows each, as two m64 accumulators of
//   m64n128 that stay in registers across the R taps: per tap
//   wgmma.mma_async m64n128k16 bf16 (8 per 128-deep tap) or m64n128k32 s8
//   (4 per tap) from the swizzled tiles. Every w tile feeds 256 rows, half
//   the L2-to-shared traffic per flop of a 128-row block. One tap's
//   products stay in flight while the next tap's are issued; the stage is
//   released when they complete.
// - Epilogue: each warpgroup rounds its 128 x 128 block to bf16 into its
//   own 32 KB output stage (the 128-byte swizzle keeps the stores free of
//   bank conflicts), one box of 64 columns at a time, and one thread
//   issues a TMA store per box, which clips rows past M. A box's store is
//   waited for (reads done) only before that box is rewritten, one item
//   later, so the stores overlap the next item's products and the other
//   box's rounding: the output bytes that bound K8 leave while the tensor
//   cores work.
// - int8 sums below 2^22 in magnitude (all of the probes') become floats
//   with one integer add and one subtraction and round once to bf16 like
//   the bf16 path's; only larger ones take the two 64-bit conversions
//   (16 a clock on an SM) that would otherwise dominate int8's epilogue.
// - Shared memory, bf16: x 64 KB + three w stages of 32 KB + 64 KB output
//   = 224 KB of the 227 KB a block may have; int8: 32 + 6 x 16 + 64 KB.
//   A second x buffer (for two w stages) or a third output box per
//   warpgroup measured no faster, and two w stages slowed the tail.
//
// The C entry points encode the three tensor maps on every call, with
// cuTensorMapEncodeTiled taken from the driver at run time (no -lcuda,
// hopper.cuh), and pass them as __grid_constant__ parameters. The mbarrier,
// TMA-load and wgmma helpers are hopper.cuh's, shared with
// qtiled_attention.cu.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

#include "errors.cuh"
#include "hopper.cuh"

namespace {

constexpr int K = 128;         // depth of every tap: 128 elements a row
constexpr int BM = 256;        // rows of an item, 128 per consumer warpgroup
constexpr int BN = 128;        // columns of an item
constexpr int ROW = 128;       // bytes of a swizzled box row
constexpr int THREADS = 384;   // producer warpgroup + two consumer warpgroups
constexpr int CONSUMER_WARPS = 8;
constexpr int OUT_BOX = 128 * ROW;         // 128 rows x 64 bf16 columns
constexpr int OUT_BYTES = 2 * 2 * OUT_BOX;  // two warpgroups x two boxes

template <typename T>
struct Cfg;

template <>
struct Cfg<__nv_bfloat16> {
  using Acc = float;
  static constexpr int BOXES = 2;  // 64-element boxes to a 128-deep row
  static constexpr int STAGES = 3;
  static constexpr CUtensorMapDataType TMA = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};

template <>
struct Cfg<int8_t> {
  using Acc = int;
  static constexpr int BOXES = 1;
  static constexpr int STAGES = 6;
  static constexpr CUtensorMapDataType TMA = CU_TENSOR_MAP_DATA_TYPE_UINT8;
};

template <typename T>
struct Smem {
  static constexpr int X = Cfg<T>::BOXES * BM * ROW;  // x tile
  static constexpr int W = Cfg<T>::BOXES * BN * ROW;  // one w stage
  static constexpr int OUT = X + Cfg<T>::STAGES * W;
  static constexpr int BARS = OUT + OUT_BYTES;
  // full[STAGES], empty[STAGES], x_full, x_empty; 1024 B for alignment
  static constexpr int BYTES = BARS + (2 * Cfg<T>::STAGES + 2) * 8 + 1024;
};
static_assert(Smem<__nv_bfloat16>::BYTES <= 232448, "bf16 shared memory");
static_assert(Smem<int8_t>::BYTES <= 232448, "int8 shared memory");

// ---------------------------------------------------------------- PTX

// The same box into L2 only, ahead of its load.
__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.prefetch.tensor.2d.L2.global [%0, {%1, %2}];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1)
      : "memory");
}

// L2 policy for the output: its lines are the first to leave L2, ahead of
// w and of the prefetched x.
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0, {%2, %3}], [%1], %4;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until all but the newest `N` of this thread's bulk store groups have
// read their shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// d (+)= A (64 x 32, K-major) * B (32 x 128, K-major), int8 in, int32 sums.
__device__ __forceinline__ void mma(int (&d)[64], uint64_t a, uint64_t b,
                                    int scale) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " REGS64
      ", %64, %65, p;\n"
      "}\n"
      : ACC64("+r", d)
      : "l"(a), "l"(b), "r"(scale));
}

// |v| <= 2^22 as a float, exactly and without a conversion instruction:
// v added to the bits of 1.5 * 2^23 stays in its mantissa.
__device__ __forceinline__ float small_to_float(int v) {
  return __int_as_float(0x4B400000 + v) - 12582912.0f;
}

__device__ __forceinline__ bool small(int v) {
  return uint32_t(v + (1 << 22)) < (1u << 23);
}

// Exact sums rounded once to bf16: through float where they fit its
// mantissa (the probes' sums all do), else through double, which holds
// every int32.
__device__ __forceinline__ uint32_t pack(int lo, int hi) {
  if (small(lo) && small(hi))
    return pack(small_to_float(lo), small_to_float(hi));
  return uint32_t(__bfloat16_as_ushort(__double2bfloat16(double(lo)))) |
         (uint32_t(__bfloat16_as_ushort(__double2bfloat16(double(hi))))
          << 16);
}

// ---------------------------------------------------------------- kernel

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    tap_matmul_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap wmap,
                      const __grid_constant__ CUtensorMap omap, int M, int N,
                      int R, int col_tiles, long long items) {
  using C = Cfg<T>;
  using S = Smem<T>;
  constexpr int STAGES = C::STAGES;
  extern __shared__ unsigned char raw[];
  const uint32_t base = (smem_addr(raw) + 1023) & ~1023u;  // swizzle atoms
  const uint32_t xs = base, ws = base + S::X, os = base + S::OUT;
  const uint32_t full = base + S::BARS, empty = full + 8 * STAGES;
  const uint32_t x_full = empty + 8 * STAGES, x_empty = x_full + 8;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMER_WARPS);
    }
    mbar_init(x_full, 1);
    mbar_init(x_empty, CONSUMER_WARPS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // this CTA's contiguous run of items; item = row tile * col_tiles + col
  const long long begin = items * blockIdx.x / gridDim.x;
  const long long end = items * (blockIdx.x + 1) / gridDim.x;
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;

  if (threadIdx.x < 128) {  // producers: warp 0 streams w, warp 1 loads x
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 0 && lane == 0) {
      int stage = 0, phase = 0;
      for (long long it = begin; it < end; ++it) {
        const int n0 = int(it % col_tiles) * BN;
        if (it + 1 < end && (it + 1) % col_tiles == 0)  // next row tile to L2
          for (int b = 0; b < C::BOXES; ++b)
            tma_prefetch(&xmap, b * (K / C::BOXES),
                         int((it + 1) / col_tiles * BM));
        for (int r = 0; r < R; ++r) {
          mbar_wait(empty + 8 * stage, phase ^ 1);
          mbar_expect_tx(full + 8 * stage, S::W);
          for (int b = 0; b < C::BOXES; ++b)
            tma_load(ws + stage * S::W + b * BN * ROW, &wmap,
                     b * (K / C::BOXES), r * N + n0, full + 8 * stage);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    } else if (warp == 1 && lane == 0) {
      int phase = 0;
      for (long long mt = begin / col_tiles; mt <= (end - 1) / col_tiles;
           ++mt) {
        mbar_wait(x_empty, phase ^ 1);
        phase ^= 1;
        mbar_expect_tx(x_full, S::X);
        for (int b = 0; b < C::BOXES; ++b)
          tma_load(xs + b * BM * ROW, &xmap, b * (K / C::BOXES), int(mt * BM),
                   x_full);
      }
    }
  } else {  // consumers: warpgroup cw owns rows 128 cw ... of each item
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = threadIdx.x / 128 - 1, t = threadIdx.x % 128;
    const uint32_t xa = xs + cw * 128 * ROW;          // this warpgroup's rows
    const uint32_t ob = os + cw * 2 * OUT_BOX;        // its output stage
    const uint64_t policy = evict_first();
    typename C::Acc acc[2][64];
    int stage = 0, phase = 0, x_phase = 0;
    long long mt_cur = -1;
    for (long long it = begin; it < end; ++it) {
      const long long mt = it / col_tiles;
      const int nt = int(it % col_tiles);
      if (mt != mt_cur) {
        mbar_wait(x_full, x_phase);
        x_phase ^= 1;
        mt_cur = mt;
      }
      int prev = 0;
      for (int r = 0; r < R; ++r) {
        mbar_wait(full + 8 * stage, phase);
        fence_acc(acc[0]);
        fence_acc(acc[1]);
        wgmma_fence();
        const uint32_t wb = ws + stage * S::W;
#pragma unroll
        for (int b = 0; b < C::BOXES; ++b)
#pragma unroll
          for (int kb = 0; kb < ROW / 32; ++kb) {  // 32 bytes of K a product
            const uint64_t bd = desc(wb + b * BN * ROW + kb * 32);
            const uint32_t a = xa + b * BM * ROW + kb * 32;
            const int scale = (r | b | kb) != 0;
            mma(acc[0], desc(a), bd, scale);
            mma(acc[1], desc(a + 64 * ROW), bd, scale);
          }
        wgmma_commit();
        fence_acc(acc[0]);
        fence_acc(acc[1]);
        if (r > 0) {  // the previous tap's products are done: free its stage
          wgmma_wait<1>();
          fence_acc(acc[0]);
          fence_acc(acc[1]);
          if (lane == 0) mbar_arrive(empty + 8 * prev);
        }
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      if (lane == 0) {
        mbar_arrive(empty + 8 * prev);
        if (it + 1 == end || (it + 1) / col_tiles != mt) mbar_arrive(x_empty);
      }

      // epilogue: bf16 into the output stage and one TMA store per box of
      // 64 columns, each its own bulk group, so a box waits only for its
      // own store of the previous item while the other box's drains. A
      // warpgroup whose rows all lie past M skips it whole: it commits no
      // group, so its writes would not wait for the last box still stored
      const long long row0 = mt * BM + cw * 128;
      if (row0 >= M) continue;
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        if (t == 0) bulk_wait_read<1>();  // box b's last store has read it
        named_sync(1 + cw);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 8 * b; j < 8 * b + 8; ++j)  // 8-column group
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int row = h * 64 + warp * 16 + lane / 4 + 8 * e;
              const uint32_t at = ob + b * OUT_BOX + row * ROW +
                                  ((j % 8) ^ (lane / 4)) * 16 + (lane % 4) * 4;
              st_shared(at, pack(acc[h][4 * j + 2 * e],
                                 acc[h][4 * j + 2 * e + 1]));
            }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        named_sync(1 + cw);
        if (t == 0) {
          tma_store(&omap, ob + b * OUT_BOX, nt * BN + 64 * b, int(row0),
                    policy);
          bulk_commit();
        }
      }
    }
    if (t == 0) bulk_wait();
  }
}

// ---------------------------------------------------------------- host

// SMs of `device`, after the kernel's shared-memory limit is raised there
// (once per device); a negative cudaError_t on failure.
template <typename T>
int prepare(int device) {
  static std::mutex mu;
  static int sms[64] = {};
  if (device < 0 || device >= 64) return -int(cudaErrorInvalidDevice);
  std::lock_guard<std::mutex> lock(mu);
  if (sms[device] == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        tap_matmul_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Smem<T>::BYTES);
    int n = 0;
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return -int(e);
    sms[device] = n;
  }
  return sms[device];
}

template <typename T>
int launch(const void* x, const void* wt, void* out, int M, int N, int R,
           void* stream) {
  using C = Cfg<T>;
  if (M < 1 || N < BN || N % BN || R < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wt) |
       reinterpret_cast<uintptr_t>(out)) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int sms = prepare<T>(device);
  if (sms < 0) return -sms;
  CUtensorMap xmap, wmap, omap;
  const uint32_t box_k = K / C::BOXES;
  if (!encode(&xmap, C::TMA, x, M, K, K * sizeof(T), BM, box_k) ||
      !encode(&wmap, C::TMA, wt, uint64_t(R) * N, K, K * sizeof(T), BN,
              box_k) ||
      !encode(&omap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, out, M, N, 2ull * N,
              128, 64))
    return IMCUI_TENSOR_MAP_ERROR;
  const int col_tiles = N / BN;
  const long long items = (M + (long long)BM - 1) / BM * col_tiles;
  const int grid = static_cast<int>(items < sms ? items : sms);
  tap_matmul_kernel<T><<<grid, THREADS, Smem<T>::BYTES,
                         static_cast<cudaStream_t>(stream)>>>(
      xmap, wmap, omap, M, N, R, col_tiles, items);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (M, 128), wt: (R, N, 128) K-major taps, out: (M, N) bf16; all
// contiguous and 16-byte aligned, N a multiple of 128.
extern "C" int tap_matmul_bf16(const void* x, const void* wt, void* out, int M,
                               int N, int R, void* stream) {
  return launch<__nv_bfloat16>(x, wt, out, M, N, R, stream);
}

extern "C" int tap_matmul_s8(const void* x, const void* wt, void* out, int M,
                             int N, int R, void* stream) {
  return launch<int8_t>(x, wt, out, M, N, R, stream);
}
