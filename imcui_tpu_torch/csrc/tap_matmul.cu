// Tap-sum matrix product, bf16 or int8 in, bf16 out:
//     out[m, n] = bf16( sum_r sum_k x[m, k] * w_r[k, n] ),   K = 128,
// summed in f32 (bf16 inputs) or int32 (int8 inputs) and rounded once to
// bf16, round-to-nearest-even.
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
// Layouts of w, read in place through two strides: tap r's (128, N) matrix
// starts at w + r * tap_stride, its rows are ldw elements apart. "taps"
// (R, 128, N): tap_stride = 128 N, ldw = N. "wide" (128, R N) with
// w_wide[k, r N + n] = w_r[k, n] (K13's k_wide): tap_stride = N, ldw = R N.
//
// What bounds it on an H100: operations at the stage-tail shape (M = 4 Mi
// rows, R = 9, N = 128: 1237 GFLOP, 1.251 ms at 989 TFLOP/s bf16, 0.625 ms
// at 1979 TOPS int8, against 2.15 / 1.61 GB of compulsory traffic, 0.64 /
// 0.48 ms at 3.35 TB/s); bytes for the wide single-tap products of K8 (R = 1,
// N >= 512: the bf16 output dominates).
//
// Design, a simple first version. A block owns 128 rows of x and keeps them
// in shared memory for every tap and every 128-column tile of the output;
// it streams one 128 x 128 tap of w at a time through two buffers filled by
// cp.async, so the next tap arrives while the tensor cores work on this one
// (all nine bf16 taps, 288 KB, would not fit the 227 KB a block may have).
// Eight warps, 4 x 2, each own 32 rows x 64 columns: eight WMMA 16x16x16
// accumulators stay in registers across the taps, and the epilogue rounds
// them to bf16 through a 1 KB scratch per warp. A ragged last row tile is
// zero-filled on load and masked on store. wgmma and TMA are later work.
//
// Shared-memory layouts. bf16: row-major, rows padded to 136 elements
// (272 B), so fragment pointers stay 32-byte aligned and the eight rows of
// an ldmatrix phase fall on distinct banks. int8: a row-major tile would put
// every odd 16-deep k step at a 16-byte offset, below WMMA's 32-byte
// alignment, so the tile is stored as eight column blocks of 16 bytes x 128
// rows (ldm = 16): every fragment pointer is 256-byte aligned and the eight
// rows of an ldmatrix phase are 128 contiguous bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int K = 128;      // depth of every tap
constexpr int TILE = 128;   // rows of x per block; columns of a tap tile
constexpr int WARPS = 8;    // 4 x 2 warps of 32 rows x 64 columns
constexpr int THREADS = WARPS * 32;

template <typename T>
struct Tile;

template <>
struct Tile<__nv_bfloat16> {
  using In = __nv_bfloat16;
  using Acc = float;
  static constexpr int LD = K + 8;
  static constexpr int ELEMS = TILE * LD;
  __device__ static int at(int row, int col) { return row * LD + col; }
  // 16-byte chunk i of a 128 x 128 tile: 16 to a row, neighbouring threads
  // on neighbouring chunks.
  __device__ static void chunk(int i, int& row, int& col) {
    row = i / 16;
    col = (i % 16) * 8;
  }
  __device__ static __nv_bfloat16 round(float v) { return __float2bfloat16_rn(v); }
};

template <>
struct Tile<int8_t> {
  using In = signed char;
  using Acc = int;
  static constexpr int LD = 16;
  static constexpr int ELEMS = TILE * K;
  __device__ static int at(int row, int col) {
    return (col / 16) * (TILE * 16) + row * 16 + col % 16;
  }
  // 8 chunks to a row; the 32 chunks of one warp's turn are 8 rows x 4
  // column blocks: 64 contiguous bytes of each row in global memory, 128
  // contiguous bytes of each column block in shared memory.
  __device__ static void chunk(int i, int& row, int& col) {
    const int lane = i % 32, g = i / 32;
    row = (g / 2) * 8 + lane % 8;
    col = ((g % 2) * 4 + lane / 8) * 16;
  }
  // exact: an int32 is a double, and the conversion rounds once
  __device__ static __nv_bfloat16 round(int v) {
    return __double2bfloat16(static_cast<double>(v));
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

// A 128 x 128 tile whose rows are `ld` elements apart in global memory;
// rows from `valid` on are zero-filled.
template <typename T>
__device__ __forceinline__ void load_tile(typename Tile<T>::In* dst,
                                          const typename Tile<T>::In* src,
                                          size_t ld, int valid) {
  constexpr int CHUNKS = TILE * K * int(sizeof(T)) / 16;
  for (int i = threadIdx.x; i < CHUNKS; i += THREADS) {
    int row, col;
    Tile<T>::chunk(i, row, col);
    const bool ok = row < valid;
    cp_async16(dst + Tile<T>::at(row, col), src + (ok ? row * ld + col : 0), ok);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
tap_matmul_kernel(const typename Tile<T>::In* __restrict__ x,
                  const typename Tile<T>::In* __restrict__ w,
                  __nv_bfloat16* __restrict__ out, int M, int N, int R,
                  int tap_stride, int ldw) {
  using In = typename Tile<T>::In;
  using Acc = typename Tile<T>::Acc;
  constexpr int E = Tile<T>::ELEMS, LD = Tile<T>::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  In* xs = reinterpret_cast<In*>(smem);
  In* ws = xs + E;  // two tap buffers
  Acc* scr = reinterpret_cast<Acc*>(ws + 2 * E) + (threadIdx.x / 32) * 256;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = (warp / 2) * 32, wc = (warp % 2) * 64;  // warp's first row, column
  const int m0 = blockIdx.x * TILE;
  const int rows = min(TILE, M - m0);
  const int steps = (N / TILE) * R;  // (column tile, tap) pairs, taps inner

  load_tile<T>(xs, x + size_t(m0) * K, K, rows);
  load_tile<T>(ws, w, ldw, K);
  cp_async_commit();

  wmma::fragment<wmma::accumulator, 16, 16, 16, Acc> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], Acc(0));

#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      const int nt = (s + 1) / R, r = (s + 1) % R;
      load_tile<T>(ws + ((s + 1) & 1) * E,
                   w + size_t(r) * tap_stride + size_t(nt) * TILE, ldw, K);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tap s (and at s = 0 the x tile) is in shared memory

    const In* wt = ws + (s & 1) * E;
#pragma unroll
    for (int kk = 0; kk < K; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, In, wmma::row_major> a0, a1;
      wmma::load_matrix_sync(a0, xs + Tile<T>::at(wr, kk), LD);
      wmma::load_matrix_sync(a1, xs + Tile<T>::at(wr + 16, kk), LD);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, In, wmma::row_major> b;
        wmma::load_matrix_sync(b, wt + Tile<T>::at(kk, wc + j * 16), LD);
        wmma::mma_sync(acc[0][j], a0, b, acc[0][j]);
        wmma::mma_sync(acc[1][j], a1, b, acc[1][j]);
      }
    }

    if (s % R == R - 1) {  // last tap of column tile s / R: round and store
      const int n0 = (s / R) * TILE + wc;
      const int r = lane / 2, c = (lane % 2) * 8;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::store_matrix_sync(scr, acc[i][j], 16, wmma::mem_row_major);
          wmma::fill_fragment(acc[i][j], Acc(0));
          __syncwarp();
          const int row = wr + i * 16 + r;
          if (row < rows) {
            __align__(16) __nv_bfloat16 o[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) o[e] = Tile<T>::round(scr[r * 16 + c + e]);
            *reinterpret_cast<uint4*>(out + size_t(m0 + row) * N + n0 + j * 16 + c) =
                *reinterpret_cast<const uint4*>(o);
          }
          __syncwarp();
        }
    }
    __syncthreads();  // everyone is done with buffer s & 1 before it refills
  }
}

template <typename T>
int launch(const void* x, const void* w, void* out, int M, int N, int R,
           int tap_stride, int ldw, void* stream) {
  if (M < 1 || N < TILE || N % TILE || R < 1 || ldw < N || tap_stride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(out)) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  using In = typename Tile<T>::In;
  using Acc = typename Tile<T>::Acc;
  const size_t smem = 3 * size_t(Tile<T>::ELEMS) * sizeof(In) +
                      size_t(WARPS) * 256 * sizeof(Acc);
  cudaFuncSetAttribute(tap_matmul_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  const int grid = (M + TILE - 1) / TILE;
  tap_matmul_kernel<T><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const In*>(x), static_cast<const In*>(w),
      static_cast<__nv_bfloat16*>(out), M, N, R, tap_stride, ldw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (M, 128), w: R taps of (128, N) at w + r * tap_stride with rows ldw
// elements apart, out: (M, N) bf16; all contiguous and 16-byte aligned,
// N a multiple of 128.
extern "C" int tap_matmul_bf16(const void* x, const void* w, void* out, int M,
                               int N, int R, int tap_stride, int ldw,
                               void* stream) {
  return launch<__nv_bfloat16>(x, w, out, M, N, R, tap_stride, ldw, stream);
}

extern "C" int tap_matmul_s8(const void* x, const void* w, void* out, int M,
                             int N, int R, int tap_stride, int ldw,
                             void* stream) {
  return launch<int8_t>(x, w, out, M, N, R, tap_stride, ldw, stream);
}
