// W8A8 products: int8 x int8 -> int32 sums on the tensor cores and a
// float32 dequantising epilogue (imcui_tpu_torch/ops/w8a8.py).
//
//   w8a8_gemm   out[m, n] = cast((f32(acc[m, n]) * rs[m]) * cs[n] + bias[n])
//               with acc = sum_k a[m, k] * b[n, k], a (M, K) and b (N, K)
//               int8 row-major; rs null: f32(acc) * cs[n] + bias[n].
//               The linear's route: a the activations quantised per row
//               (rs their scales), b the weights (cs their per-channel
//               scales).
//   w8a8_conv   the same core as an implicit-GEMM convolution: row m is an
//               output pixel (b, oy, ox) of an NHWC int8 map, column n an
//               output channel of its group, and K runs over (ky, kx, c)
//               of the group's input window, gathered with stride,
//               dilation and explicit padding (taps outside the map read
//               zeros); cs[n] = sx * w_s[n], one activation scale per
//               tensor. The output is NHWC.
//
// These kernels replace no TPU kernel: in the JAX package the W8A8 path
// (imcui_tpu/models/layers.py:_linear_int8, _conv2d_int8) is XLA. They
// exist because no library call serves W8A8 on the card: torch._int_mm
// took 9.871 ms where bf16 cuBLAS took 3.968 ms on the same 4.83 GB
// product (PERF.md, K11), slower than the bf16 it would replace, and
// PyTorch has no int8 convolution on CUDA.
//
// What bounds them on an H100: int8 operations, 2*M*N*K over 1979 TOP/s,
// or the bytes (each int8 operand read once, the output written once) over
// 3.35 TB/s; at the models' shapes (ViT-L tokens, RoMa's and DKM's trunk
// convolutions) most launches sit on the bytes side or near the ridge.
// This first design is simple and right: mma.sync m16n8k32 s8 on 128 x 128
// (or 64 x 128) output tiles, 8 warps of 64 (32) x 32, K in 64-byte steps
// through a two-stage cp.async ring, fragments by ldmatrix from rows padded
// to 80 bytes (every 8-row phase hits 8 distinct bank quads). The s8 wgmma
// machinery of tap_matmul.cu is the lever a later pass can take.
//
// The epilogue is written without FMA contraction (__fmul_rn, __fadd_rn)
// in the JAX package's order, so that it equals the plain version, which
// takes the exact integer sums, bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int THREADS = 256;  // 8 warps: 2 along the rows x 4 along N
constexpr int BN = 128;       // output columns a block
constexpr int BK = 64;        // K bytes a stage
constexpr int LDS = BK + 16;  // padded shared row, bytes
constexpr int MAX_SMS = 1024;

struct Args {
  const int8_t* a;      // GEMM: (M, K); conv: the NHWC map (B, H, W, C)
  const int8_t* b;      // (N_total, K), K-contiguous
  const float* rs;      // row scales (M,) or null
  const float* cs;      // column scales (N_total,)
  const float* bias;    // (N_total,) or null
  void* out;            // (M, ldo), float32 or bf16
  int M, N, K, ldo, bf16;
  // the convolution's gather (conv only)
  int H, W, C, Ho, Wo, kw, sy, sx, dy, dx, pt, pl, cgp;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldsm_x4(unsigned* r, const int8_t* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void mma_s8(int* c, const unsigned* a,
                                       const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One output tile: rows [m0, m0 + BM) x columns [n0, n0 + BN) of group g
// (conv only; the GEMM has one group).
template <int BM, bool CONV>
__global__ void __launch_bounds__(THREADS)
w8a8_kernel(Args p) {
  constexpr int MT = BM / 32;                  // m16 tiles a warp
  constexpr int A_PER = BM * (BK / 16) / THREADS;  // A chunks a thread
  __shared__ __align__(16) int8_t As[2][BM * LDS];
  __shared__ __align__(16) int8_t Bs[2][BN * LDS];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, g = blockIdx.z;
  const int col0 = g * p.N;  // this group's first output channel
  const int8_t* bsrc = p.b + size_t(col0) * p.K;
  const int chunk = tid % 4;  // this thread's 16-byte chunk of a row

  // this thread's A rows: their source (GEMM) or window origin (conv)
  const int8_t* arow[A_PER];
  int iy0[A_PER], ix0[A_PER];
  bool mok[A_PER];
#pragma unroll
  for (int i = 0; i < A_PER; ++i) {
    const int m = m0 + tid / 4 + i * (THREADS / 4);
    mok[i] = m < p.M;
    const int mm = mok[i] ? m : 0;
    if (CONV) {
      const int hw = p.Ho * p.Wo, bi = mm / hw, rem = mm - bi * hw;
      const int oy = rem / p.Wo, ox = rem - oy * p.Wo;
      iy0[i] = oy * p.sy - p.pt;
      ix0[i] = ox * p.sx - p.pl;
      arow[i] = p.a + size_t(bi) * p.H * p.W * p.C + size_t(g) * p.cgp;
    } else {
      iy0[i] = ix0[i] = 0;
      arow[i] = p.a + size_t(mm) * p.K;
    }
  }

  auto load = [&](int stage, int k0) {
    const int k = k0 + chunk * 16;
    const bool kin = k < p.K;
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int r = tid / 4 + i * (THREADS / 4);
      const int8_t* src = p.a;
      bool in = mok[i] && kin;
      if (CONV) {
        const int cpt = p.cgp / 16;  // chunks a tap
        const int kc = k / 16, tap = kc / cpt, cc = kc - tap * cpt;
        const int ky = tap / p.kw, kx = tap - ky * p.kw;
        const int iy = iy0[i] + ky * p.dy, ix = ix0[i] + kx * p.dx;
        in = in && iy >= 0 && iy < p.H && ix >= 0 && ix < p.W;
        if (in) src = arow[i] + (size_t(iy) * p.W + ix) * p.C + cc * 16;
      } else if (in) {
        src = arow[i] + k;
      }
      cp_async16(&As[stage][r * LDS + chunk * 16], src, in);
    }
#pragma unroll
    for (int i = 0; i < BN * (BK / 16) / THREADS; ++i) {
      const int r = tid / 4 + i * (THREADS / 4);
      const bool in = kin && n0 + r < p.N;
      cp_async16(&Bs[stage][r * LDS + chunk * 16],
                 in ? bsrc + size_t(n0 + r) * p.K + k : p.b, in);
    }
  };

  int acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int tiles = (p.K + BK - 1) / BK;
  load(0, 0);
  cp_async_commit();
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) load((t + 1) & 1, (t + 1) * BK);
    cp_async_commit();  // possibly empty: the wait below counts groups
    cp_async_wait1();   // tile t has landed
    __syncthreads();
    const int8_t* as = As[t & 1];
    const int8_t* bs = Bs[t & 1];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned af[MT][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int row = wm * (BM / 2) + i * 16 + lane % 8 + ((lane / 8) & 1) * 8;
        ldsm_x4(af[i], as + row * LDS + kk + (lane / 16) * 16);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int row = wn * 32 + j * 16 + lane % 8 + (lane / 16) * 8;
        unsigned r[4];
        ldsm_x4(r, bs + row * LDS + kk + ((lane / 8) & 1) * 16);
        bf[2 * j][0] = r[0];
        bf[2 * j][1] = r[1];
        bf[2 * j + 1][0] = r[2];
        bf[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();  // the stage is free for tile t + 2
  }

  // epilogue: c0, c1 at (row, col), (row, col + 1); c2, c3 eight rows down
  const bool pairs = p.ldo % 2 == 0 && col0 % 2 == 0;
  auto value = [&](int v, int row, int col) {
    const int gc = col0 + col;
    float x = __int2float_rn(v);
    if (p.rs != nullptr) x = __fmul_rn(x, p.rs[row]);
    x = __fmul_rn(x, p.cs[gc]);
    if (p.bias != nullptr) x = __fadd_rn(x, p.bias[gc]);
    return x;
  };
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * (BM / 2) + i * 16 + lane / 4 + h * 8;
        const int col = n0 + wn * 32 + j * 8 + (lane % 4) * 2;
        if (row >= p.M || col >= p.N) continue;
        const size_t off = size_t(row) * p.ldo + col0 + col;
        const float x0 = value(acc[i][j][2 * h], row, col);
        const bool two = col + 1 < p.N;
        const float x1 = two ? value(acc[i][j][2 * h + 1], row, col + 1) : 0.f;
        if (p.bf16) {
          __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.out) + off;
          if (two && pairs) {
            *reinterpret_cast<__nv_bfloat162*>(o) =
                __floats2bfloat162_rn(x0, x1);
          } else {
            o[0] = __float2bfloat16_rn(x0);
            if (two) o[1] = __float2bfloat16_rn(x1);
          }
        } else {
          float* o = static_cast<float*>(p.out) + off;
          if (two && pairs) {
            *reinterpret_cast<float2*>(o) = make_float2(x0, x1);
          } else {
            o[0] = x0;
            if (two) o[1] = x1;
          }
        }
      }
}

int sm_count() {
  static int sms[MAX_SMS] = {};
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0 ||
      device >= MAX_SMS)
    return 132;
  if (sms[device] == 0 &&
      cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess)
    return 132;
  return sms[device];
}

bool misaligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 != 0;
}

// 128-row tiles where they give at least one block an SM, else 64.
template <bool CONV>
int launch(const Args& p, int groups, cudaStream_t stream) {
  const long long nt = (p.N + BN - 1) / BN;
  const long long big = (p.M + 127) / 128 * nt * groups;
  const bool tall = big >= sm_count();
  const long long mt = tall ? (p.M + 127) / 128 : (p.M + 63) / 64;
  if (mt > INT_MAX || nt > 65535 || groups > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(mt), static_cast<unsigned>(nt),
                  static_cast<unsigned>(groups));
  if (tall)
    w8a8_kernel<128, CONV><<<grid, THREADS, 0, stream>>>(p);
  else
    w8a8_kernel<64, CONV><<<grid, THREADS, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a (M, K), b (N, K) int8, K a multiple of 16; rs (M,) or null; cs (N,);
// bias (N,) or null; out (M, N) float32 (bf16 = 0) or bfloat16.
extern "C" int w8a8_gemm(const void* a, const void* b, const void* rs,
                         const void* cs, const void* bias, void* out, int M,
                         int N, int K, int bf16, void* stream) {
  if (M < 1 || N < 1 || K < 16 || K % 16)
    return M < 1 || N < 1 ? 0 : static_cast<int>(cudaErrorInvalidValue);
  if (misaligned(a) || misaligned(b))
    return static_cast<int>(cudaErrorMisalignedAddress);
  Args p{};
  p.a = static_cast<const int8_t*>(a);
  p.b = static_cast<const int8_t*>(b);
  p.rs = static_cast<const float*>(rs);
  p.cs = static_cast<const float*>(cs);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.M = M;
  p.N = N;
  p.K = K;
  p.ldo = N;
  p.bf16 = bf16;
  return launch<false>(p, 1, static_cast<cudaStream_t>(stream));
}

// x (B, H, W, C) int8 NHWC with C = groups * cgp, each group's channels
// padded to cgp (a multiple of 16); w (Cout, kh, kw, cgp) int8; cs (Cout,);
// bias (Cout,) or null; out (B, Ho, Wo, Cout). dims: B, H, W, C, Ho, Wo,
// Cout, kh, kw, sy, sx, dy, dx, pad top, pad left, groups, cgp, bf16.
extern "C" int w8a8_conv(const void* x, const void* w, const void* cs,
                         const void* bias, void* out, const void* dims,
                         void* stream) {
  const int* d = static_cast<const int*>(dims);
  const int B = d[0], H = d[1], W = d[2], C = d[3], Ho = d[4], Wo = d[5];
  const int Cout = d[6], kh = d[7], kw = d[8], groups = d[15], cgp = d[16];
  if (B < 1 || Ho < 1 || Wo < 1 || groups < 1 || Cout % groups ||
      cgp < 16 || cgp % 16 || C != groups * cgp || kh < 1 || kw < 1 ||
      d[9] < 1 || d[10] < 1 || d[11] < 1 || d[12] < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (misaligned(x) || misaligned(w))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const long long M = (long long)B * Ho * Wo;
  if (M > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  Args p{};
  p.a = static_cast<const int8_t*>(x);
  p.b = static_cast<const int8_t*>(w);
  p.rs = nullptr;
  p.cs = static_cast<const float*>(cs);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.M = int(M);
  p.N = Cout / groups;
  p.K = kh * kw * cgp;
  p.ldo = Cout;
  p.bf16 = d[17];
  p.H = H;
  p.W = W;
  p.C = C;
  p.Ho = Ho;
  p.Wo = Wo;
  p.kw = kw;
  p.sy = d[9];
  p.sx = d[10];
  p.dy = d[11];
  p.dx = d[12];
  p.pt = d[13];
  p.pl = d[14];
  p.cgp = cgp;
  return launch<true>(p, groups, static_cast<cudaStream_t>(stream));
}
