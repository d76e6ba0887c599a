// kraken_gemm for Hopper (sm_90a): out = act(a @ b + bias), fp32 accumulation.
//
// Replaces the Pallas TPU kernel src/repro/kernels/kraken_gemm.py::kraken_gemm
// (bodies _ws_kernel and _os_kernel).  The TPU version picks one of two
// schedules per shape (weight-stationary full-K tiles or output-stationary
// split-K) from a VMEM tile plan and needs its operands padded to the tile
// grid.  Here there is one design and no tile plan: each block owns a
// BM x BN output tile, walks K in BK steps through shared memory, and masks
// the ragged M/N/K edges itself (out-of-range elements load as zero and are
// never stored), so the caller never pads.
//
// What bounds it on an H100: at decode (M = serving slots, 4 for the main
// path) every GEMM reads its whole [K, N] weight for a few rows of output,
// about 2 FLOP per weight byte, far below the ~295 FLOP/byte the card needs
// to be compute bound -- so the bound is the weight read at 3.35 TB/s.  At
// the mixed step (M = slots * chunk = 256) it is closer to the tensor-core
// rate.  This first design serves both with one tiling:
//   * neighbouring threads load neighbouring columns of b (and of a), 16
//     bytes per thread when the shapes allow it, so every warp's weight read
//     is one coalesced 512-byte row segment;
//   * bf16 tiles go through the tensor cores with nvcuda::wmma 16x16x16
//     fragments and an fp32 accumulator; fp32 inputs use an FMA micro-tile
//     (full fp32, no TF32), so both agree with the plain version's fp32 sum;
//   * bias and the activation run in the epilogue, on the fp32 sum, before
//     the single rounding to the output type.
// Not yet done (later work): cp.async/TMA pipelining, wgmma, and split-K for
// the small-N decode shapes, where only ceil(N/64) blocks run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int NTHREADS = 128;   // four warps
constexpr int PAD = 8;          // smem row padding, elements

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_SILU = 2, ACT_GELU = 3 };

__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case ACT_RELU:
      return fmaxf(x, 0.f);
    case ACT_SILU:
      return x / (1.f + expf(-x));
    case ACT_GELU:  // tanh form, as the reference's gelu
      return 0.5f * x *
             (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
    default:
      return x;
  }
}

template <typename T>
__device__ __forceinline__ float to_float(T x);
template <>
__device__ __forceinline__ float to_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// bf16 tiles take 64 k-steps per pass (8 KB of weight per block per pass);
// fp32 tiles 32, so that both stay under the 48 KB of static shared memory.
template <typename T>
struct Tile {
  static constexpr int BK = std::is_same<T, float>::value ? 32 : 64;
  static constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte load
  static constexpr int LDA = BK + PAD;
  static constexpr int LDB = BN + PAD;
  static constexpr int LDC = BN + 4;
};

// Stage a[m0:m0+BM, k0:k0+BK] and b[k0:k0+BK, n0:n0+BN] into shared memory,
// zero-filling everything outside [M, K] x [K, N].
template <typename T, bool VECLOAD>
__device__ __forceinline__ void load_tiles(T* As, T* Bs, const T* __restrict__ a,
                                           const T* __restrict__ b, int M, int N,
                                           int K, int m0, int n0, int k0) {
  using TL = Tile<T>;
  constexpr int BK = TL::BK;
  const int tid = threadIdx.x;
  if constexpr (VECLOAD) {
    constexpr int V = TL::VEC;
    // K % V == 0 and N % V == 0 here, so a 16-byte chunk is all in or all out
    for (int i = tid; i < BM * BK / V; i += NTHREADS) {
      const int r = i / (BK / V), c = (i % (BK / V)) * V;
      const int gm = m0 + r, gk = k0 + c;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (gm < M && gk < K)
        val = *reinterpret_cast<const uint4*>(a + (size_t)gm * K + gk);
      *reinterpret_cast<uint4*>(As + r * TL::LDA + c) = val;
    }
    for (int i = tid; i < BK * BN / V; i += NTHREADS) {
      const int r = i / (BN / V), c = (i % (BN / V)) * V;
      const int gk = k0 + r, gn = n0 + c;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (gk < K && gn < N)
        val = *reinterpret_cast<const uint4*>(b + (size_t)gk * N + gn);
      *reinterpret_cast<uint4*>(Bs + r * TL::LDB + c) = val;
    }
  } else {
    const T zero = from_float<T>(0.f);
    for (int i = tid; i < BM * BK; i += NTHREADS) {
      const int r = i / BK, c = i % BK;
      const int gm = m0 + r, gk = k0 + c;
      As[r * TL::LDA + c] = (gm < M && gk < K) ? a[(size_t)gm * K + gk] : zero;
    }
    for (int i = tid; i < BK * BN; i += NTHREADS) {
      const int r = i / BN, c = i % BN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[r * TL::LDB + c] = (gk < K && gn < N) ? b[(size_t)gk * N + gn] : zero;
    }
  }
}

template <typename T, bool VECLOAD>
__global__ void __launch_bounds__(NTHREADS)
gemm_kernel(const T* __restrict__ a, const T* __restrict__ b,
            const float* __restrict__ bias, T* __restrict__ out, int M, int N,
            int K, int act) {
  using TL = Tile<T>;
  constexpr int BK = TL::BK;
  __shared__ __align__(128) T As[BM * TL::LDA];
  __shared__ __align__(128) T Bs[BK * TL::LDB];
  __shared__ __align__(128) float Cs[BM * TL::LDC];

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;

  if constexpr (std::is_same<T, float>::value) {
    // fp32: each thread owns an 8 x 4 micro-tile of the 64 x 64 output
    const int tr = tid / 16, tc = tid % 16;
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < K; k0 += BK) {
      load_tiles<T, VECLOAD>(As, Bs, a, b, M, N, K, m0, n0, k0);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float av[8], bv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) av[i] = As[(tr * 8 + i) * TL::LDA + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[kk * TL::LDB + tc * 4 + j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Cs[(tr * 8 + i) * TL::LDC + tc * 4 + j] = acc[i][j];
  } else {
    // bf16: four warps in a 2 x 2 grid, each a 32 x 32 quarter of the tile
    // as 2 x 2 wmma fragments with fp32 accumulators
    using namespace nvcuda;
    const int warp = tid / 32;
    const int wm = warp / 2, wn = warp % 2;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0.f);
    for (int k0 = 0; k0 < K; k0 += BK) {
      load_tiles<T, VECLOAD>(As, Bs, a, b, M, N, K, m0, n0, k0);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(af[i], As + (wm * 32 + i * 16) * TL::LDA + kk, TL::LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(bf[j], Bs + kk * TL::LDB + wn * 32 + j * 16, TL::LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(c[i][j], af[i], bf[j], c[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * TL::LDC + wn * 32 + j * 16,
                                c[i][j], TL::LDC, wmma::mem_row_major);
  }
  __syncthreads();

  // epilogue: bias + activation on the fp32 sum, one rounding, masked store;
  // consecutive threads write consecutive columns
  for (int i = tid; i < BM * BN; i += NTHREADS) {
    const int r = i / BN, cc = i % BN;
    const int gm = m0 + r, gn = n0 + cc;
    if (gm < M && gn < N) {
      float x = Cs[r * TL::LDC + cc];
      if (bias != nullptr) x += bias[gn];
      out[(size_t)gm * N + gn] = from_float<T>(activate(x, act));
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, const void* bias, void* out, int M,
           int N, int K, int act, cudaStream_t stream) {
  constexpr int V = Tile<T>::VEC;
  const bool aligned = (reinterpret_cast<uintptr_t>(a) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(b) % 16 == 0);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const T* pa = static_cast<const T*>(a);
  const T* pb = static_cast<const T*>(b);
  const float* pbias = static_cast<const float*>(bias);
  T* po = static_cast<T*>(out);
  if (aligned && K % V == 0 && N % V == 0)
    gemm_kernel<T, true><<<grid, NTHREADS, 0, stream>>>(pa, pb, pbias, po, M, N, K, act);
  else
    gemm_kernel<T, false><<<grid, NTHREADS, 0, stream>>>(pa, pb, pbias, po, M, N, K, act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (a, b and out share it); bias is fp32 [N]
// or null; act: 0 none, 1 relu, 2 silu, 3 gelu (tanh).  Launches on `stream`
// and returns cudaGetLastError() (0 on success).
extern "C" int kraken_gemm(const void* a, const void* b, const void* bias, void* out,
                           int M, int N, int K, int dtype, int act, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || act < 0 || act > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((M + BM - 1) / BM > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, b, bias, out, M, N, K, act, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, b, bias, out, M, N, K, act, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
