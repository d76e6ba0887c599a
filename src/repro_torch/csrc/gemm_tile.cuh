// The first port's tile loop: grouped_moe_gemm.cu's float32, int8 and
// TMA-refused bfloat16 routes (kraken_conv.cu takes from_float alone).
//
// One block of NTHREADS (four warps) owns a BM x BN output tile of
// a[M, K] @ b[K, N] (both row-major), walks K in BK steps through shared
// memory and leaves the fp32 (int32 for int8) sum of the tile in shared
// memory for the caller's epilogue.  Ragged edges are masked on load:
// every element outside [M, K] x [K, N] stages as zero, so the caller never
// pads, and a caller that passes M < the real row count zero-fills the rows
// past M (the grouped GEMM's live-row mask).
//
//   * float: an 8 x 4 FMA micro-tile per thread, full fp32 (no TF32);
//   * bfloat16: nvcuda::wmma 16x16x16 fragments, fp32 accumulators;
//   * int8: nvcuda::wmma 16x16x16 s8 fragments, int32 accumulators.  wmma
//     wants every fragment pointer 256-bit aligned, and a 16-element int8
//     k-step is only 16 bytes, so the int8 tiles are stored k-sliced: every
//     16 x 16 operand fragment is one contiguous 256-byte block.
// Neighbouring threads load neighbouring columns, 16 bytes each when the
// shapes and pointers allow it (VECLOAD), so a warp reads one coalesced
// 512-byte row segment of b.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace kraken_tile {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int NTHREADS = 128;   // four warps
constexpr int LDC = BN + 4;     // accumulator tile row stride, elements

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__device__ __forceinline__ T zero_of() { return T(0); }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// float and bfloat16: row-major tiles with 8 elements of row padding.  bf16
// takes 64 k-steps per pass (8 KB of b per block per pass), fp32 32, so that
// both stay under the 48 KB of static shared memory.
template <typename T>
struct Tile {
  using Acc = float;
  static constexpr int BK = std::is_same<T, float>::value ? 32 : 64;
  static constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte load
  static constexpr int LDA = BK + 8;
  static constexpr int LDB = BN + 8;
  static constexpr int A_ELEMS = BM * LDA;
  static constexpr int B_ELEMS = BK * LDB;
  __device__ static int a_off(int r, int c) { return r * LDA + c; }
  __device__ static int b_off(int r, int c) { return r * LDB + c; }
};

// int8: k-sliced tiles.  a's element (r, c) lives in slice c / 16 as a
// [BM, 16] row-major block; b's element (r, c) in the [16, 16] row-major
// block (r / 16, c / 16).  LDA and LDB are the row strides inside a
// fragment's block.
template <>
struct Tile<int8_t> {
  using Acc = int32_t;
  static constexpr int BK = 64;
  static constexpr int VEC = 16;
  static constexpr int LDA = 16;
  static constexpr int LDB = 16;
  static constexpr int A_ELEMS = BM * BK;
  static constexpr int B_ELEMS = BK * BN;
  __device__ static int a_off(int r, int c) {
    return ((c >> 4) * BM + r) * 16 + (c & 15);
  }
  __device__ static int b_off(int r, int c) {
    return (((r >> 4) * (BN / 16) + (c >> 4)) * 16 + (r & 15)) * 16 + (c & 15);
  }
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
    // K % V == 0 and N % V == 0 here, so a 16-byte chunk is all in or all
    // out, and it is contiguous in every tile layout above
    for (int i = tid; i < BM * BK / V; i += NTHREADS) {
      const int r = i / (BK / V), c = (i % (BK / V)) * V;
      const int gm = m0 + r, gk = k0 + c;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (gm < M && gk < K)
        val = *reinterpret_cast<const uint4*>(a + (size_t)gm * K + gk);
      *reinterpret_cast<uint4*>(As + TL::a_off(r, c)) = val;
    }
    for (int i = tid; i < BK * BN / V; i += NTHREADS) {
      const int r = i / (BN / V), c = (i % (BN / V)) * V;
      const int gk = k0 + r, gn = n0 + c;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (gk < K && gn < N)
        val = *reinterpret_cast<const uint4*>(b + (size_t)gk * N + gn);
      *reinterpret_cast<uint4*>(Bs + TL::b_off(r, c)) = val;
    }
  } else {
    const T zero = zero_of<T>();
    for (int i = tid; i < BM * BK; i += NTHREADS) {
      const int r = i / BK, c = i % BK;
      const int gm = m0 + r, gk = k0 + c;
      As[TL::a_off(r, c)] = (gm < M && gk < K) ? a[(size_t)gm * K + gk] : zero;
    }
    for (int i = tid; i < BK * BN; i += NTHREADS) {
      const int r = i / BN, c = i % BN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[TL::b_off(r, c)] = (gk < K && gn < N) ? b[(size_t)gk * N + gn] : zero;
    }
  }
}

// The sum of a[m0:m0+BM, :K] @ b[:K, n0:n0+BN] into Cs [BM, LDC] (row-major,
// fp32 or int32).  Every thread of the block must call it; Cs is complete
// after the caller's next __syncthreads().
template <typename T, bool VECLOAD>
__device__ __forceinline__ void tile_sum(T* As, T* Bs, typename Tile<T>::Acc* Cs,
                                         const T* __restrict__ a,
                                         const T* __restrict__ b, int M, int N,
                                         int K, int m0, int n0) {
  using TL = Tile<T>;
  constexpr int BK = TL::BK;
  const int tid = threadIdx.x;
  if constexpr (std::is_same<T, float>::value) {
    // each thread owns an 8 x 4 micro-tile of the 64 x 64 output
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
      for (int j = 0; j < 4; ++j) Cs[(tr * 8 + i) * LDC + tc * 4 + j] = acc[i][j];
  } else {
    // bf16 and int8: four warps in a 2 x 2 grid, each a 32 x 32 quarter of
    // the tile as 2 x 2 wmma fragments (int8_t is the s8 fragment type)
    using namespace nvcuda;
    using Acc = typename TL::Acc;
    const int warp = tid / 32;
    const int wm = warp / 2, wn = warp % 2;
    wmma::fragment<wmma::accumulator, 16, 16, 16, Acc> c[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], Acc(0));
    for (int k0 = 0; k0 < K; k0 += BK) {
      load_tiles<T, VECLOAD>(As, Bs, a, b, M, N, K, m0, n0, k0);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> af[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> bf[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(af[i], As + TL::a_off(wm * 32 + i * 16, kk), TL::LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(bf[j], Bs + TL::b_off(kk, wn * 32 + j * 16), TL::LDB);
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
        wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                                c[i][j], LDC, wmma::mem_row_major);
  }
}

}  // namespace kraken_tile
