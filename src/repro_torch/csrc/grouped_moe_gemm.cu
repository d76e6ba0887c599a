// grouped_moe_gemm for Hopper (sm_90a): out[e, :sizes[e]] = xs[e, :sizes[e]] @ w[e]
// for every expert e in one launch, rows >= sizes[e] exactly zero.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/kraken_moe_gemm.py::grouped_moe_gemm (body _kernel).  The
// TPU version pads the capacity buffer to its block_rows plan and the lanes to
// 128, scalar-prefetches the group table, skips dead m-blocks with pl.when and
// remaps an empty group's weight DMA to expert 0.  Here the grid is fixed by
// the shapes alone, (ceil(f / BN), ceil(C / BM), E), nothing is padded, and
// each block reads its expert's live-row count sizes[e] on the device
// (clamped to [0, C]):
//   * a block whose m tile starts at or past sizes[e] writes zeros over its
//     output tile and returns before it reads a byte of xs or w, so an empty
//     expert reads no weights at all;
//   * a live block runs gemm_tile.cuh's tile loop (shared with
//     kraken_gemm.cu) with M = sizes[e]: rows past the size stage as zero,
//     ragged d / f edges are masked, and the epilogue writes exact zeros for
//     rows past the size.
// Types: bf16 through the tensor cores (wmma, fp32 accumulation, bf16 out);
// fp32 through an FMA micro-tile (no TF32, fp32 out); int8 through wmma s8
// fragments with int32 accumulation and int32 out, exact.
//
// What bounds it on an H100: at decode every live expert sees C = 1 row (a
// GEMV over its d x f weight), so the bound is reading the active experts'
// weights at 3.35 TB/s.  At the mixed step (C = 80 at mixtral's 4 x 64
// tokens) every expert is live with up to 80 rows, still far below the
// ~295 FLOP/byte the card needs to be compute bound.  This first design
// streams the weights with one 64 x 64 tile per block and no pipelining;
// like kraken_gemm it reaches a fraction of the memory rate (later work:
// split-K and a cp.async/TMA pipeline for the one-row tiles).

#include "gemm_tile.cuh"

namespace {

using namespace kraken_tile;

template <typename T>
struct Out {
  using type = T;
};
template <>
struct Out<int8_t> {
  using type = int32_t;
};

template <typename O, typename A>
__device__ __forceinline__ O convert(A x);
template <>
__device__ __forceinline__ float convert<float, float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 convert<__nv_bfloat16, float>(float x) {
  return from_float<__nv_bfloat16>(x);
}
template <>
__device__ __forceinline__ int32_t convert<int32_t, int32_t>(int32_t x) { return x; }

template <typename T, bool VECLOAD>
__global__ void __launch_bounds__(NTHREADS)
grouped_moe_gemm_kernel(const T* __restrict__ xs, const T* __restrict__ w,
                        const int32_t* __restrict__ sizes,
                        typename Out<T>::type* __restrict__ out, int C, int d,
                        int f) {
  using O = typename Out<T>::type;
  using Acc = typename Tile<T>::Acc;
  __shared__ __align__(128) T As[Tile<T>::A_ELEMS];
  __shared__ __align__(128) T Bs[Tile<T>::B_ELEMS];
  __shared__ __align__(128) Acc Cs[BM * LDC];

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int size = min(max(sizes[e], 0), C);   // the same for every thread
  O* oe = out + (size_t)e * C * f;

  if (m0 >= size) {
    // dead tile: zero-fill the output, read nothing else
    for (int i = threadIdx.x; i < BM * BN; i += NTHREADS) {
      const int gm = m0 + i / BN, gn = n0 + i % BN;
      if (gm < C && gn < f) oe[(size_t)gm * f + gn] = convert<O, Acc>(Acc(0));
    }
    return;
  }

  tile_sum<T, VECLOAD>(As, Bs, Cs, xs + (size_t)e * C * d, w + (size_t)e * d * f,
                       size, f, d, m0, n0);
  __syncthreads();

  for (int i = threadIdx.x; i < BM * BN; i += NTHREADS) {
    const int r = i / BN, cc = i % BN;
    const int gm = m0 + r, gn = n0 + cc;
    if (gm < C && gn < f)
      oe[(size_t)gm * f + gn] = convert<O, Acc>(gm < size ? Cs[r * LDC + cc] : Acc(0));
  }
}

template <typename T>
int launch(const void* xs, const void* w, const int32_t* sizes, void* out, int E,
           int C, int d, int f, cudaStream_t stream) {
  constexpr int V = Tile<T>::VEC;
  // every expert's slice starts 16-byte aligned when d and f are multiples
  // of V and the base pointers are
  const bool aligned = (reinterpret_cast<uintptr_t>(xs) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  const dim3 grid((f + BN - 1) / BN, (C + BM - 1) / BM, E);
  const T* px = static_cast<const T*>(xs);
  const T* pw = static_cast<const T*>(w);
  using O = typename Out<T>::type;
  O* po = static_cast<O*>(out);
  if (aligned && d % V == 0 && f % V == 0)
    grouped_moe_gemm_kernel<T, true><<<grid, NTHREADS, 0, stream>>>(px, pw, sizes, po, C, d, f);
  else
    grouped_moe_gemm_kernel<T, false><<<grid, NTHREADS, 0, stream>>>(px, pw, sizes, po, C, d, f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xs [E, C, d], w [E, d, f] (row-major, one dtype), sizes [E] int32 on the
// device; out [E, C, f].  dtype: 0 = float32 (out float32), 1 = bfloat16 (out
// bfloat16), 2 = int8 (out int32).  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int grouped_moe_gemm(const void* xs, const void* w, const void* sizes,
                                void* out, int E, int C, int d, int f, int dtype,
                                void* stream) {
  if (E <= 0 || C <= 0 || d < 0 || f <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (E > 65535 || (C + BM - 1) / BM > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* sz = static_cast<const int32_t*>(sizes);
  if (dtype == 0) return launch<float>(xs, w, sz, out, E, C, d, f, s);
  if (dtype == 1) return launch<__nv_bfloat16>(xs, w, sz, out, E, C, d, f, s);
  if (dtype == 2) return launch<int8_t>(xs, w, sz, out, E, C, d, f, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
