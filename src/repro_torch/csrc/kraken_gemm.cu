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
//   * the tile loop is gemm_tile.cuh's (shared with grouped_moe_gemm.cu):
//     coalesced 16-byte loads of neighbouring columns, bf16 through the
//     tensor cores (wmma, fp32 accumulator), fp32 through an FMA micro-tile
//     (full fp32, no TF32), so both agree with the plain version's fp32 sum;
//   * bias and the activation run in the epilogue, on the fp32 sum, before
//     the single rounding to the output type.
// Not yet done (later work): cp.async/TMA pipelining, wgmma, and split-K for
// the small-N decode shapes, where only ceil(N/64) blocks run.

#include "gemm_tile.cuh"

namespace {

using namespace kraken_tile;

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

template <typename T, bool VECLOAD>
__global__ void __launch_bounds__(NTHREADS)
gemm_kernel(const T* __restrict__ a, const T* __restrict__ b,
            const float* __restrict__ bias, T* __restrict__ out, int M, int N,
            int K, int act) {
  __shared__ __align__(128) T As[Tile<T>::A_ELEMS];
  __shared__ __align__(128) T Bs[Tile<T>::B_ELEMS];
  __shared__ __align__(128) float Cs[BM * LDC];

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  tile_sum<T, VECLOAD>(As, Bs, Cs, a, b, M, N, K, m0, n0);
  __syncthreads();

  // epilogue: bias + activation on the fp32 sum, one rounding, masked store;
  // consecutive threads write consecutive columns
  for (int i = threadIdx.x; i < BM * BN; i += NTHREADS) {
    const int r = i / BN, cc = i % BN;
    const int gm = m0 + r, gn = n0 + cc;
    if (gm < M && gn < N) {
      float x = Cs[r * LDC + cc];
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
