// What decode_attention.cu and paged_attention.cu share: the element
// conversions, the warp reductions and the fixed-order combine of a
// sequence split (flash-decoding).
//
// A split writes, for each query row, one record of D + 2 floats into
// part[row, z, :]: m (the running max, -1e30 when the split saw no live
// entry), l (the sum of e^(s - m)) and acc[D] (the sum of e^(s - m) v).
// combine_splits reads the splits of one row in the order z = 0, 1, ...:
// M = max m_z, out = sum e^(m_z - M) acc_z / sum e^(m_z - M) l_z, rounded
// once, exact zeros where the sum of l is 0 (no live entry).  No atomics and
// no block waits on another: the same bits on every run.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash_decode {

constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The 16 / sizeof(T) elements of a 16-byte vector as floats, by shifts (no
// address taken, so the vector stays in registers).
__device__ __forceinline__ void unpack(const uint4& w, float (&f)[4]) {
  f[0] = __uint_as_float(w.x);
  f[1] = __uint_as_float(w.y);
  f[2] = __uint_as_float(w.z);
  f[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void unpack(const uint4& w, float (&f)[8]) {
  const uint32_t x[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(x[i] << 16);   // bf16: the high half of a float
    f[2 * i + 1] = __uint_as_float(x[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4& w, float (&f)[16]) {
  const uint32_t x[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      f[4 * i + b] = static_cast<float>(static_cast<int8_t>((x[i] >> (8 * b)) & 0xffu));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// out[blockIdx.x, :] from part[blockIdx.x, z, :], z = 0 .. splits - 1 in
// that order (the file note), by a block of NTHREADS threads.  The splits'
// weights and l go through `cw` (dynamic shared memory, [2, splits] floats).
template <typename TQ, int NTHREADS>
__device__ __forceinline__ void combine_splits(const float* __restrict__ part,
                                               TQ* __restrict__ out, int splits, int D,
                                               float* cw) {
  constexpr int NW = NTHREADS / 32;
  __shared__ float red[NW];
  const int W = D + 2, tid = threadIdx.x;
  const float* pr = part + (size_t)blockIdx.x * splits * W;
  float mx = NEG;
  for (int z = tid; z < splits; z += NTHREADS) {
    cw[z] = pr[z * W];
    cw[splits + z] = pr[z * W + 1];
    mx = fmaxf(mx, cw[z]);
  }
  mx = warp_max(mx);
  if (tid % 32 == 0) red[tid / 32] = mx;
  __syncthreads();
  mx = red[0];
#pragma unroll
  for (int w = 1; w < NW; ++w) mx = fmaxf(mx, red[w]);
  for (int z = tid; z < splits; z += NTHREADS) cw[z] = expf(cw[z] - mx);
  __syncthreads();
  float den = 0.f;
  for (int z = 0; z < splits; ++z) den = fmaf(cw[z], cw[splits + z], den);
  for (int d = tid; d < D; d += NTHREADS) {
    float num = 0.f;
#pragma unroll 8
    for (int z = 0; z < splits; ++z) num = fmaf(cw[z], pr[z * W + 2 + d], num);
    out[(size_t)blockIdx.x * D + d] = from_float<TQ>(den == 0.f ? 0.f : num / den);
  }
}

}  // namespace flash_decode
