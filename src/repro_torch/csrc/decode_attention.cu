// decode_attention for Hopper (sm_90a): one-token GQA attention over a dense
// [B, KV, S, D] KV cache, optionally int8 with per-(batch, head, slot) scales.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention.py::decode_attention (body _kernel).  On
// the TPU the grid (b, kv_head, s_block) runs in order on one core and carries
// the online-softmax state in VMEM scratch from one s_block to the next; the
// wrapper picks an s_block that divides S (_divisible_block) so that the
// cache is never padded.  Blocks on a GPU run in no order and share nothing,
// so the sequential s_block axis becomes a loop inside one block: one block
// per (slot, kv head) holds the G = H / KV query rows of that head, walks the
// slot's cache in tiles of TILE entries and keeps (m, l, acc) in fp32 shared
// memory.  A ragged last tile is masked here, so no S needs padding and the
// cache is never copied.
//
// Semantics (those of repro/kernels/ref.py::decode_attention, which the JAX
// package runs off the TPU):
//   * entry j is live for slot b when 0 <= kv_pos[b, j] <= q_pos[b] (and
//     kv_pos[b, j] > q_pos[b] - window when a window is set); empty entries
//     hold -2^30;
//   * a tile with no live entry is skipped before its K/V are read, and a
//     dead entry inside a live tile is never read either;
//   * masked scores are -1e30 and m starts at -1e30, so a slot with no live
//     entry ends with l == 0 and writes exact zeros.  (The Pallas kernel does
//     not: its -1e30 fill makes every masked p equal 1 on such a row, which
//     then averages V.  The port follows the plain version.)
//   * int8 K/V are dequantized in registers with their [B, KV, S] scales.
//
// What bounds it on an H100: it reads every live K/V byte once and does
// ~2 FLOP per byte per query row, so it is bound by the cache read.  This
// first design runs B * KV blocks (16 at four slots of yi-6b), which cannot
// draw the card's full memory rate; splitting S across blocks
// (flash-decoding) is left for later work.  Within a block, the tile's K and
// V are staged in shared memory once and reused by all G query rows, and the
// K tile is padded by one float per row so that the score loop (threads over
// entries) reads distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 128;
constexpr int TILE = 32;
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

// shared memory, in floats: q [G*D], acc [G*D], k/v tiles [TILE*(D+1)] each,
// scores [G*TILE], m/l/alpha [G] each, then the tile's live-entry flags [TILE]
__host__ __device__ inline size_t smem_floats(int G, int D) {
  return 2 * (size_t)G * D + 2 * (size_t)TILE * (D + 1) + (size_t)G * TILE +
         3 * (size_t)G + TILE;
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(NTHREADS)
decode_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                        const TKV* __restrict__ v, const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale, const int* __restrict__ kv_pos,
                        const int* __restrict__ q_pos, TQ* __restrict__ out, int H,
                        int KV, int S, int D, int pos_stride, int window, float scale) {
  const int b = blockIdx.x;   // slot
  const int h = blockIdx.y;   // kv head
  const int G = H / KV;
  const int LDK = D + 1;
  const int tid = threadIdx.x;

  extern __shared__ float smem[];
  float* qs = smem;                 // [G, D]
  float* acc = qs + G * D;          // [G, D]
  float* kt = acc + G * D;          // [TILE, D+1]
  float* vt = kt + TILE * LDK;      // [TILE, D+1]
  float* sc = vt + TILE * LDK;      // [G, TILE]
  float* m = sc + G * TILE;         // [G]
  float* l = m + G;                 // [G]
  float* alpha = l + G;             // [G]
  int* live_e = reinterpret_cast<int*>(alpha + G);   // [TILE]
  __shared__ int any_live;

  const size_t q_off = ((size_t)b * H + (size_t)h * G) * D;
  for (int i = tid; i < G * D; i += NTHREADS) {
    qs[i] = to_float(q[q_off + i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += NTHREADS) {
    m[g] = NEG;
    l[g] = 0.f;
  }
  const int qp = q_pos[b];
  const int* pos_row = kv_pos + (size_t)b * pos_stride;
  const size_t row0 = ((size_t)b * KV + h) * (size_t)S;   // entry (b, h, 0)
  __syncthreads();

  for (int s0 = 0; s0 < S; s0 += TILE) {
    const int n = min(TILE, S - s0);   // the last tile may be ragged

    if (tid == 0) any_live = 0;
    __syncthreads();
    for (int e = tid; e < n; e += NTHREADS) {
      const int kp = pos_row[s0 + e];
      const int ok = kp >= 0 && kp <= qp && (window == 0 || kp > qp - window);
      live_e[e] = ok;
      if (ok) any_live = 1;
    }
    __syncthreads();
    if (!any_live) continue;   // block-uniform: nothing in this tile survives

    for (int i = tid; i < n * D; i += NTHREADS) {
      const int e = i / D, d = i % D;
      float kf = 0.f, vf = 0.f;
      if (live_e[e]) {
        const size_t ent = row0 + s0 + e;
        kf = to_float(k[ent * D + d]);
        vf = to_float(v[ent * D + d]);
        if (k_scale != nullptr) {
          kf *= k_scale[ent];
          vf *= v_scale[ent];
        }
      }
      kt[e * LDK + d] = kf;
      vt[e * LDK + d] = vf;
    }
    __syncthreads();

    // scores: one (row, entry) pair per thread
    for (int i = tid; i < G * n; i += NTHREADS) {
      const int g = i / n, e = i % n;
      float s = NEG;
      if (live_e[e]) {
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(qs[g * D + d], kt[e * LDK + d], dot);
        s = dot * scale;
      }
      sc[g * TILE + e] = s;
    }
    __syncthreads();

    // online-softmax update, one row per thread; scores become weights
    for (int g = tid; g < G; g += NTHREADS) {
      float mc = NEG;
      for (int e = 0; e < n; ++e) mc = fmaxf(mc, sc[g * TILE + e]);
      const float mn = fmaxf(m[g], mc);
      const float a = expf(m[g] - mn);
      float sum = 0.f;
      for (int e = 0; e < n; ++e) {
        const float p = expf(sc[g * TILE + e] - mn);
        sc[g * TILE + e] = p;
        sum += p;
      }
      l[g] = l[g] * a + sum;
      m[g] = mn;
      alpha[g] = a;
    }
    __syncthreads();

    for (int i = tid; i < G * D; i += NTHREADS) {
      const int g = i / D, d = i % D;
      float x = acc[i] * alpha[g];
      for (int e = 0; e < n; ++e) x = fmaf(sc[g * TILE + e], vt[e * LDK + d], x);
      acc[i] = x;
    }
    __syncthreads();
  }

  for (int i = tid; i < G * D; i += NTHREADS) {
    const float lg = l[i / D];
    out[q_off + i] = from_float<TQ>(acc[i] / (lg == 0.f ? 1.f : lg));
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, const void* kv_pos, const void* q_pos, void* out, int B,
           int H, int KV, int S, int D, int pos_stride, int window, float scale,
           cudaStream_t stream) {
  const size_t bytes = smem_floats(H / KV, D) * sizeof(float);
  auto kernel = decode_attention_kernel<TQ, TKV>;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(B, KV);
  kernel<<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int*>(kv_pos), static_cast<const int*>(q_pos),
      static_cast<TQ*>(out), H, KV, S, D, pos_stride, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, H, D] and out [B, H, D] share q_dtype; k/v [B, KV, S, D] have
// kv_dtype (equal to q_dtype, or int8 with fp32 scales [B, KV, S]); kv_pos
// is int32 with row b at kv_pos + b * pos_stride (pos_stride 0: one [S] row
// shared by every slot); q_pos [B] int32.  Dtype codes: 0 float32,
// 1 bfloat16, 2 int8.  Launches on `stream` and returns cudaGetLastError()
// (0 on success).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* k_scale, const void* v_scale,
                                const void* kv_pos, const void* q_pos, void* out, int B,
                                int H, int KV, int S, int D, int pos_stride, int window,
                                float scale, int q_dtype, int kv_dtype, void* stream) {
  if (B <= 0 || KV <= 0 || KV > 65535 || H % KV != 0 || D <= 0 || S < 0 ||
      pos_stride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem_floats(H / KV, D) * sizeof(float) > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool quant = kv_dtype == 2;
  if (quant != (k_scale != nullptr) || quant != (v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
#define ARGS q, k, v, k_scale, v_scale, kv_pos, q_pos, out, B, H, KV, S, D, pos_stride, \
             window, scale, s
  if (q_dtype == 0 && kv_dtype == 0) return launch<float, float>(ARGS);
  if (q_dtype == 1 && kv_dtype == 1) return launch<__nv_bfloat16, __nv_bfloat16>(ARGS);
  if (q_dtype == 0 && kv_dtype == 2) return launch<float, int8_t>(ARGS);
  if (q_dtype == 1 && kv_dtype == 2) return launch<__nv_bfloat16, int8_t>(ARGS);
#undef ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
