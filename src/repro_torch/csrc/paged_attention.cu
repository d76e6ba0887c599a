// paged_decode_attention for Hopper (sm_90a): one-token GQA attention read
// straight off the page pools.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/paged_attention.py::paged_decode_attention (body
// _kernel).  On the TPU the page table rides as a scalar-prefetch operand and
// the grid (slot, kv_head, page_block) runs in order on one core, carrying the
// online-softmax state in VMEM scratch from one grid step to the next.  Blocks
// on a GPU run in no order and share nothing, so the sequential page-block
// axis becomes a loop inside one block: one block per (slot, kv head) holds
// the G = H / KV query rows of that head, walks the slot's row of the page
// table itself, and keeps (m, l, acc) in fp32 shared memory across pages.
//
// Semantics kept from the TPU kernel:
//   * a page is dead when its table entry is >= n_pages (the unallocated-slot
//     sentinel) or its first logical index lies beyond q_pos; dead pages are
//     never read;
//   * a live page whose entries all fail the position mask (empty, future, or
//     outside the sliding window) is skipped before its K/V are touched;
//   * masked logits are -1e30 and m starts at -1e30, so a slot with no live
//     entry ends with l == 0 and writes exact zeros;
//   * int8 pools are dequantized on load with their [n_pages, KV, ps] scales.
//
// What bounds it on an H100: it reads every live K/V byte once and does ~2
// FLOP per byte per query row, so it is bound by the pool read.  This first
// design only runs B * KV blocks (16 at the main path's 4 slots x 4 KV heads),
// which cannot draw the card's full memory rate; splitting the sequence
// across blocks (flash-decoding) is left for later work.  Within a block, the
// page's K and V are staged in shared memory once and reused by all G query
// rows, and the K tile is padded by one float per row so that the score loop
// (threads over entries) reads distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 128;
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

// shared memory, in floats: q [G*D], acc [G*D], k/v tiles [ps*(D+1)] each,
// scores [G*ps], m/l/alpha [G] each, then the page's live-entry flags [ps]
__host__ __device__ inline size_t smem_floats(int G, int D, int ps) {
  return 2 * (size_t)G * D + 2 * (size_t)ps * (D + 1) + (size_t)G * ps + 3 * (size_t)G +
         (size_t)ps;
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(NTHREADS)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                    const TKV* __restrict__ v, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale, const int* __restrict__ pos,
                    const int* __restrict__ table, const int* __restrict__ q_pos,
                    TQ* __restrict__ out, int H, int KV, int D, int n_pages, int ps,
                    int MP, int window, float scale) {
  const int b = blockIdx.x;   // slot
  const int h = blockIdx.y;   // kv head
  const int G = H / KV;
  const int LDK = D + 1;
  const int tid = threadIdx.x;

  extern __shared__ float smem[];
  float* qs = smem;                 // [G, D]
  float* acc = qs + G * D;          // [G, D]
  float* kt = acc + G * D;          // [ps, D+1]
  float* vt = kt + ps * LDK;        // [ps, D+1]
  float* sc = vt + ps * LDK;        // [G, ps]
  float* m = sc + G * ps;           // [G]
  float* l = m + G;                 // [G]
  float* alpha = l + G;             // [G]
  int* live_e = reinterpret_cast<int*>(alpha + G);   // [ps]
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
  __syncthreads();

  for (int j = 0; j < MP; ++j) {
    const int pid = table[(size_t)b * MP + j];
    // page liveness: allocated, and the ring has reached its first entry
    if (pid < 0 || pid >= n_pages || (long long)j * ps > (long long)qp) continue;

    if (tid == 0) any_live = 0;
    __syncthreads();
    for (int e = tid; e < ps; e += NTHREADS) {
      const int kp = pos[(size_t)pid * ps + e];
      const int ok = kp >= 0 && kp <= qp && (window == 0 || kp > qp - window);
      live_e[e] = ok;
      if (ok) any_live = 1;
    }
    __syncthreads();
    if (!any_live) continue;   // block-uniform: nothing on this page survives

    const size_t kv_off = ((size_t)pid * KV + h) * (size_t)ps * D;
    const size_t sc_off = ((size_t)pid * KV + h) * (size_t)ps;
    for (int i = tid; i < ps * D; i += NTHREADS) {
      const int e = i / D, d = i % D;
      float kf = to_float(k[kv_off + i]);
      float vf = to_float(v[kv_off + i]);
      if (k_scale != nullptr) {
        kf *= k_scale[sc_off + e];
        vf *= v_scale[sc_off + e];
      }
      kt[e * LDK + d] = kf;
      vt[e * LDK + d] = vf;
    }
    __syncthreads();

    // scores: one (row, entry) pair per thread
    for (int i = tid; i < G * ps; i += NTHREADS) {
      const int g = i / ps, e = i % ps;
      float s = NEG;
      if (live_e[e]) {
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(qs[g * D + d], kt[e * LDK + d], dot);
        s = dot * scale;
      }
      sc[i] = s;
    }
    __syncthreads();

    // online-softmax update, one row per thread; scores become weights
    for (int g = tid; g < G; g += NTHREADS) {
      float mc = NEG;
      for (int e = 0; e < ps; ++e) mc = fmaxf(mc, sc[g * ps + e]);
      const float mn = fmaxf(m[g], mc);
      const float a = expf(m[g] - mn);
      float sum = 0.f;
      for (int e = 0; e < ps; ++e) {
        const float p = expf(sc[g * ps + e] - mn);
        sc[g * ps + e] = p;
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
      for (int e = 0; e < ps; ++e) x = fmaf(sc[g * ps + e], vt[e * LDK + d], x);
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
           const void* v_scale, const void* pos, const void* table, const void* q_pos,
           void* out, int B, int H, int KV, int D, int n_pages, int ps, int MP,
           int window, float scale, cudaStream_t stream) {
  const size_t bytes = smem_floats(H / KV, D, ps) * sizeof(float);
  auto kernel = paged_decode_kernel<TQ, TKV>;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(B, KV);
  kernel<<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int*>(pos), static_cast<const int*>(table),
      static_cast<const int*>(q_pos), static_cast<TQ*>(out), H, KV, D, n_pages, ps, MP,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, H, D] and out [B, H, D] share q_dtype; k/v pages [n_pages, KV, ps, D]
// have kv_dtype (equal to q_dtype, or int8 with fp32 scales
// [n_pages, KV, ps]); pos [n_pages, ps], table [B, MP] and q_pos [B] are
// int32.  Dtype codes: 0 float32, 1 bfloat16, 2 int8.  Launches on `stream`
// and returns cudaGetLastError() (0 on success).
extern "C" int paged_decode_attention(const void* q, const void* k, const void* v,
                                      const void* k_scale, const void* v_scale,
                                      const void* pos, const void* table,
                                      const void* q_pos, void* out, int B, int H, int KV,
                                      int D, int n_pages, int ps, int MP, int window,
                                      float scale, int q_dtype, int kv_dtype,
                                      void* stream) {
  if (B <= 0 || B > 2147483647 / 2 || KV <= 0 || KV > 65535 || H % KV != 0 || D <= 0 ||
      ps <= 0 || MP < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem_floats(H / KV, D, ps) * sizeof(float) > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool quant = kv_dtype == 2;
  if (quant != (k_scale != nullptr) || quant != (v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
#define ARGS q, k, v, k_scale, v_scale, pos, table, q_pos, out, B, H, KV, D, n_pages, ps, MP, \
             window, scale, s
  if (q_dtype == 0 && kv_dtype == 0) return launch<float, float>(ARGS);
  if (q_dtype == 1 && kv_dtype == 1) return launch<__nv_bfloat16, __nv_bfloat16>(ARGS);
  if (q_dtype == 0 && kv_dtype == 2) return launch<float, int8_t>(ARGS);
  if (q_dtype == 1 && kv_dtype == 2) return launch<__nv_bfloat16, int8_t>(ARGS);
#undef ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
