// decode_attention for Hopper (sm_90a): one-token GQA attention over a dense
// [B, KV, S, D] KV cache, optionally int8 with per-(batch, head, slot) scales.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention.py::decode_attention (body _kernel).  On
// the TPU the grid (b, kv_head, s_block) runs in order on one core and carries
// the online-softmax state in VMEM scratch from one s_block to the next; the
// wrapper picks an s_block that divides S (_divisible_block) so that the
// cache is never padded.  Blocks on a GPU run in no order and share nothing,
// so the sequence is split instead (flash-decoding): block (b, kv head, split
// z) holds the G = H / KV query rows of that head and walks only the z-th
// chunk of `tps` tiles of TILE entries, keeping (m, l, acc) in fp32; a second
// kernel combines the splits.  A ragged last tile is masked here, so no S
// needs padding and the cache is never copied.
//
// Semantics (those of repro/kernels/ref.py::decode_attention, which the JAX
// package runs off the TPU):
//   * entry j is live for slot b when 0 <= kv_pos[b, j] <= q_pos[b] (and
//     kv_pos[b, j] > q_pos[b] - window when a window is set); empty entries
//     hold -2^30.  The ring wraps, so liveness is checked entry by entry;
//   * a tile with no live entry is skipped before its K/V are read, and a
//     dead entry inside a live tile is never read either; a split whose
//     chunk holds no live entry ends with m = -1e30, l = 0, acc = 0;
//   * masked scores are -1e30 and m starts at -1e30, so a slot with no live
//     entry ends with l == 0 and writes exact zeros.  (The Pallas kernel does
//     not: its -1e30 fill makes every masked p equal 1 on such a row, which
//     then averages V.  The port follows the plain version.)
//   * int8 K/V are dequantized in registers with their [B, KV, S] scales.
//
// What bounds it on an H100: it reads every live K/V byte once and does
// ~2 FLOP per byte per query row, so it is bound by the cache read -- at the
// dense serving shape (one slot, 4 KV heads, a 512-entry int8 cache) some
// 180 KB, which the card reads in ~0.06 us.  The call is latency-bound:
// what decides its time is how many SMs share the walk and how long one
// block's chain of loads, reductions and barriers takes.  So:
//   * the plan (kernels/decode_attention.py::plan) splits the sequence until
//     B * KV * splits reaches about one block per SM, and not at all when
//     B * KV already fills the card;
//   * within a block, the tile's K and V rows are loaded as 16-byte vectors
//     (an int8 row of D 128 in 8 of them), dequantized in registers and
//     staged once in shared memory for all G query rows;
//   * each warp owns whole query rows: lane e scores entry e of the tile and
//     the row's max and sum are warp shuffles, so the online-softmax update
//     runs on every lane and needs no barrier of its own;
//   * the combine (decode_attention_combine, whose body flash_decode.cuh
//     shares with paged_attention.cu) reads the splits in the order
//     z = 0, 1, ...: M = max m_z, out = sum e^(m_z - M) acc_z / sum
//     e^(m_z - M) l_z, rounded once, exact zeros where the sum of l is 0.
//     No atomics and no block waits on another: the same bits on every run.
//     With one split the split kernel writes the output itself.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "flash_decode.cuh"

namespace {

using namespace flash_decode;

constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr int TILE = 32;   // entries a tile: one per lane of the scoring warp
constexpr int SMEM_MAX = 227 * 1024;

// Every field an int.  The one list of them: struct Plan and the names
// decode_attention_plan_fields() gives, which kernels/decode_attention.py
// checks against its PLAN_FIELDS when it loads this library.
#define DECODE_ATTENTION_PLAN(X) \
  X(B) X(H) X(KV) X(S) X(D) X(G) X(ntiles) X(splits) X(tps) X(blocks) X(smem)

#define PLAN_DECL(f) int f;
#define PLAN_NAME(f) #f ","
#define PLAN_ONE(f) +1
struct Plan {
  DECODE_ATTENTION_PLAN(PLAN_DECL)
};
constexpr int PLAN_INTS = 0 DECODE_ATTENTION_PLAN(PLAN_ONE);
static_assert(sizeof(Plan) == PLAN_INTS * sizeof(int), "Plan is ints only");

// Shared-memory geometry, in floats.  Rows are D rounded up to a float4
// (d4 groups; the padding holds zeros); the K and V tiles' row stride is an
// odd number of float4s, so that lanes reading 16 bytes of neighbouring rows
// hit distinct banks.
struct Geometry {
  int d4, ldk;
  int q, acc, kt, vt, sc, m, l, alpha, live, floats;
  __host__ __device__ explicit Geometry(int G, int D) {
    d4 = (D + 3) / 4;
    ldk = 4 * (d4 % 2 ? d4 : d4 + 1);
    q = 0;                          // [G, 4 d4] the query rows
    acc = q + G * 4 * d4;           // [G, 4 d4] the unnormalised output
    kt = acc + G * 4 * d4;          // [TILE, ldk] dequantized K
    vt = kt + TILE * ldk;           // [TILE, ldk] dequantized V
    sc = vt + TILE * ldk;           // [G, TILE] scores, then weights
    m = sc + G * TILE;              // [G]
    l = m + G;                      // [G]
    alpha = l + G;                  // [G]
    live = alpha + G;               // [TILE] ints: the tile's live entries
    floats = live + TILE;
  }
};

// Stage the tile's rows [0, TILE) of K and V as fp32 (dequantized with the
// entry's scale) into kt / vt; a dead entry, or one past S, is written as
// zeros and never read.  VEC: every row is read as 16-byte vectors.
template <typename TKV, bool VEC>
__device__ __forceinline__ void load_tile(float* kt, float* vt, const int* live,
                                          const TKV* __restrict__ k,
                                          const TKV* __restrict__ v,
                                          const float* __restrict__ k_scale,
                                          const float* __restrict__ v_scale, size_t ent0,
                                          int D, int ldk) {
  if constexpr (VEC) {
    constexpr int E = 16 / sizeof(TKV);   // elements a vector
    const int per_row = D / E;
#pragma unroll 2
    for (int i = threadIdx.x; i < TILE * per_row; i += NTHREADS) {
      const int e = i / per_row, c = (i % per_row) * E;
      float kf[E], vf[E];
      if (live[e]) {
        const size_t ent = ent0 + e;
        unpack(*reinterpret_cast<const uint4*>(k + ent * D + c), kf);
        unpack(*reinterpret_cast<const uint4*>(v + ent * D + c), vf);
        if (k_scale != nullptr) {
          const float ks = k_scale[ent], vs = v_scale[ent];
#pragma unroll
          for (int u = 0; u < E; ++u) {
            kf[u] *= ks;
            vf[u] *= vs;
          }
        }
      } else {
#pragma unroll
        for (int u = 0; u < E; ++u) kf[u] = vf[u] = 0.f;
      }
#pragma unroll
      for (int u = 0; u < E; u += 4) {
        *reinterpret_cast<float4*>(kt + e * ldk + c + u) =
            make_float4(kf[u], kf[u + 1], kf[u + 2], kf[u + 3]);
        *reinterpret_cast<float4*>(vt + e * ldk + c + u) =
            make_float4(vf[u], vf[u + 1], vf[u + 2], vf[u + 3]);
      }
    }
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < TILE * D; i += NTHREADS) {
      const int e = i / D, d = i % D;
      float kf = 0.f, vf = 0.f;
      if (live[e]) {
        const size_t ent = ent0 + e;
        kf = to_float(k[ent * D + d]);
        vf = to_float(v[ent * D + d]);
        if (k_scale != nullptr) {
          kf *= k_scale[ent];
          vf *= v_scale[ent];
        }
      }
      kt[e * ldk + d] = kf;
      vt[e * ldk + d] = vf;
    }
  }
}

// Block (b, kv head, split z): the G query rows of the head over the
// entries of tiles [z * tps, min(ntiles, (z + 1) * tps)).  With one split it
// writes out [B, H, D]; otherwise part [B, H, splits, D + 2] holds (m, l,
// acc[D]) of each row.
template <typename TQ, typename TKV, bool VEC>
__global__ void __launch_bounds__(NTHREADS)
decode_attention_split(const TQ* __restrict__ q, const TKV* __restrict__ k,
                       const TKV* __restrict__ v, const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale, const int* __restrict__ kv_pos,
                       const int* __restrict__ q_pos, TQ* __restrict__ out,
                       float* __restrict__ part, const Plan p, int pos_stride,
                       int q_stride, int window, float scale) {
  const int G = p.G, D = p.D;
  const Geometry g(G, D);
  const int D4 = g.d4;
  const int z = blockIdx.x % p.splits;
  const int h = (blockIdx.x / p.splits) % p.KV;
  const int b = blockIdx.x / (p.splits * p.KV);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qs = smem + g.q;
  float* acc = smem + g.acc;
  float* kt = smem + g.kt;
  float* vt = smem + g.vt;
  float* sc = smem + g.sc;
  float* m = smem + g.m;
  float* l = smem + g.l;
  float* alpha = smem + g.alpha;
  int* live_e = reinterpret_cast<int*>(smem + g.live);

  const int qp = q_pos[(size_t)b * q_stride];
  const int* pos_row = kv_pos + (size_t)b * pos_stride;
  const size_t row0 = ((size_t)b * p.KV + h) * (size_t)p.S;   // entry (b, h, 0)
  const int t0 = z * p.tps, t_end = min(p.ntiles, t0 + p.tps);
  // lane tid's position in the next tile, read ahead of the work before it
  int kp_next = tid < TILE && t0 * TILE + tid < p.S ? pos_row[t0 * TILE + tid] : -1;

  // the head's G query rows lie contiguous in q: 16-byte vectors where
  // D % 4 == 0 (no padding) and they are aligned, else one element a thread
  const size_t q_off = ((size_t)b * p.H + (size_t)h * G) * D;
  constexpr int QE = 16 / sizeof(TQ);
  if (D % 4 == 0 && (G * D) % QE == 0 &&
      reinterpret_cast<uintptr_t>(q + q_off) % 16 == 0) {
    for (int i = tid * QE; i < G * D; i += NTHREADS * QE) {
      float f[QE];
      unpack(*reinterpret_cast<const uint4*>(q + q_off + i), f);
#pragma unroll
      for (int u = 0; u < QE; u += 4)
        *reinterpret_cast<float4*>(qs + i + u) = make_float4(f[u], f[u + 1], f[u + 2], f[u + 3]);
    }
  } else {
#pragma unroll 4
    for (int i = tid; i < G * 4 * D4; i += NTHREADS) {
      const int r = i / (4 * D4), d = i % (4 * D4);
      qs[i] = d < D ? to_float(q[q_off + (size_t)r * D + d]) : 0.f;
    }
  }
  for (int i = tid; i < G * 4 * D4; i += NTHREADS) acc[i] = 0.f;
  // the K and V rows' padding columns stay zero: loads write columns < D
  if (D % 4 != 0) {
    for (int i = tid; i < 2 * TILE; i += NTHREADS)
      for (int d = D; d < 4 * D4; ++d) kt[i * g.ldk + d] = 0.f;   // kt, then vt
  }
  for (int r = tid; r < G; r += NTHREADS) {
    m[r] = NEG;
    l[r] = 0.f;
  }

  for (int t = t0; t < t_end; ++t) {
    const int kp = kp_next;
    int ok = 0;
    if (tid < TILE) {
      const int e = (t + 1) * TILE + tid;
      kp_next = t + 1 < t_end && e < p.S ? pos_row[e] : -1;
      ok = kp >= 0 && kp <= qp && (window == 0 || kp > qp - window);
      live_e[tid] = ok;
    }
    // also the barrier that ends the previous tile's use of kt, vt and sc
    if (!__syncthreads_or(ok)) continue;   // block-uniform: nothing live

    const int s0 = t * TILE;
    load_tile<TKV, VEC>(kt, vt, live_e, k, v, k_scale, v_scale, row0 + s0, D, g.ldk);
    __syncthreads();

    // scores and the online-softmax update: warp w owns rows w, w + 4, ...;
    // lane e scores entry e, and the row's max and sum are shuffles
    for (int r = warp; r < G; r += NWARPS) {
      float s = NEG;
      if (live_e[lane]) {
        const float4* qr = reinterpret_cast<const float4*>(qs + r * 4 * D4);
        const float4* kr = reinterpret_cast<const float4*>(kt + lane * g.ldk);
        // four running sums (one a float4 lane), added once at the end
        float4 dot = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
        for (int c = 0; c < D4; ++c) {
          const float4 a = qr[c], bk = kr[c];
          dot.x = fmaf(a.x, bk.x, dot.x);
          dot.y = fmaf(a.y, bk.y, dot.y);
          dot.z = fmaf(a.z, bk.z, dot.z);
          dot.w = fmaf(a.w, bk.w, dot.w);
        }
        s = ((dot.x + dot.y) + (dot.z + dot.w)) * scale;
      }
      const float m_old = m[r];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float pe = live_e[lane] ? expf(s - m_new) : 0.f;
      const float sum = warp_sum(pe);
      sc[r * TILE + lane] = pe;
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        m[r] = m_new;
        l[r] = l[r] * a + sum;
        alpha[r] = a;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V: thread over (row, float4 column group);
    // neighbouring threads read neighbouring 16 bytes of a V row
    for (int i = tid; i < G * D4; i += NTHREADS) {
      const int r = i / D4, c = i % D4;
      float4* ar = reinterpret_cast<float4*>(acc + r * 4 * D4) + c;
      const float a = alpha[r];
      float4 x = *ar;
      x.x *= a;
      x.y *= a;
      x.z *= a;
      x.w *= a;
      const float* pr = sc + r * TILE;
#pragma unroll 8
      for (int e = 0; e < TILE; ++e) {
        const float pe = pr[e];
        const float4 vv = reinterpret_cast<const float4*>(vt + e * g.ldk)[c];
        x.x = fmaf(pe, vv.x, x.x);
        x.y = fmaf(pe, vv.y, x.y);
        x.z = fmaf(pe, vv.z, x.z);
        x.w = fmaf(pe, vv.w, x.w);
      }
      *ar = x;
    }
  }
  __syncthreads();

  if (p.splits == 1) {
    for (int i = tid; i < G * D; i += NTHREADS) {
      const int r = i / D, d = i % D;
      const float lr = l[r];
      out[q_off + i] = from_float<TQ>(acc[r * 4 * D4 + d] / (lr == 0.f ? 1.f : lr));
    }
    return;
  }
  const int W = D + 2;
  for (int i = tid; i < G * W; i += NTHREADS) {
    const int r = i / W, c = i % W;
    const float x = c == 0 ? m[r] : c == 1 ? l[r] : acc[r * 4 * D4 + c - 2];
    part[(((size_t)b * p.H + (size_t)h * G + r) * p.splits + z) * W + c] = x;
  }
}

// out[row, :] from part[row, z, :] for z = 0, 1, ..., splits - 1, in that
// order: M = max m_z, out = sum e^(m_z - M) acc_z / sum e^(m_z - M) l_z,
// rounded once; exact zeros when the sum of l is 0 (no live entry).  The
// splits' weights and l go through shared memory ([2, splits] floats).
template <typename TQ>
__global__ void __launch_bounds__(NTHREADS)
decode_attention_combine(const float* __restrict__ part, TQ* __restrict__ out, int splits,
                         int D) {
  extern __shared__ float cw[];   // [splits] m_z, then e^(m_z - M); [splits] l_z
  combine_splits<TQ, NTHREADS>(part, out, splits, D, cw);
}

bool plan_ok(const Plan& p) {
  if (p.B <= 0 || p.KV <= 0 || p.H % p.KV != 0 || p.G != p.H / p.KV || p.D <= 0 || p.S < 0)
    return false;
  if (p.ntiles != (p.S + TILE - 1) / TILE || p.splits < 1 || p.tps < (p.ntiles > 0))
    return false;
  if (p.tps * p.splits < p.ntiles || (p.splits > 1 && (p.splits - 1) * p.tps >= p.ntiles))
    return false;
  if (static_cast<long long>(p.B) * p.KV * p.splits != p.blocks) return false;
  const long long bytes = static_cast<long long>(Geometry(p.G, p.D).floats) * sizeof(float);
  return p.smem == bytes && bytes <= SMEM_MAX;
}

template <typename TQ, typename TKV, bool VEC>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, const void* kv_pos, const void* q_pos, void* out, void* part,
           const Plan& p, int pos_stride, int q_stride, int window, float scale,
           cudaStream_t stream) {
  auto kernel = decode_attention_split<TQ, TKV, VEC>;
  if (p.smem > 48 * 1024) {
    static bool sized[64] = {};   // once per variant and device: the most any plan asks
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= 64 || !sized[dev]) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (dev < 64) sized[dev] = true;
    }
  }
  kernel<<<p.blocks, NTHREADS, p.smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int*>(kv_pos), static_cast<const int*>(q_pos), static_cast<TQ*>(out),
      static_cast<float*>(part), p, pos_stride, q_stride, window, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return static_cast<int>(err);
  decode_attention_combine<TQ><<<p.B * p.H, NTHREADS, 2 * p.splits * sizeof(float), stream>>>(
      static_cast<const float*>(part), static_cast<TQ*>(out), p.splits, p.D);
  return static_cast<int>(cudaGetLastError());
}

// whether every K and V row can be read as 16-byte vectors
template <typename TKV>
bool vectors(const void* k, const void* v, int D) {
  return (static_cast<size_t>(D) * sizeof(TKV)) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(k) % 16 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0;
}

}  // namespace

// The plan's field names in struct Plan's order, each followed by a comma.
extern "C" const char* decode_attention_plan_fields() {
  return DECODE_ATTENTION_PLAN(PLAN_NAME);
}

// q [B, H, D] and out [B, H, D] share q_dtype; k/v [B, KV, S, D] have
// kv_dtype (equal to q_dtype, or int8 with fp32 scales [B, KV, S]); kv_pos
// is int32 with row b at kv_pos + b * pos_stride (pos_stride 0: one [S] row
// shared by every slot); q_pos int32, slot b's at q_pos[b * q_stride].
// `plan` holds `nplan` ints in the order of kernels/decode_attention.py's
// PLAN_FIELDS; when it splits the sequence, part is an fp32 buffer of
// B * H * splits * (D + 2).  Dtype codes: 0 float32, 1 bfloat16, 2 int8.
// Launches on `stream` (two kernels when split) and returns
// cudaGetLastError() (0 on success); a plan it does not take returns
// cudaErrorInvalidValue without launching.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* k_scale, const void* v_scale,
                                const void* kv_pos, const void* q_pos, void* out, void* part,
                                const int* plan, int nplan, int pos_stride, int q_stride,
                                int window, float scale, int q_dtype, int kv_dtype,
                                void* stream) {
  if (nplan != PLAN_INTS || pos_stride < 0 || q_stride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  memcpy(&p, plan, sizeof p);
  if (!plan_ok(p) || (p.splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool quant = kv_dtype == 2;
  if (quant != (k_scale != nullptr) || quant != (v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ARGS q, k, v, k_scale, v_scale, kv_pos, q_pos, out, part, p, pos_stride, q_stride, \
             window, scale, s
#define LAUNCH(TQ, TKV)                                                        \
  return vectors<TKV>(k, v, p.D) ? launch<TQ, TKV, true>(ARGS) \
                                 : launch<TQ, TKV, false>(ARGS)
  if (q_dtype == 0 && kv_dtype == 0) LAUNCH(float, float);
  if (q_dtype == 1 && kv_dtype == 1) LAUNCH(__nv_bfloat16, __nv_bfloat16);
  if (q_dtype == 0 && kv_dtype == 2) LAUNCH(float, int8_t);
  if (q_dtype == 1 && kv_dtype == 2) LAUNCH(__nv_bfloat16, int8_t);
#undef LAUNCH
#undef ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
