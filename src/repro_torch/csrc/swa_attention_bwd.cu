// swa_attention_bwd for Hopper (sm_90a): the gradient of causal
// sliding-window attention (swa_attention.cu) with respect to q, k and v.
// q, out, dout and dq are [B, H, S, D], k, v, dk and dv [B, KV, S, D] (GQA:
// query head h reads KV head h / (H / KV)); lse [B, H, S] is the forward's
// row log-sum-exp of the scaled scores, in natural log units.  Token i
// attends to key j iff i - W < j <= i.
//
// Replaces no TPU kernel: the Pallas swa_attention
// (src/repro/kernels/swa_attention.py::swa_attention) has no backward, and
// JAX's pallas_call has a JVP rule but no transpose, so the reference cannot
// train through it (on a TPU it takes the kernel; elsewhere it takes an
// attention XLA differentiates).  It was added so that the windowed archs
// (gemma3-12b's local layers, mixtral-8x22b) train on the card through the
// same forward kernel they are served with: ops.SwaAttention saves q, k, v,
// out and lse and calls this for dq, dk and dv.
//
// The flash-attention backward, recomputing the probabilities from lse:
//   s_ij = scale q_i . k_j,  P_ij = exp(s_ij - lse_i) inside the window,
//   dP_ij = dout_i . v_j,    delta_i = sum_d dout_id out_id,
//   dS_ij = P_ij (dP_ij - delta_i),
//   dq_i = scale sum_j dS_ij k_j,  dk_j = scale sum_i dS_ij q_i,
//   dv_j = sum_i P_ij dout_i  (i over the query heads of k_j's group too).
// Three passes, two launches:
//   * swa_bwd_delta: one warp a row, delta_i in fp32 (scratch [B, H, S]);
//   * one grid of two kinds of block.  A dK/dV block per (b * KV, key tile)
//     walks the q tiles that see its keys (rows j .. j + W - 1, clipped at
//     S), the G query heads of its group in a fixed order, and keeps dk and
//     dv for its keys on chip; a dQ block per (b * H, q tile) walks the kv
//     tiles of its rows' windows, as the forward does, and keeps dq on chip.
//     Each output is written once by one block: no atomics, so two calls
//     give the same bits.  The dK/dV blocks walk about G times the pairs
//     and come first in the grid.  Masked pairs (outside the window, rows or
//     keys past S) get P = dS = 0 without evaluating exp.
//
// bfloat16 (swa_bwd_mma; kernels/swa_attention.py::plan_bwd path 1): the
// products on the tensor cores with mma.sync m16n8k16 (bf16 in, fp32
// accumulate), operands read from shared memory by ldmatrix (.trans where
// the product wants the tile's other major), D zero-padded to DP = 64, 128
// or 256 columns, rows at stride DP + 8 so that ldmatrix's eight rows fall
// in distinct banks.  8 warps: 4 groups of 16 rows (dQ) or keys (dK/dV) x
// 2 halves of DP.  A dQ block holds 64 q rows and steps over 64-key tiles:
// each warp computes S and dP for its 16 rows (both halves compute them),
// turns them into dS in registers and accumulates dq for its half of DP.
// A dK/dV block holds 64 keys and steps over 32-row q tiles: each warp
// computes S^T and dP^T for its 16 keys, P^T and dS^T in registers, and
// accumulates dv = P^T dout and dk = dS^T q for its half of DP.  P and dS
// are rounded to bf16 as the A operands of the second products (the
// forward rounds P for its PV product the same way); the fp32 accumulators
// are rounded once to bf16 at the end.
//
// float32 (swa_bwd_fma; path 0): the FMA kernel, fp32 throughout (no TF32):
// tiles of 32 rows at an odd row stride (D + 1, so lanes over keys read
// distinct banks, rows as broadcasts), the P and dS tiles at stride 33.
//
// What bounds it on an H100: the bound counts 10 operations per in-window
// pair and dim (2.5x the forward's 4) at the tensor cores' bf16 rate.  The
// bf16 kernel does 22: both passes recompute S and dP, and the two halves
// of DP compute them twice; it reads its operands from shared memory with
// one barrier between a tile's load and its products, so latency, not the
// tensor cores' rate, bounds it.  The fp32 kernel does 14 on FMA, bound by
// its shared-memory loads.  A wgmma/TMA redesign is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int SMEM_MAX = 227 * 1024;

// Every field an int.  The one list of them: struct Plan and the names
// swa_attention_bwd_plan_fields() gives, which kernels/swa_attention.py
// checks against its BWD_PLAN_FIELDS when it loads this library.
#define SWA_ATTENTION_BWD_PLAN(X)                                              \
  X(path) X(B) X(H) X(KV) X(S) X(D) X(W)                                       \
  /* bfloat16: D padded to DP columns */                                       \
  X(DP) X(qtiles) X(kvtiles) X(dq_blocks) X(dkv_blocks) X(smem)

#define PLAN_DECL(f) int f;
#define PLAN_NAME(f) #f ","
#define PLAN_ONE(f) +1
struct Plan {
  SWA_ATTENTION_BWD_PLAN(PLAN_DECL)
};
constexpr int PLAN_INTS = 0 SWA_ATTENTION_BWD_PLAN(PLAN_ONE);
static_assert(sizeof(Plan) == PLAN_INTS * sizeof(int), "Plan is ints only");

__host__ __device__ inline size_t align128(size_t x) {
  return (x + 127) & ~static_cast<size_t>(127);
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// delta_i = sum_d dout_id out_id, one warp a row, lanes over d in a fixed
// order
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
swa_bwd_delta(const T* __restrict__ out, const T* __restrict__ dout, float* __restrict__ delta,
              long long rows, int D) {
  const long long row = static_cast<long long>(blockIdx.x) * NWARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* o = out + row * D;
  const T* g = dout + row * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s = fmaf(widen(o[d]), widen(g[d]), s);
  s = warp_sum(s);
  if (lane == 0) delta[row] = s;
}

// lse and delta of rows row0 .. row0 + n - 1 into [rows] (0 past n)
__device__ __forceinline__ void load_stats(float* lse_s, float* delta_s,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ delta, size_t row0, int n,
                                           int rows) {
  for (int r = threadIdx.x; r < rows; r += NTHREADS) {
    lse_s[r] = r < n ? lse[row0 + r] : 0.f;
    delta_s[r] = r < n ? delta[row0 + r] : 0.f;
  }
}

// ---------------------------------------------------------------------------
// float32: the FMA kernel
// ---------------------------------------------------------------------------

namespace fp32 {

constexpr int BQ = 32, BKV = 32;   // q and kv tile rows (and a dK/dV step's rows)
constexpr int LDS = BKV + 1;       // row stride of the P and dS tiles

// Shared memory for head dim D (kernels/swa_attention.py::_bwd_smem): the
// Q, dO, K and V tiles at row stride D + 1, the P and dS tiles at stride 33,
// two [32, D] accumulators (dK and dV; a dQ block uses the first), and the
// rows' lse and delta, each region 128-byte aligned.
struct Geometry {
  int ldt;
  size_t off_do, off_k, off_v, off_p, off_ds, off_acc, off_acc2, off_stats, bytes;

  __host__ __device__ explicit Geometry(int D) {
    ldt = D + 1;
    const size_t tile = align128(sizeof(float) * BQ * ldt);
    const size_t ptile = align128(sizeof(float) * BQ * LDS);
    const size_t acc = align128(sizeof(float) * BKV * D);
    off_do = tile;
    off_k = off_do + tile;
    off_v = off_k + tile;
    off_p = off_v + tile;
    off_ds = off_p + ptile;
    off_acc = off_ds + ptile;
    off_acc2 = off_acc + acc;
    off_stats = off_acc2 + acc;   // lse, delta: [BQ] each
    bytes = off_stats + align128(sizeof(float) * 2 * BQ);
  }
};

// Stage rows [0, n) of a [*, D] row-major slice into a [32, D] tile of row
// stride ld; rows >= n are zero.
__device__ void load_tile(float* dst, const float* __restrict__ src, int n, int D, int ld) {
  for (int i = threadIdx.x; i < BQ * D; i += NTHREADS) {
    const int r = i / D, c = i % D;
    dst[r * ld + c] = r < n ? src[static_cast<size_t>(r) * D + c] : 0.f;
  }
}

// The scores of one (q tile, kv tile) pair and their gradient: lanes over the
// 32 keys, warps over rows r = warp + 8u.  Writes P (when ps is not null) and
// dS to shared memory, zero outside the window and past S.
__device__ __forceinline__ void score_tile(const float* qs, const float* dos, const float* ks,
                                           const float* vs, const float* lse_s,
                                           const float* delta_s, float* ps, float* dss,
                                           int q0, int k0, int S, int W, int D, int ldt,
                                           float scale) {
  constexpr int RPW = BQ / NWARPS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float s[RPW], dp[RPW];
#pragma unroll
  for (int u = 0; u < RPW; ++u) s[u] = dp[u] = 0.f;
  for (int d = 0; d < D; ++d) {
    const float kd = ks[lane * ldt + d], vd = vs[lane * ldt + d];
#pragma unroll
    for (int u = 0; u < RPW; ++u) {
      const int r = warp + NWARPS * u;
      s[u] = fmaf(qs[r * ldt + d], kd, s[u]);
      dp[u] = fmaf(dos[r * ldt + d], vd, dp[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < RPW; ++u) {
    const int r = warp + NWARPS * u;
    const int i = q0 + r, j = k0 + lane;
    const bool ok = i < S && j < S && j <= i && j > i - W;
    float p = 0.f, ds = 0.f;
    if (ok) {
      p = expf(s[u] * scale - lse_s[r]);
      ds = p * (dp[u] - delta_s[r]);
    }
    if (ps != nullptr) ps[r * LDS + lane] = p;
    dss[r * LDS + lane] = ds;
  }
}

// two blocks an SM where shared memory allows (D <= 128): 128 registers
__global__ void __launch_bounds__(NTHREADS, 2)
swa_bwd_fma(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv, const Plan p,
            float scale) {
  const Geometry g(p.D);
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* dos = reinterpret_cast<float*>(smem + g.off_do);
  float* ks = reinterpret_cast<float*>(smem + g.off_k);
  float* vs = reinterpret_cast<float*>(smem + g.off_v);
  float* ps = reinterpret_cast<float*>(smem + g.off_p);
  float* dss = reinterpret_cast<float*>(smem + g.off_ds);
  float* acc = reinterpret_cast<float*>(smem + g.off_acc);
  float* acc2 = reinterpret_cast<float*>(smem + g.off_acc2);
  float* lse_s = reinterpret_cast<float*>(smem + g.off_stats);
  float* delta_s = lse_s + BQ;
  const int S = p.S, D = p.D, ldt = g.ldt;
  const int W = min(p.W, S);   // a window past S is the causal mask
  const int G = p.H / p.KV;

  if (static_cast<int>(blockIdx.x) < p.dkv_blocks) {
    // ---- dK/dV: one 32-key tile of one KV head ------------------------------
    const int bkv = blockIdx.x / p.kvtiles, kt = blockIdx.x % p.kvtiles;
    const int b = bkv / p.KV, kvh = bkv % p.KV;
    const int k0 = kt * BKV, nk = min(BKV, S - k0);
    const size_t kv_off = (static_cast<size_t>(bkv) * S + k0) * D;
    load_tile(ks, k + kv_off, nk, D, ldt);
    load_tile(vs, v + kv_off, nk, D, ldt);
    for (int i = threadIdx.x; i < BKV * D; i += NTHREADS) acc[i] = acc2[i] = 0.f;
    // the rows that see keys k0 .. k0 + 31: k0 to k0 + 31 + W - 1
    const int qt_lo = k0 / BQ;
    const int qt_hi = min(S - 1, k0 + BKV - 1 + W - 1) / BQ;
    for (int gi = 0; gi < G; ++gi) {
      const int bh = b * p.H + kvh * G + gi;
      for (int qt = qt_lo; qt <= qt_hi; ++qt) {
        const int q0 = qt * BQ, nq = min(BQ, S - q0);
        const size_t row0 = static_cast<size_t>(bh) * S + q0;
        __syncthreads();   // the previous tile's readers are done
        load_tile(qs, q + row0 * D, nq, D, ldt);
        load_tile(dos, dout + row0 * D, nq, D, ldt);
        load_stats(lse_s, delta_s, lse, delta, row0, nq, BQ);
        __syncthreads();
        score_tile(qs, dos, ks, vs, lse_s, delta_s, ps, dss, q0, k0, S, W, D, ldt, scale);
        __syncthreads();
        // dv[c][d] += sum_r P[r][c] dO[r][d]; dk[c][d] += sum_r dS[r][c] Q[r][d]
        for (int i = threadIdx.x; i < BKV * D; i += NTHREADS) {
          const int c = i / D, d = i % D;
          float av = acc2[i], ak = acc[i];
#pragma unroll 8
          for (int r = 0; r < BQ; ++r) {
            av = fmaf(ps[r * LDS + c], dos[r * ldt + d], av);
            ak = fmaf(dss[r * LDS + c], qs[r * ldt + d], ak);
          }
          acc2[i] = av;
          acc[i] = ak;
        }
      }
    }
    for (int i = threadIdx.x; i < nk * D; i += NTHREADS) {
      dk[kv_off + i] = acc[i] * scale;
      dv[kv_off + i] = acc2[i];
    }
    return;
  }

  // ---- dQ: one 32-row q tile of one query head, the longest walks first ----
  const int idx = blockIdx.x - p.dkv_blocks;
  const int BH = p.B * p.H;
  const int bh = idx % BH;
  const int qt = p.qtiles - 1 - idx / BH;
  const int b = bh / p.H, kvh = (bh % p.H) / G;
  const int q0 = qt * BQ, nq = min(BQ, S - q0);
  const size_t row0 = static_cast<size_t>(bh) * S + q0;
  const size_t kv_base = (static_cast<size_t>(b) * p.KV + kvh) * S * D;
  load_tile(qs, q + row0 * D, nq, D, ldt);
  load_tile(dos, dout + row0 * D, nq, D, ldt);
  load_stats(lse_s, delta_s, lse, delta, row0, nq, BQ);
  for (int i = threadIdx.x; i < BQ * D; i += NTHREADS) acc[i] = 0.f;
  const int kt_lo = max(0, q0 - W + 1) / BKV;
  const int kt_hi = (min(S, q0 + BQ) - 1) / BKV;
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BKV, nk = min(BKV, S - k0);
    __syncthreads();   // the previous tile's readers are done
    load_tile(ks, k + kv_base + static_cast<size_t>(k0) * D, nk, D, ldt);
    load_tile(vs, v + kv_base + static_cast<size_t>(k0) * D, nk, D, ldt);
    __syncthreads();
    score_tile(qs, dos, ks, vs, lse_s, delta_s, nullptr, dss, q0, k0, S, W, D, ldt, scale);
    __syncthreads();
    // dq[r][d] += sum_c dS[r][c] K[c][d]
    for (int i = threadIdx.x; i < BQ * D; i += NTHREADS) {
      const int r = i / D, d = i % D;
      float a = acc[i];
#pragma unroll 8
      for (int c = 0; c < BKV; ++c) a = fmaf(dss[r * LDS + c], ks[c * ldt + d], a);
      acc[i] = a;
    }
  }
  for (int i = threadIdx.x; i < nq * D; i += NTHREADS) dq[row0 * D + i] = acc[i] * scale;
}

}  // namespace fp32

// ---------------------------------------------------------------------------
// bfloat16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

namespace mma {

using bf16 = __nv_bfloat16;
constexpr int BQ = 64;    // a dQ block's q rows
constexpr int BKV = 64;   // a dK/dV block's keys, and a dQ block's kv step
constexpr int BQS = 32;   // a dK/dV block's q rows a step
constexpr int PAD = 8;    // row padding, elements: ldmatrix's rows in distinct banks

// Shared memory for DP columns (kernels/swa_attention.py::_bwd_smem): four
// bf16 tiles of 64 rows at stride DP + 8 (a dQ block: Q, dO, K, V; a dK/dV
// block: K, V, Q, dO, the last two of 32 rows used) and 64 lse and delta.
struct Geometry {
  int ld;
  size_t tile, bytes;
  __host__ __device__ explicit Geometry(int DP) {
    ld = DP + PAD;
    tile = sizeof(bf16) * 64 * ld;
    bytes = 4 * tile + sizeof(float) * 2 * 64;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a b: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col), d 16 x 8 fp32
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// The A fragment of k16 step s from the accumulator fragments of n8 tiles
// 2s and 2s + 1 (rows g and g + 8, columns 2t, 2t + 1 of each), rounded to
// bf16.
__device__ __forceinline__ void to_a(const float (&c0)[4], const float (&c1)[4],
                                     uint32_t (&a)[4]) {
  a[0] = pack(c0[0], c0[1]);
  a[1] = pack(c0[2], c0[3]);
  a[2] = pack(c1[0], c1[1]);
  a[3] = pack(c1[2], c1[3]);
}

// ldmatrix row addresses of this lane: an A fragment (16 rows from m0, k16
// from k0) of a row-major [m][k] tile; a B fragment pair (n8 tiles n0 and
// n0 + 8, k16 from k0) of a tile stored [n][k] (non-trans) or [k][n] (trans)
__device__ __forceinline__ uint32_t a_addr(uint32_t base, int ld, int m0, int k0, int lane) {
  return base + 2 * ((m0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}
__device__ __forceinline__ uint32_t bn_addr(uint32_t base, int ld, int n0, int k0, int lane) {
  return base + 2 * ((n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 + ((lane >> 3) & 1) * 8);
}
__device__ __forceinline__ uint32_t bt_addr(uint32_t base, int ld, int k0, int n0, int lane) {
  return base + 2 * ((k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 + (lane >> 4) * 8);
}

// Stage rows [0, n) of a [*, D] bf16 slice into a [rows, DP] tile of row
// stride ld in 16-byte chunks; columns D .. DP - 1 and rows >= n are zero.
__device__ void load_tile(bf16* dst, const bf16* __restrict__ src, int n, int rows, int D, int DP,
                          int ld) {
  const int cpr = DP / 8;
  for (int i = threadIdx.x; i < rows * cpr; i += NTHREADS) {
    const int r = i / cpr, c = (i % cpr) * 8;
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (r < n && c < D) w = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = w;
  }
}

template <int DP>
__global__ void __launch_bounds__(NTHREADS, 1)
swa_bwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
            const bf16* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, bf16* __restrict__ dq, bf16* __restrict__ dk,
            bf16* __restrict__ dv, const Plan p, float scale) {
  constexpr int NK = DP / 16;       // k16 steps over DP
  constexpr int NH = DP / 16;       // n8 tiles of one half of DP
  constexpr int HALF = DP / 2;
  const Geometry geo(DP);
  const int ld = geo.ld;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* t0 = reinterpret_cast<bf16*>(smem);
  bf16* t1 = t0 + 64 * ld;
  bf16* t2 = t1 + 64 * ld;
  bf16* t3 = t2 + 64 * ld;
  float* lse_s = reinterpret_cast<float*>(t3 + 64 * ld);
  float* delta_s = lse_s + 64;
  const uint32_t s0 = smem_u32(t0), s1 = smem_u32(t1), s2 = smem_u32(t2), s3 = smem_u32(t3);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int grp = warp & 3, dh = warp >> 2;   // 16 rows or keys, half of DP
  const int S = p.S, D = p.D;
  const int W = min(p.W, S);   // a window past S is the causal mask
  const int G = p.H / p.KV;

  if (static_cast<int>(blockIdx.x) < p.dkv_blocks) {
    // ---- dK/dV: 64 keys of one KV head; t0 = K, t1 = V, t2 = Q, t3 = dO ----
    const int bkv = blockIdx.x / p.kvtiles, kt = blockIdx.x % p.kvtiles;
    const int b = bkv / p.KV, kvh = bkv % p.KV;
    const int k0 = kt * BKV, nk = min(BKV, S - k0);
    const size_t kv_off = (static_cast<size_t>(bkv) * S + k0) * D;
    load_tile(t0, k + kv_off, nk, BKV, D, DP, ld);
    load_tile(t1, v + kv_off, nk, BKV, D, DP, ld);
    float acck[NH][4], accv[NH][4];
#pragma unroll
    for (int j = 0; j < NH; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acck[j][c] = accv[j][c] = 0.f;
    const int key0 = k0 + grp * 16 + g;   // this thread's keys: key0, key0 + 8
    // the rows that see keys k0 .. k0 + 63: k0 to k0 + 63 + W - 1
    const int qt_lo = k0 / BQS;
    const int qt_hi = min(S - 1, k0 + BKV - 1 + W - 1) / BQS;
    for (int gi = 0; gi < G; ++gi) {
      const int bh = b * p.H + kvh * G + gi;
      for (int qt = qt_lo; qt <= qt_hi; ++qt) {
        const int q0 = qt * BQS, nq = min(BQS, S - q0);
        const size_t row0 = static_cast<size_t>(bh) * S + q0;
        __syncthreads();   // the previous tile's readers are done
        load_tile(t2, q + row0 * D, nq, BQS, D, DP, ld);
        load_tile(t3, dout + row0 * D, nq, BQS, D, DP, ld);
        load_stats(lse_s, delta_s, lse, delta, row0, nq, BQS);
        __syncthreads();
        // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x 32 rows
        float st[4][4], dpt[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) st[j][c] = dpt[j][c] = 0.f;
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
          uint32_t ak[4], av[4];
          ldsm_x4(a_addr(s0, ld, grp * 16, kk * 16, lane), ak);
          ldsm_x4(a_addr(s1, ld, grp * 16, kk * 16, lane), av);
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t bq[4], bo[4];
            ldsm_x4(bn_addr(s2, ld, np * 16, kk * 16, lane), bq);
            ldsm_x4(bn_addr(s3, ld, np * 16, kk * 16, lane), bo);
            mma16816(st[2 * np], ak, bq[0], bq[1]);
            mma16816(st[2 * np + 1], ak, bq[2], bq[3]);
            mma16816(dpt[2 * np], av, bo[0], bo[1]);
            mma16816(dpt[2 * np + 1], av, bo[2], bo[3]);
          }
        }
        // P^T and dS^T: element c of n8 tile j is key key0 + 8 (c >> 1),
        // row q0 + 8 j + 2 t + (c & 1)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int key = key0 + 8 * (c >> 1), r = 8 * j + 2 * t + (c & 1), row = q0 + r;
            const bool ok = row < S && key < S && key <= row && key > row - W;
            float pv = 0.f, ds = 0.f;
            if (ok) {
              pv = expf(st[j][c] * scale - lse_s[r]);
              ds = pv * (dpt[j][c] - delta_s[r]);
            }
            st[j][c] = pv;
            dpt[j][c] = ds;
          }
        // dV += P^T dO and dK += dS^T Q over the 32 rows, this warp's half
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          uint32_t ap[4], ad[4];
          to_a(st[2 * ks], st[2 * ks + 1], ap);
          to_a(dpt[2 * ks], dpt[2 * ks + 1], ad);
#pragma unroll
          for (int n2 = 0; n2 < NH / 2; ++n2) {
            const int n0 = dh * HALF + n2 * 16;
            uint32_t bo[4], bq[4];
            ldsm_x4_t(bt_addr(s3, ld, ks * 16, n0, lane), bo);
            ldsm_x4_t(bt_addr(s2, ld, ks * 16, n0, lane), bq);
            mma16816(accv[2 * n2], ap, bo[0], bo[1]);
            mma16816(accv[2 * n2 + 1], ap, bo[2], bo[3]);
            mma16816(acck[2 * n2], ad, bq[0], bq[1]);
            mma16816(acck[2 * n2 + 1], ad, bq[2], bq[3]);
          }
        }
      }
    }
    // keys key0, key0 + 8; columns dh * HALF + 8 j + 2 t, + 1 (pairs: D % 8 == 0)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int key = key0 + 8 * hh;
      if (key >= S) continue;
      const size_t o = (static_cast<size_t>(bkv) * S + key) * D;
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        const int d = dh * HALF + 8 * j + 2 * t;
        if (d < D) {
          *reinterpret_cast<__nv_bfloat162*>(dk + o + d) = __floats2bfloat162_rn(
              acck[j][2 * hh] * scale, acck[j][2 * hh + 1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(dv + o + d) =
              __floats2bfloat162_rn(accv[j][2 * hh], accv[j][2 * hh + 1]);
        }
      }
    }
    return;
  }

  // ---- dQ: 64 q rows of one query head, the longest walks first; t0 = Q,
  // t1 = dO, t2 = K, t3 = V --------------------------------------------------
  const int idx = blockIdx.x - p.dkv_blocks;
  const int BH = p.B * p.H;
  const int bh = idx % BH;
  const int qt = p.qtiles - 1 - idx / BH;
  const int b = bh / p.H, kvh = (bh % p.H) / G;
  const int q0 = qt * BQ, nq = min(BQ, S - q0);
  const size_t row0 = static_cast<size_t>(bh) * S + q0;
  const size_t kv_base = (static_cast<size_t>(b) * p.KV + kvh) * S * D;
  load_tile(t0, q + row0 * D, nq, BQ, D, DP, ld);
  load_tile(t1, dout + row0 * D, nq, BQ, D, DP, ld);
  load_stats(lse_s, delta_s, lse, delta, row0, nq, BQ);
  float acc[NH][4];
#pragma unroll
  for (int j = 0; j < NH; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
  const int r0 = grp * 16 + g;   // this thread's rows in the tile: r0, r0 + 8
  const int kt_lo = max(0, q0 - W + 1) / BKV;
  const int kt_hi = (min(S, q0 + BQ) - 1) / BKV;
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BKV, nk = min(BKV, S - k0);
    __syncthreads();   // the previous tile's readers are done
    load_tile(t2, k + kv_base + static_cast<size_t>(k0) * D, nk, BKV, D, DP, ld);
    load_tile(t3, v + kv_base + static_cast<size_t>(k0) * D, nk, BKV, D, DP, ld);
    __syncthreads();
    // S = Q K^T and dP = dO V^T for this warp's 16 rows x 64 keys
    float sc[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[j][c] = dp[j][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t aq[4], ao[4];
      ldsm_x4(a_addr(s0, ld, grp * 16, kk * 16, lane), aq);
      ldsm_x4(a_addr(s1, ld, grp * 16, kk * 16, lane), ao);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4], bv[4];
        ldsm_x4(bn_addr(s2, ld, np * 16, kk * 16, lane), bk);
        ldsm_x4(bn_addr(s3, ld, np * 16, kk * 16, lane), bv);
        mma16816(sc[2 * np], aq, bk[0], bk[1]);
        mma16816(sc[2 * np + 1], aq, bk[2], bk[3]);
        mma16816(dp[2 * np], ao, bv[0], bv[1]);
        mma16816(dp[2 * np + 1], ao, bv[2], bv[3]);
      }
    }
    // dS: element c of n8 tile j is row r0 + 8 (c >> 1), key k0 + 8 j + 2 t
    // + (c & 1)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = r0 + 8 * (c >> 1), row = q0 + r, key = k0 + 8 * j + 2 * t + (c & 1);
        const bool ok = row < S && key < S && key <= row && key > row - W;
        float ds = 0.f;
        if (ok) ds = expf(sc[j][c] * scale - lse_s[r]) * (dp[j][c] - delta_s[r]);
        sc[j][c] = ds;
      }
    // dQ += dS K over the 64 keys, this warp's half of DP
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t a[4];
      to_a(sc[2 * ks], sc[2 * ks + 1], a);
#pragma unroll
      for (int n2 = 0; n2 < NH / 2; ++n2) {
        uint32_t bk[4];
        ldsm_x4_t(bt_addr(s2, ld, ks * 16, dh * HALF + n2 * 16, lane), bk);
        mma16816(acc[2 * n2], a, bk[0], bk[1]);
        mma16816(acc[2 * n2 + 1], a, bk[2], bk[3]);
      }
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + 8 * hh;
    if (r >= nq) continue;
    bf16* o = dq + (row0 + r) * D;
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      const int d = dh * HALF + 8 * j + 2 * t;
      if (d < D)
        *reinterpret_cast<__nv_bfloat162*>(o + d) =
            __floats2bfloat162_rn(acc[j][2 * hh] * scale, acc[j][2 * hh + 1] * scale);
    }
  }
}

}  // namespace mma

int check(const Plan& p) {
  if (p.path == 0) {
    const fp32::Geometry g(p.D);
    const int qtiles = (p.S + fp32::BQ - 1) / fp32::BQ;
    const int kvtiles = (p.S + fp32::BKV - 1) / fp32::BKV;
    return p.DP == 0 && static_cast<long long>(g.bytes) == p.smem && p.qtiles == qtiles &&
           p.kvtiles == kvtiles;
  }
  if (p.path != 1 || (p.DP != 64 && p.DP != 128 && p.DP != 256) || p.D > p.DP ||
      (p.DP > 64 && p.D <= p.DP / 2))
    return 0;
  const mma::Geometry g(p.DP);
  return static_cast<long long>(g.bytes) == p.smem && p.qtiles == (p.S + mma::BQ - 1) / mma::BQ &&
         p.kvtiles == (p.S + mma::BKV - 1) / mma::BKV;
}

template <typename T, typename K>
int launch(K kernel, const void* q, const void* k, const void* v, const void* out,
           const void* dout, const void* lse, void* dq, void* dk, void* dv, void* delta,
           const Plan& p, float scale, cudaStream_t stream) {
  const long long rows = static_cast<long long>(p.B) * p.H * p.S;
  swa_bwd_delta<T><<<static_cast<unsigned>((rows + NWARPS - 1) / NWARPS), NTHREADS, 0,
                     stream>>>(static_cast<const T*>(out), static_cast<const T*>(dout),
                               static_cast<float*>(delta), rows, p.D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<p.dkv_blocks + p.dq_blocks, NTHREADS, p.smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), p, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The plan's field names in struct Plan's order, each followed by a comma.
extern "C" const char* swa_attention_bwd_plan_fields() {
  return SWA_ATTENTION_BWD_PLAN(PLAN_NAME);
}

// q, out, dout and dq [B, H, S, D], k, v, dk and dv [B, KV, S, D], all of
// one dtype (path 0 float32, path 1 bfloat16), contiguous and 16-byte
// aligned; lse and the delta scratch fp32 [B, H, S]; `plan` holds `nplan`
// ints in the order of kernels/swa_attention.py's BWD_PLAN_FIELDS.
// H % KV == 0, D % 8 == 0 and D <= 256, window W >= 1.  Launches the delta
// pass and the dQ and dK/dV grid on `stream` and returns cudaGetLastError()
// (0 on success); a plan it does not take returns cudaErrorInvalidValue
// without launching.
extern "C" int swa_attention_bwd(const void* q, const void* k, const void* v, const void* out,
                                 const void* dout, const void* lse, void* dq, void* dk,
                                 void* dv, void* delta, const int* plan, int nplan, float scale,
                                 void* stream) {
  if (nplan != PLAN_INTS) return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  memcpy(&p, plan, sizeof p);
  if (p.B <= 0 || p.H <= 0 || p.KV <= 0 || p.H % p.KV != 0 || p.S <= 0 || p.D <= 0 ||
      p.D % 8 != 0 || p.D > 256 || p.W < 1 || p.smem > SMEM_MAX || !check(p) ||
      static_cast<long long>(p.dq_blocks) != static_cast<long long>(p.qtiles) * p.B * p.H ||
      static_cast<long long>(p.dkv_blocks) != static_cast<long long>(p.kvtiles) * p.B * p.KV)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.path == 0)
    return launch<float>(fp32::swa_bwd_fma, q, k, v, out, dout, lse, dq, dk, dv, delta, p,
                         scale, s);
  if (p.DP == 64)
    return launch<__nv_bfloat16>(mma::swa_bwd_mma<64>, q, k, v, out, dout, lse, dq, dk, dv,
                                 delta, p, scale, s);
  if (p.DP == 128)
    return launch<__nv_bfloat16>(mma::swa_bwd_mma<128>, q, k, v, out, dout, lse, dq, dk, dv,
                                 delta, p, scale, s);
  return launch<__nv_bfloat16>(mma::swa_bwd_mma<256>, q, k, v, out, dout, lse, dq, dk, dv,
                               delta, p, scale, s);
}
