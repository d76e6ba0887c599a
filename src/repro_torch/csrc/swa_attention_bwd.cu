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
//     keys past S) get P = dS = 0.
//
// bfloat16 (swa_bwd_wgmma; kernels/swa_attention.py::plan_bwd path 1): the
// products on wgmma (bf16 in, fp32 accumulate), D read in DB boxes of 64
// columns with the 128-byte swizzle (D padded to DP = 64, 128 or 256 by
// TMA's zeros).  Both kinds of block hold 64 rows: 64 keys (dK/dV) or 64 q
// rows (dQ), and step over 64-row tiles of the walked operand.  384 threads:
//   * warpgroup 2's first warp produces.  A dK/dV block's K and V tiles, a
//     dQ block's Q and dO, arrive once by TMA; the walked tiles (Q, dO and
//     their rows' lse and delta for dK/dV; K and V for dQ) cycle through a
//     ring of 2-4 stages with a full and an empty mbarrier each: its first
//     thread starts the TMA loads, the warp writes the 64 rows' lse (in
//     log2 units) and delta;
//   * warpgroup 0 computes S (S^T for dK/dV) once per tile, an SS wgmma
//     m64n64 with both operands K-major over D, and P = exp(s scale - lse)
//     in registers inside the window (0 outside it and past S); rounded to
//     bf16 it is the A operand of dV += P^T dO (RS wgmma, dO read MN-major
//     as it lies, N = DP), and it is handed to warpgroup 1 through one of
//     two shared-memory buffers, each under a pair of named barriers (full,
//     and empty once read): the only exchange between the warpgroups;
//   * warpgroup 1 computes dP (dP^T) once per tile, forms dS = P (dP -
//     delta) from the bf16 P it receives, rounds it to bf16 and accumulates
//     dK += dS^T Q or dQ += dS K (RS wgmma, N = DP).
// So each of S and dP is computed once a tile: 14 operations per in-window
// pair and dim (8 in the dK/dV pass, 6 in the dQ pass), and a warpgroup
// holds one DP-wide accumulator (128 registers at DP 256, 232 after
// setmaxnreg).  The fp32 accumulators are rounded once to bf16 at the end.
//
// float32 (swa_bwd_fma; path 0): the FMA kernel, fp32 throughout (no TF32):
// tiles of 32 rows at an odd row stride (D + 1, so lanes over keys read
// distinct banks, rows as broadcasts), the P and dS tiles at stride 33.
//
// What bounds it on an H100: the bound counts 10 operations per in-window
// pair and dim (2.5x the forward's 4) at the tensor cores' bf16 rate.  Both
// kernels do 14: S and dP are computed in each of the two passes, so that
// every output has one writer.  The fp32 kernel runs them on FMA, bound by
// its shared-memory loads.

#include "hopper.cuh"

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
  /* bfloat16: D padded to DP columns, ring stages */                         \
  X(DP) X(stages) X(qtiles) X(kvtiles) X(dq_blocks) X(dkv_blocks)              \
  /* operations per in-window pair and dim */                                  \
  X(ops) X(smem)

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
// bfloat16: wgmma, a TMA ring, a producer warp
// ---------------------------------------------------------------------------

namespace wg {

using namespace hopper;
using bf16 = __nv_bfloat16;
constexpr int T = 64;                 // rows of every tile: q rows or keys
constexpr int BOX = T * 128;          // one [64, 64] bf16 box, 128-byte swizzled
constexpr int XBUF = 128 * 16 * 4;    // a [64, 64] bf16 tile, 16 words a thread
constexpr int STATS = 1024;           // a stage's lse (log2 units) and delta
constexpr int STAGES_MAX = 4;
constexpr int RESERVED = 2048;        // the 1024-byte alignment and the barriers
constexpr int THREADS = 384;          // consumer warpgroups 0 and 1, producer 2
constexpr float LOG2E = 1.4426950408889634f;
// named barriers of the P hand-off, one pair a buffer (0 is __syncthreads)
constexpr int X_FULL = 1, X_EMPTY = 3;

// Shared memory for D in DB boxes of 64 (kernels/swa_attention.py::
// _bwd_smem): the block's two fixed tiles [64, 64 DB], two P hand-off
// buffers, `stages` ring stages of two tiles and the stats, the barriers.
__host__ __device__ inline int tile_bytes(int DB) { return DB * BOX; }
__host__ __device__ inline int stage_bytes(int DB) { return 2 * tile_bytes(DB) + STATS; }
__host__ __device__ inline int smem_bytes(int DB, int stages) {
  return 2 * tile_bytes(DB) + 2 * XBUF + stages * stage_bytes(DB) + RESERVED;
}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;" ::"r"(id) : "memory");
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}
__device__ __forceinline__ float lo_of(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_of(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// acc += a (the 64 x 16 A fragment in registers) * b (16 x N, MN-major)
template <int N>
__device__ __forceinline__ void mma_rs(float (&acc)[N / 2], const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void mma_rs<64>(float (&acc)[32], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_mn_m64n64k16(acc, a, db, 1);
}
template <>
__device__ __forceinline__ void mma_rs<128>(float (&acc)[64], const uint32_t (&a)[4],
                                            uint64_t db) {
  wgmma_rs_mn_m64n128k16(acc, a, db, 1);
}
template <>
__device__ __forceinline__ void mma_rs<256>(float (&acc)[128], const uint32_t (&a)[4],
                                            uint64_t db) {
  wgmma_rs_mn_m64n256k16(acc, a, db, 1);
}

// The [64 x 64] product of the fixed tile at `fa` and the stage tile at `fb`,
// both K-major over D: S = Q K^T or dP = dO V^T (a dQ block), S^T = K Q^T or
// dP^T = V dO^T (a dK/dV block).
template <int DB>
__device__ __forceinline__ void first_product(float (&sc)[32], uint32_t fa, uint32_t fb) {
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < DB; ++c) {
    const uint64_t da = desc_k128(fa + c * BOX), db = desc_k128(fb + c * BOX);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss_kk_m64n64k16(sc, da + 2 * kk, db + 2 * kk, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
}

// acc += A (4 k16 fragments: the tile's 64 columns) * the stage tile at `fb`
// read MN-major ([64, D] as it lies, D along N)
template <int NP>
__device__ __forceinline__ void second_product(float (&acc)[NP / 2], const uint32_t (&af)[4][4],
                                               uint32_t fb) {
  const uint64_t db = desc_mn128(fb, BOX);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j) mma_rs<NP>(acc, af[j], db + 128 * j);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

template <int DB>
__global__ void __launch_bounds__(THREADS, 1)
swa_bwd_wgmma(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap omap,
              const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv, const Plan p,
              float scale) {
  constexpr int TILE = DB * BOX, STAGE = 2 * TILE + STATS;
  constexpr int NP = 64 * DB;   // the second products' N: D padded to 64, 128 or 256
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* fixed = smem;                                  // F0, F1
  uint32_t* xbuf = reinterpret_cast<uint32_t*>(smem + 2 * TILE);
  unsigned char* ring = smem + 2 * TILE + 2 * XBUF;
  uint64_t* fixbar = reinterpret_cast<uint64_t*>(ring + p.stages * STAGE);
  uint64_t* full = fixbar + 1;
  uint64_t* empty = full + STAGES_MAX;

  const int S = p.S, W = min(p.W, S), G = p.H / p.KV;
  const bool dkv = static_cast<int>(blockIdx.x) < p.dkv_blocks;
  // a dK/dV block: 64 keys of KV row `frow` from k0, stepping over the q
  // tiles qlo .. qlo + nq - 1 of each of the group's G query heads in order;
  // a dQ block: 64 q rows of head row `frow` from q0 (the longest walks
  // first), stepping over the kv tiles klo .. of KV row `krow`
  int frow, f0, nsteps, nq = 1, lo, krow = 0;
  if (dkv) {
    frow = blockIdx.x / p.kvtiles;
    f0 = (blockIdx.x % p.kvtiles) * T;
    lo = f0 / T;
    nq = min(S - 1, f0 + T - 1 + W - 1) / T - lo + 1;
    nsteps = G * nq;
  } else {
    const int idx = blockIdx.x - p.dkv_blocks, BH = p.B * p.H;
    frow = idx % BH;
    f0 = (p.qtiles - 1 - idx / BH) * T;
    krow = (frow / p.H) * p.KV + (frow % p.H) / G;
    lo = max(0, f0 - W + 1) / T;
    nsteps = (min(S, f0 + T) - 1) / T - lo + 1;
  }

  if (threadIdx.x == 0) {
    mbar_init(fixbar, 1);
    for (int i = 0; i < p.stages; ++i) {
      // the TMA thread's expect_tx arrival, and a dK/dV block's 32 stats
      // writers
      mbar_init(&full[i], 1 + (dkv ? 32 : 0));
      mbar_init(&empty[i], 2 * 128);   // every consumer thread
    }
    fence_mbar_init();
  }
  __syncthreads();

  // the warpgroup's role, taken through a shuffle so that the compiler
  // knows it is the same in every lane: wgmma is not serialised
  const int role = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (role == 2) {
    // ---- producer: one warp; its first thread issues every TMA load -------
    setmaxnreg_dec<40>();
    const int lane = threadIdx.x - 256;
    if (lane >= 32 || (!dkv && lane != 0)) return;
    if (lane == 0) {
      mbar_expect_tx(fixbar, 2 * TILE);
#pragma unroll
      for (int c = 0; c < DB; ++c) {
        tma_load_3d(fixed + c * BOX, dkv ? &kmap : &qmap, fixbar, c * 64, f0, frow);
        tma_load_3d(fixed + TILE + c * BOX, dkv ? &vmap : &omap, fixbar, c * 64, f0, frow);
      }
    }
    int s = 0;
    uint32_t ph = 0;
    for (int t = 0; t < nsteps; ++t) {
      mbar_wait(&empty[s], ph ^ 1);
      unsigned char* st = ring + s * STAGE;
      if (dkv) {
        // Q and dO of query head (frow's group, t / nq), q tile lo + t % nq,
        // and their rows' lse (in log2 units) and delta; 0 past S
        const int bh = (frow / p.KV) * p.H + (frow % p.KV) * G + t / nq;
        const int q0 = (lo + t % nq) * T;
        float* stats = reinterpret_cast<float*>(st + 2 * TILE);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = lane + 32 * h, row = q0 + r;
          const size_t at = static_cast<size_t>(bh) * S + row;
          stats[r] = row < S ? lse[at] * LOG2E : 0.f;
          stats[T + r] = row < S ? delta[at] : 0.f;
        }
        mbar_arrive(&full[s]);
        if (lane == 0) {
          mbar_expect_tx(&full[s], 2 * TILE);
#pragma unroll
          for (int c = 0; c < DB; ++c) {
            tma_load_3d(st + c * BOX, &qmap, &full[s], c * 64, q0, bh);
            tma_load_3d(st + TILE + c * BOX, &omap, &full[s], c * 64, q0, bh);
          }
        }
      } else {
        // K and V of kv tile lo + t
        mbar_expect_tx(&full[s], 2 * TILE);
#pragma unroll
        for (int c = 0; c < DB; ++c) {
          tma_load_3d(st + c * BOX, &kmap, &full[s], c * 64, (lo + t) * T, krow);
          tma_load_3d(st + TILE + c * BOX, &vmap, &full[s], c * 64, (lo + t) * T, krow);
        }
      }
      if (++s == p.stages) { s = 0; ph ^= 1; }
    }
    return;
  }

  // ---- consumers: warpgroup 0 computes S and P and hands P over (and, in a
  // dK/dV block, accumulates dV = P^T dO); warpgroup 1 computes dP, forms dS
  // and accumulates dK = dS^T Q or dQ = dS K ----------------------------------
  setmaxnreg_inc<232>();
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31, tid = threadIdx.x & 127;
  const int arow = warp * 16 + (lane >> 2);   // this thread's rows arow, arow + 8
  const float scale_log2 = scale * LOG2E;
  float acc[NP / 2];
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) acc[i] = 0.f;
  // a dQ block's rows: lse (log2 units) for warpgroup 0, delta for 1
  float rs[2] = {0.f, 0.f};
  if (!dkv) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = f0 + arow + 8 * hh;
      const size_t at = static_cast<size_t>(frow) * S + row;
      if (row < S) rs[hh] = role == 0 ? lse[at] * LOG2E : delta[at];
    }
  }
  const uint32_t fa = smem_u32(fixed + role * TILE);
  mbar_wait(fixbar, 0);

  int s = 0;
  uint32_t ph = 0;
  for (int t = 0; t < nsteps; ++t) {
    // the tile's first q row and first key
    const int i0 = dkv ? (lo + t % nq) * T : f0;
    const int j0 = dkv ? f0 : (lo + t) * T;
    mbar_wait(&full[s], ph);
    const uint32_t st = smem_u32(ring + s * STAGE);
    const float* stats = reinterpret_cast<const float*>(ring + s * STAGE + 2 * TILE);
    uint32_t* xb = xbuf + (t & 1) * (XBUF / 4);
    float sc[32];
    first_product<DB>(sc, fa, st + role * TILE);
    uint32_t af[4][4];
    if (role == 0) {
      // P = exp(s scale - lse) inside the window, 0 elsewhere; element e is
      // accumulator row arow + 8 ((e >> 1) & 1), column 8 (e >> 2) + 2 (lane
      // % 4) + (e & 1): (key, q row) in a dK/dV block, (q row, key) in a dQ
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int r = arow + 8 * ((e >> 1) & 1), c = 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
        const int row = dkv ? i0 + c : i0 + r, key = dkv ? j0 + r : j0 + c;
        const bool ok = row < S && key < S && key <= row && key > row - W;
        const float l2 = dkv ? stats[c] : rs[(e >> 1) & 1];
        sc[e] = ok ? exp2f(sc[e] * scale_log2 - l2) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int u = 0; u < 4; ++u) af[j][u] = pack(sc[8 * j + 2 * u], sc[8 * j + 2 * u + 1]);
      // hand P (bf16) to warpgroup 1 through buffer t % 2, once it has read
      // what this buffer held two steps ago
      if (t >= 2) bar_sync(X_EMPTY + (t & 1));
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int u = 0; u < 4; ++u) xb[(4 * j + u) * 128 + tid] = af[j][u];
      bar_arrive(X_FULL + (t & 1));
      if (dkv) second_product<NP>(acc, af, st + TILE);   // dV += P^T dO
    } else {
      bar_sync(X_FULL + (t & 1));
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int u = 0; u < 4; ++u) af[j][u] = xb[(4 * j + u) * 128 + tid];
      if (t + 2 < nsteps) bar_arrive(X_EMPTY + (t & 1));
      // dS = P (dP - delta), P as warpgroup 0 rounded it (0 outside the
      // window, so dS is too), rounded to bf16 as the A operand
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float d2[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = 8 * j + 2 * u + h;
            const int c = 8 * (e >> 2) + 2 * (lane & 3) + h;
            const float dl = dkv ? stats[T + c] : rs[(e >> 1) & 1];
            d2[h] = sc[e] - dl;
          }
          af[j][u] = pack(lo_of(af[j][u]) * d2[0], hi_of(af[j][u]) * d2[1]);
        }
      second_product<NP>(acc, af, st);   // dK += dS^T Q, or dQ += dS K
    }
    mbar_arrive(&empty[s]);
    if (++s == p.stages) { s = 0; ph ^= 1; }
  }

  // epilogue: rows arow, arow + 8 of the tile (keys, or q rows), columns 8i +
  // 2 (lane % 4) and + 1 of every 8-column block i below D (D % 8 == 0)
  if (dkv || role == 1) {
    bf16* out = dkv ? (role == 0 ? dv : dk) : dq;
    const float mul = dkv && role == 0 ? 1.f : scale;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = f0 + arow + 8 * hh;
      if (r >= S) continue;
      bf16* o = out + (static_cast<size_t>(frow) * S + r) * p.D;
#pragma unroll
      for (int i = 0; i < NP / 8; ++i) {
        const int c = 8 * i + 2 * (lane & 3);
        if (c < p.D)
          *reinterpret_cast<__nv_bfloat162*>(o + c) =
              __floats2bfloat162_rn(acc[4 * i + 2 * hh] * mul, acc[4 * i + 2 * hh + 1] * mul);
      }
    }
  }
}

int boxes(int D) { return D <= 64 ? 1 : D <= 128 ? 2 : 4; }

template <int DB>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, void* dq, void* dk, void* dv, const Plan& p, float scale,
           cudaStream_t stream) {
  CUtensorMap qmap, omap, kmap, vmap;
  memset(&qmap, 0, sizeof qmap);
  memset(&omap, 0, sizeof omap);
  memset(&kmap, 0, sizeof kmap);
  memset(&vmap, 0, sizeof vmap);
  const cuuint64_t row = static_cast<cuuint64_t>(p.D) * 2;
  const cuuint64_t strides[2] = {row, row * p.S};
  const cuuint64_t qdims[3] = {static_cast<cuuint64_t>(p.D), static_cast<cuuint64_t>(p.S),
                               static_cast<cuuint64_t>(p.B) * p.H};
  const cuuint64_t kvdims[3] = {static_cast<cuuint64_t>(p.D), static_cast<cuuint64_t>(p.S),
                                static_cast<cuuint64_t>(p.B) * p.KV};
  const cuuint32_t box[3] = {64, T, 1};
  int e = hopper_host::bf16_map(&qmap, q, 3, qdims, strides, box);
  if (!e) e = hopper_host::bf16_map(&omap, dout, 3, qdims, strides, box);
  if (!e) e = hopper_host::bf16_map(&kmap, k, 3, kvdims, strides, box);
  if (!e) e = hopper_host::bf16_map(&vmap, v, 3, kvdims, strides, box);
  if (e) return e;
  auto kernel = swa_bwd_wgmma<DB>;
  static bool sized[64] = {};   // once per variant and device: the most any plan asks
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !sized[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) sized[dev] = true;
  }
  kernel<<<p.dkv_blocks + p.dq_blocks, THREADS, p.smem, stream>>>(
      qmap, omap, kmap, vmap, lse, delta, static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), p, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// the operations per in-window pair and dim both paths do: S and dP in
// each pass, dV and dK in the dK/dV blocks, dQ in the dQ blocks, each 2
constexpr int OPS = 2 * (4 + 3);

int check(const Plan& p) {
  if (p.ops != OPS) return 0;
  if (p.path == 0) {
    const fp32::Geometry g(p.D);
    const int qtiles = (p.S + fp32::BQ - 1) / fp32::BQ;
    const int kvtiles = (p.S + fp32::BKV - 1) / fp32::BKV;
    return p.DP == 0 && p.stages == 0 && static_cast<long long>(g.bytes) == p.smem &&
           p.qtiles == qtiles && p.kvtiles == kvtiles;
  }
  if (p.path != 1 || p.D > 256 || p.DP != 64 * wg::boxes(p.D) || p.stages < 2 ||
      p.stages > wg::STAGES_MAX)
    return 0;
  const int tiles = (p.S + wg::T - 1) / wg::T;
  return wg::smem_bytes(p.DP / 64, p.stages) == p.smem && p.qtiles == tiles &&
         p.kvtiles == tiles;
}

template <typename T>
int launch_delta(const void* out, const void* dout, void* delta, const Plan& p,
                 cudaStream_t stream) {
  const long long rows = static_cast<long long>(p.B) * p.H * p.S;
  swa_bwd_delta<T><<<static_cast<unsigned>((rows + NWARPS - 1) / NWARPS), NTHREADS, 0,
                     stream>>>(static_cast<const T*>(out), static_cast<const T*>(dout),
                               static_cast<float*>(delta), rows, p.D);
  return static_cast<int>(cudaGetLastError());
}

int launch_fma(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               void* dq, void* dk, void* dv, void* delta, const Plan& p, float scale,
               cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(fp32::swa_bwd_fma,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fp32::swa_bwd_fma<<<p.dkv_blocks + p.dq_blocks, NTHREADS, p.smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), static_cast<float*>(dk),
      static_cast<float*>(dv), p, scale);
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
// without launching, a failed tensor-map encoding its CUresult.
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
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (p.path == 0) {
    const int e = launch_delta<float>(out, dout, delta, p, s);
    return e ? e : launch_fma(q, k, v, dout, lse, dq, dk, dv, delta, p, scale, s);
  }
  const int e = launch_delta<__nv_bfloat16>(out, dout, delta, p, s);
  if (e) return e;
  if (p.DP == 64) return wg::launch<1>(q, k, v, dout, l, dl, dq, dk, dv, p, scale, s);
  if (p.DP == 128) return wg::launch<2>(q, k, v, dout, l, dl, dq, dk, dv, p, scale, s);
  return wg::launch<4>(q, k, v, dout, l, dl, dq, dk, dv, p, scale, s);
}
