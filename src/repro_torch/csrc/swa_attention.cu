// swa_attention for Hopper (sm_90a): causal sliding-window attention over a
// whole sequence, q [B, H, S, D] against k/v [B, KV, S, D] (GQA: query head h
// reads KV head h / (H / KV)).  Token i attends to key j iff i - W < j <= i.
//
// Replaces the Pallas TPU kernel src/repro/kernels/swa_attention.py::
// swa_attention (body _kernel).  There the grid (b*h, q tile, kv step) runs
// in order on one core: the kv steps of one q tile carry (m, l, acc) in VMEM
// scratch, and the index map clamps the window's first tiles to block 0 and
// masks them (so a clamped tile may be read more than once).  Blocks on a GPU
// run in no order, so the kv steps become a loop inside one block: one block
// per (b*h, q tile) walks only the kv tiles from max(0, q0 - W + 1) to the
// diagonal, each once, and keeps the online-softmax state on chip.  The kv
// head is resolved in the block's own offsets; no repeated-KV tensor is
// built.  A ragged last q or kv tile is masked here (rows and keys >= S), so
// nothing needs S % 128 == 0.
//
// Semantics (those of the Pallas _kernel): fp32 scores (bf16 products are
// exact in fp32), scaled after the dot; masked scores never contribute
// (p = 0, which is what the Pallas -1e30 fill gives once a row has seen a
// live key, and every row sees its own diagonal key); fp32 online softmax;
// the probabilities are rounded to V's dtype before the PV product, as
// p.astype(v_ref.dtype) does there, while l sums the unrounded ones; the
// output is acc / l in q's dtype.
//
// The row log-sum-exp (training): given an fp32 `lse` [B, H, S], each row
// also writes lse_i = log(sum_j exp(s_ij)) of its scaled scores in natural
// log units on both paths (the FMA kernel keeps m in natural units, the
// wgmma kernel in log2 units and converts: (m + log2 l) * ln 2), so that
// swa_attention_bwd.cu recomputes P = exp(s - lse).  A null `lse` writes
// nothing and leaves the output's bits as they are.
//
// What bounds it on an H100: per q tile it does 4 * BQ * BKV * D operations
// on every kv tile it loads, so at gemma3's D 240 and W 1024 it is bound by
// the tensor cores (989 TFLOP/s bf16), not by memory.
//
// bfloat16 (swa_wgmma), the plan from kernels/swa_attention.py::plan:
//   * one block per (b*h, 128-row q tile), the longest walks first; two
//     consumer warpgroups own 64 q rows each and the third warpgroup's first
//     thread issues TMA (setmaxnreg hands its registers to the consumers);
//   * Q arrives once by TMA; K and V tiles of 64 keys cycle through a ring of
//     2-4 stages, each with a K and a V "full" mbarrier (so QK^T starts while
//     V is still in flight) and one "empty" mbarrier.  The maps are 3-D,
//     [B*heads, S, D], so rows past S arrive as zeros and never as the next
//     head's rows; D is read in boxes of 64 columns with the 128-byte swizzle,
//     the columns past D arriving as zeros (D 240: four boxes, the last with
//     16 zero columns);
//   * S = Q K^T: SS wgmma m64n64k16 with Q and K both K-major (D
//     contiguous), one k16 step at a time over D padded to 64;
//   * the softmax runs in registers on the accumulator fragment: a row's max
//     goes across the 4 lanes that hold it; only a tile that crosses the
//     diagonal or the window's edge for the warpgroup's rows evaluates the
//     mask (masked scores are -inf, the running max starts at -1e30, so a row
//     that has seen no live key keeps p = 0); l sums the unrounded p per
//     thread and is reduced across the 4 lanes once, at the end;
//   * O += P V: RS wgmma with P from registers (the accumulator fragment is
//     the A fragment once rounded to bf16) and V read as it lies, MN-major
//     (desc_mn128), N = D padded to 64, 128 or 256;
//   * the epilogue divides by l (0 -> 1) and stores bf16 rows < S.
//
// float32 (swa_fma) keeps the first port's fp32 FMA kernel (no TF32): 32-row
// q and kv tiles staged by 16-byte loads, a barrier between the load, score,
// softmax and PV phases of each kv tile.

#include "hopper.cuh"

#include <string.h>

namespace {

constexpr float NEG = -1e30f;
constexpr int SMEM_MAX = 227 * 1024;

// Every field an int.  The one list of them: struct Plan and the names
// swa_attention_plan_fields() gives, which kernels/swa_attention.py checks
// against its PLAN_FIELDS when it loads this library.
#define SWA_ATTENTION_PLAN(X)                                                  \
  X(path) X(B) X(H) X(KV) X(S) X(D) X(W)                                       \
  /* bfloat16: the wgmma kernel (64-column boxes of D, ring stages) */         \
  X(DB) X(stages) X(qtiles) X(blocks) X(smem)

#define PLAN_DECL(f) int f;
#define PLAN_NAME(f) #f ","
#define PLAN_ONE(f) +1
struct Plan {
  SWA_ATTENTION_PLAN(PLAN_DECL)
};
constexpr int PLAN_INTS = 0 SWA_ATTENTION_PLAN(PLAN_ONE);
static_assert(sizeof(Plan) == PLAN_INTS * sizeof(int), "Plan is ints only");

__host__ __device__ inline size_t align128(size_t x) {
  return (x + 127) & ~static_cast<size_t>(127);
}

// ---------------------------------------------------------------------------
// float32: the FMA kernel
// ---------------------------------------------------------------------------

namespace fp32 {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int BQ = 32, BKV = 32;   // q and kv tile rows

// Shared-memory geometry for head dim D: tiles have an odd row stride
// (D + 1), so that threads over kv rows read distinct banks.
struct Geometry {
  int ldt;   // row stride of the Q, K and V tiles, elements
  int lds;   // row stride of the scores (and probabilities)
  size_t off_k, off_v, off_s, off_acc, off_stats, bytes;

  __host__ __device__ explicit Geometry(int D) {
    ldt = D + 1;
    lds = BKV + 4;
    size_t o = align128(sizeof(float) * BQ * ldt);
    off_k = o;
    o += align128(sizeof(float) * BKV * ldt);
    off_v = o;
    o += align128(sizeof(float) * BKV * ldt);
    off_s = o;
    o += align128(sizeof(float) * BQ * lds);
    off_acc = o;
    o += align128(sizeof(float) * BQ * D);
    off_stats = o;   // m, l: [BQ] each
    o += align128(sizeof(float) * 2 * BQ);
    bytes = o;
  }
};

// Stage rows [0, n) of a [*, D] row-major slice into a [rows, D] tile of row
// stride ld; rows >= n are zero, so padded keys and values add nothing.
__device__ void load_tile(float* dst, const float* __restrict__ src, int n, int rows, int D,
                          int ld) {
  const int per_row = D / 4;
  for (int i = threadIdx.x; i < rows * per_row; i += NTHREADS) {
    const int r = i / per_row, c = (i % per_row) * 4;
    float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n) w = *reinterpret_cast<const float4*>(src + static_cast<size_t>(r) * D + c);
    dst[r * ld + c] = w.x;
    dst[r * ld + c + 1] = w.y;
    dst[r * ld + c + 2] = w.z;
    dst[r * ld + c + 3] = w.w;
  }
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

__global__ void __launch_bounds__(NTHREADS, 1)
swa_fma(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
        float* __restrict__ out, float* __restrict__ lse, int H, int KV, int S, int D, int W,
        float scale) {
  const Geometry g(D);
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = reinterpret_cast<float*>(smem + g.off_k);
  float* vs = reinterpret_cast<float*>(smem + g.off_v);
  float* ss = reinterpret_cast<float*>(smem + g.off_s);
  float* acc = reinterpret_cast<float*>(smem + g.off_acc);
  float* m = reinterpret_cast<float*>(smem + g.off_stats);
  float* l = m + BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;   // b * H + h
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const size_t kv_off = (static_cast<size_t>(b) * KV + kvh) * S * D;
  const int nq = min(BQ, S - q0);

  load_tile(qs, q + (static_cast<size_t>(bh) * S + q0) * D, nq, BQ, D, g.ldt);
  for (int i = threadIdx.x; i < BQ * D; i += NTHREADS) acc[i] = 0.f;
  for (int i = threadIdx.x; i < BQ; i += NTHREADS) {
    m[i] = NEG;
    l[i] = 0.f;
  }

  // the window of row q0 starts at q0 - W + 1; the tile's last row ends on
  // the diagonal (or at S)
  const int kt_lo = max(0, q0 - W + 1) / BKV;
  const int kt_hi = (min(S, q0 + BQ) - 1) / BKV;
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BKV;
    const int nk = min(BKV, S - k0);
    load_tile(ks, k + kv_off + static_cast<size_t>(k0) * D, nk, BKV, D, g.ldt);
    load_tile(vs, v + kv_off + static_cast<size_t>(k0) * D, nk, BKV, D, g.ldt);
    __syncthreads();

    // scores: lanes over the 32 keys (odd K row stride: distinct banks),
    // warps over rows; the Q element is a broadcast
    {
      constexpr int RPW = BQ / NWARPS;
      float sacc[RPW];
#pragma unroll
      for (int u = 0; u < RPW; ++u) sacc[u] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float kv = ks[lane * g.ldt + d];
#pragma unroll
        for (int u = 0; u < RPW; ++u)
          sacc[u] = fmaf(qs[(warp + NWARPS * u) * g.ldt + d], kv, sacc[u]);
      }
#pragma unroll
      for (int u = 0; u < RPW; ++u) ss[(warp + NWARPS * u) * g.lds + lane] = sacc[u];
    }
    __syncthreads();

    // the online-softmax update, one row per warp at a time: masked keys get
    // p = 0, m and l move on, the accumulator row is rescaled by alpha and
    // the probabilities go back over the scores
    for (int r = warp; r < BQ; r += NWARPS) {
      const int i = q0 + r, j = k0 + lane;
      const bool ok = i < S && j < S && j <= i && j > i - W;
      const float s = ok ? ss[r * g.lds + lane] * scale : NEG;
      const float m_old = m[r];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float alpha = expf(m_old - m_new);
      const float p = ok ? expf(s - m_new) : 0.f;
      ss[r * g.lds + lane] = p;
      const float sum = warp_sum(p);   // every lane has read m[r] before lane 0 writes
      if (lane == 0) {
        m[r] = m_new;
        l[r] = l[r] * alpha + sum;
      }
      for (int d = lane; d < D; d += 32) acc[r * D + d] *= alpha;
    }
    __syncthreads();

    // acc += P V: threads over (row, d), neighbouring d read neighbouring V
    // words
    for (int idx = threadIdx.x; idx < BQ * D; idx += NTHREADS) {
      const int r = idx / D, d = idx % D;
      float x = acc[idx];
#pragma unroll 8
      for (int c = 0; c < BKV; ++c) x = fmaf(ss[r * g.lds + c], vs[c * g.ldt + d], x);
      acc[idx] = x;
    }
    __syncthreads();   // before the next tile overwrites K, V and P
  }

  float* o = out + (static_cast<size_t>(bh) * S + q0) * D;
  for (int idx = threadIdx.x; idx < nq * D; idx += NTHREADS) {
    const float lr = l[idx / D];
    o[idx] = acc[idx] / (lr == 0.f ? 1.f : lr);
  }
  if (lse != nullptr)
    for (int r = threadIdx.x; r < nq; r += NTHREADS)
      lse[static_cast<size_t>(bh) * S + q0 + r] = m[r] + logf(l[r]);
}

int launch(const void* q, const void* k, const void* v, void* out, float* lse, const Plan& p,
           float scale, cudaStream_t stream) {
  const Geometry g(p.D);
  if (static_cast<long long>(g.bytes) != p.smem || p.smem > SMEM_MAX ||
      p.qtiles != (p.S + BQ - 1) / BQ || p.blocks != p.qtiles * p.B * p.H ||
      p.B * p.H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      cudaFuncSetAttribute(swa_fma, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.qtiles, p.B * p.H);
  swa_fma<<<grid, NTHREADS, p.smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), lse, p.H, p.KV, p.S, p.D, p.W, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fp32

// ---------------------------------------------------------------------------
// bfloat16: the wgmma kernel
// ---------------------------------------------------------------------------

namespace bf16 {

using namespace hopper;

constexpr int BQ = 128;              // q rows a block: two warpgroups of 64
constexpr int BKV = 64;              // keys a kv tile
constexpr int ROW = 128;             // bytes of a 64-element swizzled row
constexpr int QBOX = BQ * ROW;       // one 64-column box of the Q tile
constexpr int KVBOX = BKV * ROW;     // one 64-column box of a K or V tile
constexpr int STAGES_MAX = 4;
constexpr int RESERVED = 2048;       // the 1024-byte alignment and the barriers
constexpr int THREADS = 384;         // consumer warpgroups 0 and 1, producer 2
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int N>
__device__ __forceinline__ void mma_pv(float (&o)[N / 2], const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void mma_pv<64>(float (&o)[32], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_mn_m64n64k16(o, a, db, 1);
}
template <>
__device__ __forceinline__ void mma_pv<128>(float (&o)[64], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_mn_m64n128k16(o, a, db, 1);
}
template <>
__device__ __forceinline__ void mma_pv<256>(float (&o)[128], const uint32_t (&a)[4],
                                            uint64_t db) {
  wgmma_rs_mn_m64n256k16(o, a, db, 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// One kv tile's online-softmax update on the score fragment sa (already
// scaled to log2 units): sa[4i + 2hh + c] is row `row + 8 hh`, key
// k0 + 8i + 2(lane % 4) + c.  MASK: the tile crosses the diagonal or the
// window's edge, so each key is checked.  Rescales o, adds the unrounded p
// to the thread's share of l, and leaves p rounded to bf16 in pf as the A
// fragments of the tile's four k16 slices.
template <bool MASK, int NPV>
__device__ __forceinline__ void softmax_tile(float (&sa)[32], float (&o)[NPV / 2],
                                             uint32_t (&pf)[4][4], float (&m)[2],
                                             float (&l)[2], int row, int k0, int W,
                                             int lane) {
  float mx[2] = {NEG, NEG};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int hh = (i >> 1) & 1;
    if constexpr (MASK) {
      const int key = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      const int r = row + 8 * hh;
      if (key > r || key <= r - W) sa[i] = __int_as_float(0xff800000u);   // -inf
    }
    mx[hh] = fmaxf(mx[hh], sa[i]);
  }
  float alpha[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
    const float m_new = fmaxf(m[hh], mx[hh]);
    alpha[hh] = exp2f(m[hh] - m_new);
    m[hh] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int hh = (i >> 1) & 1;
    sa[i] = exp2f(sa[i] - m[hh]);
    sum[hh] += sa[i];
  }
  l[0] = l[0] * alpha[0] + sum[0];
  l[1] = l[1] * alpha[1] + sum[1];
#pragma unroll
  for (int i = 0; i < NPV / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    pf[j][0] = pack_bf16(sa[8 * j + 0], sa[8 * j + 1]);
    pf[j][1] = pack_bf16(sa[8 * j + 2], sa[8 * j + 3]);
    pf[j][2] = pack_bf16(sa[8 * j + 4], sa[8 * j + 5]);
    pf[j][3] = pack_bf16(sa[8 * j + 6], sa[8 * j + 7]);
  }
}

template <int DB>
__global__ void __launch_bounds__(THREADS, 1)
swa_wgmma(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
          const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ out,
          float* __restrict__ lse, const Plan p, float scale_log2) {
  constexpr int Q_BYTES = DB * QBOX, KV_BYTES = DB * KVBOX, STAGE = 2 * KV_BYTES;
  constexpr int NPV = 64 * DB;   // the PV product's N: D padded to 64, 128 or 256
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* qs = smem;
  unsigned char* ring = smem + Q_BYTES;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(ring + p.stages * STAGE);
  uint64_t* kfull = qbar + 1;
  uint64_t* vfull = kfull + STAGES_MAX;
  uint64_t* empty = vfull + STAGES_MAX;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(&kfull[i], 1);
      mbar_init(&vfull[i], 1);
      mbar_init(&empty[i], 2 * 128);   // every consumer thread
    }
    fence_mbar_init();
  }
  __syncthreads();

  // the last q tiles walk the most kv tiles: they go first
  const int BH = p.B * p.H;
  const int bh = blockIdx.x % BH;
  const int q0 = (p.qtiles - 1 - blockIdx.x / BH) * BQ;
  const int kvrow = (bh / p.H) * p.KV + (bh % p.H) / (p.H / p.KV);
  const int kt_lo = max(0, q0 - p.W + 1) / BKV;
  const int kt_hi = (min(p.S, q0 + BQ) - 1) / BKV;

  // the warpgroup's role, taken through a shuffle so that the compiler
  // knows it is the same in every lane: wgmma is not serialised
  const int role = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (role == 2) {
    // ---- producer: one thread issues every TMA load ----------------------
    setmaxnreg_dec<24>();
    if (threadIdx.x != 256) return;
    mbar_expect_tx(qbar, Q_BYTES);
#pragma unroll
    for (int c = 0; c < DB; ++c) tma_load_3d(qs + c * QBOX, &qmap, qbar, c * 64, q0, bh);
    int s = 0;
    uint32_t ph = 0;
    for (int kt = kt_lo; kt <= kt_hi; ++kt) {
      mbar_wait(&empty[s], ph ^ 1);
      unsigned char* st = ring + s * STAGE;
      mbar_expect_tx(&kfull[s], KV_BYTES);
#pragma unroll
      for (int c = 0; c < DB; ++c)
        tma_load_3d(st + c * KVBOX, &kmap, &kfull[s], c * 64, kt * BKV, kvrow);
      mbar_expect_tx(&vfull[s], KV_BYTES);
#pragma unroll
      for (int c = 0; c < DB; ++c)
        tma_load_3d(st + KV_BYTES + c * KVBOX, &vmap, &vfull[s], c * 64, kt * BKV, kvrow);
      if (++s == p.stages) { s = 0; ph ^= 1; }
    }
    return;
  }

  // ---- consumer warpgroups: 64 q rows each --------------------------------
  setmaxnreg_inc<240>();
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int r0 = q0 + role * 64;                  // the warpgroup's first row
  const int row = r0 + warp * 16 + (lane >> 2);   // this thread's rows: row, row + 8
  // the warpgroup's own kv tiles: the window of row r0 to the diagonal of
  // its last row; a warpgroup whose rows all lie past S takes none
  const int lo = r0 < p.S ? max(0, r0 - p.W + 1) / BKV : kt_hi + 1;
  const int hi = (min(p.S, r0 + 64) - 1) / BKV;
  float o[NPV / 2];
#pragma unroll
  for (int i = 0; i < NPV / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  const uint32_t qa = smem_u32(qs) + role * 64 * ROW;
  mbar_wait(qbar, 0);

  int s = 0;
  uint32_t ph = 0;
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const uint32_t st = smem_u32(ring + s * STAGE);
    mbar_wait(&kfull[s], ph);
    if (kt >= lo && kt <= hi) {
      // S = Q K^T over D in k16 steps, both operands K-major
      float sa[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sa[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < DB; ++c) {
        const uint64_t dq = desc_k128(qa + c * QBOX), dk = desc_k128(st + c * KVBOX);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_ss_kk_m64n64k16(sa, dq + 2 * kk, dk + 2 * kk, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sa);
#pragma unroll
      for (int i = 0; i < 32; ++i) sa[i] *= scale_log2;

      const int k0 = kt * BKV;
      uint32_t pf[4][4];
      if (k0 + BKV - 1 > r0 || k0 < r0 + 64 - p.W)
        softmax_tile<true, NPV>(sa, o, pf, m, l, row, k0, p.W, lane);
      else
        softmax_tile<false, NPV>(sa, o, pf, m, l, row, k0, p.W, lane);

      // O += P V, V MN-major: 16 keys a k16 step, 64-column blocks 8 KB apart
      mbar_wait(&vfull[s], ph);
      const uint64_t dv = desc_mn128(st + KV_BYTES, KVBOX);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_pv<NPV>(o, pf[j], dv + 128 * j);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
    } else {
      // the other warpgroup's tile: it is released only once it has landed
      mbar_wait(&vfull[s], ph);
    }
    mbar_arrive(&empty[s]);
    if (++s == p.stages) { s = 0; ph ^= 1; }
  }

  // epilogue: l across the 4 lanes of a row, divide (0 -> 1), store rows < S
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row + 8 * hh;
    if (r >= p.S) continue;
    const float inv = 1.f / (l[hh] == 0.f ? 1.f : l[hh]);
    __nv_bfloat16* dst = out + (static_cast<size_t>(bh) * p.S + r) * p.D;
#pragma unroll
    for (int i = 0; i < NPV / 8; ++i) {
      const int c = 8 * i + 2 * (lane & 3);
      if (c < p.D)   // D % 8 == 0: c + 1 < D too
        *reinterpret_cast<__nv_bfloat162*>(dst + c) =
            __floats2bfloat162_rn(o[4 * i + 2 * hh] * inv, o[4 * i + 2 * hh + 1] * inv);
    }
    // the row's log-sum-exp in natural units: m and the scores are in log2
    if (lse != nullptr && (lane & 3) == 0)
      lse[static_cast<size_t>(bh) * p.S + r] = (m[hh] + log2f(l[hh])) * LN2;
  }
}

int boxes(int D) { return D <= 64 ? 1 : D <= 128 ? 2 : 4; }

bool plan_ok(const Plan& p) {
  if (p.D % 8 != 0 || p.D > 256 || p.DB != boxes(p.D)) return false;
  if (p.stages < 2 || p.stages > STAGES_MAX) return false;
  if (p.qtiles != (p.S + BQ - 1) / BQ ||
      static_cast<long long>(p.qtiles) * p.B * p.H != p.blocks)
    return false;
  const long long bytes = static_cast<long long>(p.DB) * (QBOX + 2 * p.stages * KVBOX) + RESERVED;
  return p.smem == bytes && bytes <= SMEM_MAX;
}

template <int DB>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, const Plan& p,
           float scale, cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap;
  memset(&qmap, 0, sizeof qmap);
  memset(&kmap, 0, sizeof kmap);
  memset(&vmap, 0, sizeof vmap);
  const cuuint64_t row = static_cast<cuuint64_t>(p.D) * 2;
  const cuuint64_t strides[2] = {row, row * p.S};
  const cuuint64_t qdims[3] = {static_cast<cuuint64_t>(p.D), static_cast<cuuint64_t>(p.S),
                               static_cast<cuuint64_t>(p.B) * p.H};
  const cuuint64_t kvdims[3] = {static_cast<cuuint64_t>(p.D), static_cast<cuuint64_t>(p.S),
                                static_cast<cuuint64_t>(p.B) * p.KV};
  const cuuint32_t qbox[3] = {64, BQ, 1};
  const cuuint32_t kvbox[3] = {64, BKV, 1};
  int e = hopper_host::bf16_map(&qmap, q, 3, qdims, strides, qbox);
  if (!e) e = hopper_host::bf16_map(&kmap, k, 3, kvdims, strides, kvbox);
  if (!e) e = hopper_host::bf16_map(&vmap, v, 3, kvdims, strides, kvbox);
  if (e) return e;
  auto kernel = swa_wgmma<DB>;
  static bool sized[64] = {};   // once per variant and device: the most any plan asks
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !sized[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) sized[dev] = true;
  }
  kernel<<<p.blocks, THREADS, p.smem, stream>>>(qmap, kmap, vmap,
                                                static_cast<__nv_bfloat16*>(out), lse,
                                                p, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bf16

}  // namespace

// The plan's field names in struct Plan's order, each followed by a comma.
extern "C" const char* swa_attention_plan_fields() { return SWA_ATTENTION_PLAN(PLAN_NAME); }

// q and out [B, H, S, D], k and v [B, KV, S, D], all of one dtype, contiguous
// and 16-byte aligned; `lse` an fp32 [B, H, S] for the rows' log-sum-exp, or
// null; `plan` holds `nplan` ints in the order of
// kernels/swa_attention.py's PLAN_FIELDS: path 0 is float32 (the FMA
// kernel), path 1 bfloat16 (wgmma).  H % KV == 0, D % 8 == 0 and D <= 256,
// window W >= 1.  Launches on `stream` and returns cudaGetLastError() (0 on
// success); a plan it does not take returns cudaErrorInvalidValue without
// launching, a failed tensor-map encoding its CUresult.
extern "C" int swa_attention(const void* q, const void* k, const void* v, void* out, void* lse,
                             const int* plan, int nplan, float scale, void* stream) {
  if (nplan != PLAN_INTS) return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  memcpy(&p, plan, sizeof p);
  if (p.B <= 0 || p.H <= 0 || p.KV <= 0 || p.H % p.KV != 0 || p.S <= 0 || p.D <= 0 ||
      p.D % 8 != 0 || p.D > 256 || p.W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (p.path == 0) return fp32::launch(q, k, v, out, l, p, scale, s);
  if (p.path != 1 || !bf16::plan_ok(p)) return static_cast<int>(cudaErrorInvalidValue);
  if (p.DB == 1) return bf16::launch<1>(q, k, v, out, l, p, scale, s);
  if (p.DB == 2) return bf16::launch<2>(q, k, v, out, l, p, scale, s);
  return bf16::launch<4>(q, k, v, out, l, p, scale, s);
}
