// kraken_gemm for Hopper (sm_90a): out = act(a @ b + bias), fp32 accumulation.
//
// Replaces the Pallas TPU kernel src/repro/kernels/kraken_gemm.py::kraken_gemm
// (bodies _ws_kernel and _os_kernel).  The TPU version picks one of two
// schedules per shape (weight-stationary full-K tiles or output-stationary
// split-K) from a VMEM tile plan and needs its operands padded to the tile
// grid.  Here one design serves every shape; the plan (tile, ring, split,
// fill) comes from kernels/kraken_gemm.py::plan, which the CPU tests check,
// and the ragged M/N/K edges are masked in the kernel, so nothing is padded.
//
// What bounds each shape class on an H100 (989 TFLOP/s bf16, 3.35 TB/s):
//   * decode (M = serving slots, 1-64): every call reads its whole [K, N]
//     weight for a few output rows, about 2 FLOP per weight byte against the
//     ~295 the card needs to be compute bound: the bound is the weight read,
//     and only a grid that streams it from every SM comes near it;
//   * the mixed step (M 256): ~250 FLOP per weight byte, near the ridge:
//     bytes and tensor cores both matter;
//   * the forward (M 4096) and the im2col conv at batch 32 (M up to 1.6 M):
//     bound by the tensor-core rate; the kernel reaches about two thirds of
//     it, likely held by how fast shared memory is fed from L2 (a 128 x 256
//     tile needs 48 KB per 64-deep step; not measured apart);
//   * the im2col conv's first layers (K 27, 147, 363): bound by reading A,
//     whose rows TMA cannot take.
//
// bfloat16 (kraken_gemm_wgmma):
//   * one block per output tile of BM (64 or 128) x BN (64, 128 or 256) and
//     split z of K; warp specialisation: consumer warpgroups 0 (and 1) own
//     64 rows each and run wgmma, the last warpgroup produces;
//   * a ring of 2-5 stages over K, each an A box [BM, 64] and BN/64 B boxes
//     [64, 64], 128-byte swizzled, with a full and an empty mbarrier.  One
//     thread starts the TMA loads, the weights' with an L2 evict-first
//     policy; TMA's zero fill takes the ragged M, N and K edges (at M = 4
//     the rows past M arrive as zeros and are never read from memory);
//   * wgmma with both operands in shared memory (SS): A K-major, B read as
//     it lies -- the [K, N] weights are MN-major, which 16-bit wgmma takes
//     through its transpose immediate -- so no copy of the weights is made;
//     one group of products stays in flight while the next stage is awaited;
//   * where TMA refuses an operand (a base or row stride not a multiple of
//     16 bytes: the im2col conv's A at K 27, 147, 363, or N % 8 != 0), the
//     producer warpgroup fills that operand's stages with 2-byte loads into
//     the same swizzled layout (fill_tile), the one non-TMA fill;
//   * split-K, when the output tiles alone leave SMs idle (decode): split z
//     writes its fp32 partial sums to a scratch tensor the wrapper
//     allocates, and kraken_gemm_reduce adds them in the order z = 0, 1, ...
//     and only then applies bias and the activation and rounds once: no
//     atomics, no block waits on another, the same bits on every run;
//   * the epilogue adds bias, applies the activation to the fp32 sum and
//     rounds once to bf16, masked to [M, N].
//
// float32 (kraken_gemm_fma): full fp32 FMA, no TF32 (the parity route, held
// to 1e-4), bound by the FMA pipes (67 TFLOP/s, a 16th of bf16's tensor rate):
//   * one block of 256 threads per output tile of 128 x 128 and split z of K;
//     8 warps in a 4 x 2 grid of 32 x 64, each thread an 8 x 8 register
//     micro-tile (rows 4ty + 16h + r of its warp's 32, columns 4tx + 32h + c
//     of its 64), so that a k step's two 16-byte reads of A and two of B
//     feed 64 FMAs;
//   * a ring of 3 stages of K = 32 in dynamic shared memory, filled with
//     cp.async: A [128, 32] stored K-major, transposed to [32, 128] at a row
//     stride of 132 floats by 4-byte copies (a warp's 32 take 4 rows x 8
//     consecutive k, one 32-byte sector a row, into 32 distinct banks), B
//     [32, 128] as it lies by 16-byte copies (4-byte ones where its base or
//     rows are not 16-byte aligned: fill_b).  A warp's reads of A are 4
//     distinct 16-byte words of one row, of B 8: no bank conflicts.  Each
//     thread's copy addresses are set once a tile (Copies), the slots
//     advance without a division, and a k step's fragments are read while
//     the previous step's FMAs run;
//   * everything past M, K and N is zero-filled by the copy's source size 0
//     and never read, so no Inf or NaN outside the operands leaks in;
//   * split-K when the output tiles number fewer than the SMs, as bf16:
//     fp32 partials into the wrapper's scratch, summed in the order z = 0,
//     1, ... by kraken_gemm_reduce<float>, which then applies bias and the
//     activation once.  Two blocks fit an SM (128 registers, 97.5 KB each),
//     which the planner counts.
// It runs at about 55% of the FMA pipes' rate at train_lm's products, 1.16x
// torch.matmul's: the 2048 FMAs of a thread's step share the issue slots
// with 128 shared loads, the copies and a barrier, and 96-tile products
// leave a partial wave or a split's partials.

#include "hopper.cuh"

#include <string.h>

#include <algorithm>

namespace {

// Every field an int.  The one list of them: struct Plan and the names
// kraken_gemm_plan_fields() gives, which kernels/kraken_gemm.py checks
// against its PLAN_FIELDS when it loads this library.
#define KRAKEN_GEMM_PLAN(X)                                                    \
  X(path) X(M) X(N) X(K)                                                       \
  /* the tile, ring, split and fill of either kernel */                        \
  X(BM) X(BN) X(stages) X(nk) X(split) X(kps) X(mtiles) X(ntiles) X(tiles)     \
  X(fill_a) X(fill_b) X(smem)

#define PLAN_DECL(f) int f;
#define PLAN_NAME(f) #f ","
#define PLAN_ONE(f) +1
struct Plan {
  KRAKEN_GEMM_PLAN(PLAN_DECL)
};
constexpr int PLAN_INTS = 0 KRAKEN_GEMM_PLAN(PLAN_ONE);
static_assert(sizeof(Plan) == PLAN_INTS * sizeof(int), "Plan is ints only");

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

// ---------------------------------------------------------------------------
// bfloat16: the wgmma kernel
// ---------------------------------------------------------------------------

using namespace hopper;

constexpr int SMEM_MAX = 227 * 1024;
constexpr int KB = 64;            // K per ring stage: one 128-byte swizzled row
constexpr int ROW = 128;          // bytes of a 64-element swizzled row
constexpr int STAGES_MAX = 5;
constexpr int FILLERS = 128;      // the producer warpgroup, where TMA cannot take an operand

struct OutTile {
  int m0, n0, k0, ksteps, z;
};

// Tile t: row tile fastest, then column tile, then split z (each split a
// run of kps k-steps; the planner leaves none empty).
__device__ __forceinline__ OutTile tile_at(const Plan& p, int t) {
  OutTile o;
  const int mt = t % p.mtiles, rest = t / p.mtiles;
  o.m0 = mt * p.BM;
  o.n0 = (rest % p.ntiles) * p.BN;
  o.z = rest / p.ntiles;
  o.k0 = o.z * p.kps;
  o.ksteps = min(p.kps, p.nk - o.k0);
  return o;
}

// ---------------------------------------------------------------------------
// float32: the FMA kernel
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int THREADS = 256;                 // 8 warps, 4 x 2, of 32 x 64
constexpr int LDA = BM + 4;                  // A^T's row stride, floats
constexpr int A_FLOATS = BK * LDA;
constexpr int STAGE_FLOATS = A_FLOATS + BK * BN;
constexpr int STAGES = 3;

__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// A thread's share of the copies, fixed for the tile: zeros past M, K and N
// (source size 0: nothing read there).  A [BM, BK] goes in transposed, A^T
// [BK, BM] at row stride LDA, by 4-byte copies: thread t takes rows t / 8 +
// 32 j (j < 4) at k t % 8 + 8 q, so a warp's 32 take 4 rows x 8 consecutive
// k (one 32-byte sector a row) into banks 4k + m, all distinct.  B [BK, BN]
// as it lies, by 16-byte copies: thread t takes row t / 32 + 8 q at columns
// 4 (t % 32) .. + 3, a warp one 512-byte row (4-byte copies where fill_b).
struct Copies {
  const float* a;     // A[m0 + t / 8, t % 8]
  const float* b;     // B[t / 32, n0 + 4 (t % 32)]
  size_t a_rows;      // 32 rows of A
  int rows_in;        // bit j: row t / 8 + 32 j is inside M
  bool cols_in;       // the 4 columns are inside N
  uint32_t a_dst, b_dst;
};

__device__ __forceinline__ Copies copies_of(const float* __restrict__ a,
                                            const float* __restrict__ b, const Plan& p,
                                            int m0, int n0) {
  const int t = threadIdx.x;
  Copies c;
  c.a = a + static_cast<size_t>(min(m0 + t / 8, p.M - 1)) * p.K + t % 8;
  c.b = b + (t / 32) * static_cast<size_t>(p.N) + n0 + 4 * (t % 32);
  c.a_rows = static_cast<size_t>(32) * p.K;
  c.rows_in = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) c.rows_in |= (m0 + t / 8 + 32 * j < p.M) << j;
  c.cols_in = n0 + 4 * (t % 32) < p.N;
  c.a_dst = 4 * ((t % 8) * LDA + t / 8);
  c.b_dst = 4 * (A_FLOATS + (t / 32) * BN + 4 * (t % 32));
  return c;
}

// Stage k step k0 of the tile (m0, n0) into the ring slot at `st`.
__device__ __forceinline__ void load_stage(uint32_t st, const Copies& c,
                                           const float* __restrict__ a,
                                           const float* __restrict__ b, const Plan& p, int n0,
                                           int k0) {
  const int t = threadIdx.x;
#pragma unroll
  for (int q = 0; q < BK / 8; ++q) {
    const bool kin = k0 + 8 * q + t % 8 < p.K;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool in = kin && ((c.rows_in >> j) & 1);
      cp_async4(st + c.a_dst + 4 * (8 * q * LDA + 32 * j),
                in ? c.a + j * c.a_rows + k0 + 8 * q : a, in);
    }
  }
  if (!p.fill_b) {
#pragma unroll
    for (int q = 0; q < BK / 8; ++q) {
      const bool in = c.cols_in && k0 + 8 * q + t / 32 < p.K;
      cp_async16(st + c.b_dst + 4 * (8 * q * BN),
                 in ? c.b + static_cast<size_t>(k0 + 8 * q) * p.N : b, in);
    }
  } else {
    for (int e = t; e < BK * BN; e += THREADS) {
      const int r = e / BN, nc = e % BN;
      const int gk = k0 + r, gn = n0 + nc;
      const bool in = gk < p.K && gn < p.N;
      cp_async4(st + 4 * (A_FLOATS + r * BN + nc),
                in ? b + static_cast<size_t>(gk) * p.N + gn : b, in);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 2)
kraken_gemm_fma(const float* __restrict__ a, const float* __restrict__ b,
                const float* __restrict__ bias, float* __restrict__ out,
                float* __restrict__ part, const Plan p, int act) {
  extern __shared__ __align__(16) float ring[];
  const OutTile tl = tile_at(p, blockIdx.x);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // this thread's rows rm + 16 g + r and columns cn + 32 h + c (g, h < 2;
  // r, c < 4): of a k step, two 16-byte reads of A^T and two of B feed 64
  // FMAs; a warp's A reads are 4 distinct 16-byte words of one row, its B
  // reads 8, one 128-byte row: no bank conflicts
  const int rm = (warp >> 1) * 32 + (lane >> 3) * 4;
  const int cn = (warp & 1) * 64 + (lane & 7) * 4;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const Copies cp = copies_of(a, b, p, tl.m0, tl.n0);
  const uint32_t ring0 = smem_u32(ring);
  // split z's run of K: n steps from step kb; the ring: steps 0 .. STAGES -
  // 2 in flight before the first product
  const int n = tl.ksteps, kb = tl.k0;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n) load_stage(ring0 + 4 * s * STAGE_FLOATS, cp, a, b, p, tl.n0, (kb + s) * BK);
    cp_async_commit();
  }
  int rd = 0, wr = STAGES - 1;   // the slots of steps i and i + STAGES - 1
  for (int i = 0; i < n; ++i) {
    cp_async_wait<STAGES - 2>();   // step i landed: at most STAGES - 2 younger pending
    __syncthreads();   // every thread's copies of step i, and step i - 1 read
    if (i + STAGES - 1 < n)
      load_stage(ring0 + 4 * wr * STAGE_FLOATS, cp, a, b, p, tl.n0,
                 (kb + i + STAGES - 1) * BK);
    cp_async_commit();
    const float* As = ring + rd * STAGE_FLOATS + rm;
    const float* Bs = ring + rd * STAGE_FLOATS + A_FLOATS + cn;
    rd = rd == STAGES - 1 ? 0 : rd + 1;
    wr = wr == STAGES - 1 ? 0 : wr + 1;
    // the fragments of k step kk + 1 are read while kk's FMAs run
    float av[2][8], bv[2][8];
#pragma unroll
    for (int kk = 0; kk <= BK; ++kk) {
      if (kk < BK) {
        float* x = av[kk & 1];
        float* y = bv[kk & 1];
        *reinterpret_cast<float4*>(x) = *reinterpret_cast<const float4*>(As + kk * LDA);
        *reinterpret_cast<float4*>(x + 4) = *reinterpret_cast<const float4*>(As + kk * LDA + 16);
        *reinterpret_cast<float4*>(y) = *reinterpret_cast<const float4*>(Bs + kk * BN);
        *reinterpret_cast<float4*>(y + 4) = *reinterpret_cast<const float4*>(Bs + kk * BN + 32);
      }
      if (kk > 0) {
        const int u = (kk - 1) & 1;
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(av[u][r], bv[u][j], acc[r][j]);
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: a split's partial as it is, else bias + activation, masked to
  // [M, N]; 16-byte stores where N % 4 == 0 (then a 4-column group is all in
  // or all out), a warp's eight one 128-byte row
  const size_t MN = static_cast<size_t>(p.M) * p.N;
  float* dst = p.split > 1 ? part + tl.z * MN : out;
  const bool vec = p.N % 4 == 0;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int gm = tl.m0 + rm + 16 * (r >> 2) + (r & 3);
    if (gm >= p.M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gn = tl.n0 + cn + 32 * h;
      if (gn >= p.N) continue;
      float v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        v[c] = acc[r][4 * h + c];
        if (p.split == 1) {
          if (bias != nullptr && gn + c < p.N) v[c] += bias[gn + c];
          v[c] = activate(v[c], act);
        }
      }
      float* o = dst + static_cast<size_t>(gm) * p.N + gn;
      if (vec) {
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (gn + c < p.N) o[c] = v[c];
      }
    }
  }
}

}  // namespace f32

// The one fill for an operand TMA cannot take: src[r0 + r, c0 + c] (row
// stride ld, zero outside [rows, cols]) for r < nrows, c < 64 * ncblk, into
// the layout a TMA box with the 128-byte swizzle leaves: 64-column block cb
// at cb * nrows * 128 bytes, row r at r * 128, 16-byte chunk j at j ^ (r % 8).
// Thread f of FILLERS writes whole chunks; neighbouring threads take
// neighbouring chunks of a row.  Loads are 2 bytes: such rows are not
// 4-byte aligned in general.
__device__ void fill_tile(unsigned char* dst, const uint16_t* __restrict__ src, int ld,
                          int rows, int cols, int r0, int c0, int nrows, int ncblk, int f) {
  const uint32_t base = smem_u32(dst);
  const int total = ncblk * nrows * 8;
#pragma unroll 2
  for (int u = f; u < total; u += FILLERS) {
    const int j = u & 7, q = u >> 3;
    const int rr = q % nrows, cb = q / nrows;
    const int r = r0 + rr, c = c0 + cb * 64 + j * 8;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (r < rows && c < cols) {
      const uint16_t* row = src + static_cast<size_t>(r) * ld;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t lo = c + 2 * e < cols ? row[c + 2 * e] : 0u;
        const uint32_t hi = c + 2 * e + 1 < cols ? row[c + 2 * e + 1] : 0u;
        w[e] = lo | (hi << 16);
      }
    }
    const uint32_t at = base + (cb * nrows + rr) * ROW + ((j ^ (rr & 7)) << 4);
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(at), "r"(w[0]), "r"(w[1]),
                 "r"(w[2]), "r"(w[3])
                 : "memory");
  }
}

template <int BM, int BN>
__global__ void __launch_bounds__(128 * (BM / 64 + 1), 1)
kraken_gemm_wgmma(const __grid_constant__ CUtensorMap amap,
                  const __grid_constant__ CUtensorMap bmap,
                  const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
                  const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                  float* __restrict__ part, const Plan p, int act) {
  constexpr int NC = BM / 64;                   // consumer warpgroups
  constexpr int A_BYTES = BM * ROW, B_BYTES = BN * ROW, STAGE = A_BYTES + B_BYTES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.stages * STAGE);
  uint64_t* empty = full + STAGES_MAX;
  const bool fill = p.fill_a || p.fill_b;

  if (threadIdx.x == 0) {
    for (int i = 0; i < p.stages; ++i) {
      // the TMA thread's expect_tx arrival, plus every filler's
      mbar_init(&full[i], 1 + (fill ? FILLERS : 0));
      mbar_init(&empty[i], NC * 128);
    }
    fence_mbar_init();
  }
  __syncthreads();
  const OutTile tl = tile_at(p, blockIdx.x);

  // the warpgroup's role, taken through a shuffle so that the compiler
  // knows it is the same in every lane: wgmma is not serialised
  const int role = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (role == NC) {
    // ---- producer warpgroup ---------------------------------------------
    if constexpr (NC == 2) setmaxnreg_dec<56>();
    const int f = threadIdx.x - NC * 128;
    if (f != 0 && !fill) return;
    const uint32_t tx = (p.fill_a ? 0 : A_BYTES) + (p.fill_b ? 0 : B_BYTES);
    // the weights are streamed: their lines go first, so that A's rows (read
    // by every column tile) and the split's partials stay in L2
    const uint64_t weights_policy = l2_evict_first();
    int s = 0;
    uint32_t ph = 0;
    for (int i = 0; i < tl.ksteps; ++i) {
      mbar_wait(&empty[s], ph ^ 1);
      unsigned char* st = smem + s * STAGE;
      const int k0 = (tl.k0 + i) * KB;
      if (f == 0) {
        mbar_expect_tx(&full[s], tx);
        if (!p.fill_a) tma_load_2d(st, &amap, &full[s], k0, tl.m0);
        if (!p.fill_b) {
#pragma unroll
          for (int nb = 0; nb < BN / 64; ++nb)
            tma_load_2d(st + A_BYTES + nb * KB * ROW, &bmap, &full[s], tl.n0 + nb * 64, k0,
                        weights_policy);
        }
      }
      if (fill) {
        if (p.fill_a)
          fill_tile(st, reinterpret_cast<const uint16_t*>(a), p.K, p.M, p.K, tl.m0, k0, BM, 1,
                    f);
        if (p.fill_b)
          fill_tile(st + A_BYTES, reinterpret_cast<const uint16_t*>(b), p.N, p.K, p.N, k0,
                    tl.n0, KB, BN / 64, f);
        fence_proxy_async();
        mbar_arrive(&full[s]);
      }
      if (++s == p.stages) { s = 0; ph ^= 1; }
    }
    return;
  }

  // ---- consumer warpgroups: 64 rows each ---------------------------------
  if constexpr (NC == 2) setmaxnreg_inc<224>();
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  int s = 0, prev = -1;
  uint32_t ph = 0;
  for (int i = 0; i < tl.ksteps; ++i) {
    mbar_wait(&full[s], ph);
    const uint32_t st = smem_u32(smem + s * STAGE);
    const uint64_t da = desc_k128(st + role * 64 * ROW);
    const uint64_t db = desc_mn128(st + A_BYTES, KB * ROW);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KB / 16; ++kk) wgmma_ss<BN>(acc, da + 2 * kk, db + 128 * kk);
    wgmma_commit();
    // keep this stage's products in flight; the previous stage's are done
    wgmma_wait<1>();
    if (prev >= 0) mbar_arrive(&empty[prev]);
    prev = s;
    if (++s == p.stages) { s = 0; ph ^= 1; }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // epilogue: thread (warp, lane) holds rows lane/4 and lane/4 + 8 of the
  // warp's 16, columns 8i + 2(lane%4) and + 1 of every 8-column block i
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int row0 = tl.m0 + role * 64 + warp * 16 + (lane >> 2);
  const bool pair = p.N % 2 == 0;
  const size_t MN = static_cast<size_t>(p.M) * p.N;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    if (r >= p.M) continue;
    const size_t at = static_cast<size_t>(r) * p.N;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int c = tl.n0 + 8 * i + 2 * (lane & 3);
      if (c >= p.N) continue;
      float v0 = acc[4 * i + 2 * h], v1 = acc[4 * i + 2 * h + 1];
      const bool ok1 = c + 1 < p.N;
      if (p.split > 1) {
        float* dst = part + tl.z * MN + at + c;
        if (pair && ok1) {
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          dst[0] = v0;
          if (ok1) dst[1] = v1;
        }
        continue;
      }
      if (bias != nullptr) {
        v0 += bias[c];
        if (ok1) v1 += bias[c + 1];
      }
      v0 = activate(v0, act);
      v1 = activate(v1, act);
      if (pair && ok1) {
        *reinterpret_cast<__nv_bfloat162*>(out + at + c) = __floats2bfloat162_rn(v0, v1);
      } else {
        out[at + c] = __float2bfloat16(v0);
        if (ok1) out[at + c + 1] = __float2bfloat16(v1);
      }
    }
  }
}

__device__ __forceinline__ void store_out(float* o, float x) { *o = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* o, float x) { *o = __float2bfloat16(x); }

// out = act(part[0] + part[1] + ... + part[split - 1] + bias), in that order,
// rounded once to out's type: the same bits on every run.
template <typename T>
__global__ void __launch_bounds__(256)
kraken_gemm_reduce(const float* __restrict__ part, const float* __restrict__ bias,
                   T* __restrict__ out, int M, int N, int split, int act) {
  const size_t count = static_cast<size_t>(M) * N;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < count;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = part[i];
    for (int z = 1; z < split; ++z) s += part[z * count + i];
    if (bias != nullptr) s += bias[i % N];
    store_out(out + i, activate(s, act));
  }
}

template <typename T>
int launch_reduce(const void* part, const void* bias, void* out, const Plan& p, int act,
                  cudaStream_t stream) {
  const size_t count = static_cast<size_t>(p.M) * p.N;
  const int blocks = static_cast<int>(std::min<size_t>((count + 255) / 256, 4096));
  kraken_gemm_reduce<T><<<blocks, 256, 0, stream>>>(static_cast<const float*>(part),
                                                    static_cast<const float*>(bias),
                                                    static_cast<T*>(out), p.M, p.N, p.split,
                                                    act);
  return static_cast<int>(cudaGetLastError());
}

// The float32 plan: the 128 x 128 tile, a ring of 3 K = 32 stages, the
// split's runs of K steps; A always by 4-byte copies (fill_a), B by 4-byte
// ones exactly where 16-byte ones do not fit (a base not 16-byte aligned, or
// rows of N not a multiple of 4).
bool fma_plan_ok(const Plan& p, const void* b) {
  if (p.BM != f32::BM || p.BN != f32::BN) return false;
  if (p.stages != f32::STAGES) return false;
  if (p.nk != (p.K + f32::BK - 1) / f32::BK || p.split < 1 || p.kps < (p.nk > 0)) return false;
  if (p.kps * p.split < p.nk || (p.split > 1 && (p.split - 1) * p.kps >= p.nk)) return false;
  if (p.mtiles != (p.M + p.BM - 1) / p.BM || p.ntiles != (p.N + p.BN - 1) / p.BN) return false;
  if (static_cast<long long>(p.mtiles) * p.ntiles * p.split != p.tiles) return false;
  if (p.smem != p.stages * f32::STAGE_FLOATS * 4) return false;
  const bool vec_b = reinterpret_cast<uintptr_t>(b) % 16 == 0 && p.N % 4 == 0;
  return p.fill_a == 1 && p.fill_b == !vec_b;
}

int launch_fma(const void* a, const void* b, const void* bias, void* out, void* part,
               const Plan& p, int act, cudaStream_t stream) {
  static bool sized[64] = {};   // once per device: the ring's shared memory
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !sized[dev]) {
    err = cudaFuncSetAttribute(f32::kraken_gemm_fma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               f32::STAGES * f32::STAGE_FLOATS * 4);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) sized[dev] = true;
  }
  f32::kraken_gemm_fma<<<p.tiles, f32::THREADS, p.smem, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(bias), static_cast<float*>(out), static_cast<float*>(part), p,
      act);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.split == 1) return static_cast<int>(err);
  return launch_reduce<float>(part, bias, out, p, act, stream);
}

bool plan_ok(const Plan& p, const void* a, const void* b) {
  if (p.BM != 64 && p.BM != 128) return false;
  if (p.BN != 64 && p.BN != 128 && p.BN != 256) return false;
  if (p.stages < 2 || p.stages > STAGES_MAX) return false;
  if (p.nk != (p.K + KB - 1) / KB || p.split < 1 || p.kps < (p.nk > 0)) return false;
  if (p.kps * p.split < p.nk || (p.split > 1 && (p.split - 1) * p.kps >= p.nk)) return false;
  if (p.mtiles != (p.M + p.BM - 1) / p.BM || p.ntiles != (p.N + p.BN - 1) / p.BN) return false;
  if (static_cast<long long>(p.mtiles) * p.ntiles * p.split != p.tiles) return false;
  if (p.smem > SMEM_MAX || p.smem < p.stages * (p.BM + p.BN) * ROW + 1024 + 16 * STAGES_MAX)
    return false;
  // TMA takes a 2-D operand whose base and row stride are multiples of 16 bytes
  const bool tma_a = reinterpret_cast<uintptr_t>(a) % 16 == 0 && p.K % 8 == 0;
  const bool tma_b = reinterpret_cast<uintptr_t>(b) % 16 == 0 && p.N % 8 == 0;
  if ((p.fill_a != 0 && p.fill_a != 1) || (p.fill_b != 0 && p.fill_b != 1)) return false;
  if ((!p.fill_a && !tma_a) || (!p.fill_b && !tma_b)) return false;
  return true;
}

template <int BM, int BN>
int launch_wgmma(const void* a, const void* b, const void* bias, void* out, void* part,
                 const Plan& p, int act, cudaStream_t stream) {
  CUtensorMap amap, bmap;
  memset(&amap, 0, sizeof amap);
  memset(&bmap, 0, sizeof bmap);
  if (p.nk > 0 && !p.fill_a) {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(p.K), static_cast<cuuint64_t>(p.M)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(p.K) * 2};
    const cuuint32_t box[2] = {KB, static_cast<cuuint32_t>(BM)};
    const int e = hopper_host::bf16_map(&amap, a, 2, dims, strides, box);
    if (e) return e;
  }
  if (p.nk > 0 && !p.fill_b) {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(p.N), static_cast<cuuint64_t>(p.K)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(p.N) * 2};
    const cuuint32_t box[2] = {64, KB};
    const int e = hopper_host::bf16_map(&bmap, b, 2, dims, strides, box);
    if (e) return e;
  }
  auto kernel = kraken_gemm_wgmma<BM, BN>;
  static bool sized[64] = {};   // once per variant and device: the most any plan asks
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !sized[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) sized[dev] = true;
  }
  kernel<<<p.tiles, 128 * (BM / 64 + 1), p.smem, stream>>>(
      amap, bmap, static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(part), p, act);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.split == 1) return static_cast<int>(err);
  return launch_reduce<__nv_bfloat16>(part, bias, out, p, act, stream);
}

template <int BM>
int launch_bn(const void* a, const void* b, const void* bias, void* out, void* part,
              const Plan& p, int act, cudaStream_t s) {
  if (p.BN == 256) return launch_wgmma<BM, 256>(a, b, bias, out, part, p, act, s);
  if (p.BN == 128) return launch_wgmma<BM, 128>(a, b, bias, out, part, p, act, s);
  return launch_wgmma<BM, 64>(a, b, bias, out, part, p, act, s);
}

}  // namespace

// The plan's field names in struct Plan's order, each followed by a comma.
extern "C" const char* kraken_gemm_plan_fields() { return KRAKEN_GEMM_PLAN(PLAN_NAME); }

// a [M, K] and b [K, N] of one dtype, contiguous; out [M, N] of that dtype;
// bias fp32 [N] or null; act: 0 none, 1 relu, 2 silu, 3 gelu (tanh).  `plan`
// holds `nplan` ints in the order of kernels/kraken_gemm.py's PLAN_FIELDS:
// path 0 is float32 (the FMA kernel), path 1 bfloat16 (wgmma); when the
// plan splits K, part is an fp32 buffer of split * M * N.  Launches on
// `stream` and returns cudaGetLastError() (0 on success); a plan it does not
// take returns cudaErrorInvalidValue without launching, a failed tensor-map
// encoding its CUresult.
extern "C" int kraken_gemm(const void* a, const void* b, const void* bias, void* out,
                           void* part, const int* plan, int nplan, int act, void* stream) {
  if (nplan != PLAN_INTS || act < 0 || act > 3) return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  memcpy(&p, plan, sizeof p);
  if (p.M <= 0 || p.N <= 0 || p.K < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.path == 0 && fma_plan_ok(p, b) && (p.split == 1 || part != nullptr))
    return launch_fma(a, b, bias, out, part, p, act, s);
  if (p.path == 1 && plan_ok(p, a, b) && (p.split == 1 || part != nullptr))
    return p.BM == 128 ? launch_bn<128>(a, b, bias, out, part, p, act, s)
                       : launch_bn<64>(a, b, bias, out, part, p, act, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
