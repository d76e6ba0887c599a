// grouped_moe_gemm for Hopper (sm_90a): out[e, :sizes[e]] = xs[e, :sizes[e]] @ w[e]
// for every expert e in one call, rows >= sizes[e] exactly zero.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/kraken_moe_gemm.py::grouped_moe_gemm (body _kernel).  The
// TPU version pads the capacity buffer to its block_rows plan and the lanes to
// 128, scalar-prefetches the group table, skips dead m-blocks with pl.when and
// remaps an empty group's weight DMA to expert 0.  Here nothing is padded, the
// grid comes from the shapes alone (so a CUDA graph captures the call), and
// the live-row counts sizes[e] (clamped to [0, C]) are read on the device
// only.  The plan (route, tile, ring, split) comes from
// kernels/kraken_moe_gemm.py::plan, which the CPU tests check.
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s): reading the live
// experts' weights.  At decode every live expert sees one row (C = 1), about
// 1 FLOP per weight byte; at mixtral's mixed step (C = 80) at most 80, still
// far under the ~295 the card needs to be compute bound.  So the kernel's
// job is to stream each live expert's [d, f] weights once, from every SM,
// with enough bytes in flight, and to read nothing of a dead expert.
//
// bfloat16 (grouped_moe_gemm_wgmma), when TMA takes both operands (d and f
// multiples of 8, 16-byte aligned bases):
//   * a persistent grid of `blocks` (one per SM); every block builds, from
//     sizes, the same table of live m tiles (an expert's tile of BM rows is
//     live when it starts below sizes[e]) and walks the work items t =
//     blockIdx.x, + gridDim.x, ...: (live m tile, n tile of BN, split z),
//     live tile fastest.  A dead tile is never an item, so a dead expert's
//     weights are never read; every warpgroup walks the same items, so all
//     take the same branches before any mbarrier wait;
//   * two tiles, BM x BN of 64 x 256 at C <= 64 (decode) and 128 x 128
//     above (the mixed step): narrower tiles were slower at every served
//     shape, and a shape with f under BN runs on them as well (the weights'
//     boxes past f arrive as zeros, the epilogue skips their columns);
//   * warp specialisation as kraken_gemm.cu: one producer thread issues TMA
//     into a ring of 2-5 stages over d (an A box [BM, 64] of xs[e] and BN/64
//     boxes [64, 64] of w[e], 128-byte swizzled, full and empty mbarriers);
//     the consumer warpgroups (one at BM 64, two at BM 128) run SS wgmma with
//     the weights read MN-major as they lie (wgmma's transpose immediate), no
//     copy made.  The ring runs on across items: the next item's loads
//     overlap this item's epilogue;
//   * 3-D tensor maps, xs as [E, C, d] and w as [E, d, f]: rows past C, and
//     d and f past their ends, arrive as zeros (never the next expert's
//     rows); the weights load with an L2 evict-first policy;
//   * the epilogue writes rows below sizes[e] and exact zeros for the rest of
//     its tile (each output row depends on its own A row only, so garbage,
//     Inf or NaN in a dead row reaches no live row); the consumers zero-fill
//     the dead tiles before their first item;
//   * split over d when the live tiles alone leave SMs idle: the plan gives
//     the most splits a call may take, and the kernel picks, from the live
//     tile count it sees, live_split() splits, and block 0 writes that
//     count after the partials.  Split z writes fp32 partials of its live
//     rows to `part`; grouped_moe_gemm_sum, a second launch, reads the
//     count, adds them in the order z = 0, 1, ... and rounds once, writing
//     every output element (zeros for dead rows); it returns at once when
//     the call did not split.  No atomics, no block waits on another: the
//     same bits on every run.
//
// float32, int8, and bf16 where TMA refuses a row stride or base keep the
// first port's tile loop (gemm_tile.cuh, shared with kraken_gemm.cu): one
// 64 x 64 tile per block, dead tiles zero-filled without a read; bf16
// through wmma, fp32 through an FMA micro-tile (no TF32), int8 through wmma
// s8 fragments with int32 accumulation and int32 out, exact.

#include "gemm_tile.cuh"
#include "hopper.cuh"

#include <string.h>

#include <algorithm>

namespace {

// Every field an int.  The one list of them: struct Plan and the names
// grouped_moe_gemm_plan_fields() gives, which kernels/kraken_moe_gemm.py
// checks against its PLAN_FIELDS when it loads this library.
#define GROUPED_MOE_GEMM_PLAN(X)                                               \
  X(path) X(dtype) X(E) X(C) X(d) X(f)                                         \
  /* bfloat16 on wgmma */                                                      \
  X(BM) X(BN) X(stages) X(nk) X(mtiles) X(ntiles) X(split) X(blocks) X(smem)

#define PLAN_DECL(f) int f;
#define PLAN_NAME(f) #f ","
#define PLAN_ONE(f) +1
struct Plan {
  GROUPED_MOE_GEMM_PLAN(PLAN_DECL)
};
constexpr int PLAN_INTS = 0 GROUPED_MOE_GEMM_PLAN(PLAN_ONE);
static_assert(sizeof(Plan) == PLAN_INTS * sizeof(int), "Plan is ints only");

enum Path { PATH_TILE = 0, PATH_WGMMA = 1 };
enum DType { DT_F32 = 0, DT_BF16 = 1, DT_INT8 = 2 };

__device__ __forceinline__ int live_rows(const int32_t* __restrict__ sizes, int e, int C) {
  return min(max(sizes[e], 0), C);
}

// ---------------------------------------------------------------------------
// float32, int8 and bf16 that TMA cannot take: the tile loop of gemm_tile.cuh
// ---------------------------------------------------------------------------

namespace tile {

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
  const int size = live_rows(sizes, e, C);   // the same for every thread
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

int launch_dtype(const void* xs, const void* w, const int32_t* sizes, void* out, const Plan& p,
                 cudaStream_t s) {
  if (p.E > 65535 || (p.C + BM - 1) / BM > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (p.dtype == DT_F32) return launch<float>(xs, w, sizes, out, p.E, p.C, p.d, p.f, s);
  if (p.dtype == DT_BF16) return launch<__nv_bfloat16>(xs, w, sizes, out, p.E, p.C, p.d, p.f, s);
  if (p.dtype == DT_INT8) return launch<int8_t>(xs, w, sizes, out, p.E, p.C, p.d, p.f, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tile

// ---------------------------------------------------------------------------
// bfloat16: the persistent wgmma kernel
// ---------------------------------------------------------------------------

namespace wg {

using namespace hopper;

constexpr int SMEM_MAX = 227 * 1024;
constexpr int KB = 64;           // d per ring stage: one 128-byte swizzled row
constexpr int ROW = 128;         // bytes of a 64-element swizzled row
constexpr int STAGES_MAX = 5;
constexpr int EMAX = 1024;       // experts the live table holds

// After the ring: the full and empty barriers, then the live table.
struct Table {
  int live;            // live m tiles over every expert
  int split;           // this call's split of d (live_split)
  int kps;             // k-steps a split
  int pad;
  int pre[EMAX + 1];   // live m tiles of the experts before e
};
// the bytes a plan keeps past its ring: the 1024-byte alignment, the
// barriers and the table (kernels/kraken_moe_gemm.py's RESERVED)
constexpr int RESERVED = 6144;
static_assert(1024 + 16 * STAGES_MAX + static_cast<int>(sizeof(Table)) <= RESERVED,
              "RESERVED holds the barriers and the table");

// The splits a call takes when `tiles` (live m tiles x n tiles) are live:
// none once they fill the grid, else up to the plan's most, each a
// non-empty run of k-steps.  kernels/kraken_moe_gemm.py::live_split is the
// same function.
__device__ __forceinline__ int live_split(const Plan& p, int tiles) {
  if (p.split <= 1 || tiles <= 0 || tiles >= p.blocks) return 1;
  const int s = min(p.split, (p.blocks + tiles - 1) / tiles);
  const int kps = (p.nk + s - 1) / s;
  return (p.nk + kps - 1) / kps;
}

// Warp 0 scans the experts' live m-tile counts, 32 at a time.
__device__ void build_table(Table* tb, const int32_t* __restrict__ sizes, const Plan& p) {
  const int lane = threadIdx.x;
  int run = 0;
  for (int base = 0; base < p.E; base += 32) {
    const int e = base + lane;
    const int cnt = e < p.E ? (live_rows(sizes, e, p.C) + p.BM - 1) / p.BM : 0;
    int x = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (e < p.E) tb->pre[e] = run + x - cnt;
    run += __shfl_sync(0xffffffffu, x, 31);
  }
  if (lane == 0) {
    tb->pre[p.E] = run;
    tb->live = run;
    tb->split = live_split(p, run * p.ntiles);
    tb->kps = (p.nk + tb->split - 1) / tb->split;
  }
}

struct Work {
  int e, m0, n0, z, k0, ksteps;
};

// Item t: live m tile fastest, then n tile, then split z.  The expert is the
// last one whose table entry is at or below the live tile's index (a binary
// search; an empty expert shares its successor's entry and is never chosen).
__device__ __forceinline__ Work work_at(const Plan& p, const Table* tb, int t) {
  const int lt = t % tb->live, rest = t / tb->live;
  int lo = 0, hi = p.E - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tb->pre[mid] <= lt) lo = mid;
    else hi = mid - 1;
  }
  Work w;
  w.e = lo;
  w.m0 = (lt - tb->pre[lo]) * p.BM;
  w.n0 = (rest % p.ntiles) * p.BN;
  w.z = rest / p.ntiles;
  w.k0 = w.z * tb->kps;
  w.ksteps = min(tb->kps, p.nk - w.k0);
  return w;
}

// The dead tiles (an m tile at or past its expert's size) of this block's
// share, zero-filled with 16-byte stores by the consumer threads (f is a
// multiple of 8 on this route, so every row starts 16-byte aligned).
__device__ void zero_dead_tiles(const Plan& p, const int32_t* __restrict__ sizes,
                                __nv_bfloat16* __restrict__ out, int tid, int nthreads) {
  for (int q = blockIdx.x; q < p.E * p.mtiles; q += gridDim.x) {
    const int e = q / p.mtiles, m0 = (q % p.mtiles) * p.BM;
    if (m0 < live_rows(sizes, e, p.C)) continue;
    const int n = min(p.BM, p.C - m0) * (p.f / 8);
    uint4* dst = reinterpret_cast<uint4*>(out + (static_cast<size_t>(e) * p.C + m0) * p.f);
    for (int i = tid; i < n; i += nthreads) dst[i] = make_uint4(0u, 0u, 0u, 0u);
  }
}

template <int BM, int BN>
__global__ void __launch_bounds__(128 * (BM / 64 + 1), 1)
grouped_moe_gemm_wgmma(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap wmap,
                       const int32_t* __restrict__ sizes, __nv_bfloat16* __restrict__ out,
                       float* __restrict__ part, const Plan p) {
  constexpr int NC = BM / 64;                   // consumer warpgroups
  constexpr int A_BYTES = BM * ROW, B_BYTES = BN * ROW, STAGE = A_BYTES + B_BYTES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.stages * STAGE);
  uint64_t* empty = full + STAGES_MAX;
  Table* tb = reinterpret_cast<Table*>(empty + STAGES_MAX);

  if (threadIdx.x < 32) build_table(tb, sizes, p);
  if (threadIdx.x == 32) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(&full[i], 1);            // the producer's expect_tx arrival
      mbar_init(&empty[i], NC * 128);    // every consumer thread
    }
    fence_mbar_init();
  }
  __syncthreads();
  const int items = tb->live * p.ntiles * tb->split;
  const int split = tb->split;
  // the split taken, for grouped_moe_gemm_sum: after the plan's most partials
  if (p.split > 1 && blockIdx.x == 0 && threadIdx.x == 0)
    reinterpret_cast<int*>(part + static_cast<size_t>(p.split) * p.E * p.C * p.f)[0] = split;

  // the warpgroup's role, taken through a shuffle so that the compiler
  // knows it is the same in every lane: wgmma is not serialised
  const int role = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (role == NC) {
    // ---- producer: one thread issues every load ----------------------------
    if constexpr (NC == 2) setmaxnreg_dec<56>();
    if (threadIdx.x != NC * 128) return;
    // the weights are streamed once: their lines go first, so that the
    // tokens' rows (read by every n tile) stay in L2
    const uint64_t weights_policy = l2_evict_first();
    int s = 0;
    uint32_t ph = 0;
    for (int t = blockIdx.x; t < items; t += gridDim.x) {
      const Work w = work_at(p, tb, t);
      for (int i = 0; i < w.ksteps; ++i) {
        mbar_wait(&empty[s], ph ^ 1);
        unsigned char* st = smem + s * STAGE;
        const int k0 = (w.k0 + i) * KB;
        mbar_expect_tx(&full[s], STAGE);
        tma_load_3d(st, &xmap, &full[s], k0, w.m0, w.e);
#pragma unroll
        for (int nb = 0; nb < BN / 64; ++nb)
          tma_load_3d(st + A_BYTES + nb * KB * ROW, &wmap, &full[s], w.n0 + nb * 64, k0, w.e,
                      weights_policy);
        if (++s == p.stages) { s = 0; ph ^= 1; }
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 rows each -----------------------------------
  if constexpr (NC == 2) setmaxnreg_inc<224>();
  const int tid = threadIdx.x;
  if (split == 1) zero_dead_tiles(p, sizes, out, tid, NC * 128);
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const size_t count = static_cast<size_t>(p.E) * p.C * p.f;
  int s = 0;
  uint32_t ph = 0;
  for (int t = blockIdx.x; t < items; t += gridDim.x) {
    const Work w = work_at(p, tb, t);
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int prev = -1;
    for (int i = 0; i < w.ksteps; ++i) {
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
    if (prev >= 0) mbar_arrive(&empty[prev]);

    // epilogue: thread (warp, lane) holds rows lane/4 and lane/4 + 8 of the
    // warp's 16, columns 8i + 2(lane%4) and + 1 of every 8-column block i
    const int size = live_rows(sizes, w.e, p.C);
    const int row0 = w.m0 + role * 64 + warp * 16 + (lane >> 2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h;
      if (r >= p.C) continue;
      const bool live = r < size;
      if (split > 1 && !live) continue;
      const size_t at = (static_cast<size_t>(w.e) * p.C + r) * p.f;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int c = w.n0 + 8 * i + 2 * (lane & 3);
        if (c >= p.f) continue;   // f is even: c + 1 < f too
        float v0 = acc[4 * i + 2 * h], v1 = acc[4 * i + 2 * h + 1];
        if (split > 1) {
          *reinterpret_cast<float2*>(part + w.z * count + at + c) = make_float2(v0, v1);
          continue;
        }
        if (!live) v0 = v1 = 0.f;
        *reinterpret_cast<__nv_bfloat162*>(out + at + c) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// Every output element, when the call split: the live rows' partials summed
// in the order z = 0, 1, ..., split - 1 and rounded once, zeros for the dead
// rows.  It reads the split the product kernel took, and returns at once
// when that is 1 (the product kernel then wrote the output).
__global__ void __launch_bounds__(256)
grouped_moe_gemm_sum(const float* __restrict__ part, const int32_t* __restrict__ sizes,
                     __nv_bfloat16* __restrict__ out, const Plan p) {
  const size_t count = static_cast<size_t>(p.E) * p.C * p.f;
  const int split = reinterpret_cast<const int*>(part + p.split * count)[0];
  if (split == 1) return;
  for (size_t i = 2 * (blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x); i < count;
       i += 2 * static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t row = i / p.f;   // e * C + r; f is even, so a pair shares its row
    const int e = static_cast<int>(row / p.C), r = static_cast<int>(row % p.C);
    float2 v = make_float2(0.f, 0.f);
    if (r < live_rows(sizes, e, p.C)) {
      v = *reinterpret_cast<const float2*>(part + i);
      for (int z = 1; z < split; ++z) {
        const float2 u = *reinterpret_cast<const float2*>(part + z * count + i);
        v.x += u.x;
        v.y += u.y;
      }
    }
    *reinterpret_cast<__nv_bfloat162*>(out + i) = __floats2bfloat162_rn(v.x, v.y);
  }
}

bool plan_ok(const Plan& p, const void* xs, const void* w) {
  if (p.dtype != DT_BF16 || p.E > EMAX || p.d % 8 != 0 || p.f % 8 != 0) return false;
  // TMA takes a base and strides that are multiples of 16 bytes
  if (reinterpret_cast<uintptr_t>(xs) % 16 != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return false;
  if (p.BM != 64 && p.BM != 128) return false;
  if (p.BN != (p.BM == 64 ? 256 : 128)) return false;
  if (p.stages < 2 || p.stages > STAGES_MAX) return false;
  if (p.nk != (p.d + KB - 1) / KB || p.mtiles != (p.C + p.BM - 1) / p.BM ||
      p.ntiles != (p.f + p.BN - 1) / p.BN)
    return false;
  if (p.split < 1 || (p.split > 1 && p.split > p.nk) || p.blocks < 1) return false;
  if (static_cast<long long>(p.E) * p.mtiles * p.ntiles * p.split > 0x7fffffffLL) return false;
  return p.smem <= SMEM_MAX && p.smem >= p.stages * (p.BM + p.BN) * ROW + RESERVED;
}

template <int BM, int BN>
int launch(const void* xs, const void* w, const int32_t* sizes, void* out, void* part,
           const Plan& p, cudaStream_t stream) {
  CUtensorMap xmap, wmap;
  memset(&xmap, 0, sizeof xmap);
  memset(&wmap, 0, sizeof wmap);
  if (p.nk > 0) {   // with d = 0 no item loads anything
    const cuuint64_t xdims[3] = {static_cast<cuuint64_t>(p.d), static_cast<cuuint64_t>(p.C),
                                 static_cast<cuuint64_t>(p.E)};
    const cuuint64_t xstrides[2] = {static_cast<cuuint64_t>(p.d) * 2,
                                    static_cast<cuuint64_t>(p.d) * p.C * 2};
    const cuuint32_t xbox[3] = {KB, static_cast<cuuint32_t>(BM), 1};
    int e = hopper_host::bf16_map(&xmap, xs, 3, xdims, xstrides, xbox);
    if (e) return e;
    const cuuint64_t wdims[3] = {static_cast<cuuint64_t>(p.f), static_cast<cuuint64_t>(p.d),
                                 static_cast<cuuint64_t>(p.E)};
    const cuuint64_t wstrides[2] = {static_cast<cuuint64_t>(p.f) * 2,
                                    static_cast<cuuint64_t>(p.f) * p.d * 2};
    const cuuint32_t wbox[3] = {64, KB, 1};
    e = hopper_host::bf16_map(&wmap, w, 3, wdims, wstrides, wbox);
    if (e) return e;
  }
  auto kernel = grouped_moe_gemm_wgmma<BM, BN>;
  static bool sized[64] = {};   // once per variant and device: the most any plan asks
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !sized[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) sized[dev] = true;
  }
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  kernel<<<p.blocks, 128 * (BM / 64 + 1), p.smem, stream>>>(xmap, wmap, sizes, o,
                                                            static_cast<float*>(part), p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.split == 1) return static_cast<int>(err);
  const size_t pairs = static_cast<size_t>(p.E) * p.C * p.f / 2;
  const int blocks = static_cast<int>(std::min<size_t>((pairs + 255) / 256, 4096));
  grouped_moe_gemm_sum<<<blocks, 256, 0, stream>>>(static_cast<const float*>(part), sizes, o, p);
  return static_cast<int>(cudaGetLastError());
}

// The two tiles: 64 x 256 (one consumer warpgroup) and 128 x 128 (two).
int launch_tile(const void* xs, const void* w, const int32_t* sizes, void* out, void* part,
                const Plan& p, cudaStream_t s) {
  return p.BM == 128 ? launch<128, 128>(xs, w, sizes, out, part, p, s)
                     : launch<64, 256>(xs, w, sizes, out, part, p, s);
}

}  // namespace wg

}  // namespace

// The plan's field names in struct Plan's order, each followed by a comma.
extern "C" const char* grouped_moe_gemm_plan_fields() {
  return GROUPED_MOE_GEMM_PLAN(PLAN_NAME);
}

// xs [E, C, d], w [E, d, f] (row-major, one dtype), sizes [E] int32 on the
// device; out [E, C, f]: float32 for dtype 0, bfloat16 for 1, int32 for int8
// (2).  `plan` holds `nplan` ints in the order of kernels/kraken_moe_gemm.py's
// PLAN_FIELDS: path 0 is the tile loop (any dtype), path 1 the bf16 wgmma
// kernel; when its plan may split d, part is an fp32 buffer of
// split * E * C * f + 4 (the partials, then the split taken).  Launches on `stream` and returns cudaGetLastError() (0
// on success); a plan it does not take returns cudaErrorInvalidValue without
// launching, a failed tensor-map encoding its CUresult.
extern "C" int grouped_moe_gemm(const void* xs, const void* w, const void* sizes, void* out,
                                void* part, const int* plan, int nplan, void* stream) {
  if (nplan != PLAN_INTS) return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  memcpy(&p, plan, sizeof p);
  if (p.E <= 0 || p.C <= 0 || p.d < 0 || p.f <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* sz = static_cast<const int32_t*>(sizes);
  if (p.path == PATH_TILE) return tile::launch_dtype(xs, w, sz, out, p, s);
  if (p.path == PATH_WGMMA && wg::plan_ok(p, xs, w) && (p.split == 1 || part != nullptr))
    return wg::launch_tile(xs, w, sz, out, part, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
