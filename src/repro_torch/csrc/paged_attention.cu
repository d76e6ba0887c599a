// paged_decode_attention for Hopper (sm_90a): one-token GQA attention read
// straight off the page pools, split over each slot's live pages.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/paged_attention.py::paged_decode_attention (body
// _kernel).  On the TPU the page table rides as a scalar-prefetch operand and
// the grid (slot, kv_head, page_block) runs in order on one core, carrying the
// online-softmax state in VMEM scratch from one grid step to the next.  Blocks
// on a GPU run in no order and share nothing, so each slot's pages are split
// instead (flash-decoding): block (slot b, kv head h, split z) holds the
// G = H / KV query rows of that head and walks the z-th equal share of the
// slot's live logical pages, keeping (m, l, acc) in fp32; a second kernel
// combines the splits.
//
// Semantics kept from the TPU kernel:
//   * a table entry < 0 or >= n_pages is dead (the unallocated sentinel), and
//     so is logical page j when j * ps > q_pos (the ring has not reached it);
//     dead pages are never read;
//   * entry e of a page is live when 0 <= pos <= q_pos (and pos > q_pos -
//     window when a window is set); a page with no live entry is skipped
//     before its K/V are requested, and the K/V of a dead entry inside a live
//     page never reach a sum (its score is replaced by -1e30 and its P V
//     term selected out, not multiplied by zero), so garbage or Inf there
//     cannot reach a live row;
//   * masked scores are -1e30 and m starts at -1e30, so a slot with no live
//     entry ends with l == 0 and writes exact zeros; a split whose share holds
//     no live entry writes m = -1e30, l = 0, acc = 0;
//   * int8 pools are dequantized in registers with their [n_pages, KV, ps]
//     scales: K's scale multiplies the score, V's the entry's weight.
//
// What bounds it on an H100: it reads every live K/V byte once and does ~2
// FLOP per byte per query row -- at yi-6b's decode step (4 slots, 4 KV heads,
// 128-wide heads, pages of 16, 52 live pages) some 1.7 MB, which the card
// reads in ~0.53 us.  So the call is latency-bound: what decides its time is
// how many SMs share the walk and how long one block's chain of loads and
// steps takes.  G <= 8 query rows against wgmma's 64-row tile would be
// mostly padding, so the products run as FMA on the CUDA cores; the tensor
// cores are not the limit.  The design:
//   * the plan (kernels/paged_attention.py::plan) chooses `splits` from the
//     shapes alone, so that B * KV * splits reaches about one block per SM
//     (none once B * KV fills the card, never more than MP).  Each block
//     reads its slot's q_pos itself, counts the live logical pages
//     n_live = min(MP, q_pos / ps + 1) and takes [z n_live / splits,
//     (z + 1) n_live / splits): the work follows the slot's length, and
//     nothing is read on the host, so a CUDA graph of the call replays right
//     after the table and q_pos change in place;
//   * the whole block first reads the share's table entries and position
//     rows at once (one round of independent loads) into a bit mask of live
//     entries a page, and lists the pages with a live entry in order;
//   * one producer warp streams the listed pages through a ring of `ring`
//     (page, head) slots, K, V and (int8) their scales, each slot with a full
//     and an empty mbarrier: on the `tma` route one thread issues TMA loads of
//     the (1, ps, D) box of a 3-D map over [n_pages * KV, ps, D] (no swizzle);
//     where TMA refuses the shapes (a row of D * itemsize bytes, or int8's
//     scale row of ps * 4 bytes, not a multiple of 16, or an operand not 16-byte
//     aligned) the plan takes the `ldg` route, on which the producer warp copies
//     the page with plain loads and the consumers read it one element at a
//     time.  Neither route is taken because the other failed;
//   * each consumer warp owns whole query rows, staged in shared memory in
//     q's own dtype (bf16 halves what the scores read); a step takes `pps`
//     pages (two at ps = 16), and lane e scores entry e of the step (entries
//     e, e + 32, ... when ps > 32) reading 16-byte columns of its K row in a
//     lane-rotated order, so that the lanes of a quarter warp hit distinct
//     banks; the row's max is a warp shuffle, each lane keeps its own share
//     of the row's sum (summed once, at the end), and the update needs no
//     barrier.  For P V the warp splits into groups that each add one
//     16-byte column of V per lane over every H-th entry, and the groups'
//     sums meet in shuffles;
//   * the combine (paged_decode_attention_combine, whose body flash_decode.cuh
//     shares with decode_attention.cu) reads the splits in the order z = 0,
//     1, ...  and rounds once.  No atomics and no block waits on another: the
//     same bits on every run.  With one split the split kernel writes the
//     output itself.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "flash_decode.cuh"
#include "hopper.cuh"

namespace {

using namespace flash_decode;
using namespace hopper;

constexpr int NWARPS = 8;                      // consumer warps
constexpr int NTHREADS = 32 * (NWARPS + 1);    // and the producer warp
constexpr int MAX_PS = 256;                    // a TMA box side; lanes' entries <= 8
constexpr int MAX_D = 256;                     // columns a lane owns <= 8
constexpr int MAX_U = MAX_PS / 32;             // and the mask words of a page
constexpr int MAX_KD = MAX_D / 32;
constexpr int SMEM_MAX = 227 * 1024;
constexpr int COMBINE_THREADS = 128;

// Every field an int.  The one list of them: struct Plan and the names
// paged_attention_plan_fields() gives, which kernels/paged_attention.py
// checks against its PLAN_FIELDS when it loads this library.
#define PAGED_ATTENTION_PLAN(X)                                                               \
  X(B) X(H) X(KV) X(D) X(G) X(ps) X(MP) X(isz) X(quant) X(splits) X(share) X(pps) X(ring) \
  X(tma) X(blocks) X(smem)

#define PLAN_DECL(f) int f;
#define PLAN_NAME(f) #f ","
#define PLAN_ONE(f) +1
struct Plan {
  PAGED_ATTENTION_PLAN(PLAN_DECL)
};
constexpr int PLAN_INTS = 0 PAGED_ATTENTION_PLAN(PLAN_ONE);
static_assert(sizeof(Plan) == PLAN_INTS * sizeof(int), "Plan is ints only");

__host__ __device__ inline int align_up(int x, int a) { return (x + a - 1) / a * a; }

// Shared-memory geometry, in bytes from a 1024-aligned base.
struct Geometry {
  int page, scales, slot, q, acc, m, l, pw, pid, mask, bar, count, bytes;
  __host__ __device__ explicit Geometry(const Plan& p) {
    const int nw = (p.ps + 31) / 32;
    page = align_up(p.ps * p.D * p.isz, 128);   // one (page, head) of K or of V
    scales = p.quant ? align_up(p.ps * 4, 128) : 0;
    slot = 2 * page + 2 * scales;               // K, V, K's scales, V's scales
    q = p.ring * slot;                          // [G, D] query rows in q's dtype (<= 4 bytes)
    acc = q + 4 * p.G * p.D;                    // [G, D] fp32 unnormalised output
    m = acc + 4 * p.G * p.D;                    // [G]
    l = m + 4 * p.G;                            // [G, 32] each lane's share of the row sums
    pw = l + 4 * 32 * p.G;                      // [NWARPS, pps * ps] a step's weights
    pid = pw + 4 * NWARPS * p.pps * p.ps;       // [share] physical pages, then the live ones
    mask = pid + 4 * p.share;                   // [share, nw] live entries, then the live pages'
    bar = align_up(mask + 4 * p.share * nw, 8); // [ring] full, then [ring] empty mbarriers
    count = bar + 16 * p.ring;                  // pages with a live entry
    bytes = count + 16;
  }
};

// E elements of a query row as floats, from 16-byte vectors (the row is
// staged in q's own dtype: bf16 halves what the scores read)
template <int E>
__device__ __forceinline__ void load_q(const float* p, float (&f)[E]) {
#pragma unroll
  for (int k = 0; k < E; k += 4) {
    const float4 x = *reinterpret_cast<const float4*>(p + k);
    f[k] = x.x;
    f[k + 1] = x.y;
    f[k + 2] = x.z;
    f[k + 3] = x.w;
  }
}
template <int E>
__device__ __forceinline__ void load_q(const __nv_bfloat16* p, float (&f)[E]) {
  static_assert(E % 8 == 0, "bf16 q rows are read 8 elements at a time");
#pragma unroll
  for (int k = 0; k < E; k += 8) {
    float g[8];
    unpack(*reinterpret_cast<const uint4*>(p + k), g);
#pragma unroll
    for (int u = 0; u < 8; ++u) f[k + u] = g[u];
  }
}

// q . k for one K row in the ring: 16-byte columns (VEC, the tma route)
// starting at column lane % n and wrapping, so that neighbouring lanes read
// distinct banks; or one element at a time from element lane % D.
template <typename TQ, typename TKV, bool VEC>
__device__ __forceinline__ float dot(const TQ* __restrict__ qr, const TKV* __restrict__ kr,
                                     int D, int lane) {
  if constexpr (VEC) {
    constexpr int E = 16 / sizeof(TKV);   // elements a column
    const int n = D / E;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    auto add = [&](int c) {
      float f[E], a[E];
      unpack(*reinterpret_cast<const uint4*>(kr + c * E), f);
      load_q(qr + c * E, a);
#pragma unroll
      for (int u = 0; u < E; u += 4) {
        s.x = fmaf(a[u], f[u], s.x);
        s.y = fmaf(a[u + 1], f[u + 1], s.y);
        s.z = fmaf(a[u + 2], f[u + 2], s.z);
        s.w = fmaf(a[u + 3], f[u + 3], s.w);
      }
    };
    if ((n & (n - 1)) == 0) {   // D 128 in bf16: 16 columns
#pragma unroll 8
      for (int i = 0; i < n; ++i) add((lane + i) & (n - 1));
    } else {
      int c = lane % n;
#pragma unroll 4
      for (int i = 0; i < n; ++i) {
        add(c);
        if (++c == n) c = 0;
      }
    }
    return (s.x + s.y) + (s.z + s.w);
  } else {
    int d = lane % D;
    float s = 0.f;
    for (int i = 0; i < D; ++i) {
      s = fmaf(to_float(qr[d]), to_float(kr[d]), s);
      if (++d == D) d = 0;
    }
    return s;
  }
}

// Block (b, kv head h, split z): the G query rows of head h over the live
// pages of [z n_live / splits, (z + 1) n_live / splits).  With one split it
// writes out [B, H, D]; otherwise part [B, H, splits, D + 2] holds (m, l,
// acc[D]) of each row.  TMA: the ring is fed by TMA (else by the producer
// warp's loads, K and V then read one element at a time).  Two blocks fit
// an SM, for grids past one block an SM (no split).
template <typename TQ, typename TKV, bool TMA>
__global__ void __launch_bounds__(NTHREADS, 2)
paged_decode_attention_split(const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             const __grid_constant__ CUtensorMap ksmap,
                             const __grid_constant__ CUtensorMap vsmap,
                             const TQ* __restrict__ q, const TKV* __restrict__ k,
                             const TKV* __restrict__ v, const float* __restrict__ k_scale,
                             const float* __restrict__ v_scale, const int* __restrict__ pos,
                             const int* __restrict__ table, const int* __restrict__ q_pos,
                             TQ* __restrict__ out, float* __restrict__ part, const Plan p,
                             int n_pages, int q_stride, int window, float scale) {
  const int z = blockIdx.x % p.splits;
  const int h = (blockIdx.x / p.splits) % p.KV;
  const int b = blockIdx.x / (p.splits * p.KV);
  const int G = p.G, D = p.D, ps = p.ps, nw = (ps + 31) / 32;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bool quant = k_scale != nullptr;
  const Geometry g(p);

  extern __shared__ __align__(1024) uint8_t smem[];
  TQ* qs = reinterpret_cast<TQ*>(smem + g.q);   // q's own dtype
  float* acc = reinterpret_cast<float*>(smem + g.acc);
  float* ms = reinterpret_cast<float*>(smem + g.m);
  float* ls = reinterpret_cast<float*>(smem + g.l);
  float* pbuf = reinterpret_cast<float*>(smem + g.pw);
  int* pids = reinterpret_cast<int*>(smem + g.pid);
  uint32_t* masks = reinterpret_cast<uint32_t*>(smem + g.mask);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + g.bar);
  uint64_t* empty = full + p.ring;
  int* count = reinterpret_cast<int*>(smem + g.count);

  // the slot's live logical pages [0, n_live) and this split's share of them
  const int qp = q_pos[(size_t)b * q_stride];
  const int n_live = qp < 0 ? 0 : min(p.MP, qp / ps + 1);
  const int lo = static_cast<int>(static_cast<long long>(z) * n_live / p.splits);
  const int npg = static_cast<int>(static_cast<long long>(z + 1) * n_live / p.splits) - lo;
  const int row_warps = min(G, NWARPS);   // consumer warps that own a row

  const size_t q_off = ((size_t)b * p.H + (size_t)h * G) * D;
  for (int i = tid; i < G * D; i += NTHREADS) {
    qs[i] = q[q_off + i];
    acc[i] = 0.f;
  }
  for (int r = tid; r < G; r += NTHREADS) ms[r] = NEG;
  for (int i = tid; i < 32 * G; i += NTHREADS) ls[i] = 0.f;
  for (int i = tid; i < npg * nw; i += NTHREADS) masks[i] = 0u;
  if (tid == 0) {
    for (int s = 0; s < p.ring; ++s) {
      mbar_init(&full[s], TMA ? 1 : 32);
      mbar_init(&empty[s], row_warps);
    }
    fence_mbar_init();
  }
  __syncthreads();

  // the liveness pass: every (page, entry) of the share at once.  Where ps
  // divides 32 a page's entries are neighbouring lanes of one warp, and its
  // mask is a slice of their ballot.
  const bool whole = 32 % ps == 0;
  for (int i0 = tid - lane; i0 < npg * ps; i0 += NTHREADS) {   // warp-uniform
    const int i = i0 + lane, j = i / ps, e = i - j * ps;
    bool live = false;
    if (i < npg * ps) {
      const int pid = table[(size_t)b * p.MP + lo + j];
      const bool real = pid >= 0 && pid < n_pages;
      if (e == 0) pids[j] = real ? pid : -1;
      if (real) {
        const int kp = pos[(size_t)pid * ps + e];
        live = kp >= 0 && kp <= qp && (window == 0 || kp > qp - window);
      }
    }
    if (whole) {
      const uint32_t bal = __ballot_sync(0xffffffffu, live);
      if (i < npg * ps && e == 0) masks[j] = ps == 32 ? bal : (bal >> lane) & ((1u << ps) - 1u);
    } else if (live) {
      atomicOr(&masks[j * nw + e / 32], 1u << (e % 32));
    }
  }
  __syncthreads();
  // warp 0 lists the pages with a live entry, in order, in place
  if (warp == 0) {
    int n = 0;
    for (int j0 = 0; j0 < npg; j0 += 32) {
      const int j = j0 + lane;
      uint32_t mw[MAX_U];
      bool live = false;
      int pid = -1;
#pragma unroll
      for (int w = 0; w < MAX_U; ++w) {
        mw[w] = j < npg && w < nw ? masks[j * nw + w] : 0u;
        live |= mw[w] != 0u;
      }
      if (j < npg) pid = pids[j];
      const uint32_t bal = __ballot_sync(0xffffffffu, live);
      __syncwarp();
      if (live) {
        const int at = n + __popc(bal & ((1u << lane) - 1u));
        pids[at] = pid;
#pragma unroll
        for (int w = 0; w < MAX_U; ++w)
          if (w < nw) masks[at * nw + w] = mw[w];
      }
      __syncwarp();
      n += __popc(bal);
    }
    if (lane == 0) *count = n;
  }
  __syncthreads();
  const int L = *count;
  const int W = D + 2;

  if (L == 0) {   // no live entry in the share (block-uniform)
    if (p.splits == 1) {
      for (int i = tid; i < G * D; i += NTHREADS) out[q_off + i] = from_float<TQ>(0.f);
    } else {
      for (int i = tid; i < G * W; i += NTHREADS) {
        const int r = i / W, c = i - r * W;
        part[(((size_t)b * p.H + (size_t)h * G + r) * p.splits + z) * W + c] =
            c == 0 ? NEG : 0.f;
      }
    }
    return;
  }

  if (warp == NWARPS) {   // the producer: page i into ring slot i % ring
    const uint32_t bytes = 2u * ps * D * sizeof(TKV) + (quant ? 2u * ps * 4u : 0u);
    for (int i = 0; i < L; ++i) {
      const int s = i % p.ring;
      uint8_t* st = smem + s * g.slot;
      const int row = pids[i] * p.KV + h;   // (page, head) of [n_pages * KV, ps, D]
      if (i >= p.ring) mbar_wait(&empty[s], ((i / p.ring) - 1) & 1);
      if constexpr (TMA) {
        if (lane == 0) {
          mbar_expect_tx(&full[s], bytes);
          tma_load_3d(st, &kmap, &full[s], 0, 0, row);
          tma_load_3d(st + g.page, &vmap, &full[s], 0, 0, row);
          if (quant) {
            tma_load_2d(st + 2 * g.page, &ksmap, &full[s], 0, row);
            tma_load_2d(st + 2 * g.page + g.scales, &vsmap, &full[s], 0, row);
          }
        }
      } else {
        TKV* kd = reinterpret_cast<TKV*>(st);
        TKV* vd = reinterpret_cast<TKV*>(st + g.page);
        const size_t base = (size_t)row * ps * D;
        for (int x = lane; x < ps * D; x += 32) {
          kd[x] = k[base + x];
          vd[x] = v[base + x];
        }
        if (quant) {
          float* kz = reinterpret_cast<float*>(st + 2 * g.page);
          float* vz = reinterpret_cast<float*>(st + 2 * g.page + g.scales);
          for (int e = lane; e < ps; e += 32) {
            kz[e] = k_scale[(size_t)row * ps + e];
            vz[e] = v_scale[(size_t)row * ps + e];
          }
        }
        mbar_arrive(&full[s]);   // each lane: its own copies are in
      }
    }
    return;
  }
  if (warp >= row_warps) return;

  // the consumers: warp w owns rows w, w + NWARPS, ...; a step takes the
  // next pps listed pages, entry j of the step being entry j % ps of page
  // j / ps.  Lane c scores the step's entries c, c + 32, ...  For P V, where
  // a row is n16 16-byte columns and n16 divides 32 (`cols`, tma), the warp is
  // H = 32 / n16 groups of n16 lanes: lane (h, c) adds column c of entries
  // h, h + H, ... of each page, and the groups' sums meet in shuffles;
  // otherwise lane c adds columns c, c + 32, ... of every entry.
  constexpr int E = 16 / sizeof(TKV);   // elements of a 16-byte column
  const int n16 = TMA ? D / E : 1;
  const bool cols = TMA && n16 <= 32 && 32 % n16 == 0;
  const int H = cols ? 32 / n16 : 1, hh = cols ? lane / n16 : 0, cc = cols ? lane % n16 : 0;
  const int U = (p.pps * ps + 31) / 32;
  float* pw = pbuf + warp * p.pps * ps;   // the step's weights of the warp's row
  int s0 = 0;                             // ring slot of the step's first page
  for (int i0 = 0; i0 < L; i0 += p.pps) {
    const int np = min(p.pps, L - i0), T = np * ps;
    auto slot_of = [&](int pg) {   // ring slot of the step's page pg
      const int x = s0 + pg;
      return x >= p.ring ? x - p.ring : x;
    };
    for (int t = 0; t < np; ++t) mbar_wait(&full[slot_of(t)], ((i0 + t) / p.ring) & 1);
    // bit u of lv: the lane's entry u * 32 + lane of the step (entry
    // entry_of(u) of its page page_of(u)) is live
    auto page_of = [&](int u) { return (u * 32 + lane) / ps; };
    auto entry_of = [&](int u) { return u * 32 + lane - page_of(u) * ps; };
    uint32_t lv = 0;
#pragma unroll
    for (int u = 0; u < MAX_U; ++u) {
      if (u >= U || u * 32 + lane >= T) continue;
      const int pg = page_of(u), e = entry_of(u);
      lv |= ((masks[(i0 + pg) * nw + (e >> 5)] >> (e & 31)) & 1u) << u;
    }

    for (int r = warp; r < G; r += NWARPS) {
      const TQ* qr = qs + r * D;
      float sc[MAX_U];
      float mx = NEG;
#pragma unroll
      for (int u = 0; u < MAX_U; ++u) {
        sc[u] = NEG;
        if ((lv >> u) & 1u) {
          const uint8_t* st = smem + slot_of(page_of(u)) * g.slot;
          const int e = entry_of(u);
          float s =
              dot<TQ, TKV, TMA>(qr, reinterpret_cast<const TKV*>(st) + (size_t)e * D, D, lane) *
              scale;
          if (quant) s *= reinterpret_cast<const float*>(st + 2 * g.page)[e];
          sc[u] = s;
          mx = fmaxf(mx, s);
        }
      }
      const float m_old = ms[r];
      const float m_new = fmaxf(m_old, warp_max(mx));
      const float a = expf(m_old - m_new);
      float sum = ls[r * 32 + lane] * a;   // the lane's share of l, summed at the end
#pragma unroll
      for (int u = 0; u < MAX_U; ++u) {
        if (u * 32 + lane >= T) continue;
        const bool live = (lv >> u) & 1u;
        const float pe = live ? expf(sc[u] - m_new) : 0.f;
        sum += pe;
        // the entry's weight in P V: int8's V scale folded in
        pw[u * 32 + lane] =
            quant && live
                ? pe * reinterpret_cast<const float*>(smem + slot_of(page_of(u)) * g.slot +
                                                      2 * g.page + g.scales)[entry_of(u)]
                : pe;
      }
      ls[r * 32 + lane] = sum;
      __syncwarp();   // the weights' stores before any lane reads them

      // acc = acc * a + P V over the live entries only
      if (cols) {
        float* ar = acc + r * D + cc * E;
        float x[E];
#pragma unroll
        for (int k = 0; k < E; ++k) x[k] = hh == 0 ? ar[k] * a : 0.f;
        for (int pg = 0; pg < np; ++pg) {
          const uint8_t* vb = smem + slot_of(pg) * g.slot + g.page + cc * 16;
          const uint32_t* mk = masks + (i0 + pg) * nw;
          const float* pp = pw + pg * ps;
          // the whole page was loaded: a dead entry's V (garbage or Inf) is
          // read but selected out, never added
#pragma unroll 4
          for (int e = hh; e < ps; e += H) {
            const bool live = (mk[e >> 5] >> (e & 31)) & 1u;
            float f[E];
            unpack(*reinterpret_cast<const uint4*>(vb + (size_t)e * D * sizeof(TKV)), f);
            const float w = pp[e];
#pragma unroll
            for (int k = 0; k < E; ++k) x[k] = live ? fmaf(w, f[k], x[k]) : x[k];
          }
        }
        for (int o = n16; o < 32; o <<= 1)
#pragma unroll
          for (int k = 0; k < E; ++k) x[k] += __shfl_xor_sync(0xffffffffu, x[k], o);
        if (hh == 0)
#pragma unroll
          for (int k = 0; k < E; ++k) ar[k] = x[k];
      } else {
        float ac[MAX_KD];
#pragma unroll
        for (int kk = 0; kk < MAX_KD; ++kk) {
          const int d = lane + 32 * kk;
          ac[kk] = d < D ? acc[r * D + d] * a : 0.f;
        }
        for (int pg = 0; pg < np; ++pg) {
          const TKV* vb = reinterpret_cast<const TKV*>(smem + slot_of(pg) * g.slot + g.page);
          const uint32_t* mk = masks + (i0 + pg) * nw;
          for (int e = 0; e < ps; ++e) {
            if (!((mk[e >> 5] >> (e & 31)) & 1u)) continue;   // warp-uniform
            const float w = pw[pg * ps + e];
#pragma unroll
            for (int kk = 0; kk < MAX_KD; ++kk) {
              const int d = lane + 32 * kk;
              if (d < D) ac[kk] = fmaf(w, to_float(vb[(size_t)e * D + d]), ac[kk]);
            }
          }
        }
#pragma unroll
        for (int kk = 0; kk < MAX_KD; ++kk) {
          const int d = lane + 32 * kk;
          if (d < D) acc[r * D + d] = ac[kk];
        }
      }
      if (lane == 0) ms[r] = m_new;
      __syncwarp();
    }
    if (lane == 0)
      for (int t = 0; t < np; ++t) mbar_arrive(&empty[slot_of(t)]);
    s0 = slot_of(p.pps);
  }

  for (int r = warp; r < G; r += NWARPS) {
    const float lr = warp_sum(ls[r * 32 + lane]);
    if (p.splits == 1) {
      for (int d = lane; d < D; d += 32)
        out[q_off + (size_t)r * D + d] = from_float<TQ>(acc[r * D + d] / (lr == 0.f ? 1.f : lr));
    } else {
      float* dst = part + (((size_t)b * p.H + (size_t)h * G + r) * p.splits + z) * W;
      if (lane == 0) {
        dst[0] = ms[r];
        dst[1] = lr;
      }
      for (int d = lane; d < D; d += 32) dst[2 + d] = acc[r * D + d];
    }
  }
}

template <typename TQ>
__global__ void __launch_bounds__(COMBINE_THREADS)
paged_decode_attention_combine(const float* __restrict__ part, TQ* __restrict__ out, int splits,
                               int D) {
  extern __shared__ float cw[];   // [splits] m_z, then e^(m_z - M); [splits] l_z
  combine_splits<TQ, COMBINE_THREADS>(part, out, splits, D, cw);
}

bool plan_ok(const Plan& p) {
  if (p.B <= 0 || p.KV <= 0 || p.H % p.KV != 0 || p.G != p.H / p.KV || p.D <= 0 ||
      p.D > MAX_D || p.ps <= 0 || p.ps > MAX_PS || p.MP < 0)
    return false;
  if (!(p.isz == 1 || p.isz == 2 || p.isz == 4) || p.quant != (p.isz == 1)) return false;
  if (p.splits < 1 || p.splits > (p.MP > 1 ? p.MP : 1) ||
      p.share != (p.MP + p.splits - 1) / p.splits)
    return false;
  if (p.pps != (p.ps < 32 ? 32 / p.ps : 1) || p.ring < p.pps) return false;
  if (p.tma != 0 && (p.tma != 1 || (p.D * p.isz) % 16 != 0 || (p.quant && p.ps % 4 != 0)))
    return false;
  if (static_cast<long long>(p.B) * p.KV * p.splits != p.blocks) return false;
  const long long bytes = Geometry(p).bytes;
  return p.smem == bytes && bytes <= SMEM_MAX;
}

// A tensor map of `rank` dims (innermost first; strides in bytes of dims
// 1..rank-1) read in boxes of `box`, no swizzle: hopper.cuh's encoder entry
// point with the pools' element types.  Returns 0 or a CUresult.
int plain_map(CUtensorMap* map, CUtensorMapDataType type, const void* base, int rank,
              const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box) {
  hopper_host::EncodeTiled fn = hopper_host::encode_tiled();
  if (fn == nullptr) return static_cast<int>(CUDA_ERROR_NOT_FOUND);
  const cuuint32_t ones[3] = {1, 1, 1};
  return static_cast<int>(fn(map, type, rank, const_cast<void*>(base), dims, strides, box, ones,
                             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

template <typename TKV>
CUtensorMapDataType map_type();
template <>
CUtensorMapDataType map_type<float>() { return CU_TENSOR_MAP_DATA_TYPE_FLOAT32; }
template <>
CUtensorMapDataType map_type<__nv_bfloat16>() { return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16; }
template <>
CUtensorMapDataType map_type<int8_t>() { return CU_TENSOR_MAP_DATA_TYPE_UINT8; }

template <typename TQ, typename TKV, bool TMA>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, const void* pos, const void* table, const void* q_pos,
           void* out, void* part, const Plan& p, int n_pages, int q_stride, int window,
           float scale, cudaStream_t stream) {
  auto kernel = paged_decode_attention_split<TQ, TKV, TMA>;
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
  CUtensorMap maps[4];
  memset(maps, 0, sizeof maps);
  if constexpr (TMA) {
    const cuuint64_t rows = static_cast<cuuint64_t>(n_pages) * p.KV;
    const cuuint64_t kvdims[3] = {static_cast<cuuint64_t>(p.D), static_cast<cuuint64_t>(p.ps),
                                  rows};
    const cuuint64_t kvstrides[2] = {static_cast<cuuint64_t>(p.D) * sizeof(TKV),
                                     static_cast<cuuint64_t>(p.ps) * p.D * sizeof(TKV)};
    const cuuint32_t kvbox[3] = {static_cast<cuuint32_t>(p.D), static_cast<cuuint32_t>(p.ps), 1};
    int e = plain_map(&maps[0], map_type<TKV>(), k, 3, kvdims, kvstrides, kvbox);
    if (!e) e = plain_map(&maps[1], map_type<TKV>(), v, 3, kvdims, kvstrides, kvbox);
    if (!e && p.quant) {
      const cuuint64_t sdims[2] = {static_cast<cuuint64_t>(p.ps), rows};
      const cuuint64_t sstrides[1] = {static_cast<cuuint64_t>(p.ps) * 4};
      const cuuint32_t sbox[2] = {static_cast<cuuint32_t>(p.ps), 1};
      e = plain_map(&maps[2], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, k_scale, 2, sdims, sstrides, sbox);
      if (!e)
        e = plain_map(&maps[3], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, v_scale, 2, sdims, sstrides,
                      sbox);
    }
    if (e) return e;
  }
  kernel<<<p.blocks, NTHREADS, p.smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(pos),
      static_cast<const int*>(table), static_cast<const int*>(q_pos), static_cast<TQ*>(out),
      static_cast<float*>(part), p, n_pages, q_stride, window, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return static_cast<int>(err);
  paged_decode_attention_combine<TQ>
      <<<p.B * p.H, COMBINE_THREADS, 2 * p.splits * sizeof(float), stream>>>(
          static_cast<const float*>(part), static_cast<TQ*>(out), p.splits, p.D);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* x) { return reinterpret_cast<uintptr_t>(x) % 16 == 0; }

}  // namespace

// The plan's field names in struct Plan's order, each followed by a comma.
extern "C" const char* paged_attention_plan_fields() {
  return PAGED_ATTENTION_PLAN(PLAN_NAME);
}

// q [B, H, D] and out [B, H, D] share q_dtype; k/v pages [n_pages, KV, ps, D]
// have kv_dtype (equal to q_dtype, or int8 with fp32 scales
// [n_pages, KV, ps]); pos [n_pages, ps], table [B, MP] int32, q_pos int32
// with slot b's at q_pos[b * q_stride].  `plan` holds `nplan` ints in the
// order of kernels/paged_attention.py's PLAN_FIELDS; when it splits, part is
// an fp32 buffer of B * H * splits * (D + 2).  Dtype codes: 0 float32,
// 1 bfloat16, 2 int8.  Launches on `stream` (two kernels when split) and
// returns cudaGetLastError() or a CUresult of the tensor maps (0 on
// success); a plan it does not take returns cudaErrorInvalidValue without
// launching.
extern "C" int paged_decode_attention(const void* q, const void* k, const void* v,
                                      const void* k_scale, const void* v_scale,
                                      const void* pos, const void* table, const void* q_pos,
                                      void* out, void* part, const int* plan, int nplan,
                                      int n_pages, int q_stride, int window, float scale,
                                      int q_dtype, int kv_dtype, void* stream) {
  if (nplan != PLAN_INTS || n_pages < 0 || q_stride < 0 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (plan[PLAN_INTS - 3] != 0 && n_pages == 0)   // tma: a map needs a page
    return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  memcpy(&p, plan, sizeof p);
  if (!plan_ok(p) || (p.splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool quant = kv_dtype == 2;
  if (quant != (k_scale != nullptr) || quant != (v_scale != nullptr) || quant != (p.quant == 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.isz != (kv_dtype == 0 ? 4 : kv_dtype == 1 ? 2 : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.tma && !(aligned16(k) && aligned16(v) && (!quant || (aligned16(k_scale) &&
                                                             aligned16(v_scale)))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ARGS q, k, v, k_scale, v_scale, pos, table, q_pos, out, part, p, n_pages, q_stride, \
             window, scale, s
#define LAUNCH(TQ, TKV) \
  return p.tma ? launch<TQ, TKV, true>(ARGS) : launch<TQ, TKV, false>(ARGS)
  if (q_dtype == 0 && kv_dtype == 0) LAUNCH(float, float);
  if (q_dtype == 1 && kv_dtype == 1) LAUNCH(__nv_bfloat16, __nv_bfloat16);
  if (q_dtype == 0 && kv_dtype == 2) LAUNCH(float, int8_t);
  if (q_dtype == 1 && kv_dtype == 2) LAUNCH(__nv_bfloat16, int8_t);
#undef LAUNCH
#undef ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
