// kraken_conv2d_direct for Hopper (sm_90a): NHWC x HWIO -> NHWC convolution
// by Kraken's output-stationary dataflow, fp32 accumulation.
//
// Replaces the Pallas TPU kernel src/repro/kernels/kraken_conv.py::
// kraken_conv2d_direct (body _conv_kernel, input restructure
// interleave_input).  There the grid (c_o tile, N*L row block, K_H tap) runs
// in order on one core: X is first interleaved into X_hat in HBM, the whole
// weight tile and the full-C band stay resident in VMEM, and an fp32
// [R, OW, bco] accumulator carries across the tap steps.  Here the dataflow
// is kept -- outputs stationary in fp32 registers from the first tap to the
// last, the input band of each channel chunk staged once in shared memory
// and reused by every (kh, kw) tap (Table II's row shift), padding applied
// as zeros while loading, no X_hat and no padded tensor in device memory --
// and laid onto the card as follows.  The plan (tiles, ring, split) comes
// from kernels/kraken_conv.py::plan, which the CPU tests check.
//
// What bounds each layer class on an H100: a layer does 2*K_H*K_W*C_i
// operations per output.  At batch 32 the 3x3 layers with C_i >= 64 are
// bound by the bf16 tensor-core rate, the C_i = 3 first layers and most 1x1
// layers by their bytes; at batch 1, where the weights outweigh the small
// maps, most layers are bound by their bytes (the weights, read once) and
// by how many SMs stream them.  The first port of this kernel lost 6-15x to cuDNN on
// both counts: mma.sync on 16x16 fragments with each chunk's loads and math
// separated by barriers, 16-column tiles, a 128-byte pixel stride in shared
// memory, and grids of 16-64 blocks at batch 1.
//
// bfloat16 (kraken_conv_kernel):
//   * one persistent block per SM walks tiles of 128 output pixels -- TR
//     rows (whole bands of R rows) x TC columns of G images, several small
//     images in one tile -- by BN (64 or 128) output channels, and, when
//     the tiles alone leave SMs idle, by a split of C_i: split z of a tile
//     sums its chunks and writes fp32 partials, which kraken_conv_reduce adds
//     in a fixed order (no atomics: the same call gives the same bits);
//   * warp specialisation: warpgroups 0 and 1 own 64 output pixels each and
//     run wgmma; warpgroup 2 produces.  One thread starts the TMA loads: per
//     64-channel chunk the input band, a 4-D box [1, BR, BW, 64] of the NHWC
//     input at signed coordinates (TMA's zero fill is the padding), and per
//     tap the K-major weight tile [BN, 64].  Two to six band stages (enough
//     for 8 taps) and up to eight weight stages, each with a full and an
//     empty mbarrier, keep loads in flight while the consumers run every tap
//     of a ready chunk.  Where
//     TMA cannot take the rows (C_i % 8 != 0, or a misaligned x), warps 9-11
//     fill the band stages with 2-byte loads into the same layout; no layer
//     of the three networks takes this fill but the packed first layers;
//   * B (the weights) is read by wgmma from shared memory through a
//     descriptor; the HWIO weights are first copied K-major ([tap][C_o][k],
//     kraken_conv_weights, one small launch per call) because bf16 wgmma
//     reads an N-major B only transposed;
//   * A (the band) comes from registers: each lane ldmatrixes the 16-byte
//     row of its own output pixel at tap (kh, kw), band pixel
//     (r*S_H + kh, c*S_W + kw) -- Table II's band row r + kh/S_H, sub-row
//     kh%S_H -- so the Kraken shift survives as a non-dense A tile.  The band
//     is laid out with the 128-byte swizzle (16-byte chunk j of pixel q at
//     chunk j ^ (q % 8)), so the 8 rows of an ldmatrix phase hit distinct
//     banks;
//   * C_i < 16 (the first layers): (kw, c) is packed into k, so a kernel row
//     costs ceil(K_W*C_i/16) k-steps, not K_W; the band holds whole input
//     rows of BW*C_i elements and each lane loads its fragment's pairs,
//     zeros past K_W*C_i (the next pixels' elements, under zero weights);
//   * the epilogue rounds each fp32 sum once to out_dtype (or writes the
//     split's fp32 partial), masked to [OH, OW, C_o].
//
// float32 (kraken_conv_fma) keeps the first port's FMA path for parity (no TF32):
// one block per (c_o tile of 64, image, band of R rows, 16 columns), C_i in
// chunks staged with the weights behind barriers, each thread a column of R
// pixels x 4 channels.

#include "gemm_tile.cuh"
#include "hopper.cuh"

#include <string.h>

#include <algorithm>

namespace {

using kraken_tile::from_float;
using namespace hopper;

// Every field an int.  The one list of them: struct Plan and the names
// kraken_conv_plan_fields() gives, which kernels/kraken_conv.py checks
// against its PLAN_FIELDS when it loads this library.
#define KRAKEN_CONV_PLAN(X)                                                               \
  X(path) X(dtype) X(out_dtype)                                                           \
  X(N) X(H) X(W) X(C_i) X(K_H) X(K_W) X(C_o) X(S_H) X(S_W) X(pt) X(pl) X(OH) X(OW)        \
  /* float32: the FMA kernel */                                                           \
  X(R) X(L) X(ck) X(khs) X(fBR) X(fBW) X(off_w) X(vec)                                    \
  /* bfloat16: the wgmma kernel */                                                        \
  X(packed) X(band_mode) X(BN) X(TR) X(TC) X(G) X(BR) X(BW) X(rowlen) X(img_bytes)        \
  X(band_bytes) X(NB) X(NW) X(kcp) X(taps) X(nchunks) X(split) X(cps) X(rts) X(cts)       \
  X(ptiles) X(ctiles) X(tiles) X(grid) X(smem)

#define PLAN_DECL(f) int f;
#define PLAN_NAME(f) #f ","
#define PLAN_ONE(f) +1
struct Plan {
  KRAKEN_CONV_PLAN(PLAN_DECL)
};
constexpr int PLAN_INTS = 0 KRAKEN_CONV_PLAN(PLAN_ONE);
static_assert(sizeof(Plan) == PLAN_INTS * sizeof(int), "Plan is ints only");

constexpr int SMEM_MAX = 227 * 1024;

// ---------------------------------------------------------------------------
// float32: the FMA kernel
// ---------------------------------------------------------------------------

constexpr int F_THREADS = 256;
constexpr int F_BCO = 64;           // output channels per block
constexpr int F_OWT = 16;           // output columns per block
constexpr int F_MAXR = 16;          // output rows per block, at most
constexpr int F_LDW = F_BCO + 4;    // weight tile row stride

// Stage channels [c0, c0 + ck) of the block's input band into band
// [fBR][fBW][ck]: band (br, bc) is input row ih0 + br, column iw0 + bc.
// Everything outside the image (the padding) and past C_i stages as zero.
template <bool VEC>
__device__ void fma_stage_band(float* band, const float* __restrict__ x, const Plan& g, int n,
                               int ih0, int iw0, int c0) {
  const int ck = g.ck;
  if constexpr (VEC) {
    const int per_px = ck / 4;
    const int total = g.fBR * g.fBW * per_px;
    for (int i = threadIdx.x; i < total; i += F_THREADS) {
      const int px = i / per_px, cv = (i % per_px) * 4;
      const int ih = ih0 + px / g.fBW, iw = iw0 + px % g.fBW, c = c0 + cv;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (ih >= 0 && ih < g.H && iw >= 0 && iw < g.W && c < g.C_i)
        val = *reinterpret_cast<const float4*>(
            x + ((static_cast<size_t>(n) * g.H + ih) * g.W + iw) * g.C_i + c);
      *reinterpret_cast<float4*>(band + static_cast<size_t>(px) * ck + cv) = val;
    }
  } else {
    const int total = g.fBR * g.fBW * ck;
    for (int i = threadIdx.x; i < total; i += F_THREADS) {
      const int px = i / ck, cc = i % ck;
      const int ih = ih0 + px / g.fBW, iw = iw0 + px % g.fBW, c = c0 + cc;
      float val = 0.f;
      if (ih >= 0 && ih < g.H && iw >= 0 && iw < g.W && c < g.C_i)
        val = x[((static_cast<size_t>(n) * g.H + ih) * g.W + iw) * g.C_i + c];
      band[i] = val;
    }
  }
}

// Stage k[kh0 : kh0 + nkh, :, c0 : c0 + ck, co0 : co0 + F_BCO] into
// wts [nkh * K_W][ck][F_LDW]; channels past C_i and outputs past C_o are 0.
template <bool VEC>
__device__ void fma_stage_weights(float* wts, const float* __restrict__ k, const Plan& g,
                                  int kh0, int nkh, int c0, int co0) {
  const int ck = g.ck;
  const int rows = nkh * g.K_W * ck;   // (tap, channel) rows
  if constexpr (VEC) {
    constexpr int per_row = F_BCO / 4;
    for (int i = threadIdx.x; i < rows * per_row; i += F_THREADS) {
      const int row = i / per_row, co = (i % per_row) * 4;
      const int tap = row / ck, c = c0 + row % ck, gco = co0 + co;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < g.C_i && gco < g.C_o)
        val = *reinterpret_cast<const float4*>(
            k + (static_cast<size_t>(kh0 * g.K_W + tap) * g.C_i + c) * g.C_o + gco);
      *reinterpret_cast<float4*>(wts + row * F_LDW + co) = val;
    }
  } else {
    for (int i = threadIdx.x; i < rows * F_BCO; i += F_THREADS) {
      const int row = i / F_BCO, co = i % F_BCO;
      const int tap = row / ck, c = c0 + row % ck, gco = co0 + co;
      float val = 0.f;
      if (c < g.C_i && gco < g.C_o)
        val = k[(static_cast<size_t>(kh0 * g.K_W + tap) * g.C_i + c) * g.C_o + gco];
      wts[row * F_LDW + co] = val;
    }
  }
}

template <typename O, bool VEC>
__global__ void __launch_bounds__(F_THREADS)
kraken_conv_fma(const float* __restrict__ x, const float* __restrict__ k, O* __restrict__ out,
                const Plan g) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* band = reinterpret_cast<float*>(smem);
  float* wts = reinterpret_cast<float*>(smem + g.off_w);

  const int co0 = blockIdx.x * F_BCO;
  const int n = blockIdx.y / g.L, l = blockIdx.y % g.L;
  const int oh0 = l * g.R, ow0 = blockIdx.z * F_OWT;
  const int ih0 = oh0 * g.S_H - g.pt, iw0 = ow0 * g.S_W - g.pl;
  const int ck = g.ck;

  // thread (pg, cg) owns output column ow0 + pg, channels co0 + 4 cg .. + 3,
  // of every row
  const int cg = threadIdx.x % 16, pg = threadIdx.x / 16;
  float facc[F_MAXR][4];
#pragma unroll
  for (int r = 0; r < F_MAXR; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) facc[r][e] = 0.f;

  for (int c0 = 0; c0 < g.C_i; c0 += ck) {
    // the previous chunk ended with a barrier: the band is free
    fma_stage_band<VEC>(band, x, g, n, ih0, iw0, c0);
    const int cdepth = min(ck, g.C_i - c0);   // live channels of the chunk
    for (int kh0 = 0; kh0 < g.K_H; kh0 += g.khs) {
      const int nkh = min(g.khs, g.K_H - kh0);
      fma_stage_weights<VEC>(wts, k, g, kh0, nkh, c0, co0);
      __syncthreads();
      for (int khl = 0; khl < nkh; ++khl) {
        const int kh = kh0 + khl;
        // Table II: output row r at tap kh reads band row r + kh / S_H,
        // sub-row kh % S_H
        const int q = kh / g.S_H, s = kh % g.S_H;
        for (int kw = 0; kw < g.K_W; ++kw) {
          const float* wtap = wts + (khl * g.K_W + kw) * ck * F_LDW;
          const float* bcol = band + static_cast<size_t>(pg * g.S_W + kw) * ck;
          for (int c = 0; c < cdepth; ++c) {
            const float4 b = *reinterpret_cast<const float4*>(wtap + c * F_LDW + 4 * cg);
#pragma unroll
            for (int r = 0; r < F_MAXR; ++r) {
              if (r < g.R) {
                const float a = bcol[static_cast<size_t>((r + q) * g.S_H + s) * g.fBW * ck + c];
                facc[r][0] = fmaf(a, b.x, facc[r][0]);
                facc[r][1] = fmaf(a, b.y, facc[r][1]);
                facc[r][2] = fmaf(a, b.z, facc[r][2]);
                facc[r][3] = fmaf(a, b.w, facc[r][3]);
              }
            }
          }
        }
      }
      __syncthreads();   // before the next stage overwrites weights or band
    }
  }

  // one rounding of each complete fp32 sum; only outputs inside [OH, OW,
  // C_o] are written
  const int ow = ow0 + pg;
#pragma unroll
  for (int r = 0; r < F_MAXR; ++r) {
    const int oh = oh0 + r;
    if (r < g.R && oh < g.OH && ow < g.OW) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int co = co0 + 4 * cg + e;
        if (co < g.C_o)
          out[((static_cast<size_t>(n) * g.OH + oh) * g.OW + ow) * g.C_o + co] =
              from_float<O>(facc[r][e]);
      }
    }
  }
}

template <typename O>
int launch_fma(const void* x, const void* k, void* out, const Plan& g, cudaStream_t stream) {
  auto kernel = g.vec ? kraken_conv_fma<O, true> : kraken_conv_fma<O, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((g.C_o + F_BCO - 1) / F_BCO, g.N * g.L, (g.OW + F_OWT - 1) / F_OWT);
  kernel<<<grid, F_THREADS, g.smem, stream>>>(static_cast<const float*>(x),
                                              static_cast<const float*>(k), static_cast<O*>(out),
                                              g);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bfloat16: the wgmma kernel
// ---------------------------------------------------------------------------

constexpr int THREADS = 384;      // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int PRODUCER = 256;     // the thread that starts the TMA loads
constexpr int FILLER0 = 288;      // warps 9-11 fill bands TMA cannot take
constexpr int FILLERS = THREADS - FILLER0;
constexpr int CONSUMERS = 256;
constexpr int CK = 64;            // channels per chunk
constexpr int ROW = 128;          // bytes of a 64-channel band pixel or weight row
constexpr int NB_MAX = 6, NW_MAX = 8;
constexpr int BAND_TMA = 0, BAND_LD2 = 1;

struct Tile {
  int z, n0, oh0, ow0, co0;
};

// Tile t: split z, pixel tile (image group, row tile, column tile) and c_o
// tile, c_o fastest, so that consecutive blocks share a band.
__device__ __forceinline__ Tile tile_at(const Plan& p, int t) {
  const int mn = p.ptiles * p.ctiles;
  const int rem = t % mn;
  const int pt = rem / p.ctiles, ct = rem % p.ctiles;
  const int per_group = p.rts * p.cts;
  const int pr = pt % per_group;
  Tile o;
  o.z = t / mn;
  o.co0 = ct * p.BN;
  o.n0 = (pt / per_group) * p.G;
  o.oh0 = (pr / p.cts) * p.TR;
  o.ow0 = (pr % p.cts) * p.TC;
  return o;
}

// Output slot (0..127) of a tile -> image g, row r, column c of the tile;
// false for a slot past G x TR x TC (it then reads pixel (0, 0, 0) and is
// never written).
__device__ __forceinline__ bool slot_at(const Plan& p, int slot, int& g, int& r, int& c) {
  const int per = p.TR * p.TC;
  g = slot / per;
  const int rem = slot - g * per;
  r = rem / p.TC;
  c = rem - r * p.TC;
  if (g < p.G) return true;
  g = r = c = 0;
  return false;
}

__device__ __forceinline__ uint32_t pack2(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// Elements j and j + 1 of a packed band row from element `row`, each zero
// at or past `kwc`.
__device__ __forceinline__ uint32_t window_pair(const uint16_t* e, int row, int j, int kwc) {
  return pack2(j < kwc ? e[row + j] : 0, j + 1 < kwc ? e[row + j + 1] : 0);
}

template <int BN>
__device__ __forceinline__ void mma_step(float (&acc)[BN / 2], const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void mma_step<64>(float (&acc)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_m64n64k16(acc, a, db, 1);
}
template <>
__device__ __forceinline__ void mma_step<128>(float (&acc)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_m64n128k16(acc, a, db, 1);
}

template <typename O>
__device__ __forceinline__ void store2(O* dst, size_t i, float v0, float v1, bool ok0, bool ok1,
                                       bool pair);
template <>
__device__ __forceinline__ void store2<float>(float* dst, size_t i, float v0, float v1, bool ok0,
                                              bool ok1, bool pair) {
  if (pair && ok1) {
    *reinterpret_cast<float2*>(dst + i) = make_float2(v0, v1);
  } else {
    if (ok0) dst[i] = v0;
    if (ok1) dst[i + 1] = v1;
  }
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* dst, size_t i, float v0,
                                                      float v1, bool ok0, bool ok1, bool pair) {
  if (pair && ok1) {
    *reinterpret_cast<__nv_bfloat162*>(dst + i) = __floats2bfloat162_rn(v0, v1);
  } else {
    if (ok0) dst[i] = __float2bfloat16(v0);
    if (ok1) dst[i + 1] = __float2bfloat16(v1);
  }
}

// The band of chunk `chunk` of tile tl filled by warps 9-11 where TMA cannot
// take the rows: the same layout as TMA's (packed: whole input rows of
// rowlen elements), zeros outside the image and past C_i.
__device__ void fill_band(unsigned char* stage, const __nv_bfloat16* __restrict__ x,
                          const Plan& p, const Tile& tl, int chunk, int f) {
  const int ih0 = tl.oh0 * p.S_H - p.pt, iw0 = tl.ow0 * p.S_W - p.pl;
  const int nimg = min(p.G, p.N - tl.n0);
  const uint16_t* xs = reinterpret_cast<const uint16_t*>(x);
  if (p.packed) {
    const int per_img = p.BR * p.rowlen;
#pragma unroll 4
    for (int u = f; u < nimg * per_img; u += FILLERS) {
      const int gi = u / per_img, v = u - gi * per_img;
      const int br = v / p.rowlen, e = v - br * p.rowlen;
      const int col = e / p.C_i, ih = ih0 + br, iw = iw0 + col;
      uint16_t val = 0;
      if (col < p.BW && ih >= 0 && ih < p.H && iw >= 0 && iw < p.W)
        val = xs[((static_cast<size_t>(tl.n0 + gi) * p.H + ih) * p.W + iw0) * p.C_i + e];
      reinterpret_cast<uint16_t*>(stage + gi * p.img_bytes)[v] = val;
    }
    return;
  }
  const int per_img = p.BR * p.BW * 32;   // 32 channel pairs per pixel
  const int c0 = chunk * CK;
  const uint32_t base = smem_u32(stage);
#pragma unroll 4
  for (int u = f; u < nimg * per_img; u += FILLERS) {
    const int gi = u / per_img, v = u - gi * per_img;
    const int q = v >> 5, jp = v & 31;    // pixel, channel pair
    const int br = q / p.BW, bc = q - br * p.BW;
    const int ih = ih0 + br, iw = iw0 + bc, ch = c0 + 2 * jp;
    const bool in = ih >= 0 && ih < p.H && iw >= 0 && iw < p.W;
    const size_t src = ((static_cast<size_t>(tl.n0 + gi) * p.H + ih) * p.W + iw) * p.C_i + ch;
    const uint32_t dst = base + gi * p.img_bytes + q * ROW + ((((jp >> 2) ^ (q & 7))) << 4) +
                         (jp & 3) * 4;
    const uint16_t v0 = in && ch < p.C_i ? xs[src] : 0;
    const uint16_t v1 = in && ch + 1 < p.C_i ? xs[src + 1] : 0;
    asm volatile("st.shared.u32 [%0], %1;" ::"r"(dst), "r"(pack2(v0, v1)) : "memory");
  }
}

template <typename O, int BN>
__global__ void __launch_bounds__(THREADS, 1)
kraken_conv_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap wmap,
                   const __nv_bfloat16* __restrict__ x, O* __restrict__ out,
                   float* __restrict__ part, const Plan p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* bands = smem;
  unsigned char* wts = smem + p.NB * p.band_bytes;
  constexpr int WBYTES = BN * ROW;
  uint64_t* bars = reinterpret_cast<uint64_t*>(wts + p.NW * WBYTES);
  uint64_t* full_b = bars;
  uint64_t* empty_b = bars + NB_MAX;
  uint64_t* full_w = bars + 2 * NB_MAX;
  uint64_t* empty_w = bars + 2 * NB_MAX + NW_MAX;

  if (threadIdx.x == 0) {
    for (int i = 0; i < p.NB; ++i) {
      mbar_init(&full_b[i], p.band_mode == BAND_TMA ? 1 : FILLERS);
      mbar_init(&empty_b[i], CONSUMERS);
    }
    for (int i = 0; i < p.NW; ++i) {
      mbar_init(&full_w[i], 1);
      mbar_init(&empty_w[i], CONSUMERS);
    }
    fence_mbar_init();
  }
  __syncthreads();

  // the warpgroup's role, taken through a shuffle so that the compiler
  // knows it is the same in every lane: wgmma is not serialised
  const int role = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (role == 2) {
    // ---- producer warpgroup ---------------------------------------------
    int bs = 0, ws = 0;
    uint32_t bph = 0, wph = 0;
    if (threadIdx.x == PRODUCER) {
      const uint32_t band_tx = p.BR * p.BW * ROW;
      for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
        const Tile tl = tile_at(p, t);
        const int ih0 = tl.oh0 * p.S_H - p.pt, iw0 = tl.ow0 * p.S_W - p.pl;
        const int nimg = min(p.G, p.N - tl.n0);
        const int c_end = min(p.nchunks, (tl.z + 1) * p.cps);
        for (int chunk = tl.z * p.cps; chunk < c_end; ++chunk) {
          if (p.band_mode == BAND_TMA) {
            mbar_wait(&empty_b[bs], bph ^ 1);
            mbar_expect_tx(&full_b[bs], nimg * band_tx);
            for (int gi = 0; gi < nimg; ++gi)
              tma_load_4d(bands + bs * p.band_bytes + gi * p.img_bytes, &xmap, &full_b[bs],
                          chunk * CK, iw0, ih0, tl.n0 + gi);
            if (++bs == p.NB) { bs = 0; bph ^= 1; }
          }
          for (int tap = 0; tap < p.taps; ++tap) {
            mbar_wait(&empty_w[ws], wph ^ 1);
            mbar_expect_tx(&full_w[ws], WBYTES);
            tma_load_3d(wts + ws * WBYTES, &wmap, &full_w[ws], p.packed ? 0 : chunk * CK,
                        tl.co0, tap);
            if (++ws == p.NW) { ws = 0; wph ^= 1; }
          }
        }
      }
    } else if (threadIdx.x >= FILLER0 && p.band_mode != BAND_TMA) {
      const int f = threadIdx.x - FILLER0;
      for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
        const Tile tl = tile_at(p, t);
        const int c_end = min(p.nchunks, (tl.z + 1) * p.cps);
        for (int chunk = tl.z * p.cps; chunk < c_end; ++chunk) {
          mbar_wait(&empty_b[bs], bph ^ 1);
          fill_band(bands + bs * p.band_bytes, x, p, tl, chunk, f);
          mbar_arrive(&full_b[bs]);
          if (++bs == p.NB) { bs = 0; bph ^= 1; }
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 output pixels each ------------------------
  const int wg = role, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int row0 = wg * 64 + warp * 16;   // this warp's 16 slots
  const size_t M = static_cast<size_t>(p.N) * p.OH * p.OW;
  int bs = 0, ws = 0;
  uint32_t bph = 0, wph = 0;
  float acc[BN / 2];

  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const Tile tl = tile_at(p, t);
    // the band offsets of this lane's A rows: its ldmatrix row (slot row0 +
    // lane % 16) or, packed, its fragment rows (row0 + lane / 4, + 8)
    int ga, ra, ca, gb, rb, cb;
    slot_at(p, row0 + (p.packed ? lane >> 2 : lane & 15), ga, ra, ca);
    slot_at(p, row0 + (lane >> 2) + 8, gb, rb, cb);
    const int qa = ra * p.S_H * p.BW + ca * p.S_W;   // band pixel at tap (0, 0)
    const int ea = ga * p.img_bytes / 2 + ra * p.S_H * p.rowlen + ca * p.S_W * p.C_i;
    const int eb = gb * p.img_bytes / 2 + rb * p.S_H * p.rowlen + cb * p.S_W * p.C_i;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

    const int c_end = min(p.nchunks, (tl.z + 1) * p.cps);
    for (int chunk = tl.z * p.cps; chunk < c_end; ++chunk) {
      const int ks = p.packed ? (p.K_W * p.C_i + 15) / 16 : min(4, (p.C_i - chunk * CK + 15) / 16);
      mbar_wait(&full_b[bs], bph);
      unsigned char* stage = bands + bs * p.band_bytes;
      for (int tap = 0; tap < p.taps; ++tap) {
        uint32_t a[4][4];
        if (!p.packed) {
          // Table II: output row r at tap (kh, kw) reads band pixel
          // (r*S_H + kh, c*S_W + kw); 16-byte chunk 2s + lane/16 of it
          const int kh = tap / p.K_W, kw = tap - kh * p.K_W;
          const int q = qa + kh * p.BW + kw;
          const uint32_t rowp = smem_u32(stage + ga * p.img_bytes + q * ROW);
#pragma unroll
          for (int s = 0; s < 4; ++s)
            if (s < ks) ldmatrix_x4(rowp + ((((2 * s) | (lane >> 4)) ^ (q & 7)) << 4), a[s]);
        } else {
          // (kw, c) packed: k index j is element j of the input row from
          // the pixel's first column; the fragment's pairs (j, j + 1) of
          // rows lane/4 and lane/4 + 8 at j = 16s + 2(lane%4) (+ 8).  Past
          // K_W*C_i the row holds the next pixels, outside this output's
          // window: those elements are zeros here, so that an Inf or NaN
          // there does not reach this output through a zero weight
          const uint16_t* e = reinterpret_cast<const uint16_t*>(stage);
          const int ra_ = ea + tap * p.rowlen, rb_ = eb + tap * p.rowlen;
          const int kwc = p.K_W * p.C_i;
#pragma unroll
          for (int s = 0; s < 4; ++s)
            if (s < ks) {
              const int j = 16 * s + 2 * (lane & 3);
              a[s][0] = window_pair(e, ra_, j, kwc);
              a[s][1] = window_pair(e, rb_, j, kwc);
              a[s][2] = window_pair(e, ra_, j + 8, kwc);
              a[s][3] = window_pair(e, rb_, j + 8, kwc);
            }
        }
        mbar_wait(&full_w[ws], wph);
        const uint64_t db = desc_k128(smem_u32(wts + ws * WBYTES));
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < 4; ++s)
          if (s < ks) mma_step<BN>(acc, a[s], db + 2 * s);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        mbar_arrive(&empty_w[ws]);
        if (++ws == p.NW) { ws = 0; wph ^= 1; }
      }
      mbar_arrive(&empty_b[bs]);
      if (++bs == p.NB) { bs = 0; bph ^= 1; }
    }

    // epilogue: thread (warp, lane) holds rows lane/4 and lane/4 + 8 of the
    // warp's 16, columns 8i + 2(lane%4) and + 1 of every 8-column block i
    const bool pair = p.C_o % 2 == 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int g, r, c;
      const bool in_tile = slot_at(p, row0 + (lane >> 2) + 8 * h, g, r, c);
      const int n = tl.n0 + g, oh = tl.oh0 + r, ow = tl.ow0 + c;
      if (!in_tile || n >= p.N || oh >= p.OH || ow >= p.OW) continue;
      const size_t pix = ((static_cast<size_t>(n) * p.OH + oh) * p.OW + ow) * p.C_o;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int co = tl.co0 + 8 * i + 2 * (lane & 3);
        const float v0 = acc[4 * i + 2 * h], v1 = acc[4 * i + 2 * h + 1];
        if (p.split > 1)
          store2<float>(part + tl.z * M * p.C_o, pix + co, v0, v1, co < p.C_o, co + 1 < p.C_o,
                        pair);
        else
          store2<O>(out, pix + co, v0, v1, co < p.C_o, co + 1 < p.C_o, pair);
      }
    }
  }
}

// k viewed as [T][J][C_o] (T taps of J = C_i, or K_H rows of J = K_W*C_i
// packed) -> wt [T][C_o][kcp], K-major, zeros for j >= J.
__global__ void __launch_bounds__(256)
kraken_conv_weights(const __nv_bfloat16* __restrict__ k, __nv_bfloat16* __restrict__ wt, int J,
                    int C_o, int kcp) {
  __shared__ uint16_t tile[32][33];
  const int t = blockIdx.z, j0 = blockIdx.x * 32, co0 = blockIdx.y * 32;
  const uint16_t* src = reinterpret_cast<const uint16_t*>(k) + static_cast<size_t>(t) * J * C_o;
  uint16_t* dst = reinterpret_cast<uint16_t*>(wt) + static_cast<size_t>(t) * C_o * kcp;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int j = j0 + i, co = co0 + threadIdx.x;
    tile[i][threadIdx.x] = j < J && co < C_o ? src[static_cast<size_t>(j) * C_o + co] : 0;
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int co = co0 + i, j = j0 + threadIdx.x;
    if (co < C_o && j < kcp) dst[static_cast<size_t>(co) * kcp + j] = tile[threadIdx.x][i];
  }
}

// out = part[0] + part[1] + ... + part[split - 1], in that order, rounded
// once: the same bits on every run.
template <typename O>
__global__ void __launch_bounds__(256)
kraken_conv_reduce(const float* __restrict__ part, O* __restrict__ out, size_t count,
                   int split) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < count;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = part[i];
    for (int z = 1; z < split; ++z) s += part[z * count + i];
    out[i] = from_float<O>(s);
  }
}

bool plan_ok(const Plan& p) {
  if (p.BN != 64 && p.BN != 128) return false;
  if (p.band_mode != BAND_TMA && p.band_mode != BAND_LD2) return false;
  if (p.NB < 1 || p.NB > NB_MAX || p.NW < 2 || p.NW > NW_MAX) return false;
  if (p.G < 1 || p.TR < 1 || p.TC < 1 || p.G * p.TR * p.TC > 128) return false;
  if (p.BR < 1 || p.BR > 256 || p.BW < 1 || p.BW > 256 || p.img_bytes % 1024) return false;
  if (p.packed ? p.K_W * p.C_i > CK || p.kcp != CK || p.nchunks != 1 || p.taps != p.K_H ||
                     p.band_mode != BAND_LD2 || p.rowlen < p.BW * p.C_i + 16
               : p.taps != p.K_H * p.K_W || p.nchunks != (p.C_i + CK - 1) / CK ||
                     p.kcp != p.nchunks * CK)
    return false;
  if (p.split < 1 || p.cps * p.split < p.nchunks || p.tiles != p.ptiles * p.ctiles * p.split)
    return false;
  if (p.grid < 1 || p.smem > SMEM_MAX ||
      p.smem < p.NB * p.band_bytes + p.NW * p.BN * ROW + 1024 + 8 * 2 * (NB_MAX + NW_MAX))
    return false;
  return true;
}

template <typename O, int BN>
int launch_wgmma(const void* x, const void* k, void* out, void* wt, void* part, const Plan& p,
                 cudaStream_t stream) {
  const int J = p.packed ? p.K_W * p.C_i : p.C_i;
  const dim3 tgrid(p.kcp / 32, (p.C_o + 31) / 32, p.taps);
  kraken_conv_weights<<<tgrid, dim3(32, 8), 0, stream>>>(
      static_cast<const __nv_bfloat16*>(k), static_cast<__nv_bfloat16*>(wt), J, p.C_o, p.kcp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  CUtensorMap wmap, xmap;
  memset(&xmap, 0, sizeof xmap);
  {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(p.kcp), static_cast<cuuint64_t>(p.C_o),
                                static_cast<cuuint64_t>(p.taps)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(p.kcp) * 2,
                                   static_cast<cuuint64_t>(p.C_o) * p.kcp * 2};
    const cuuint32_t box[3] = {CK, static_cast<cuuint32_t>(BN), 1};
    const int e = hopper_host::bf16_map(&wmap, wt, 3, dims, strides, box);
    if (e) return e;
  }
  if (p.band_mode == BAND_TMA) {
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(p.C_i), static_cast<cuuint64_t>(p.W),
                                static_cast<cuuint64_t>(p.H), static_cast<cuuint64_t>(p.N)};
    const cuuint64_t strides[3] = {static_cast<cuuint64_t>(p.C_i) * 2,
                                   static_cast<cuuint64_t>(p.W) * p.C_i * 2,
                                   static_cast<cuuint64_t>(p.H) * p.W * p.C_i * 2};
    const cuuint32_t box[4] = {CK, static_cast<cuuint32_t>(p.BW), static_cast<cuuint32_t>(p.BR),
                               1};
    const int e = hopper_host::bf16_map(&xmap, x, 4, dims, strides, box);
    if (e) return e;
  }

  auto kernel = kraken_conv_kernel<O, BN>;
  static bool sized[64] = {};   // once per variant and device: the most any plan asks
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !sized[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) sized[dev] = true;
  }
  kernel<<<p.grid, THREADS, p.smem, stream>>>(xmap, wmap, static_cast<const __nv_bfloat16*>(x),
                                              static_cast<O*>(out), static_cast<float*>(part),
                                              p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.split == 1) return static_cast<int>(err);
  const size_t count = static_cast<size_t>(p.N) * p.OH * p.OW * p.C_o;
  const int blocks = static_cast<int>(std::min<size_t>((count + 255) / 256, 4096));
  kraken_conv_reduce<O><<<blocks, 256, 0, stream>>>(static_cast<const float*>(part),
                                                    static_cast<O*>(out), count, p.split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [N, H, W, C_i] and k [K_H, K_W, C_i, C_o] of one dtype, contiguous; out
// [N, OH, OW, C_o] of out_dtype (0 float32, 1 bfloat16).  `plan` holds
// `nplan` ints in the order of kernels/kraken_conv.py's PLAN_FIELDS; for
// bfloat16, wt is a bf16 buffer of taps * C_o * kcp elements (the weights'
// K-major copy) and, when the plan splits C_i, part an fp32 buffer of
// split * N * OH * OW * C_o.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); a plan it does not take returns
// cudaErrorInvalidValue without launching, a failed tensor-map encoding its
// CUresult.
// The plan's field names in struct Plan's order, each followed by a comma.
extern "C" const char* kraken_conv_plan_fields() { return KRAKEN_CONV_PLAN(PLAN_NAME); }

extern "C" int kraken_conv2d(const void* x, const void* k, void* out, void* wt, void* part,
                             const int* plan, int nplan, void* stream) {
  if (nplan != PLAN_INTS) return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  memcpy(&p, plan, sizeof p);
  if (p.N <= 0 || p.H <= 0 || p.W <= 0 || p.C_i <= 0 || p.K_H <= 0 || p.K_W <= 0 ||
      p.C_o <= 0 || p.S_H <= 0 || p.S_W <= 0 || p.pt < 0 || p.pl < 0 || p.OH <= 0 || p.OW <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.path == 0 && p.dtype == 0) {
    if (p.R < 1 || p.R > F_MAXR || p.smem > SMEM_MAX)
      return static_cast<int>(cudaErrorInvalidValue);
    if (p.out_dtype == 0) return launch_fma<float>(x, k, out, p, s);
    if (p.out_dtype == 1) return launch_fma<__nv_bfloat16>(x, k, out, p, s);
  }
  if (p.path == 1 && p.dtype == 1 && (p.out_dtype == 0 || p.out_dtype == 1) && wt != nullptr &&
      plan_ok(p) && (p.split == 1 || part != nullptr)) {
    const bool bf = p.out_dtype == 1;
    if (p.BN == 128)
      return bf ? launch_wgmma<__nv_bfloat16, 128>(x, k, out, wt, part, p, s)
                : launch_wgmma<float, 128>(x, k, out, wt, part, p, s);
    return bf ? launch_wgmma<__nv_bfloat16, 64>(x, k, out, wt, part, p, s)
              : launch_wgmma<float, 64>(x, k, out, wt, part, p, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
