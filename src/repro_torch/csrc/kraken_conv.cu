// kraken_conv2d_direct for Hopper (sm_90a): NHWC x HWIO -> NHWC convolution
// by Kraken's output-stationary dataflow, fp32 accumulation.
//
// Replaces the Pallas TPU kernel src/repro/kernels/kraken_conv.py::
// kraken_conv2d_direct (body _conv_kernel, input restructure
// interleave_input).  There the grid (c_o tile, N*L row block, K_H tap) runs
// in order on one core: X is first interleaved into X_hat in HBM, the whole
// [K_H, K_W, C_i, bco] weight tile and the full-C band stay resident in VMEM,
// and an fp32 [R, OW, bco] accumulator carries across the tap steps.  Blocks
// on a GPU run in no order and a block has at most 227 KB of shared memory
// (VGG's 3x3 x 512 weights alone are 590 KB per 64 output channels), so the
// structure is kept where Hopper allows and the rest is looped:
//   * one block per (c_o tile of BCO = 64, image n, band l of R output rows,
//     tile of OWT = 16 output columns); its R x 16 x 64 outputs live in fp32
//     accumulators (wmma fragments for bf16, registers for float32) from the
//     first tap to the last and are written once: partials never leave the
//     block;
//   * C_i is walked in chunks of `ck` channels.  Per chunk the input band of
//     (R-1)*S_H + K_H rows x (OWT-1)*S_W + K_W columns is staged once in
//     shared memory, read straight from the NHWC input with the padding
//     applied as zeros while loading (no X_hat copy, nothing padded in
//     device memory), and reused by every (kh, kw) tap: the pixel shifter.
//     Output row r at tap kh reads band row r + kh / S_H, sub-row kh % S_H
//     (Table II), i.e. input row (l*R + r)*S_H + kh - pad_top;
//   * the weights of the block's c_o tile for the chunk are staged beside the
//     band, `khs` kernel rows at a time (all K_H when they fit);
//   * bfloat16: per tap and 16-channel step, one 16x16 weight fragment times
//     one 16-pixel fragment of each of the warp's output rows (nvcuda::wmma
//     16x16x16, fp32 accumulators; the 16 pixels of a fragment are 16
//     neighbouring output columns, S_W pixels apart in the band); float32:
//     fp32 FMA, each thread a column of R pixels x 4 channels, no TF32.
//     Channels past C_i and outputs past C_o stage as zeros, so C_i = 3 and
//     ragged chunks and c_o tiles need no padding in device memory.
//
// What bounds it on an H100: a layer does 2*K_H*K_W*C_i operations per output
// element.  At batch 32 the 3x3 layers with C_i >= 64 are bound by the bf16
// tensor-core rate, the C_i = 3 first layers and most 1x1 layers by their
// bytes; at batch 1, where the weights outweigh the small maps, most layers
// are bound by their bytes (chip_smoke.py's conv_kernels logs each
// layer's bound).  This first design is far from either: wmma (mma.sync),
// no cp.async/TMA pipeline (each chunk's loads and math are separated by
// barriers), 16-column tiles that waste 9/16 of the work on a 7-wide map,
// and C_i = 3 taking a whole 16-channel step.  wgmma with a TMA ring comes
// later.

#include "gemm_tile.cuh"

#include <algorithm>

namespace {

using namespace nvcuda;
using kraken_tile::from_float;
using kraken_tile::zero_of;

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int BCO = 64;    // output channels per block
constexpr int OWT = 16;    // output columns per block
constexpr int MAX_R = 16;  // output rows per block, at most
constexpr size_t SMEM_MAX = 227 * 1024;
constexpr size_t SMEM_TARGET = 100 * 1024;   // two blocks per SM

template <typename T>
constexpr bool is_bf16 = std::is_same<T, __nv_bfloat16>::value;
// weight tile row stride: 8 (bf16) or 4 (fp32) elements of padding
template <typename T>
constexpr int LDW = is_bf16<T> ? BCO + 8 : BCO + 4;
// channel chunk: a multiple of CK_STEP, at most CK_MAX
template <typename T>
constexpr int CK_STEP = is_bf16<T> ? 16 : 8;
template <typename T>
constexpr int CK_MAX = is_bf16<T> ? 64 : 32;

__host__ __device__ inline size_t align128(size_t x) {
  return (x + 127) & ~static_cast<size_t>(127);
}

struct Geom {
  int N, H, W, C_i, K_H, K_W, C_o, S_H, S_W, pt, pl, OH, OW, R, L;
  int BR, BW;    // band rows and columns
  int ck, khs;   // channel chunk, kernel rows staged at once
  int off_w, off_scr, bytes;
};

template <typename T>
size_t smem_bytes(const Geom& g, int ck, int khs, size_t* off_w, size_t* off_scr) {
  size_t o = align128(sizeof(T) * static_cast<size_t>(g.BR) * g.BW * ck);
  *off_w = o;
  o += align128(sizeof(T) * static_cast<size_t>(khs) * g.K_W * ck * LDW<T>);
  *off_scr = o;   // bf16: one 16x16 fp32 epilogue tile per warp
  o += is_bf16<T> ? sizeof(float) * NWARPS * 256 : 0;
  return o;
}

// The chunk and the kernel rows staged at once: the largest chunk, all K_H
// rows before one row, that fits two blocks per SM, else one block per SM.
template <typename T>
bool plan(Geom& g) {
  g.BR = (g.R - 1) * g.S_H + g.K_H;
  g.BW = (OWT - 1) * g.S_W + g.K_W;
  const int step = CK_STEP<T>;
  const int ck_max = std::min(CK_MAX<T>, (g.C_i + step - 1) / step * step);
  int cands[4], nc = 0;
  cands[nc++] = ck_max;
  for (int c = CK_MAX<T>; c >= step; c /= 2)
    if (c < ck_max) cands[nc++] = c;
  for (size_t limit : {SMEM_TARGET, SMEM_MAX})
    for (int i = 0; i < nc; ++i)
      for (int khs : {g.K_H, 1}) {
        size_t off_w, off_scr;
        const size_t bytes = smem_bytes<T>(g, cands[i], khs, &off_w, &off_scr);
        if (bytes <= limit) {
          g.ck = cands[i];
          g.khs = khs;
          g.off_w = static_cast<int>(off_w);
          g.off_scr = static_cast<int>(off_scr);
          g.bytes = static_cast<int>(bytes);
          return true;
        }
      }
  return false;
}

// Stage channels [c0, c0 + ck) of the block's input band into band
// [BR][BW][ck]: band (br, bc) is input row ih0 + br, column iw0 + bc.
// Everything outside the image (the padding) and past C_i stages as zero.
// VEC: C_i % V == 0 and 16-byte aligned rows, so a 16-byte chunk of a pixel
// is all in or all out.
template <typename T, bool VEC>
__device__ void stage_band(T* band, const T* __restrict__ x, const Geom& g, int n,
                           int ih0, int iw0, int c0) {
  const int ck = g.ck;
  if constexpr (VEC) {
    constexpr int V = 16 / sizeof(T);
    const int per_px = ck / V;
    const int total = g.BR * g.BW * per_px;
    for (int i = threadIdx.x; i < total; i += NTHREADS) {
      const int px = i / per_px, cv = (i % per_px) * V;
      const int ih = ih0 + px / g.BW, iw = iw0 + px % g.BW, c = c0 + cv;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (ih >= 0 && ih < g.H && iw >= 0 && iw < g.W && c < g.C_i)
        val = *reinterpret_cast<const uint4*>(
            x + ((static_cast<size_t>(n) * g.H + ih) * g.W + iw) * g.C_i + c);
      *reinterpret_cast<uint4*>(band + static_cast<size_t>(px) * ck + cv) = val;
    }
  } else {
    const T zero = zero_of<T>();
    const int total = g.BR * g.BW * ck;
    for (int i = threadIdx.x; i < total; i += NTHREADS) {
      const int px = i / ck, cc = i % ck;
      const int ih = ih0 + px / g.BW, iw = iw0 + px % g.BW, c = c0 + cc;
      T val = zero;
      if (ih >= 0 && ih < g.H && iw >= 0 && iw < g.W && c < g.C_i)
        val = x[((static_cast<size_t>(n) * g.H + ih) * g.W + iw) * g.C_i + c];
      band[i] = val;
    }
  }
}

// Stage k[kh0 : kh0 + nkh, :, c0 : c0 + ck, co0 : co0 + BCO] into
// wts [nkh * K_W][ck][LDW]; channels past C_i and outputs past C_o are zero.
template <typename T, bool VEC>
__device__ void stage_weights(T* wts, const T* __restrict__ k, const Geom& g, int kh0,
                              int nkh, int c0, int co0) {
  const int ck = g.ck;
  const int rows = nkh * g.K_W * ck;   // (tap, channel) rows
  if constexpr (VEC) {
    constexpr int V = 16 / sizeof(T);
    constexpr int per_row = BCO / V;
    for (int i = threadIdx.x; i < rows * per_row; i += NTHREADS) {
      const int row = i / per_row, co = (i % per_row) * V;
      const int tap = row / ck, c = c0 + row % ck, gco = co0 + co;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (c < g.C_i && gco < g.C_o)
        val = *reinterpret_cast<const uint4*>(
            k + (static_cast<size_t>(kh0 * g.K_W + tap) * g.C_i + c) * g.C_o + gco);
      *reinterpret_cast<uint4*>(wts + row * LDW<T> + co) = val;
    }
  } else {
    const T zero = zero_of<T>();
    for (int i = threadIdx.x; i < rows * BCO; i += NTHREADS) {
      const int row = i / BCO, co = i % BCO;
      const int tap = row / ck, c = c0 + row % ck, gco = co0 + co;
      T val = zero;
      if (c < g.C_i && gco < g.C_o)
        val = k[(static_cast<size_t>(kh0 * g.K_W + tap) * g.C_i + c) * g.C_o + gco];
      wts[row * LDW<T> + co] = val;
    }
  }
}

template <typename T, typename O, bool VEC>
__global__ void __launch_bounds__(NTHREADS)
kraken_conv_kernel(const T* __restrict__ x, const T* __restrict__ k, O* __restrict__ out,
                   const Geom g) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* band = reinterpret_cast<T*>(smem);
  T* wts = reinterpret_cast<T*>(smem + g.off_w);

  const int co0 = blockIdx.x * BCO;
  const int n = blockIdx.y / g.L, l = blockIdx.y % g.L;
  const int oh0 = l * g.R, ow0 = blockIdx.z * OWT;
  const int ih0 = oh0 * g.S_H - g.pt, iw0 = ow0 * g.S_W - g.pl;
  const int ck = g.ck;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // bf16: warp (h, j) owns the 16 channels co0 + 16 j of output rows h, h + 2,
  // ...; float32: thread (pg, cg) owns output column ow0 + pg, channels
  // co0 + 4 cg .. + 3, of every row
  const int j = warp % 4, h = warp / 4;
  const int cg = threadIdx.x % 16, pg = threadIdx.x / 16;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MAX_R / 2];
  float facc[is_bf16<T> ? 1 : MAX_R][4];
  if constexpr (is_bf16<T>) {
#pragma unroll
    for (int i = 0; i < MAX_R / 2; ++i) wmma::fill_fragment(acc[i], 0.f);
  } else {
#pragma unroll
    for (int r = 0; r < MAX_R; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) facc[r][e] = 0.f;
  }

  for (int c0 = 0; c0 < g.C_i; c0 += ck) {
    // the previous chunk ended with a barrier: the band is free
    stage_band<T, VEC>(band, x, g, n, ih0, iw0, c0);
    const int cdepth = min(ck, g.C_i - c0);   // live channels of the chunk
    for (int kh0 = 0; kh0 < g.K_H; kh0 += g.khs) {
      const int nkh = min(g.khs, g.K_H - kh0);
      stage_weights<T, VEC>(wts, k, g, kh0, nkh, c0, co0);
      __syncthreads();
      for (int khl = 0; khl < nkh; ++khl) {
        const int kh = kh0 + khl;
        // Table II: output row r at tap kh reads band row r + kh / S_H,
        // sub-row kh % S_H
        const int q = kh / g.S_H, s = kh % g.S_H;
        for (int kw = 0; kw < g.K_W; ++kw) {
          const T* wtap = wts + (khl * g.K_W + kw) * ck * LDW<T>;
          if constexpr (is_bf16<T>) {
            for (int kk = 0; kk < cdepth; kk += 16) {
              wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
              wmma::load_matrix_sync(bf, wtap + kk * LDW<T> + 16 * j, LDW<T>);
#pragma unroll
              for (int i = 0; i < MAX_R / 2; ++i) {
                const int r = h + 2 * i;
                if (r < g.R) {
                  // 16 neighbouring output columns: S_W pixels apart
                  const T* a = band + (static_cast<size_t>((r + q) * g.S_H + s) * g.BW + kw) * ck + kk;
                  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
                  wmma::load_matrix_sync(af, a, g.S_W * ck);
                  wmma::mma_sync(acc[i], af, bf, acc[i]);
                }
              }
            }
          } else {
            const T* bcol = band + static_cast<size_t>(pg * g.S_W + kw) * ck;
            for (int c = 0; c < cdepth; ++c) {
              const float4 b = *reinterpret_cast<const float4*>(wtap + c * LDW<T> + 4 * cg);
#pragma unroll
              for (int r = 0; r < MAX_R; ++r) {
                if (r < g.R) {
                  const float a = bcol[static_cast<size_t>((r + q) * g.S_H + s) * g.BW * ck + c];
                  facc[r][0] = fmaf(a, b.x, facc[r][0]);
                  facc[r][1] = fmaf(a, b.y, facc[r][1]);
                  facc[r][2] = fmaf(a, b.z, facc[r][2]);
                  facc[r][3] = fmaf(a, b.w, facc[r][3]);
                }
              }
            }
          }
        }
      }
      __syncthreads();   // before the next stage overwrites weights or band
    }
  }

  // epilogue: one rounding of each complete fp32 sum; only outputs inside
  // [OH, OW, C_o] are written
  if constexpr (is_bf16<T>) {
    float* scr = reinterpret_cast<float*>(smem + g.off_scr) + warp * 256;
#pragma unroll
    for (int i = 0; i < MAX_R / 2; ++i) {
      const int r = h + 2 * i;
      if (r < g.R) {
        wmma::store_matrix_sync(scr, acc[i], 16, wmma::mem_row_major);
        __syncwarp();
        const int oh = oh0 + r;
        if (oh < g.OH) {
          for (int e = lane; e < 256; e += 32) {
            const int ow = ow0 + e / 16, co = co0 + 16 * j + e % 16;
            if (ow < g.OW && co < g.C_o)
              out[((static_cast<size_t>(n) * g.OH + oh) * g.OW + ow) * g.C_o + co] =
                  from_float<O>(scr[e]);
          }
        }
        __syncwarp();
      }
    }
  } else {
    const int ow = ow0 + pg;
#pragma unroll
    for (int r = 0; r < MAX_R; ++r) {
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
}

template <typename T, typename O>
int launch(const void* x, const void* k, void* out, Geom g, cudaStream_t stream) {
  if (!plan<T>(g)) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int V = 16 / sizeof(T);
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 && g.C_i % V == 0 &&
                   g.C_o % V == 0;
  auto kernel = vec ? kraken_conv_kernel<T, O, true> : kraken_conv_kernel<T, O, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         g.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((g.C_o + BCO - 1) / BCO, g.N * g.L, (g.OW + OWT - 1) / OWT);
  kernel<<<grid, NTHREADS, g.bytes, stream>>>(static_cast<const T*>(x),
                                              static_cast<const T*>(k), static_cast<O*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [N, H, W, C_i] and k [K_H, K_W, C_i, C_o] of one dtype, contiguous;
// out [N, OH, OW, C_o] of out_dtype (0 float32, 1 bfloat16 for all three).
// Strides S_H, S_W; pad_top/pad_left zeros before the image (the bottom and
// right padding is implied by OH and OW).  R output rows per block, 1..16.
// Launches on `stream` and returns cudaGetLastError() (0 on success); a
// shape it does not take (or one whose tiles exceed the shared memory)
// returns cudaErrorInvalidValue without launching.
extern "C" int kraken_conv2d(const void* x, const void* k, void* out, int N, int H, int W,
                             int C_i, int K_H, int K_W, int C_o, int S_H, int S_W,
                             int pad_top, int pad_left, int OH, int OW, int R, int dtype,
                             int out_dtype, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C_i <= 0 || K_H <= 0 || K_W <= 0 || C_o <= 0 ||
      S_H <= 0 || S_W <= 0 || pad_top < 0 || pad_left < 0 || OH <= 0 || OW <= 0 ||
      R < 1 || R > MAX_R)
    return static_cast<int>(cudaErrorInvalidValue);
  Geom g{};
  g.N = N; g.H = H; g.W = W; g.C_i = C_i; g.K_H = K_H; g.K_W = K_W; g.C_o = C_o;
  g.S_H = S_H; g.S_W = S_W; g.pt = pad_top; g.pl = pad_left; g.OH = OH; g.OW = OW;
  g.R = R; g.L = (OH + R - 1) / R;
  if (static_cast<long long>(N) * g.L > 65535 || (OW + OWT - 1) / OWT > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && out_dtype == 0) return launch<float, float>(x, k, out, g, s);
  if (dtype == 0 && out_dtype == 1) return launch<float, __nv_bfloat16>(x, k, out, g, s);
  if (dtype == 1 && out_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, k, out, g, s);
  if (dtype == 1 && out_dtype == 0) return launch<__nv_bfloat16, float>(x, k, out, g, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
