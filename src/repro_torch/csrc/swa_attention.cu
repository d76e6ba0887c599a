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
// diagonal, each once, and keeps the online-softmax state in shared memory.
// The kv head is resolved in the block's own offsets; no repeated-KV tensor
// is built.  A ragged last q or kv tile is masked here (rows and keys >= S),
// so nothing needs S % 128 == 0.
//
// Semantics (those of the Pallas _kernel): fp32 scores (bf16 products are
// exact in fp32), scaled after the dot; masked scores never contribute
// (p = 0, which is what the Pallas -1e30 fill gives once a row has seen a
// live key, and every row sees its own diagonal key); fp32 online softmax;
// the probabilities are rounded to V's dtype before the PV product, as
// p.astype(v_ref.dtype) does there, while l sums the unrounded ones; the
// output is acc / l in q's dtype.
//
// What bounds it on an H100: per q tile it does 4 * BQ * BKV * D operations
// on every kv tile it loads, so at gemma3's D 240 and W 1024 it is bound by
// the tensor cores, not by memory.  This first design uses nvcuda::wmma
// 16x16x16 bf16 fragments with fp32 accumulators (64-row q and kv tiles,
// eight warps, one block per SM because of its ~181 KB of shared memory at
// D 240); float32 runs fp32 FMA (no TF32) on 32-row tiles.  The tiles are
// staged in shared memory by plain 16-byte loads, with a barrier between the
// four phases of each kv tile (load, scores, softmax, PV), so loads and math
// do not overlap; wgmma, TMA and a multi-stage pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr float NEG = -1e30f;

template <typename T>
constexpr bool is_bf16 = std::is_same<T, __nv_bfloat16>::value;

// q and kv tile rows: 64 for bf16 (wmma's 16-row steps), 32 for float32,
// whose fp32 tiles are twice as large
template <typename T>
constexpr int BQ = is_bf16<T> ? 64 : 32;
template <typename T>
constexpr int BKV = is_bf16<T> ? 64 : 32;

__host__ __device__ inline size_t align128(size_t x) {
  return (x + 127) & ~static_cast<size_t>(127);
}

// Shared-memory geometry for one dtype and head dim D.  bf16 tiles are D
// rounded up to wmma's 16-wide step (the extra columns hold zeros), with 8
// elements of row padding; float32 tiles have an odd row stride (D + 1), so
// that threads over kv rows read distinct banks.  Every region starts on a
// 128-byte boundary (wmma wants 256-bit aligned fragment pointers).
template <typename T>
struct Geometry {
  int dp;    // staged width of a Q/K/V row
  int ldt;   // row stride of the Q, K and V tiles, elements
  int lds;   // row stride of the fp32 scores
  int ldp;   // row stride of the bf16 probabilities
  int lda;   // row stride of the fp32 output accumulator
  size_t off_k, off_v, off_s, off_p, off_acc, off_stats, bytes;

  __host__ __device__ explicit Geometry(int D) {
    dp = is_bf16<T> ? (D + 15) / 16 * 16 : D;
    ldt = is_bf16<T> ? dp + 8 : D + 1;
    lds = BKV<T> + 4;
    ldp = BKV<T> + 8;
    lda = is_bf16<T> ? dp + 4 : D;
    size_t o = align128(sizeof(T) * BQ<T> * ldt);
    off_k = o;
    o += align128(sizeof(T) * BKV<T> * ldt);
    off_v = o;
    o += align128(sizeof(T) * BKV<T> * ldt);
    off_s = o;
    o += align128(sizeof(float) * BQ<T> * lds);
    off_p = o;   // float32 writes its probabilities over the scores
    o += is_bf16<T> ? align128(sizeof(T) * BQ<T> * ldp) : 0;
    off_acc = o;
    o += align128(sizeof(float) * BQ<T> * lda);
    off_stats = o;   // m, l: [BQ] each
    o += align128(sizeof(float) * 2 * BQ<T>);
    bytes = o;
  }
};

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Stage rows [0, n) of a [*, D] row-major slice into a [rows, dp] tile of
// row stride ld; rows >= n and columns >= D are zero, so padded keys, values
// and head dims add nothing (and no uninitialised NaN reaches a product).
// D % 8 == 0 and 16-byte aligned rows let every thread move 16 bytes.
template <typename T>
__device__ void load_tile(T* dst, const T* __restrict__ src, int n, int rows,
                          int D, int dp, int ld) {
  constexpr int VEC = 16 / sizeof(T);
  const int per_row = dp / VEC;
  for (int i = threadIdx.x; i < rows * per_row; i += NTHREADS) {
    const int r = i / per_row, c = (i % per_row) * VEC;
    uint4 word = make_uint4(0u, 0u, 0u, 0u);
    if (r < n && c < D)
      word = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * D + c);
    if constexpr (is_bf16<T>) {
      *reinterpret_cast<uint4*>(dst + r * ld + c) = word;   // ld % 8 == 0
    } else {
      const float* f = reinterpret_cast<const float*>(&word);
#pragma unroll
      for (int e = 0; e < VEC; ++e) dst[r * ld + c + e] = f[e];
    }
  }
}

// S = Q K^T for one kv tile, unscaled fp32, into ss [BQ, lds]
template <typename T>
__device__ void scores(const T* qs, const T* ks, float* ss, const Geometry<T>& g) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if constexpr (is_bf16<T>) {
    constexpr int TK = BKV<T> / 16;
    for (int t = warp; t < (BQ<T> / 16) * TK; t += NWARPS) {
      const int ti = t / TK, tj = t % TK;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.f);
      for (int k = 0; k < g.dp; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
        wmma::load_matrix_sync(a, qs + 16 * ti * g.ldt + k, g.ldt);
        // K^T column-major is K row-major: column j of K^T is row j of K
        wmma::load_matrix_sync(b, ks + 16 * tj * g.ldt + k, g.ldt);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(ss + 16 * ti * g.lds + 16 * tj, c, g.lds,
                              wmma::mem_row_major);
    }
  } else {
    // lanes over the 32 keys (odd K row stride: distinct banks), warps over
    // rows; the Q element is a broadcast
    constexpr int RPW = BQ<T> / NWARPS;
    float acc[RPW];
#pragma unroll
    for (int u = 0; u < RPW; ++u) acc[u] = 0.f;
    const int D = g.dp;
    for (int d = 0; d < D; ++d) {
      const float kv = ks[lane * g.ldt + d];
#pragma unroll
      for (int u = 0; u < RPW; ++u)
        acc[u] = fmaf(qs[(warp + NWARPS * u) * g.ldt + d], kv, acc[u]);
    }
#pragma unroll
    for (int u = 0; u < RPW; ++u) ss[(warp + NWARPS * u) * g.lds + lane] = acc[u];
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

// The online-softmax update of one kv tile, one row per warp at a time:
// masked keys get p = 0, m and l move on, the accumulator row is rescaled
// by alpha, and the probabilities go to ps (bf16, rounded) or back over the
// scores (float32).
template <typename T>
__device__ void softmax_update(float* ss, T* ps, float* acc, float* m, float* l,
                               const Geometry<T>& g, int q0, int k0, int S,
                               int W, float scale) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int PER_LANE = BKV<T> / 32;
  const int acc_w = is_bf16<T> ? g.dp : g.lda;
  for (int r = warp; r < BQ<T>; r += NWARPS) {
    const int i = q0 + r;
    float s[PER_LANE];
    bool ok[PER_LANE];
    float mc = NEG;
#pragma unroll
    for (int u = 0; u < PER_LANE; ++u) {
      const int c = lane + 32 * u, j = k0 + c;
      ok[u] = i < S && j < S && j <= i && j > i - W;
      s[u] = ok[u] ? ss[r * g.lds + c] * scale : NEG;
      mc = fmaxf(mc, s[u]);
    }
    mc = warp_max(mc);
    const float m_old = m[r];
    const float m_new = fmaxf(m_old, mc);
    const float alpha = expf(m_old - m_new);
    float sum = 0.f;
#pragma unroll
    for (int u = 0; u < PER_LANE; ++u) {
      const int c = lane + 32 * u;
      const float p = ok[u] ? expf(s[u] - m_new) : 0.f;
      sum += p;
      if constexpr (is_bf16<T>)
        ps[r * g.ldp + c] = __float2bfloat16(p);
      else
        ss[r * g.lds + c] = p;
    }
    sum = warp_sum(sum);   // every lane has read m[r] before lane 0 writes
    if (lane == 0) {
      m[r] = m_new;
      l[r] = l[r] * alpha + sum;
    }
    for (int d = lane; d < acc_w; d += 32) acc[r * g.lda + d] *= alpha;
  }
}

// acc += P V for one kv tile
template <typename T>
__device__ void pv(const float* ss, const T* ps, const T* vs, float* acc,
                   const Geometry<T>& g) {
  if constexpr (is_bf16<T>) {
    const int warp = threadIdx.x / 32;
    const int td = g.dp / 16;
    for (int t = warp; t < (BQ<T> / 16) * td; t += NWARPS) {
      const int ti = t / td, tj = t % td;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      float* tile = acc + 16 * ti * g.lda + 16 * tj;
      wmma::load_matrix_sync(c, tile, g.lda, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BKV<T>; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(a, ps + 16 * ti * g.ldp + kk, g.ldp);
        wmma::load_matrix_sync(b, vs + kk * g.ldt + 16 * tj, g.ldt);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(tile, c, g.lda, wmma::mem_row_major);
    }
  } else {
    // threads over (row, d): neighbouring d read neighbouring V words
    const int D = g.lda;
    for (int idx = threadIdx.x; idx < BQ<T> * D; idx += NTHREADS) {
      const int r = idx / D, d = idx % D;
      float x = acc[r * g.lda + d];
#pragma unroll 8
      for (int c = 0; c < BKV<T>; ++c) x = fmaf(ss[r * g.lds + c], vs[c * g.ldt + d], x);
      acc[r * g.lda + d] = x;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1)
swa_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ out, int H, int KV, int S, int D, int W, float scale) {
  const Geometry<T> g(D);
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = reinterpret_cast<T*>(smem + g.off_k);
  T* vs = reinterpret_cast<T*>(smem + g.off_v);
  float* ss = reinterpret_cast<float*>(smem + g.off_s);
  T* ps = reinterpret_cast<T*>(smem + g.off_p);
  float* acc = reinterpret_cast<float*>(smem + g.off_acc);
  float* m = reinterpret_cast<float*>(smem + g.off_stats);
  float* l = m + BQ<T>;

  const int q0 = blockIdx.x * BQ<T>;
  const int bh = blockIdx.y;   // b * H + h
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const size_t kv_off = (static_cast<size_t>(b) * KV + kvh) * S * D;
  const int nq = min(BQ<T>, S - q0);

  load_tile(qs, q + (static_cast<size_t>(bh) * S + q0) * D, nq, BQ<T>, D, g.dp, g.ldt);
  for (int i = threadIdx.x; i < BQ<T> * g.lda; i += NTHREADS) acc[i] = 0.f;
  for (int i = threadIdx.x; i < BQ<T>; i += NTHREADS) {
    m[i] = NEG;
    l[i] = 0.f;
  }

  // the window of row q0 starts at q0 - W + 1; the tile's last row ends on
  // the diagonal (or at S)
  const int kt_lo = max(0, q0 - W + 1) / BKV<T>;
  const int kt_hi = (min(S, q0 + BQ<T>) - 1) / BKV<T>;
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BKV<T>;
    const int nk = min(BKV<T>, S - k0);
    load_tile(ks, k + kv_off + static_cast<size_t>(k0) * D, nk, BKV<T>, D, g.dp, g.ldt);
    load_tile(vs, v + kv_off + static_cast<size_t>(k0) * D, nk, BKV<T>, D, g.dp, g.ldt);
    __syncthreads();
    scores(qs, ks, ss, g);
    __syncthreads();
    softmax_update(ss, ps, acc, m, l, g, q0, k0, S, W, scale);
    __syncthreads();
    pv(ss, ps, vs, acc, g);
    __syncthreads();   // before the next tile overwrites K, V and P
  }

  T* o = out + (static_cast<size_t>(bh) * S + q0) * D;
  for (int idx = threadIdx.x; idx < nq * D; idx += NTHREADS) {
    const int r = idx / D, d = idx % D;
    const float lr = l[r];
    o[static_cast<size_t>(r) * D + d] = from_float<T>(acc[r * g.lda + d] / (lr == 0.f ? 1.f : lr));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B, int H,
           int KV, int S, int D, int W, float scale, cudaStream_t stream) {
  const Geometry<T> g(D);
  if (g.bytes > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = swa_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(g.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ<T> - 1) / BQ<T>, B * H);
  kernel<<<grid, NTHREADS, g.bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), H, KV, S, D, W, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q and out [B, H, S, D], k and v [B, KV, S, D], all of one dtype (0 float32,
// 1 bfloat16), contiguous and 16-byte aligned; H % KV == 0, D % 8 == 0 and
// D <= 256, window >= 1.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); a shape it does not take returns
// cudaErrorInvalidValue without launching.
extern "C" int swa_attention(const void* q, const void* k, const void* v, void* out,
                             int B, int H, int KV, int S, int D, int window, float scale,
                             int dtype, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || S <= 0 || D <= 0 || D % 8 != 0 ||
      D > 256 || window < 1 || static_cast<long long>(B) * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, out, B, H, KV, S, D, window, scale, s);
  if (dtype == 1) return launch<__nv_bfloat16>(q, k, v, out, B, H, KV, S, D, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
