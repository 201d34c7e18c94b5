// Nonzero-granular SELL-C-sigma SpMM with a fused epilogue, for sm_90a.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   K2 spmm_sell_kernel           (src/repro/kernels/spmm/sell.py:66)
//   K6 spmm_sell_epilogue_kernel  (src/repro/kernels/fused/spmm.py:207)
// K2 is this kernel with act = identity and no bias or residual.
//
//   Y[r, :] = act(sum_{k < nnz[r]} vals[s_r + k] * H[cols[s_r + k], :]
//                 + bias + res_perm[r, :]),   s_r = row_slot[r],
// for every row r of the compact output (n_live * bm rows, the live
// block-rows of the packed order; the caller un-permutes it).  Rows with
// no nonzeros, padding rows included, are written as act(bias + res).
//
// What bounds it on an H100: bytes.  A row's nonzeros are the first slots
// of its packed row, in ascending column, so the work the data needs is
// one multiply-add per nonzero and column of H: the row arrays, the
// nonzeros' columns and values, H and Y, each once, are a few MB at the
// serving shapes, and the arithmetic is far below the FP32 peak.  The TPU
// kernel multiplied dense 64 x 64 tiles holding a few nonzeros each; this
// one touches no tile at all.
// The design: a group of L lanes owns one output row (L = 32 at D >= 128,
// D/4 below that, so a warp holds 32/L rows), and its lanes run across D
// with 16-byte loads of H's rows (a scalar path where D % 4 != 0 or a
// pointer is not 16-byte aligned).  The group loads its row's (col, val)
// pairs 32 at a time, coalesced, and hands them out with __shfl_sync; H
// goes through the read-only path (__ldg), and at the serving shapes it
// stays in the 50 MB L2, so the gathers of H's rows are the floor.  A
// gather waits on L2, so each lane issues kBatch of them before it adds
// any.  Each lane sums its nonzeros in ascending column order with f32
// fmaf (no TF32), so a light row's sum adds the same nonzero terms in the
// same order as the tile-granular plain version; the epilogue is applied
// in registers before the only store.  Rows of a packed slice have similar
// counts (SELL's sigma sort), so the lanes of a warp stay together.
// Heavy rows: graph rows are skewed (one of 1,057 nonzeros where the mean
// is 17), and one group summing such a row alone would set the kernel's
// time.  Rows above heavy_nnz (listed at packing, SellCS.tile_heavy_rows)
// get a CTA each: its groups sum contiguous chunks of the row, and the
// partial sums are added in chunk order through shared memory.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kActRelu = 1;
constexpr int kActLeakyRelu = 2;

__device__ __forceinline__ float apply_act(float z, int act, float slope) {
  if (act == kActRelu) return fmaxf(z, 0.f);
  if (act == kActLeakyRelu) return z >= 0.f ? z : slope * z;
  return z;
}

// W columns per lane and load: float4 (W = 4) or float (W = 1).
template <int W>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
  __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static T load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ static void fma(float a, const T& x, T& acc) {
    acc.x = fmaf(a, x.x, acc.x);
    acc.y = fmaf(a, x.y, acc.y);
    acc.z = fmaf(a, x.z, acc.z);
    acc.w = fmaf(a, x.w, acc.w);
  }
  __device__ static float get(const T& v, int c) {
    return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
  }
  __device__ static void set(T& v, int c, float z) {
    if (c == 0) v.x = z;
    else if (c == 1) v.y = z;
    else if (c == 2) v.z = z;
    else v.w = z;
  }
  __device__ static void store(float* p, const T& v) {
    *reinterpret_cast<float4*>(p) = v;
  }
};
template <>
struct Vec<1> {
  using T = float;
  __device__ static T zero() { return 0.f; }
  __device__ static T load(const float* p) { return __ldg(p); }
  __device__ static void fma(float a, const T& x, T& acc) {
    acc = fmaf(a, x, acc);
  }
  __device__ static float get(const T& v, int) { return v; }
  __device__ static void set(T& v, int, float z) { v = z; }
  __device__ static void store(float* p, const T& v) { *p = v; }
};

// Loads in flight per lane: each batch first fetches kBatch rows of H,
// then adds them in order, so a lane waits on L2 once per batch and not
// once per nonzero.
constexpr int kBatch = 8;

// acc += the row's nonzeros lo..hi-1 (slots slot + k), in ascending k,
// each lane over its W columns at col; the pairs are read by every lane
// of the group (one broadcast load each).
template <int W>
__device__ __forceinline__ void sum_slots(
    const int* __restrict__ cols, const float* __restrict__ vals,
    const float* __restrict__ h, int slot, int lo, int hi, int col, int d,
    typename Vec<W>::T& acc) {
  using V = Vec<W>;
  const size_t ld = static_cast<size_t>(d);
  for (int k0 = lo; k0 < hi; k0 += kBatch) {
    int c[kBatch];
    float v[kBatch];
    typename V::T x[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const bool ok = k0 + b < hi;
      c[b] = ok ? __ldg(cols + slot + k0 + b) : 0;
      v[b] = ok ? __ldg(vals + slot + k0 + b) : 0.f;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      x[b] = k0 + b < hi && col < d
                 ? V::load(h + static_cast<size_t>(c[b]) * ld + col)
                 : V::zero();
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (k0 + b < hi) V::fma(v[b], x[b], acc);
  }
}

// act(acc + bias + res) stored at row, columns col .. col + W - 1.
template <int W>
__device__ __forceinline__ void finish(typename Vec<W>::T acc, int row,
                                       int col, int d,
                                       const float* __restrict__ bias,
                                       const float* __restrict__ res,
                                       float* __restrict__ y, int act,
                                       float slope) {
  using V = Vec<W>;
  const size_t at = static_cast<size_t>(row) * d + col;
  typename V::T extra = V::zero();
  if (res != nullptr) extra = V::load(res + at);
#pragma unroll
  for (int c = 0; c < W; ++c) {
    float z = V::get(acc, c);
    if (bias != nullptr) z += __ldg(bias + col + c);
    if (res != nullptr) z += V::get(extra, c);
    V::set(acc, c, apply_act(z, act, slope));
  }
  V::store(y + at, acc);
}

// Light rows (at most heavy_nnz nonzeros): one group of L lanes per output
// row, 32 / L rows per warp.  Every lane of a warp runs the same number
// of shuffle steps (the warp's largest light count), so the shuffles see
// the full mask; a lane adds a term only for its own row's nonzeros.
template <int L, int W>
__device__ __forceinline__ void light_rows(
    int block, const int* __restrict__ row_slot,
    const int* __restrict__ row_nnz,
    const int* __restrict__ cols, const float* __restrict__ vals,
    const float* __restrict__ h, const float* __restrict__ bias,
    const float* __restrict__ res, float* __restrict__ y, int n_rows,
    int d, int heavy_nnz, int act, float slope) {
  using V = Vec<W>;
  constexpr int P = 32 / L;  // pairs each lane holds per round of 32
  const int lane = threadIdx.x & 31;
  const int sub = lane % L;
  const int warp = (block * kThreads + threadIdx.x) >> 5;
  const int row = warp * P + lane / L;
  const int count = row < n_rows ? row_nnz[row] : 0;
  const bool mine = row < n_rows && count <= heavy_nnz;  // else: a CTA's
  const int nnz = mine ? count : 0;
  const int slot = mine ? row_slot[row] : 0;
  const int nnz_max = __reduce_max_sync(kFull, nnz);
  const size_t ld = static_cast<size_t>(d);

  for (int c0 = 0; c0 < d; c0 += L * W) {
    const int col = c0 + sub * W;
    typename V::T acc = V::zero();
    for (int base = 0; base < nnz_max; base += 32) {
      int cq[P];
      float vq[P];
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const int k = base + q * L + sub;
        cq[q] = k < nnz ? __ldg(cols + slot + k) : 0;
        vq[q] = k < nnz ? __ldg(vals + slot + k) : 0.f;
      }
      const int n_round = min(32, nnz_max - base);
#pragma unroll
      for (int j0 = 0; j0 < 32; j0 += kBatch) {
        if (j0 >= n_round) break;  // warp-uniform
        int c[kBatch];
        float v[kBatch];
        typename V::T x[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int j = j0 + b;
          c[b] = __shfl_sync(kFull, cq[j / L], j % L, L);
          v[b] = __shfl_sync(kFull, vq[j / L], j % L, L);
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b)
          x[b] = base + j0 + b < nnz && col < d
                     ? V::load(h + static_cast<size_t>(c[b]) * ld + col)
                     : V::zero();
#pragma unroll
        for (int b = 0; b < kBatch; ++b)
          if (base + j0 + b < nnz) V::fma(v[b], x[b], acc);
      }
    }
    if (mine && col < d) finish<W>(acc, row, col, d, bias, res, y, act,
                                   slope);
  }
}

// One heavy row for the whole CTA: its kThreads / L groups each sum one
// contiguous chunk of the nonzeros, then the chunks' partial sums are
// added in chunk order through shared memory (a fixed order, so the
// result does not change from run to run).
template <int L, int W>
__device__ __forceinline__ void heavy_row(
    int row, const int* __restrict__ row_slot,
    const int* __restrict__ row_nnz, const int* __restrict__ cols,
    const float* __restrict__ vals, const float* __restrict__ h,
    const float* __restrict__ bias, const float* __restrict__ res,
    float* __restrict__ y, int d, int act, float slope) {
  using V = Vec<W>;
  constexpr int G = kThreads / L;  // chunks
  constexpr int C = L * W;         // columns per pass
  __shared__ float part[G][C];
  const int g = threadIdx.x / L;
  const int sub = threadIdx.x % L;
  const int nnz = row_nnz[row];
  const int slot = row_slot[row];
  const int chunk = (nnz + G - 1) / G;
  const int lo = min(nnz, g * chunk);
  const int hi = min(nnz, lo + chunk);

  for (int c0 = 0; c0 < d; c0 += C) {
    typename V::T acc = V::zero();
    sum_slots<W>(cols, vals, h, slot, lo, hi, c0 + sub * W, d, acc);
#pragma unroll
    for (int c = 0; c < W; ++c) part[g][sub * W + c] = V::get(acc, c);
    __syncthreads();
    for (int t = threadIdx.x; t < C && c0 + t < d; t += kThreads) {
      float z = 0.f;
      for (int k = 0; k < G; ++k) z += part[k][t];
      finish<1>(z, row, c0 + t, d, bias, res, y, act, slope);
    }
    __syncthreads();
  }
}

// The first n_heavy blocks own one heavy row each, so their long sums
// start first and overlap the light rows; each block after them owns
// kThreads / L consecutive rows.  The launch bound asks two CTAs per SM
// (at most 128 registers): the gathers wait on L2, and more warps in
// flight hide more of that wait than registers for a longer batch.  At
// L <= 2 (D <= 8) a lane holds 16 or 32 pairs, which do not fit in 128
// registers, so those instances ask one.
template <int L, int W>
__global__ void __launch_bounds__(kThreads, L >= 4 ? 2 : 1)
    spmm_sell_rows_kernel(const int* __restrict__ row_slot,
                          const int* __restrict__ row_nnz,
                          const int* __restrict__ heavy_rows,
                          const int* __restrict__ cols,
                          const float* __restrict__ vals,
                          const float* __restrict__ h,
                          const float* __restrict__ bias,
                          const float* __restrict__ res,
                          float* __restrict__ y, int n_rows, int n_heavy,
                          int heavy_nnz, int d, int act, float slope) {
  const int block = static_cast<int>(blockIdx.x);
  if (block < n_heavy)
    heavy_row<L, W>(heavy_rows[block], row_slot, row_nnz, cols, vals, h,
                    bias, res, y, d, act, slope);
  else
    light_rows<L, W>(block - n_heavy, row_slot, row_nnz, cols, vals, h,
                     bias, res, y, n_rows, d, heavy_nnz, act, slope);
}

struct Args {
  const int* row_slot;
  const int* row_nnz;
  const int* heavy_rows;
  const int* cols;
  const float* vals;
  const float* h;
  const float* bias;
  const float* res;
  float* y;
  int n_rows, n_heavy, heavy_nnz, d, act;
  float slope;
  cudaStream_t stream;
};

template <int L, int W>
cudaError_t launch(const Args& a) {
  constexpr int rows_per_block = kThreads / L;
  const int n_light = (a.n_rows + rows_per_block - 1) / rows_per_block;
  spmm_sell_rows_kernel<L, W><<<n_light + a.n_heavy, kThreads, 0,
                                a.stream>>>(
      a.row_slot, a.row_nnz, a.heavy_rows, a.cols, a.vals, a.h, a.bias,
      a.res, a.y, a.n_rows, a.n_heavy, a.heavy_nnz, a.d, a.act, a.slope);
  return cudaGetLastError();
}

// Lanes per row: the fewest powers of two that cover d / W columns, at
// most a warp (wider rows loop over column passes of 32 * W).
template <int W>
cudaError_t dispatch(const Args& a) {
  const int need = (a.d + W - 1) / W;
  if (need <= 1) return launch<1, W>(a);
  if (need <= 2) return launch<2, W>(a);
  if (need <= 4) return launch<4, W>(a);
  if (need <= 8) return launch<8, W>(a);
  if (need <= 16) return launch<16, W>(a);
  return launch<32, W>(a);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// row_slot, row_nnz int32[n_rows]: first slot and nonzero count of each
// compact output row; heavy_rows int32[n_heavy]: exactly the rows with
// more than heavy_nnz nonzeros (each gets a CTA); cols int32[S] (each <
// the rows of h), vals f32[S]; h f32[n, d]; bias f32[d] or null;
// res f32[n_rows, d] or null; y f32[n_rows, d].
// Returns the cudaError_t of the launch.
extern "C" int spmm_sell_f32(const int* row_slot, const int* row_nnz,
                             const int* heavy_rows, const int* cols,
                             const float* vals, const float* h,
                             const float* bias, const float* res, float* y,
                             int n_rows, int n_heavy, int heavy_nnz, int d,
                             int act, float slope, void* stream) {
  if (n_rows == 0 || d == 0) return cudaSuccess;
  const Args a{row_slot, row_nnz,   heavy_rows, cols,
               vals,     h,         bias,       res,
               y,        n_rows,    n_heavy,    heavy_nnz,
               d,        act,       slope,      static_cast<cudaStream_t>(stream)};
  const bool vec = d % 4 == 0 && aligned16(h) && aligned16(y) &&
                   (res == nullptr || aligned16(res));
  return static_cast<int>(vec ? dispatch<4>(a) : dispatch<1>(a));
}
