// SDDMM for sm_90a: Block-COO tiles (K3) and SELL-C-sigma slots (K4).
//
// Replaces two Pallas TPU kernels of the JAX package:
//   K3 sddmm_blockcoo_kernel  (src/repro/kernels/sddmm/kernel.py:52)
//   K4 sddmm_sell_kernel      (src/repro/kernels/sddmm/sell.py:58)
//
// K3, for every listed tile t of a Block-COO operand (B [Mp, K]):
//
//   Y[t] = round(mask[t] * round(B[rows[t]-block, :] @ C[:, cols[t]-block]))
//
// with A's values as the mask (a weighted mask is allowed), or with no mask
// (a null pointer): then every cell of each tile is sampled, which is what
// the ones array the ELL path used to build per call gave, bit for bit
// (1.0f * acc == acc).  round is the output dtype's rounding; the dot is
// rounded before the mask multiplies it (a no-op in f32), so one weighted
// launch equals the unweighted launch followed by values * dots in f32,
// rounded once, in every dtype.  B and C share one element type TB, the
// mask and Y another, TO (f32, bf16 or f16 each; the wrapper widens a
// mixed pair, exactly); dots sum in f32 with fmaf from 0 in ascending K.
//
// What bounds it on an H100: bytes.  At GAT's K = 2 an output element
// costs 2 multiply-adds against 4 bytes written (8 with a mask read), far
// below the card's ~20 FLOP per byte, and B and C (K * 64 KB a side on the
// serving graph) stay in L2: the time is the tiles out and the mask in.
// The first design was one CTA per 64 x 64 tile that staged B and C
// through shared memory behind two barriers per 16-wide K chunk, stored
// 4-byte scalars and always read a mask.  Now two kernels:
//  - sddmm_stream_kernel (K <= 16, tile rows of whole 16-byte vectors,
//    16-byte aligned pointers): no shared memory and no barrier.  Each
//    thread owns 16-byte vectors of output (VEC elements of one tile row)
//    and reads its B row and VEC columns of C, K values each, straight into
//    registers through the read-only path (L1 / L2 hits); a warp stores 512
//    contiguous bytes at once, with streaming stores (st.global.cs: nothing
//    re-reads the tiles), and reads the mask with 16-byte streaming loads.
//    A grid-stride loop over tiles with the CTAs the SMs hold at once lets
//    one tile's stores drain while the next tile's loads issue.
//  - sddmm_staged_kernel (any other K or tile): that first loop, one CTA per
//    tile, a (bm x 16) slice of B and a (16 x bn) slice of C staged
//    through shared memory per K chunk, each thread R x R elements (rows
//    ty + 16 i, columns tx + 16 j, R up to 8 = bm, bn up to 128), now with
//    native element types, the optional mask and streaming stores.  The
//    last K chunk is ragged and masked, so any K >= 1 works (the Pallas
//    wrapper needed K % bk == 0 and fell back to bk = K).
// Both sum each dot in the same order, so they agree bit for bit.
//
// K4 (sddmm_slots_kernel), the raw dots at the structural nonzeros of a
// SELL packing, in slot order:
//
//   y[row_slot[r] + j] = B[perm[r], :] . C[:, cols[row_slot[r] + j]]
//   for every compact row r and j < row_nnz[r]
//
// (the row view built once at packing: a row's nonzeros are the first
// slots of its packed row; perm gives its logical row of B).  Other slots,
// padding and those of pruned slices, are left to the caller, which
// zeroes y.  The Pallas kernel multiplied a dense 64 x 64 tile per live
// tile, ~4.6 nonzeros each on a skewed graph, behind a 0/1 tile mask and
// into a tile output that the caller gathered back to slots: a GB each way
// at 16384 nodes.  What bounds K4 on an H100: bytes, and only a few MB of
// them: the row arrays, each nonzero's column and dot, B and C (K = 2:
// 2 multiply-adds per nonzero).  One warp owns a row: it reads the row's
// B once (into registers when K is 2), its lanes stride over the row's
// nonzeros kSlotBatch at a time (that many column loads, then that many
// C-column gathers, in flight per lane: the gathers wait on L2), and each
// dot is summed over K in ascending order with fmaf from 0, as K3's tile
// loop does, so a dot equals the tile kernel's element bit for bit.  SELL
// orders its buckets by ascending width, so the heaviest rows are the last
// compact rows: the warps walk the rows from the last, and those start
// first.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  __device__ static float to_f(float x) { return x; }
  __device__ static float from_f(float x) { return x; }
};

template <>
struct Elem<__nv_bfloat16> {
  __device__ static float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 from_f(float x) {
    return __float2bfloat16_rn(x);
  }
};

template <>
struct Elem<__half> {
  __device__ static float to_f(__half x) { return __half2float(x); }
  __device__ static __half from_f(float x) { return __float2half_rn(x); }
};

// x rounded to T, back in f32
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return Elem<T>::to_f(Elem<T>::from_f(x));
}

// The output element: the dot rounded to TO, times the mask, rounded once.
template <typename TO, bool MASK>
__device__ __forceinline__ TO sample(float acc, TO m) {
  if constexpr (MASK)
    return Elem<TO>::from_f(Elem<TO>::to_f(m) * round_to<TO>(acc));
  else
    return Elem<TO>::from_f(acc);
}

// An unsigned type of B bytes, for vector loads and stores.
template <int B>
struct Bits;
template <>
struct Bits<16> {
  using type = uint4;
};
template <>
struct Bits<8> {
  using type = uint2;
};
template <>
struct Bits<4> {
  using type = unsigned int;
};
template <>
struct Bits<2> {
  using type = unsigned short;
};

// N elements of T at p (aligned to their size) through the read-only path.
template <typename T, int N>
__device__ __forceinline__ void ldg_vec(const T* p, T (&v)[N]) {
  using B = typename Bits<sizeof(T) * N>::type;
  const B raw = __ldg(reinterpret_cast<const B*>(p));
  memcpy(v, &raw, sizeof raw);
}

// Streaming load and store (.cs: evict first, nothing reads them again).
template <typename T, int N>
__device__ __forceinline__ void ldcs_vec(const T* p, T (&v)[N]) {
  using B = typename Bits<sizeof(T) * N>::type;
  const B raw = __ldcs(reinterpret_cast<const B*>(p));
  memcpy(v, &raw, sizeof raw);
}

template <typename T, int N>
__device__ __forceinline__ void stcs_vec(T* p, const T (&v)[N]) {
  using B = typename Bits<sizeof(T) * N>::type;
  B raw;
  memcpy(&raw, v, sizeof raw);
  __stcs(reinterpret_cast<B*>(p), raw);
}

constexpr int kStreamMaxK = 16;

// Output elements per 16-byte vector: the wider of TB and TO sets it, so
// that VEC columns of C are at most 16 bytes too.
template <typename TB, typename TO>
constexpr int kVec = 16 / (sizeof(TB) > sizeof(TO) ? sizeof(TB) : sizeof(TO));

template <typename TB, typename TO, bool MASK>
__global__ void __launch_bounds__(kThreads)
    sddmm_stream_kernel(const int* __restrict__ rows,
                        const int* __restrict__ cols,
                        const TO* __restrict__ mask,
                        const TB* __restrict__ b, const TB* __restrict__ c,
                        TO* __restrict__ y, int n_tiles, int bm, int bn, int k,
                        int n) {
  constexpr int VEC = kVec<TB, TO>;
  const int vpr = bn / VEC;  // vectors per tile row
  const int nvec = bm * vpr;
  // this thread's first vector (row r0, vector v0 of it) and the step of
  // kThreads vectors as (rows, vectors)
  const int r0 = static_cast<int>(threadIdx.x) / vpr;
  const int v0 = static_cast<int>(threadIdx.x) - r0 * vpr;
  const int dr = kThreads / vpr;
  const int dv = kThreads - dr * vpr;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const TB* btile = b + static_cast<size_t>(rows[t]) * bm * k;
    const TB* ctile = c + static_cast<size_t>(cols[t]) * bn;
    const size_t tile0 = static_cast<size_t>(t) * bm * bn;
    int r = r0, v = v0;
    for (int e = threadIdx.x; e < nvec; e += kThreads) {
      const int col = v * VEC;
      const TB* brow = btile + static_cast<size_t>(r) * k;
      float acc[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < k; ++kk) {
        TB bv[1], cv[VEC];
        ldg_vec(brow + kk, bv);
        ldg_vec(ctile + static_cast<size_t>(kk) * n + col, cv);
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          acc[i] = fmaf(Elem<TB>::to_f(bv[0]), Elem<TB>::to_f(cv[i]), acc[i]);
      }
      const size_t at = tile0 + static_cast<size_t>(r) * bn + col;
      TO m[VEC] = {}, out[VEC];
      if constexpr (MASK) ldcs_vec(mask + at, m);
#pragma unroll
      for (int i = 0; i < VEC; ++i) out[i] = sample<TO, MASK>(acc[i], m[i]);
      stcs_vec(y + at, out);
      r += dr;
      v += dv;
      if (v >= vpr) {
        v -= vpr;
        ++r;
      }
    }
  }
}

constexpr int kSide = 16;  // the staged kernel's thread grid is kSide^2
constexpr int kBK = 16;    // K chunk staged per step
constexpr int kMaxR = 8;   // elements a thread owns per side: 128 / kSide

template <typename TB, typename TO, bool MASK>
__global__ void __launch_bounds__(kThreads)
    sddmm_staged_kernel(const int* __restrict__ rows,
                        const int* __restrict__ cols,
                        const TO* __restrict__ mask,
                        const TB* __restrict__ b, const TB* __restrict__ c,
                        TO* __restrict__ y, int bm, int bn, int k, int n) {
  __shared__ float Bs[kMaxR * kSide][kBK + 1];
  __shared__ float Cs[kBK][kMaxR * kSide];
  const int t = blockIdx.x;
  const int tx = threadIdx.x % kSide;
  const int ty = threadIdx.x / kSide;
  const int ri = (bm + kSide - 1) / kSide;  // rows ty + 16 i, i < ri
  const int rj = (bn + kSide - 1) / kSide;  // columns tx + 16 j, j < rj
  const size_t brow0 = static_cast<size_t>(rows[t]) * bm;
  const size_t ccol0 = static_cast<size_t>(cols[t]) * bn;

  float acc[kMaxR][kMaxR];
#pragma unroll
  for (int i = 0; i < kMaxR; ++i)
#pragma unroll
    for (int j = 0; j < kMaxR; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kBK) {
    const int kc = min(kBK, k - k0);
    for (int e = threadIdx.x; e < bm * kc; e += kThreads) {
      const int r = e / kc;
      const int kk = e - r * kc;
      Bs[r][kk] = Elem<TB>::to_f(b[(brow0 + r) * k + k0 + kk]);
    }
    for (int e = threadIdx.x; e < kc * bn; e += kThreads) {
      const int kk = e / bn;
      const int col = e - kk * bn;
      Cs[kk][col] =
          Elem<TB>::to_f(c[static_cast<size_t>(k0 + kk) * n + ccol0 + col]);
    }
    __syncthreads();
    for (int kk = 0; kk < kc; ++kk) {
      float bv[kMaxR], cv[kMaxR];
#pragma unroll
      for (int i = 0; i < kMaxR; ++i) {
        const int r = ty + i * kSide;
        bv[i] = i < ri && r < bm ? Bs[r][kk] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kMaxR; ++j) {
        const int col = tx + j * kSide;
        cv[j] = j < rj && col < bn ? Cs[kk][col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kMaxR; ++i)
#pragma unroll
        for (int j = 0; j < kMaxR; ++j)
          if (i < ri && j < rj) acc[i][j] = fmaf(bv[i], cv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const size_t tile0 = static_cast<size_t>(t) * bm * bn;
#pragma unroll
  for (int i = 0; i < kMaxR; ++i) {
    const int r = ty + i * kSide;
    if (i >= ri || r >= bm) continue;
#pragma unroll
    for (int j = 0; j < kMaxR; ++j) {
      const int col = tx + j * kSide;
      if (j >= rj || col >= bn) continue;
      const size_t at = tile0 + static_cast<size_t>(r) * bn + col;
      TO m[1] = {}, out[1];
      if constexpr (MASK) ldcs_vec(mask + at, m);
      out[0] = sample<TO, MASK>(acc[i][j], m[0]);
      stcs_vec(y + at, out);
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename TB, typename TO, bool MASK>
cudaError_t launch_tiles(const int* rows, const int* cols, const void* mask,
                         const void* b, const void* c, void* y, int n_tiles,
                         int bm, int bn, int k, int n, cudaStream_t stream) {
  const auto* m = static_cast<const TO*>(mask);
  const auto* bp = static_cast<const TB*>(b);
  const auto* cp = static_cast<const TB*>(c);
  auto* yp = static_cast<TO*>(y);
  if (k <= kStreamMaxK && bn % kVec<TB, TO> == 0 && aligned16(c) &&
      aligned16(y) && (!MASK || aligned16(mask))) {
    auto kernel = sddmm_stream_kernel<TB, TO, MASK>;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, 0);
    if (err != cudaSuccess) return err;
    const int grid = std::min(n_tiles, sms * std::max(per_sm, 1));
    kernel<<<grid, kThreads, 0, stream>>>(rows, cols, m, bp, cp, yp, n_tiles,
                                          bm, bn, k, n);
  } else {
    sddmm_staged_kernel<TB, TO, MASK><<<n_tiles, kThreads, 0, stream>>>(
        rows, cols, m, bp, cp, yp, bm, bn, k, n);
  }
  return cudaGetLastError();
}

// The instance for B / C's element type TB (code 0 f32, 1 bf16, 2 f16),
// Y's and the mask's TO, and whether there is a mask.
template <typename TB>
cudaError_t dispatch_out(int out_dtype, bool has_mask, const int* rows,
                         const int* cols, const void* mask, const void* b,
                         const void* c, void* y, int n_tiles, int bm, int bn,
                         int k, int n, cudaStream_t s) {
  const auto run = [&](auto launch) {
    return launch(rows, cols, mask, b, c, y, n_tiles, bm, bn, k, n, s);
  };
  switch (out_dtype) {
    case 0:
      return has_mask ? run(launch_tiles<TB, float, true>)
                      : run(launch_tiles<TB, float, false>);
    case 1:
      return has_mask ? run(launch_tiles<TB, __nv_bfloat16, true>)
                      : run(launch_tiles<TB, __nv_bfloat16, false>);
    case 2:
      return has_mask ? run(launch_tiles<TB, __half, true>)
                      : run(launch_tiles<TB, __half, false>);
  }
  return cudaErrorInvalidValue;
}

constexpr int kSlotBatch = 4;  // nonzeros in flight per lane

// KS: K fixed at compile time (B's row then lives in registers), or 0.
template <int KS>
__global__ void __launch_bounds__(kThreads)
    sddmm_slots_kernel(const int* __restrict__ row_slot,
                       const int* __restrict__ row_nnz,
                       const int* __restrict__ perm,
                       const int* __restrict__ cols,
                       const float* __restrict__ b,
                       const float* __restrict__ c, float* __restrict__ y,
                       int n_rows, int k, int n) {
  const int warp = static_cast<int>(
      (static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x) / 32);
  if (warp >= n_rows) return;
  const int lane = threadIdx.x % 32;
  const int r = n_rows - 1 - warp;  // the heaviest rows first
  const int nnz = row_nnz[r];
  if (nnz == 0) return;
  const int s0 = row_slot[r];
  const float* brow = b + static_cast<size_t>(perm[r]) * k;
  const int kk_n = KS > 0 ? KS : k;
  float breg[KS > 0 ? KS : 1];
  if constexpr (KS > 0) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) breg[kk] = __ldg(brow + kk);
  }
  for (int j0 = lane; j0 < nnz; j0 += 32 * kSlotBatch) {
    int col[kSlotBatch];
    float acc[kSlotBatch];
#pragma unroll
    for (int t = 0; t < kSlotBatch; ++t) {
      const int j = j0 + 32 * t;
      col[t] = j < nnz ? __ldg(cols + s0 + j) : -1;
      acc[t] = 0.f;
    }
#pragma unroll(KS > 0 ? KS : 1)
    for (int kk = 0; kk < kk_n; ++kk) {
      float bv;
      if constexpr (KS > 0)
        bv = breg[kk];
      else
        bv = __ldg(brow + kk);
      const float* crow = c + static_cast<size_t>(kk) * n;
#pragma unroll
      for (int t = 0; t < kSlotBatch; ++t)
        if (col[t] >= 0) acc[t] = fmaf(bv, __ldg(crow + col[t]), acc[t]);
    }
#pragma unroll
    for (int t = 0; t < kSlotBatch; ++t)
      if (col[t] >= 0) y[s0 + j0 + 32 * t] = acc[t];
  }
}

}  // namespace

// rows, cols int32[n_tiles]; mask [n_tiles, bm, bn] in Y's dtype, or null
// (every cell sampled); b [*, k] with rows[t] * bm + bm <= its row count and
// c [k, n] with n a multiple of bn, both of dtype b_dtype; y [n_tiles, bm,
// bn] of dtype out_dtype (codes 0 f32, 1 bf16, 2 f16).  bm, bn <= 128.
// Returns the cudaError_t of the launch.
extern "C" int sddmm_tiles(const int* rows, const int* cols, const void* mask,
                           const void* b, const void* c, void* y, int n_tiles,
                           int bm, int bn, int k, int n, int b_dtype,
                           int out_dtype, void* stream) {
  if (n_tiles == 0) return cudaSuccess;
  if (bm < 1 || bn < 1 || bm > kMaxR * kSide || bn > kMaxR * kSide || k < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool has_mask = mask != nullptr;
  switch (b_dtype) {
    case 0:
      return dispatch_out<float>(out_dtype, has_mask, rows, cols, mask, b, c,
                                 y, n_tiles, bm, bn, k, n, s);
    case 1:
      return dispatch_out<__nv_bfloat16>(out_dtype, has_mask, rows, cols,
                                         mask, b, c, y, n_tiles, bm, bn, k,
                                         n, s);
    case 2:
      return dispatch_out<__half>(out_dtype, has_mask, rows, cols, mask, b,
                                  c, y, n_tiles, bm, bn, k, n, s);
  }
  return cudaErrorInvalidValue;
}

// row_slot, row_nnz, perm int32[n_rows]; cols int32[n_slots]; b f32[m, k]
// with perm[r] < m wherever row_nnz[r] > 0; c f32[k, n] with every column
// a row reads below n; y f32[n_slots], zeroed by the caller (only the
// nonzeros' slots are written).  Returns the cudaError_t of the launch.
extern "C" int sddmm_sell_slots_f32(const int* row_slot, const int* row_nnz,
                                    const int* perm, const int* cols,
                                    const float* b, const float* c, float* y,
                                    int n_rows, int k, int n, void* stream) {
  if (n_rows == 0 || k == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int warps_per_cta = kThreads / 32;
  const int grid = (n_rows + warps_per_cta - 1) / warps_per_cta;
  if (k == 2)
    sddmm_slots_kernel<2><<<grid, kThreads, 0, s>>>(
        row_slot, row_nnz, perm, cols, b, c, y, n_rows, k, n);
  else
    sddmm_slots_kernel<0><<<grid, kThreads, 0, s>>>(
        row_slot, row_nnz, perm, cols, b, c, y, n_rows, k, n);
  return cudaGetLastError();
}
