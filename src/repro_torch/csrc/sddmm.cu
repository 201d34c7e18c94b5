// SDDMM for sm_90a: Block-COO tiles (K3) and SELL-C-sigma slots (K4).
//
// Replaces two Pallas TPU kernels of the JAX package:
//   K3 sddmm_blockcoo_kernel  (src/repro/kernels/sddmm/kernel.py:52)
//   K4 sddmm_sell_kernel      (src/repro/kernels/sddmm/sell.py:58)
//
// K3 (sddmm_tiles_kernel), for every listed tile t of a Block-COO operand
// (B [Mp, K]):
//
//   Y[t] = mask[t] * (B[rows[t]-block, :] @ C[:, cols[t]-block])
//
// with A's values as the mask (a weighted mask is allowed).  What bounds
// it on an H100: bytes.  At GAT's K = 2 each output element needs 2
// multiply-adds and costs 8 bytes (its mask value read, itself written),
// far below the card's ~20 FLOP per byte, so the time is the mask in and
// the tiles out.  The design: the Pallas grid walked K as a sequential
// dimension with the tile accumulator resident in VMEM; here one CTA owns
// one output tile and loops over K itself, staging a (bm x BK) slice of B
// and a (BK x bn) slice of C through shared memory, so no sum crosses CTAs
// (no atomics).  The last K chunk is ragged and masked, so any K >= 1
// works (the Pallas wrapper needed K % bk == 0 and fell back to bk = K).
// A 16 x 16 thread grid owns R x R elements per thread, rows ty + 16 i and
// columns tx + 16 j, so each warp reads and writes two 64-byte runs of a
// row-major tile per access: whole 32-byte sectors.  The mask multiplies
// once, at the only store.
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
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kSide = 16;  // the thread grid is kSide x kSide
constexpr int kBK = 16;    // K chunk staged per step

template <int R>
__global__ void __launch_bounds__(kThreads)
    sddmm_tiles_kernel(const int* __restrict__ rows,
                       const int* __restrict__ cols,
                       const float* __restrict__ mask,
                       const float* __restrict__ b,
                       const float* __restrict__ c, float* __restrict__ y,
                       int bm, int bn, int k, int n) {
  constexpr int kRows = R * kSide;
  __shared__ float Bs[kRows][kBK + 1];
  __shared__ float Cs[kBK][kRows];
  const int t = blockIdx.x;
  const int tx = threadIdx.x % kSide;
  const int ty = threadIdx.x / kSide;
  const size_t brow0 = static_cast<size_t>(rows[t]) * bm;
  const size_t ccol0 = static_cast<size_t>(cols[t]) * bn;

  float acc[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kBK) {
    const int kc = min(kBK, k - k0);
    for (int e = threadIdx.x; e < bm * kc; e += kThreads) {
      const int r = e / kc;
      const int kk = e - r * kc;
      Bs[r][kk] = b[(brow0 + r) * k + k0 + kk];
    }
    for (int e = threadIdx.x; e < kc * bn; e += kThreads) {
      const int kk = e / bn;
      const int col = e - kk * bn;
      Cs[kk][col] = c[static_cast<size_t>(k0 + kk) * n + ccol0 + col];
    }
    __syncthreads();
    for (int kk = 0; kk < kc; ++kk) {
      float bv[R], cv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = ty + i * kSide;
        bv[i] = r < bm ? Bs[r][kk] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int col = tx + j * kSide;
        cv[j] = col < bn ? Cs[kk][col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) acc[i][j] = fmaf(bv[i], cv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const size_t tile0 = static_cast<size_t>(t) * bm * bn;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty + i * kSide;
    if (r >= bm) continue;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int col = tx + j * kSide;
      if (col >= bn) continue;
      const size_t at = tile0 + static_cast<size_t>(r) * bn + col;
      y[at] = mask[at] * acc[i][j];
    }
  }
}

template <int R>
cudaError_t launch(const int* rows, const int* cols, const float* mask,
                   const float* b, const float* c, float* y, int n_tiles,
                   int bm, int bn, int k, int n, cudaStream_t stream) {
  sddmm_tiles_kernel<R><<<n_tiles, kThreads, 0, stream>>>(
      rows, cols, mask, b, c, y, bm, bn, k, n);
  return cudaGetLastError();
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

// rows, cols int32[n_tiles]; mask f32[n_tiles, bm, bn]; b f32[*, k] with
// rows[t] * bm + bm <= its row count; c f32[k, n] with n a multiple of bn;
// y f32[n_tiles, bm, bn].  bm, bn <= 128.  Returns the cudaError_t of the
// launch.
extern "C" int sddmm_tiles_f32(const int* rows, const int* cols,
                               const float* mask, const float* b,
                               const float* c, float* y, int n_tiles, int bm,
                               int bn, int k, int n, void* stream) {
  if (n_tiles == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int side = bm > bn ? bm : bn;
  if (side <= kSide)
    return launch<1>(rows, cols, mask, b, c, y, n_tiles, bm, bn, k, n, s);
  if (side <= 2 * kSide)
    return launch<2>(rows, cols, mask, b, c, y, n_tiles, bm, bn, k, n, s);
  if (side <= 4 * kSide)
    return launch<4>(rows, cols, mask, b, c, y, n_tiles, bm, bn, k, n, s);
  if (side <= 8 * kSide)
    return launch<8>(rows, cols, mask, b, c, y, n_tiles, bm, bn, k, n, s);
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
