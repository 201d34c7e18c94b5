// Masked tile SDDMM, Block-COO and tile-pruned SELL-C-sigma, for sm_90a.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   K3 sddmm_blockcoo_kernel  (src/repro/kernels/sddmm/kernel.py)
//   K4 sddmm_sell_kernel      (src/repro/kernels/sddmm/sell.py)
// Both compute, for every listed tile t,
//
//   Y[t] = mask[t] * (B[rows[t]-block, :] @ C[:, cols[t]-block])
//
// K3 over the nonzero blocks of a Block-COO operand (B [Mp, K]), K4 over
// the live tiles of a SELL packing (B gathered into packed row order,
// [n_live * bm, K], rows[t] the compact block-row).  K3's mask carries A's
// values (a weighted mask is allowed); K4's is the 0/1 pattern.
//
// What bounds it on an H100: bytes.  At GAT's K = 2 each output element
// needs 2 multiply-adds and costs 8 bytes (its mask value read, itself
// written), far below the card's ~20 FLOP per byte, so the time is the
// mask in and the tiles out.  The design: the Pallas grid walked K as a
// sequential dimension with the tile accumulator resident in VMEM; here one
// CTA owns one output tile and loops over K itself, staging a (bm x BK)
// slice of B and a (BK x bn) slice of C through shared memory, so no sum
// crosses CTAs (no atomics).  The last K chunk is ragged and masked, so any
// K >= 1 works (the Pallas wrapper needed K % bk == 0 and fell back to
// bk = K).  A 16 x 16 thread grid owns R x R elements per thread, rows
// ty + 16 i and columns tx + 16 j, so each warp reads and writes two
// 64-byte runs of a row-major tile per access: whole 32-byte sectors.
// The mask multiplies once, at the only store.
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
