// Tile-pruned SELL-C-sigma SpMM with a fused epilogue, for sm_90a.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   K2 spmm_sell_kernel           (src/repro/kernels/spmm/sell.py)
//   K6 spmm_sell_epilogue_kernel  (src/repro/kernels/fused/spmm.py)
// K2 is this kernel with act = identity and no bias or residual.
//
//   Y[L-block, :] = act(sum_{t : tile_rows[t] == L} tiles[t] @ H[cols[t]-block, :]
//                       + bias + res_perm[L-block, :])
// over the flat list of live tiles, with a compact output of n_live * bm
// rows (the caller un-permutes it).
//
// What bounds it on an H100: the bytes of the T tiles, read once; the
// nonzeros need far less arithmetic.  This kernel multiplies every live
// tile densely (2 * T * bm * bn * D FFMA work, above the byte time at
// D = 128), and a hyper-sparse graph leaves only a few nonzeros in each
// 64 x 64 tile, so most of that work multiplies zeros; this kernel
// computes what the TPU kernel computes.
// The design: the Pallas kernel kept the output tile resident across
// sequential grid steps and flushed when tile_rows changed.  CTAs run in
// no order here, so the wrapper derives row_ptr (the first tile of each
// live block-row, over the ascending tile_rows) and one CTA owns one
// (live block-row, D-tile) and loops over that row's tiles: no atomics,
// a deterministic sum, and the epilogue once at the only store.
#include "spmm_tile.cuh"

namespace {

struct SellSlots {
  const int* cols;
  const float* tiles;
  int block_elems;
  __device__ const float* block(int t) const {
    return tiles + static_cast<size_t>(t) * block_elems;
  }
  __device__ int col(int t) const { return cols[t]; }
};

template <int BD, int R>
__global__ void __launch_bounds__(spmm::kThreads)
    spmm_sell_kernel(const int* __restrict__ row_ptr,
                     const int* __restrict__ cols,
                     const float* __restrict__ tiles,
                     const float* __restrict__ h,
                     const float* __restrict__ bias,
                     const float* __restrict__ res, float* __restrict__ y,
                     int bm, int bn, int d, int act, float slope) {
  const int row = blockIdx.x;
  const SellSlots slots{cols, tiles, bm * bn};
  spmm::tile_spmm<BD, R>(slots, row_ptr[row], row_ptr[row + 1], h, bias, res,
                         y, row * bm, bm, bn, d, act, slope);
}

struct SellLauncher {
  const int* row_ptr;
  const int* cols;
  const float* tiles;
  const float* h;
  const float* bias;
  const float* res;
  float* y;
  int n_live, bm, bn, d, act;
  float slope;
  cudaStream_t stream;

  template <int BD, int R>
  cudaError_t run(size_t smem) const {
    auto kernel = spmm_sell_kernel<BD, R>;
    cudaError_t err = spmm::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(n_live, (d + BD - 1) / BD);
    kernel<<<grid, spmm::kThreads, smem, stream>>>(row_ptr, cols, tiles, h,
                                                   bias, res, y, bm, bn, d,
                                                   act, slope);
    return cudaGetLastError();
  }
};

}  // namespace

// row_ptr int32[n_live + 1]; cols int32[T]; tiles f32[T, bm, bn];
// h f32[n, d] with n a multiple of bn; bias f32[d] or null;
// res f32[n_live*bm, d] or null; y f32[n_live*bm, d].
// Returns the cudaError_t of the launch.
extern "C" int spmm_sell_f32(const int* row_ptr, const int* cols,
                             const float* tiles, const float* h,
                             const float* bias, const float* res, float* y,
                             int n_live, int bm, int bn, int d, int act,
                             float slope, void* stream) {
  if (n_live == 0 || d == 0) return cudaSuccess;
  const SellLauncher launcher{row_ptr, cols, tiles, h, bias, res, y, n_live,
                              bm, bn, d, act, slope,
                              static_cast<cudaStream_t>(stream)};
  return static_cast<int>(spmm::dispatch(launcher, bm, bn, d));
}
