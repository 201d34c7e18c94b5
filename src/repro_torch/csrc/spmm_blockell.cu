// Block-ELL SpMM with a fused epilogue, for sm_90a.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   K1 spmm_blockell_kernel           (src/repro/kernels/spmm/kernel.py)
//   K5 spmm_blockell_epilogue_kernel  (src/repro/kernels/fused/spmm.py)
// K1 is this kernel with act = identity and no bias or residual.
//
//   Y[i-block, :] = act(sum_w blocks[i, w] @ H[idx[i, w]-block, :]
//                       + bias + res[i-block, :])
//
// What bounds it on an H100: the bytes of `blocks`, read once; the
// nonzeros need far less arithmetic than that takes time.  This kernel
// multiplies the blocks densely, so it also cannot beat the dense FFMA
// work (2 * nbr * W * bm * bn * D over the 67 TFLOP/s FP32 rate, above
// the byte time at D = 128), and each CTA reads its block-row's W blocks
// once per D-tile (twice at D = 128).  The design: the Pallas grid
// carried the sum across sequential slot steps; here one CTA owns one (block-row, D-tile) and loops over the
// W slots itself, so no sum crosses CTAs (no atomics, deterministic).  A
// and H tiles go through shared memory and each thread keeps an R x 4
// register tile, four FFMA per shared-memory read of A.  Padding slots
// carry zero blocks and valid indices, so they add exactly zero.  The
// D-tile is the kernel's own choice (16, 32 or 64 columns) and its ragged
// edge is masked, since D is 16 on the last GCN layer.
#include "spmm_tile.cuh"

namespace {

struct EllSlots {
  const int* idx;
  const float* blocks;
  int block_elems;
  __device__ const float* block(int s) const {
    return blocks + static_cast<size_t>(s) * block_elems;
  }
  __device__ int col(int s) const { return idx[s]; }
};

template <int BD, int R>
__global__ void __launch_bounds__(spmm::kThreads)
    spmm_blockell_kernel(const int* __restrict__ idx,
                         const float* __restrict__ blocks,
                         const float* __restrict__ h,
                         const float* __restrict__ bias,
                         const float* __restrict__ res, float* __restrict__ y,
                         int w, int bm, int bn, int d, int act, float slope) {
  const int i = blockIdx.x;
  const EllSlots slots{idx, blocks, bm * bn};
  spmm::tile_spmm<BD, R>(slots, i * w, (i + 1) * w, h, bias, res, y, i * bm,
                         bm, bn, d, act, slope);
}

struct EllLauncher {
  const int* idx;
  const float* blocks;
  const float* h;
  const float* bias;
  const float* res;
  float* y;
  int nbr, w, bm, bn, d, act;
  float slope;
  cudaStream_t stream;

  template <int BD, int R>
  cudaError_t run(size_t smem) const {
    auto kernel = spmm_blockell_kernel<BD, R>;
    cudaError_t err = spmm::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(nbr, (d + BD - 1) / BD);
    kernel<<<grid, spmm::kThreads, smem, stream>>>(idx, blocks, h, bias, res,
                                                   y, w, bm, bn, d, act,
                                                   slope);
    return cudaGetLastError();
  }
};

}  // namespace

// idx int32[nbr, w]; blocks f32[nbr, w, bm, bn]; h f32[n, d] with n a
// multiple of bn; bias f32[d] or null; res f32[nbr*bm, d] or null;
// y f32[nbr*bm, d].  Returns the cudaError_t of the launch.
extern "C" int spmm_blockell_f32(const int* idx, const float* blocks,
                                 const float* h, const float* bias,
                                 const float* res, float* y, int nbr, int w,
                                 int bm, int bn, int d, int act, float slope,
                                 void* stream) {
  if (nbr == 0 || d == 0) return cudaSuccess;
  const EllLauncher launcher{idx, blocks, h, bias, res, y, nbr, w, bm, bn, d,
                             act, slope, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(spmm::dispatch(launcher, bm, bn, d));
}
