// Shared pieces of the dense-tile kernels K7/K8 (fused_attention.cu), and
// the epilogue activation of K1/K5 (spmm_blockell.cu): the CTA's register
// tile layout, the padded shared-memory A tile, the launch helpers that
// pick the D-tile and rows per thread, and act().
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace spmm {

constexpr int kThreads = 256;
constexpr int kActIdentity = 0;
constexpr int kActRelu = 1;
constexpr int kActLeakyRelu = 2;

__device__ __forceinline__ float apply_act(float z, int act, float slope) {
  if (act == kActRelu) return fmaxf(z, 0.f);
  if (act == kActLeakyRelu) return z >= 0.f ? z : slope * z;
  return z;
}

// Threads of a CTA form a TY x TX grid: TX threads across the D-tile (four
// adjacent columns each, read from shared memory as one float4) and TY
// down the rows; each thread owns R rows, ty + q * TY for q < R.
template <int BD>
struct Layout {
  static constexpr int TX = BD / 4;
  static constexpr int TY = kThreads / TX;
};

// Shared memory: A tile [R*TY][bn+1] (the +1 column keeps the row reads of
// neighbouring ty on different banks; rows >= bm stay zero so the inner
// loop needs no row guard), then the H tile [bn][BD], 16-byte aligned.
__host__ __device__ inline size_t a_tile_floats(int rows, int bn) {
  return ((static_cast<size_t>(rows) * (bn + 1) + 3) / 4) * 4;
}

inline size_t smem_bytes(int bd, int rows, int bn) {
  return (a_tile_floats(rows, bn) + static_cast<size_t>(bn) * bd) *
         sizeof(float);
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Calls launcher.run<BD, R>(smem) with the smallest D-tile that covers d
// (16, 32 or 64 columns) and the fewest rows per thread that cover bm.
template <int BD, class Launcher>
cudaError_t dispatch_rows(const Launcher& launcher, int bm, int bn) {
  constexpr int TY = Layout<BD>::TY;
  if (bm <= TY) return launcher.template run<BD, 1>(smem_bytes(BD, TY, bn));
  if (bm <= 2 * TY)
    return launcher.template run<BD, 2>(smem_bytes(BD, 2 * TY, bn));
  if (bm <= 4 * TY)
    return launcher.template run<BD, 4>(smem_bytes(BD, 4 * TY, bn));
  if (bm <= 8 * TY)
    return launcher.template run<BD, 8>(smem_bytes(BD, 8 * TY, bn));
  return cudaErrorInvalidValue;
}

template <class Launcher>
cudaError_t dispatch(const Launcher& launcher, int bm, int bn, int d) {
  if (d > 32) return dispatch_rows<64>(launcher, bm, bn);
  if (d > 16) return dispatch_rows<32>(launcher, bm, bn);
  return dispatch_rows<16>(launcher, bm, bn);
}

}  // namespace spmm
