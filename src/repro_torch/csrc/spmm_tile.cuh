// Tile loop of the Block-ELL SpMM kernels (spmm_blockell.cu, K1 and K5):
// one CTA owns one (bm x BD) output tile and walks a contiguous range of
// "slots", each a dense (bm x bn) A block and the block-column of H it
// multiplies.  A and H tiles are staged in shared
// memory, the product is FFMA in f32 (no TF32: the reference tolerances
// are 1e-4 to 1e-5), and the epilogue act(y + bias + residual) is applied
// in registers before the only store of the tile.
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

// Slots: .block(s) -> pointer to slot s's bm*bn A block (row-major),
//        .col(s)   -> block-column of H that slot s multiplies.
template <int BD, int R, class Slots>
__device__ __forceinline__ void tile_spmm(
    const Slots& slots, int begin, int end, const float* __restrict__ h,
    const float* __restrict__ bias, const float* __restrict__ res,
    float* __restrict__ y, int out_row0, int bm, int bn, int d, int act,
    float slope) {
  constexpr int TX = Layout<BD>::TX;
  constexpr int TY = Layout<BD>::TY;
  extern __shared__ __align__(16) float smem[];
  const int lda = bn + 1;
  float* As = smem;
  float* Hs = smem + a_tile_floats(R * TY, bn);
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int col0 = blockIdx.y * BD;

  for (int e = threadIdx.x + bm * lda; e < R * TY * lda; e += kThreads)
    As[e] = 0.f;

  float acc[R][4];
#pragma unroll
  for (int q = 0; q < R; ++q)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[q][c] = 0.f;

  for (int s = begin; s < end; ++s) {
    const float* __restrict__ a = slots.block(s);
    const float* __restrict__ hb =
        h + static_cast<size_t>(slots.col(s)) * bn * d;
    for (int e = threadIdx.x; e < bm * bn; e += kThreads) {
      const int r = e / bn;
      As[r * lda + (e - r * bn)] = a[e];
    }
    for (int e = threadIdx.x; e < bn * BD; e += kThreads) {
      const int k = e / BD;
      const int gc = col0 + (e - k * BD);
      Hs[e] = gc < d ? hb[static_cast<size_t>(k) * d + gc] : 0.f;
    }
    __syncthreads();
    for (int k = 0; k < bn; ++k) {
      const float4 hv = *reinterpret_cast<const float4*>(&Hs[k * BD + tx * 4]);
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const float av = As[(ty + q * TY) * lda + k];
        acc[q][0] = fmaf(av, hv.x, acc[q][0]);
        acc[q][1] = fmaf(av, hv.y, acc[q][1]);
        acc[q][2] = fmaf(av, hv.z, acc[q][2]);
        acc[q][3] = fmaf(av, hv.w, acc[q][3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int r = ty + q * TY;
    if (r >= bm) continue;
    const size_t row = static_cast<size_t>(out_row0 + r);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int gc = col0 + tx * 4 + c;
      if (gc >= d) continue;
      float z = acc[q][c];
      if (bias != nullptr) z += bias[gc];
      if (res != nullptr) z += res[row * d + gc];
      y[row * d + gc] = apply_act(z, act, slope);
    }
  }
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
