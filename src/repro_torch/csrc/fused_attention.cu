// One-pass fused graph attention, Block-ELL and SELL-C-sigma, for sm_90a.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   K7 fused_attn_blockell_kernel  (src/repro/kernels/fused/attention.py)
//   K8 fused_attn_sell_kernel      (src/repro/kernels/fused/attention.py)
// For every block-row of A's pattern,
//
//   Y[row-block, :] = softmax_row(act(q kT) at A's nonzeros) @ V
//
// in one sweep over the row's slots (K7: the W Block-ELL slots of the
// block-row; K8: the live SELL tiles of the compact block-row, through a
// row pointer over the ascending tile_rows).  Per slot, with the (bm x bn)
// mask tile, the (dk x bn) kT tile and the (bn x BD) V tile in shared
// memory:
//
//   s   = act(q_tile @ kT_tile), -1e30 where masked (finite: no nan)
//   m'  = max(m, rowmax(s));  scale = exp(m - m')
//   p   = exp(s - m') where unmasked, exactly 0 where masked
//   l   = l * scale + rowsum(p);  acc = acc * scale + p @ V_tile
//
// and at the only store  Y = acc / max(l, 1e-12), so a row with no edge
// comes out exactly 0.  exp is expf (no fast-math), as the tolerances of
// the reference (1e-4 / 1e-5) need.
//
// What bounds it on an H100: bytes, those of the mask (A's blocks for K7,
// the 0/1 tiles for K8), read once; dk = 2 scores and a D-wide product per
// nonzero are little arithmetic.  The design: the Pallas kernels carried
// m, l and acc in VMEM across sequential grid steps and flushed on the
// last slot (K7) or when tile_rows changed (K8).  CTAs run in no order
// here, so one CTA owns one (block-row, D-tile) and loops over the row's
// slots itself: the softmax statistics never leave the CTA and no sum
// crosses CTAs (no atomics).  Each D-tile CTA recomputes the same scores
// (cheap at dk = 2), so every D-tile sees the same statistics.  The score
// tile is turned into probabilities in place in shared memory, one warp
// per row for the max and the sum, and then multiplies V with the register
// tile of the SpMM kernels (spmm_tile.cuh).
#include "spmm_tile.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kEps = 1e-12f;
constexpr int kWarps = spmm::kThreads / 32;

// Shared memory, in floats: the score / probability tile Ps [R*TY][bn+1]
// (rows >= bm stay zero), V tile Vs [bn][BD] (16-byte aligned), kT tile
// Ks [dk][bn], the block-row's q tile Qs [bm][dk], the row statistics
// m, l and scale [bm] each; then the mask tile as bytes [bm * bn].
struct Smem {
  size_t vs, ks, qs, stats, mask, bytes;
  __host__ __device__ Smem(int bd, int rows, int bm, int bn, int dk) {
    vs = spmm::a_tile_floats(rows, bn);
    ks = vs + static_cast<size_t>(bn) * bd;
    qs = ks + static_cast<size_t>(dk) * bn;
    stats = qs + static_cast<size_t>(bm) * dk;
    mask = stats + 3 * static_cast<size_t>(bm);
    bytes = mask * sizeof(float) + static_cast<size_t>(bm) * bn;
  }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// row_ptr == nullptr: Block-ELL, block-row i owns slots [i*w, (i+1)*w).
// Otherwise SELL: compact block-row i owns tiles [row_ptr[i], row_ptr[i+1]).
// cols[s] is slot s's block-column; blocks + s*bm*bn its mask tile.
template <int BD, int R>
__global__ void __launch_bounds__(spmm::kThreads)
    fused_attn_kernel(const int* __restrict__ row_ptr,
                      const int* __restrict__ cols,
                      const float* __restrict__ blocks,
                      const float* __restrict__ q,
                      const float* __restrict__ kt,
                      const float* __restrict__ v, float* __restrict__ y,
                      int w, int bm, int bn, int dk, int n, int d, int act,
                      float slope) {
  constexpr int TX = spmm::Layout<BD>::TX;
  constexpr int TY = spmm::Layout<BD>::TY;
  extern __shared__ __align__(16) float smem[];
  const Smem lay(BD, R * TY, bm, bn, dk);
  const int lda = bn + 1;
  float* Ps = smem;
  float* Vs = smem + lay.vs;
  float* Ks = smem + lay.ks;
  float* Qs = smem + lay.qs;
  float* m_s = smem + lay.stats;
  float* l_s = m_s + bm;
  float* sc_s = l_s + bm;
  unsigned char* Mk = reinterpret_cast<unsigned char*>(smem + lay.mask);
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row = blockIdx.x;
  const int col0 = blockIdx.y * BD;
  const int begin = row_ptr != nullptr ? row_ptr[row] : row * w;
  const int end = row_ptr != nullptr ? row_ptr[row + 1] : (row + 1) * w;
  const size_t row0 = static_cast<size_t>(row) * bm;

  for (int e = tid + bm * lda; e < R * TY * lda; e += spmm::kThreads)
    Ps[e] = 0.f;
  for (int e = tid; e < bm * dk; e += spmm::kThreads)
    Qs[e] = q[row0 * dk + e];
  for (int r = tid; r < bm; r += spmm::kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  __syncthreads();

  float acc[R][4];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  for (int s = begin; s < end; ++s) {
    const float* __restrict__ a =
        blocks + static_cast<size_t>(s) * bm * bn;
    const size_t c0 = static_cast<size_t>(cols[s]) * bn;
    for (int e = tid; e < bm * bn; e += spmm::kThreads)
      Mk[e] = a[e] != 0.f;
    for (int e = tid; e < dk * bn; e += spmm::kThreads) {
      const int kk = e / bn;
      Ks[e] = kt[static_cast<size_t>(kk) * n + c0 + (e - kk * bn)];
    }
    for (int e = tid; e < bn * BD; e += spmm::kThreads) {
      const int k = e / BD;
      const int gc = col0 + (e - k * BD);
      Vs[e] = gc < d ? v[(c0 + k) * d + gc] : 0.f;
    }
    __syncthreads();

    // scores: act(q kT) where A has an entry, -1e30 elsewhere
    for (int e = tid; e < bm * bn; e += spmm::kThreads) {
      const int r = e / bn;
      const int c = e - r * bn;
      float sv = 0.f;
      for (int kk = 0; kk < dk; ++kk)
        sv = fmaf(Qs[r * dk + kk], Ks[kk * bn + c], sv);
      Ps[r * lda + c] = Mk[e] ? spmm::apply_act(sv, act, slope) : kNegInf;
    }
    __syncthreads();

    // row statistics, one warp per row; scores become probabilities
    for (int r = warp; r < bm; r += kWarps) {
      float mx = kNegInf;
      for (int c = lane; c < bn; c += 32) mx = fmaxf(mx, Ps[r * lda + c]);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.f;
      for (int c = lane; c < bn; c += 32) {
        const float p = Mk[r * bn + c] ? expf(Ps[r * lda + c] - m_new) : 0.f;
        Ps[r * lda + c] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float scale = expf(m_prev - m_new);
        l_s[r] = l_s[r] * scale + sum;
        m_s[r] = m_new;
        sc_s[r] = scale;
      }
    }
    __syncthreads();

    // acc = acc * scale + P @ V_tile
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = ty + i * TY;
      const float sc = r < bm ? sc_s[r] : 1.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] *= sc;
    }
    for (int k = 0; k < bn; ++k) {
      const float4 hv = *reinterpret_cast<const float4*>(&Vs[k * BD + tx * 4]);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float p = Ps[(ty + i * TY) * lda + k];
        acc[i][0] = fmaf(p, hv.x, acc[i][0]);
        acc[i][1] = fmaf(p, hv.y, acc[i][1]);
        acc[i][2] = fmaf(p, hv.z, acc[i][2]);
        acc[i][3] = fmaf(p, hv.w, acc[i][3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty + i * TY;
    if (r >= bm) continue;
    const float den = fmaxf(l_s[r], kEps);
    const size_t out = (row0 + r) * d;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int gc = col0 + tx * 4 + c;
      if (gc < d) y[out + gc] = acc[i][c] / den;
    }
  }
}

struct AttnLauncher {
  const int* row_ptr;
  const int* cols;
  const float* blocks;
  const float* q;
  const float* kt;
  const float* v;
  float* y;
  int n_rows, w, bm, bn, dk, n, d, act;
  float slope;
  cudaStream_t stream;

  template <int BD, int R>
  cudaError_t run(size_t) const {
    auto kernel = fused_attn_kernel<BD, R>;
    const size_t smem =
        Smem(BD, R * spmm::Layout<BD>::TY, bm, bn, dk).bytes;
    cudaError_t err = spmm::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(n_rows, (d + BD - 1) / BD);
    kernel<<<grid, spmm::kThreads, smem, stream>>>(
        row_ptr, cols, blocks, q, kt, v, y, w, bm, bn, dk, n, d, act, slope);
    return cudaGetLastError();
  }
};

}  // namespace

// Block-ELL (K7): row_ptr null, cols = indices int32[n_rows, w], blocks
// f32[n_rows, w, bm, bn].  SELL (K8): row_ptr int32[n_rows + 1] over the
// live tiles, cols = tile_cols int32[T], blocks = 0/1 tiles f32[T, bm, bn]
// (w unused).  q f32[n_rows*bm, dk]; kt f32[dk, n] and v f32[n, d] with n
// a multiple of bn; y f32[n_rows*bm, d].  Returns the cudaError_t of the
// launch.
extern "C" int fused_attn_f32(const int* row_ptr, const int* cols,
                              const float* blocks, const float* q,
                              const float* kt, const float* v, float* y,
                              int n_rows, int w, int bm, int bn, int dk,
                              int n, int d, int act, float slope,
                              void* stream) {
  if (n_rows == 0 || d == 0) return cudaSuccess;
  const AttnLauncher launcher{row_ptr, cols, blocks, q,  kt, v,
                              y,       n_rows, w,   bm, bn, dk,
                              n,       d,    act,    slope,
                              static_cast<cudaStream_t>(stream)};
  return static_cast<int>(spmm::dispatch(launcher, bm, bn, d));
}
