// Block-sparse flash attention (GQA, causal / sliding-window masks) for
// sm_90a.
//
// Replaces the Pallas TPU kernel of the JAX package
//   K9 bsattn_kernel  (src/repro/kernels/bsattn/kernel.py)
// For every q row of every head bh, an online softmax over the keys that
// the row's valid Block-ELL slots list and that the causal / window
// predicates allow:
//
//   s   = (q . k) * scale, -1e30 where masked (finite: no nan)
//   m'  = max(m, rowmax(s));  alpha = exp(m - m')
//   p   = exp(s - m') where unmasked, exactly 0 where masked
//   l   = l * alpha + rowsum(p);  acc = acc * alpha + p @ V
//
// and at the only store  out = acc / max(l, 1e-30), so a row with no live
// key comes out exactly 0.  K / V rows come from kv head bh / group (no
// repeated KV is built).  bf16 inputs are widened to f32 on load; p is
// rounded to bf16 before p @ V, as the reference's p.astype(v.dtype) does,
// and the output is rounded to q's dtype.  exp is expf (no fast-math), and
// every product is an f32 FFMA (no tensor cores, no TF32).
//
// What bounds it on an H100: operations.  At gemma3-4b's local layers
// (S = 32768, window 1024, D = 256, 8 q heads) the live pairs need
// 2.7e11 FLOP against 0.4 GB of bf16 inputs and output: 0.27 ms at the
// bf16 tensor-core peak, 4.0 ms at the f32 FFMA peak, 0.12 ms of bytes.
// This first design stays on FFMA in f32 (wgmma on bf16 is later work) and
// spends its effort on doing only the live work:
//   * the Pallas grid (bh, q block, slot) carried m, l and acc in VMEM
//     across sequential slot steps; CTAs run in no order here, so one CTA
//     owns one (bh, 64-row q tile) and loops over its block-row's slots
//     and over each slot's keys in chunks of 32 itself: the statistics
//     never leave the CTA and no sum crosses CTAs;
//   * an invalid slot is skipped, and so is a key chunk that causality or
//     the window masks for every row of the tile.  Both skips are exact:
//     such a chunk leaves m unchanged, so alpha = 1, and adds p = 0;
//   * each warp owns 8 q rows and each lane one key of the chunk, so the
//     row max and sum are warp shuffles and m, l stay in registers; the
//     lane then owns D/32 output columns of the same 8 rows, and reads its
//     warp's p from a private 8 x 32 tile in shared memory;
//   * the q tile (64 x D), the K chunk (32 x D, rows padded by 4 floats so
//     the lanes' float4 reads fall on distinct banks) and the V chunk
//     (32 x D) live in dynamic shared memory as f32: 141 KB at D = 256;
//   * the block-rows of the last q blocks carry the most slots under a
//     causal mask, so the grid is walked from the last q block down, and
//     the longest CTAs start first.
// The tile of 64 rows and the chunk of 32 keys need not divide block_q /
// block_kv: rows past the block-row and keys past the slot are masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kTiny = 1e-30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 8;
constexpr int kTileQ = kWarps * kRowsPerWarp;  // 64 q rows per CTA
constexpr int kChunk = 32;                     // keys per chunk: one a lane

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// p as V's dtype holds it before p @ V
__device__ __forceinline__ float as_input(float p, const float*) { return p; }
__device__ __forceinline__ float as_input(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

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

// DT: the head dim rounded up to 64, 128 or 256 (columns >= d are zero in
// shared memory and never stored).  Each lane owns CPL = DT / 32 output
// columns as NV runs of VW adjacent ones, run j at j*32*VW + lane*VW.
template <int DT>
struct Cols {
  static constexpr int CPL = DT / 32;
  static constexpr int VW = CPL < 4 ? CPL : 4;
  static constexpr int NV = CPL / VW;
  static constexpr int LDK = DT + 4;  // q and K row stride, in floats
  static constexpr size_t smem_floats =
      static_cast<size_t>(kTileQ) * LDK + static_cast<size_t>(kChunk) * LDK +
      static_cast<size_t>(kChunk) * DT + kWarps * kRowsPerWarp * kChunk;
};

template <int VW>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (VW == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x;
    out[1] = x.y;
    out[2] = x.z;
    out[3] = x.w;
  } else if constexpr (VW == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x;
    out[1] = x.y;
  } else {
    out[0] = *p;
  }
}

// Copies rows [row0, row0 + n) of a [*, d] matrix into a [rows][ld] f32
// tile, zero past n rows and d columns.
template <int DT, typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, int rows,
                                          const T* __restrict__ src,
                                          size_t row0, int n, int d) {
  for (int e = threadIdx.x; e < rows * DT; e += kThreads) {
    const int r = e / DT;
    const int c = e - r * DT;
    dst[r * ld + c] =
        (r < n && c < d) ? load_f32(src + (row0 + r) * d + c) : 0.f;
  }
}

// CTAs per SM asked of ptxas.  At DT = 256 the 141 KB of shared memory
// leave room for one, so ptxas may give the 8 x 8 accumulator all the
// registers it needs.  The 64- and 128-column tiles fit two CTAs per SM
// (43 and 75 KB), which caps them at 128 registers: one CTA per SM would
// cost them about a quarter of their speed.  Under that cap their score
// loop is not unrolled (below), or ptxas spills.
template <int DT>
constexpr int kMinBlocks = DT == 256 ? 1 : 2;

template <typename T, int DT>
__global__ void __launch_bounds__(kThreads, kMinBlocks<DT>)
    bsattn_kernel(const int* __restrict__ ell_idx,
                  const int* __restrict__ valid, const T* __restrict__ q,
                  const T* __restrict__ k, const T* __restrict__ v,
                  T* __restrict__ out, int s, int d, int n_slots, int block_q,
                  int block_kv, int group, int causal, int window,
                  float scale) {
  using C = Cols<DT>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                      // [kTileQ][LDK]
  float* Ks = Qs + kTileQ * C::LDK;      // [kChunk][LDK]
  float* Vs = Ks + kChunk * C::LDK;      // [kChunk][DT]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* Pw = Vs + kChunk * DT + warp * kRowsPerWarp * kChunk;  // [8][32]

  const int tiles = (block_q + kTileQ - 1) / kTileQ;
  const int nq = s / block_q;
  const int qi = nq - 1 - static_cast<int>(blockIdx.x) / tiles;
  const int q0 = qi * block_q + (blockIdx.x % tiles) * kTileQ;
  const int nr = min(kTileQ, (qi + 1) * block_q - q0);  // live rows
  const int bh = blockIdx.y;
  const size_t kv_row0 = static_cast<size_t>(bh / group) * s;
  const int* slot_idx = ell_idx + static_cast<size_t>(qi) * n_slots;
  const int* slot_ok = valid + static_cast<size_t>(qi) * n_slots;

  load_tile<DT>(Qs, C::LDK, kTileQ, q, static_cast<size_t>(bh) * s + q0, nr,
                d);

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][C::CPL];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C::CPL; ++c) acc[i][c] = 0.f;
  }
  const int row0 = warp * kRowsPerWarp;  // this warp's first tile row
  const int q_last = q0 + nr - 1;

  for (int w = 0; w < n_slots; ++w) {
    if (slot_ok[w] == 0) continue;  // exact: m, l, acc unchanged
    const int kb = slot_idx[w] * block_kv;
    for (int c0 = 0; c0 < block_kv; c0 += kChunk) {
      const int k_first = kb + c0;
      const int nk = min(kChunk, block_kv - c0);
      // chunks ascend: once past the tile's last row, all are masked
      if (causal && k_first > q_last) break;
      if (window > 0 && k_first + nk - 1 <= q0 - window) continue;
      __syncthreads();  // the previous chunk's readers are done
      load_tile<DT>(Ks, C::LDK, kChunk, k, kv_row0 + k_first, nk, d);
      load_tile<DT>(Vs, DT, kChunk, v, kv_row0 + k_first, nk, d);
      __syncthreads();

      // scores of this warp's 8 rows against the lane's key
      float sc[kRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) sc[i] = 0.f;
      const float* kr = Ks + lane * C::LDK;
#pragma unroll (DT == 256 ? 4 : 1)
      for (int e = 0; e < DT; e += 4) {
        const float4 kv4 = *reinterpret_cast<const float4*>(kr + e);
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const float4 qv =
              *reinterpret_cast<const float4*>(Qs + (row0 + i) * C::LDK + e);
          sc[i] = fmaf(qv.x, kv4.x, sc[i]);
          sc[i] = fmaf(qv.y, kv4.y, sc[i]);
          sc[i] = fmaf(qv.z, kv4.z, sc[i]);
          sc[i] = fmaf(qv.w, kv4.w, sc[i]);
        }
      }

      // online softmax, one row at a time across the warp
      const int kpos = k_first + lane;
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int r = row0 + i;
        const int qpos = q0 + r;
        bool live = lane < nk && r < nr;
        if (causal) live = live && kpos <= qpos;
        if (window > 0) live = live && kpos > qpos - window;
        const float sv = live ? sc[i] * scale : kNegInf;
        const float m_new = fmaxf(m[i], warp_max(sv));
        const float alpha = expf(m[i] - m_new);
        const float p = live ? expf(sv - m_new) : 0.f;
        l[i] = l[i] * alpha + warp_sum(p);
        m[i] = m_new;
#pragma unroll
        for (int c = 0; c < C::CPL; ++c) acc[i][c] *= alpha;
        Pw[i * kChunk + lane] = as_input(p, q);
      }
      __syncwarp();

      // acc += p @ V_chunk
#pragma unroll 2
      for (int kk = 0; kk < kChunk; kk += 4) {
        float4 pr[kRowsPerWarp];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i)
          pr[i] = *reinterpret_cast<const float4*>(Pw + i * kChunk + kk);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float vv[C::CPL];
#pragma unroll
          for (int t = 0; t < C::NV; ++t)
            load_vec<C::VW>(Vs + (kk + j) * DT + t * 32 * C::VW + lane * C::VW,
                            vv + t * C::VW);
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i) {
            const float pj = j == 0 ? pr[i].x
                           : j == 1 ? pr[i].y
                           : j == 2 ? pr[i].z
                                    : pr[i].w;
#pragma unroll
            for (int c = 0; c < C::CPL; ++c)
              acc[i][c] = fmaf(pj, vv[c], acc[i][c]);
          }
        }
      }
      __syncwarp();  // Pw is rewritten by the next chunk
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = row0 + i;
    if (r >= nr) continue;
    const float den = fmaxf(l[i], kTiny);
    T* o = out + (static_cast<size_t>(bh) * s + q0 + r) * d;
#pragma unroll
    for (int t = 0; t < C::NV; ++t)
#pragma unroll
      for (int e = 0; e < C::VW; ++e) {
        const int col = t * 32 * C::VW + lane * C::VW + e;
        if (col < d) store(o + col, acc[i][t * C::VW + e] / den);
      }
  }
}

template <typename T, int DT>
cudaError_t launch(const int* ell_idx, const int* valid, const void* q,
                   const void* k, const void* v, void* out, int bh, int bkv,
                   int s, int d, int n_slots, int block_q, int block_kv,
                   int causal, int window, float scale, cudaStream_t stream) {
  auto kernel = bsattn_kernel<T, DT>;
  const size_t smem = Cols<DT>::smem_floats * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int tiles = (block_q + kTileQ - 1) / kTileQ;
  const dim3 grid((s / block_q) * tiles, bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      ell_idx, valid, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), s, d, n_slots, block_q,
      block_kv, bh / bkv, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dt(const int* ell_idx, const int* valid, const void* q,
                      const void* k, const void* v, void* out, int bh,
                      int bkv, int s, int d, int n_slots, int block_q,
                      int block_kv, int causal, int window, float scale,
                      cudaStream_t stream) {
  if (d <= 64)
    return launch<T, 64>(ell_idx, valid, q, k, v, out, bh, bkv, s, d,
                         n_slots, block_q, block_kv, causal, window, scale,
                         stream);
  if (d <= 128)
    return launch<T, 128>(ell_idx, valid, q, k, v, out, bh, bkv, s, d,
                          n_slots, block_q, block_kv, causal, window, scale,
                          stream);
  return launch<T, 256>(ell_idx, valid, q, k, v, out, bh, bkv, s, d, n_slots,
                        block_q, block_kv, causal, window, scale, stream);
}

}  // namespace

// ell_idx, valid int32[s / block_q, n_slots]; q [bh, s, d], k and v
// [bkv, s, d], out [bh, s, d], all f32 (bf16 = 0) or bf16 (bf16 = 1);
// 1 <= d <= 256, bh a multiple of bkv, s a multiple of block_q and
// block_kv, every ell_idx in [0, s / block_kv).  Returns the cudaError_t
// of the launch.
extern "C" int bsattn_fwd(const int* ell_idx, const int* valid,
                          const void* q, const void* k, const void* v,
                          void* out, int bh, int bkv, int s, int d,
                          int n_slots, int block_q, int block_kv, int causal,
                          int window, float scale, int bf16, void* stream) {
  if (bh == 0 || s == 0 || d == 0) return cudaSuccess;
  if (d > 256 || bkv <= 0 || bh % bkv != 0 || block_q <= 0 ||
      block_kv <= 0 || s % block_q != 0 || s % block_kv != 0)
    return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return static_cast<int>(launch_dt<__nv_bfloat16>(
        ell_idx, valid, q, k, v, out, bh, bkv, s, d, n_slots, block_q,
        block_kv, causal, window, scale, st));
  return static_cast<int>(launch_dt<float>(ell_idx, valid, q, k, v, out, bh,
                                           bkv, s, d, n_slots, block_q,
                                           block_kv, causal, window, scale,
                                           st));
}
