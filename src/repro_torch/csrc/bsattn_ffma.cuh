// K9's earlier f32 design, kept for comparison only: every product an FFMA
// on the CUDA cores (4.0 ms bound at gemma3-4b's local layers, see
// bsattn.cu).  Each warp owns 8 q rows and each lane one key of a 32-key
// chunk; q and K are f32 in shared memory.
//
// Not a source of its own: python -m repro_torch.kernels.bsattn.tiles
// splices this text into a copy of bsattn.cu (inside its anonymous
// namespace, before namespace tc) and sends f32 to ffma::launch there, so
// the two designs are timed in one run.  No entry point of the port
// launches it.

namespace ffma {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 8;
constexpr int kTileQ = kWarps * kRowsPerWarp;  // 64 q rows per CTA
constexpr int kChunk = 32;                     // keys per chunk: one a lane

__device__ __forceinline__ float load_f32(const float* p) {
  return *p;
}

// p as V's dtype holds it before p @ V
__device__ __forceinline__ float as_input(float p, const float*) {
  return p;
}

__device__ __forceinline__ void store(float* p, float x) {
  *p = x;
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

}  // namespace ffma
