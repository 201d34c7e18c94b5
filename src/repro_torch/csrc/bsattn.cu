// Block-sparse flash attention (GQA, causal / sliding-window masks) for
// sm_90a.
//
// Replaces the Pallas TPU kernel of the JAX package
//   K9 bsattn_kernel  (src/repro/kernels/bsattn/kernel.py:93)
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
// repeated KV is built).  m, l and acc are f32; for bf16 inputs p is
// rounded to bf16 before p @ V, as the reference's p.astype(v.dtype) does,
// and the output is rounded to q's dtype.
//
// What bounds it on an H100: operations.  At gemma3-4b's local layers
// (S = 32768, window 1024, D = 256, 8 q heads) the live pairs need
// 2.7e11 FLOP against 0.4 GB of bf16 inputs and output: 0.27 ms at the
// bf16 tensor-core peak, 4.0 ms at the f32 FFMA peak, 0.12 ms of bytes.
//
// Two designs, chosen by dtype, share the work split and the skips:
//   * the Pallas grid (bh, q block, slot) carried m, l and acc in VMEM
//     across sequential slot steps; CTAs run in no order here, so one CTA
//     owns one (bh, 64-row q tile) and loops over its block-row's slots
//     and over each slot's keys in chunks itself: the statistics never
//     leave the CTA and no sum crosses CTAs;
//   * an invalid slot is skipped, and so is a key chunk that causality or
//     the window masks for every row of the tile.  Both skips are exact:
//     such a chunk leaves m unchanged, so alpha = 1, and adds p = 0;
//   * the block-rows of the last q blocks carry the most slots under a
//     causal mask, so the grid is walked from the last q block down, and
//     the longest CTAs start first;
//   * the tile of 64 rows and the key chunk need not divide block_q /
//     block_kv: rows past the block-row and keys past the slot are masked.
//
// bf16 (namespace tc): the products run on the tensor cores, so the bound
// above is the one that applies.  Each of 4 warps owns 16 q rows;
// S = Q K^T and O += P V are mma.sync m16n8k16 bf16 x bf16 -> f32 (a bf16
// product is exact in f32, so only the order of the sums differs from the
// plain version), with operand fragments read by ldmatrix (ldmatrix.trans
// for V).  Q, K and V stay bf16 in shared memory, rows padded by 16 bytes
// so the 8 rows of an ldmatrix fall on distinct banks.  K and V arrive in
// chunks of kKeys keys by cp.async, two stages deep: chunk i + 1 is in
// flight while chunk i is multiplied.  At D = 256, with 32-key chunks,
// that is the q tile (33 KB) plus 2 stages x (K + V) at 17 KB each, 99 KB,
// so two CTAs fit an SM (the narrower widths take 64-key chunks).  The
// softmax runs in registers on the accumulator fragments: a thread holds
// rows lane/4 and lane/4 + 8 of its warp's 16, the row max is
// a quad shuffle, the mask is evaluated per fragment element from absolute
// positions (only in chunks that need it), and the row sum stays a
// per-thread partial until the store.  exp is exp2f with scale * log2(e)
// folded into the scores.  The O accumulator (D / 2 f32 registers a
// thread, 128 at D = 256) stays in registers; the Q fragments are read
// from shared memory again for every chunk, not held.  A warp whose 16
// rows the chunk masks entirely skips its products (exact, as above).
// Head dims that are not a multiple of 8, or unaligned rows, are loaded
// synchronously instead of by cp.async; columns past d are zero.
//
// f32 (namespace ffma): every product is an f32 FFMA (no tensor cores: the
// port keeps f32 out of TF32).  Each warp owns 8 q rows and each lane one
// key of a 32-key chunk, so the row max and sum are warp shuffles and m, l
// stay in registers; the lane then owns D/32 output columns of the same 8
// rows, and reads its warp's p from a private 8 x 32 tile in shared
// memory.  The q tile (64 x D), the K chunk (32 x D, rows padded by 4
// floats so the lanes' float4 reads fall on distinct banks) and the V
// chunk (32 x D) live in dynamic shared memory: 141 KB at D = 256.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kTiny = 1e-30f;

namespace ffma {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 8;
constexpr int kTileQ = kWarps * kRowsPerWarp;  // 64 q rows per CTA
constexpr int kChunk = 32;                     // keys per chunk: one a lane

__device__ __forceinline__ float load_f32(const float* p) { return *p; }

// p as V's dtype holds it before p @ V
__device__ __forceinline__ float as_input(float p, const float*) { return p; }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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

namespace tc {

using bf16 = __nv_bfloat16;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileQ = kWarps * 16;  // 64 q rows per CTA, 16 per warp
constexpr int kStages = 2;           // K / V chunks in flight
constexpr float kLog2e = 1.4426950408889634f;

// Keys per chunk.  At D = 256, 32 keep the scores at 16 f32 registers a
// thread beside the 128 of the O accumulator, and a CTA under half an
// SM's shared memory; below, 64 halve the Q fragment reads and barriers
// per key (python -m repro_torch.kernels.bsattn.tiles times both).
template <int DT>
constexpr int kKeys = DT == 256 ? 32 : 64;

// Least shared memory asked per CTA.  0: a CTA asks what its tiles need,
// so two share an SM at D = 256 (with 128 threads a CTA, two CTAs still
// leave a thread 255 registers).
constexpr size_t kSmemFloor = 0;

template <int DT>
struct Tile {
  static constexpr int KEYS = kKeys<DT>;
  // row stride in bf16: 16 bytes past a multiple of 128, so the 8 rows
  // an ldmatrix reads fall on distinct banks
  static constexpr int LD = DT + 8;
  static constexpr int Q_ELEMS = kTileQ * LD;
  static constexpr int KV_ELEMS = KEYS * LD;  // one K or V chunk
  static constexpr size_t bytes =
      sizeof(bf16) * (static_cast<size_t>(Q_ELEMS) + 2 * kStages * KV_ELEMS);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; zeros where
// bytes is 0 (nothing is read then).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a (16 x 16, row-major) * b (16 x 8, column-major): bf16 operands,
// f32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two values as bf16 in one register, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Rows [row0, row0 + n) of a [*, d] matrix into a [ROWS][LD] tile, zero
// past n rows and d columns: by cp.async in 16-byte pieces where vec
// (d % 8 == 0 and 16-byte aligned rows), by plain loads otherwise.
template <int DT, int ROWS>
__device__ __forceinline__ void load_rows(bf16* dst,
                                          const bf16* __restrict__ src,
                                          size_t row0, int n, int d,
                                          bool vec) {
  constexpr int LD = Tile<DT>::LD;
  if (vec) {
    constexpr int PIECES = DT / 8;
    for (int e = threadIdx.x; e < ROWS * PIECES; e += kThreads) {
      const int r = e / PIECES;
      const int c = (e - r * PIECES) * 8;
      const bool ok = r < n && c < d;
      cp_async16(smem_addr(dst + r * LD + c),
                 ok ? src + (row0 + r) * d + c : src, ok ? 16 : 0);
    }
  } else {
    const bf16 zero = __ushort_as_bfloat16(0);
    for (int e = threadIdx.x; e < ROWS * DT; e += kThreads) {
      const int r = e / DT;
      const int c = e - r * DT;
      dst[r * LD + c] = (r < n && c < d) ? src[(row0 + r) * d + c] : zero;
    }
  }
}

template <int DT>
__global__ void __launch_bounds__(kThreads, 2)
    bsattn_tc_kernel(const int* __restrict__ ell_idx,
                     const int* __restrict__ valid,
                     const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     int s, int d, int n_slots, int block_q, int block_kv,
                     int group, int causal, int window, float scale_log2,
                     int vec) {
  static_assert(kStages == 2, "the stage index below toggles");
  using L = Tile<DT>;
  constexpr int KEYS = L::KEYS;
  constexpr int LD = L::LD;
  constexpr int NS = KEYS / 8;  // 8-key n-tiles of a warp's scores
  constexpr int NO = DT / 8;    // 8-column n-tiles of its output
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [kTileQ][LD]
  bf16* Ks = Qs + L::Q_ELEMS;                // [kStages][KEYS][LD]
  bf16* Vs = Ks + kStages * L::KV_ELEMS;     // [kStages][KEYS][LD]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // fragment rows g and g + 8
  const int t4 = lane % 4;  // fragment columns 2 t4 and 2 t4 + 1

  const int tiles = (block_q + kTileQ - 1) / kTileQ;
  const int nq = s / block_q;
  const int qi = nq - 1 - static_cast<int>(blockIdx.x) / tiles;
  const int q0 = qi * block_q + (blockIdx.x % tiles) * kTileQ;
  const int nr = min(kTileQ, (qi + 1) * block_q - q0);  // live rows
  const int bh = blockIdx.y;
  const size_t kv_row0 = static_cast<size_t>(bh / group) * s;
  const int* slot_idx = ell_idx + static_cast<size_t>(qi) * n_slots;
  const int* slot_ok = valid + static_cast<size_t>(qi) * n_slots;
  const int q_last = q0 + nr - 1;
  const int w0 = warp * 16;  // this warp's first tile row
  const bool warp_live = w0 < nr;
  const int wq0 = q0 + w0;                      // its first position
  const int wq1 = q0 + min(w0 + 15, nr - 1);    // its last live position

  // Moves (w, c0) to the next key chunk that some row of the tile sees;
  // false once the block-row has none left.
  auto next_chunk = [&](int& w, int& c0) {
    c0 += KEYS;
    for (; w < n_slots; ++w, c0 = 0) {
      if (slot_ok[w] == 0) continue;  // exact: m, l, acc unchanged
      const int kb = slot_idx[w] * block_kv;
      for (; c0 < block_kv; c0 += KEYS) {
        // chunks ascend: once past the tile's last row, all are masked
        if (causal && kb + c0 > q_last) break;
        if (window > 0 &&
            kb + c0 + min(KEYS, block_kv - c0) - 1 <= q0 - window)
          continue;
        return true;
      }
    }
    return false;
  };
  auto load_kv = [&](int w, int c0, int stage) {
    const size_t row0 =
        kv_row0 + static_cast<size_t>(slot_idx[w]) * block_kv + c0;
    const int nk = min(KEYS, block_kv - c0);
    load_rows<DT, KEYS>(Ks + stage * L::KV_ELEMS, k, row0, nk, d, vec);
    load_rows<DT, KEYS>(Vs + stage * L::KV_ELEMS, v, row0, nk, d, vec);
  };

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // rows g and g + 8, scaled by log2(e)
  float l[2] = {0.f, 0.f};          // this thread's part of the row sums

  int w = 0, c0 = -KEYS;
  bool have = next_chunk(w, c0);
  if (have) {
    load_rows<DT, kTileQ>(Qs, q, static_cast<size_t>(bh) * s + q0, nr, d,
                          vec);
    load_kv(w, c0, 0);
    cp_async_commit();
  }
  // ldmatrix lane addresses.  Q (x4): rows w0 + lane % 16, columns
  // (lane / 16) * 8 give a0..a3 of m16n8k16.  K (x4): keys (lane / 16) * 8
  // + lane % 8, columns ((lane / 8) % 2) * 8 give b0, b1 of two 8-key
  // n-tiles.  V (x4.trans): keys ((lane / 8) % 2) * 8 + lane % 8, columns
  // (lane / 16) * 8 give b0, b1 of two 8-column n-tiles.
  const uint32_t q_addr =
      smem_addr(Qs + (w0 + lane % 16) * LD + (lane / 16) * 8);
  const uint32_t k_addr0 = smem_addr(
      Ks + ((lane / 16) * 8 + lane % 8) * LD + ((lane / 8) % 2) * 8);
  const uint32_t v_addr0 = smem_addr(
      Vs + (((lane / 8) % 2) * 8 + lane % 8) * LD + (lane / 16) * 8);

  for (int stage = 0; have; stage ^= 1) {
    int nw = w, nc0 = c0;
    const bool more = next_chunk(nw, nc0);
    if (more) {  // the next chunk loads while this one is multiplied
      load_kv(nw, nc0, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int kf = slot_idx[w] * block_kv + c0;  // the chunk's first key
    const int nk = min(KEYS, block_kv - c0);
    // a warp whose rows the chunk masks entirely skips it (exact)
    const bool skip = !warp_live || (causal && kf > wq1) ||
                      (window > 0 && kf + nk - 1 <= wq0 - window);
    if (!skip) {
      const uint32_t k_addr = k_addr0 + stage * L::KV_ELEMS * 2;
      const uint32_t v_addr = v_addr0 + stage * L::KV_ELEMS * 2;
      float sc[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DT; kk += 16) {
        uint32_t a[4];
        ldsm_x4(a, q_addr + kk * 2);
#pragma unroll
        for (int j = 0; j < NS; j += 2) {
          uint32_t b[4];
          ldsm_x4(b, k_addr + (j * 8 * LD + kk) * 2);
          mma_bf16(sc[j], a, b[0], b[1]);
          mma_bf16(sc[j + 1], a, b[2], b[3]);
        }
      }

      // mask only where some element of the warp's 16 x KEYS block needs
      // it: a ragged chunk, rows past the block-row, the diagonal, the
      // window's edge
      const bool masked = nk < KEYS || w0 + 16 > nr ||
                          (causal && kf + KEYS - 1 > wq0) ||
                          (window > 0 && kf <= wq1 - window);
      float mx[2] = {m[0], m[1]};
      uint32_t dead = 0;  // bit 4 j + e: element e of n-tile j is masked
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[j][e] * scale_log2;
          if (masked) {
            const int key = j * 8 + 2 * t4 + (e & 1);  // in the chunk
            const int r = w0 + g + (e >> 1) * 8;       // in the tile
            const int qpos = q0 + r;
            const int kpos = kf + key;
            bool live = key < nk && r < nr;
            if (causal) live = live && kpos <= qpos;
            if (window > 0) live = live && kpos > qpos - window;
            if (!live) {
              x = kNegInf;
              dead |= 1u << (4 * j + e);
            }
          }
          sc[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // the 4 threads of a row are a quad
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
        alpha[i] = exp2f(m[i] - mx[i]);
        m[i] = mx[i];
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
      // p in f32 into the row sums; as bf16, the A fragments of P V (the
      // accumulator layout of n-tiles 2 kk and 2 kk + 1 is that of A)
      uint32_t pa[NS / 2][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = (dead >> (4 * j + e)) & 1u ? 0.f
                                            : exp2f(sc[j][e] - m[e >> 1]);
          l[e >> 1] += p[e];
        }
        pa[j / 2][(j % 2) * 2] = pack_bf16(p[0], p[1]);
        pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
      }
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk)
#pragma unroll
        for (int n = 0; n < NO; n += 2) {
          uint32_t b[4];
          ldsm_x4_trans(b, v_addr + (kk * 16 * LD + n * 8) * 2);
          mma_bf16(o[n], pa[kk], b[0], b[1]);
          mma_bf16(o[n + 1], pa[kk], b[2], b[3]);
        }
    }
    __syncthreads();  // the next prefetch overwrites this stage
    w = nw;
    c0 = nc0;
    have = more;
  }

  if (!warp_live) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(kFull, l[i], 1);
    l[i] += __shfl_xor_sync(kFull, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = w0 + g + 8 * i;
    if (r >= nr) continue;
    const float den = fmaxf(l[i], kTiny);
    bf16* orow = out + (static_cast<size_t>(bh) * s + q0 + r) * d;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = n * 8 + 2 * t4;
      const float x0 = o[n][2 * i] / den;
      const float x1 = o[n][2 * i + 1] / den;
      if (d % 2 == 0 && col < d) {  // col + 1 < d too: both even
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        if (col < d) orow[col] = __float2bfloat16_rn(x0);
        if (col + 1 < d) orow[col + 1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

template <int DT>
cudaError_t launch(const int* ell_idx, const int* valid, const void* q,
                   const void* k, const void* v, void* out, int bh, int bkv,
                   int s, int d, int n_slots, int block_q, int block_kv,
                   int causal, int window, float scale, cudaStream_t stream) {
  auto kernel = bsattn_tc_kernel<DT>;
  const size_t smem =
      Tile<DT>::bytes > kSmemFloor ? Tile<DT>::bytes : kSmemFloor;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const auto addr = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p);
  };
  const int vec = d % 8 == 0 && (addr(q) | addr(k) | addr(v)) % 16 == 0;
  const int tiles = (block_q + kTileQ - 1) / kTileQ;
  const dim3 grid((s / block_q) * tiles, bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      ell_idx, valid, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), s, d, n_slots,
      block_q, block_kv, bh / bkv, causal, window, scale * kLog2e, vec);
  return cudaGetLastError();
}

}  // namespace tc

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
  // the instance for the head dim rounded up to 64, 128 or 256
  const auto run = [&](auto launch) {
    return static_cast<int>(launch(ell_idx, valid, q, k, v, out, bh, bkv, s,
                                   d, n_slots, block_q, block_kv, causal,
                                   window, scale, st));
  };
  if (bf16)
    return d <= 64    ? run(tc::launch<64>)
           : d <= 128 ? run(tc::launch<128>)
                      : run(tc::launch<256>);
  return d <= 64    ? run(ffma::launch<float, 64>)
         : d <= 128 ? run(ffma::launch<float, 128>)
                    : run(ffma::launch<float, 256>);
}
