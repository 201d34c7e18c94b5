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
// bf16 tensor-core peak, 0.12 ms of bytes.  In f32 the least work at f32
// accuracy is three TF32 tensor-core products per product (below): 8.1e11
// FLOP, 1.64 ms at the dense TF32 peak (4.0 ms at the f32 FFMA peak).
//
// Two designs, chosen by dtype (bf16: tc, f32: tf32), share the work
// split and the skips:
//   * the Pallas grid (bh, q block, slot) carried m, l and acc in VMEM
//     across sequential slot steps; CTAs run in no order here, so one CTA
//     owns one (bh, q tile of 16 rows a warp) and loops over its
//     block-row's slots and over each slot's keys in chunks itself: the
//     statistics never leave the CTA and no sum crosses CTAs;
//   * an invalid slot is skipped, and so is a key chunk that causality or
//     the window masks for every row of the tile.  Both skips are exact:
//     such a chunk leaves m unchanged, so alpha = 1, and adds p = 0;
//   * the block-rows of the last q blocks carry the most slots under a
//     causal mask, so the grid is walked from the last q block down, and
//     the longest CTAs start first;
//   * the q tile and the key chunk need not divide block_q / block_kv:
//     rows past the block-row and keys past the slot are masked.
//
// bf16 (namespace tc): the products run on the tensor cores at the bf16
// bound above.  Each of 4 warps owns 16 q rows;
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
// f32 (namespace tf32): the same skeleton on the tensor cores with
// error-compensated TF32.  Each f32 operand x is split, where its fragment
// is read, into hi = x rounded to TF32 and lo = x - hi (exact in f32)
// rounded to TF32, and each product a b is summed as lo(a) hi(b) +
// hi(a) lo(b) + hi(a) hi(b): three mma.sync m16n8k8 TF32 -> f32, small
// terms first; the lo lo term and the two roundings leave about 2^-21 of
// the product, near f32's 2^-24 (TF32 alone: 2^-11).  No result is
// rounded to TF32: m, l and O are f32, and p is split like any operand.
// The tensor cores add f32 with truncation, so O is not summed there
// across chunks: each chunk's P V is summed from 0 (32 keys) and folded
// into O with one fmaf an element, O = alpha O + P V, which keeps a long
// row's error from growing with its keys.  What bounds
// it is the three products' tensor-core work (1.64 ms above) and, close
// behind, the splits, which every warp does for every fragment it reads.
// How the design answers:
//   * the split rounds with integer adds and masks on the ALU, not with
//     cvt.rna, which the conversion unit issues at a fraction of the ALU's
//     rate (the probe times a copy that uses cvt.rna);
//   * fragments are permuted so each is one float4 read.  An m16n8k8
//     product sums over 8 indices k, and which data column each k names is
//     free if both operands agree: for Q K^T a thread takes d columns
//     4t..4t+3 of each 16-column step (k = t, t + 4 of two products) from
//     one float4 of its Q rows and one of its K key; for P V, keys 2t, 2t+1
//     of each 8-key n-tile are k = t, t + 4, which is where the S
//     accumulator already holds p (no shuffle), and output columns 4g + i
//     of each 32-column group are n = g of n-tile i, so one float4 of V per
//     key feeds four products and a thread stores float4s;
//   * shared memory: f32 tiles are twice bf16's.  A chunk's K and V land
//     apart in one tile each: the next chunk's K loads while this chunk's
//     P V is multiplied, its V while its own Q K^T is.  Rows are padded so
//     every fragment read is free of bank conflicts (strides 16 mod 32
//     floats for Q / K, 4 mod 16 for V);
//   * registers: a warp that owns 16 rows and all of D holds O in D / 2
//     floats a thread, and the fold needs a chunk's P V and its split P
//     beside it.  Up to D = 128 that fits (4 warps, 64-row tiles).  At
//     D = 256 it would not (128 floats of O alone), so two warps share
//     each 16 rows and own 128 columns each: each sums Q K^T over its 128
//     d columns, the two add their halves through shared memory (the
//     same two addends in both, so both see the same scores, m and l),
//     and each multiplies P by its half of V.  That is 8 warps, 64 q
//     rows, 32-key K and V tiles and the partial scores: 154 KB, one CTA
//     an SM.  The loops are unrolled, so each warp keeps several loads and
//     products in flight.
// Head dims that are not a multiple of 4, or unaligned rows, are loaded
// without cp.async.
//
// The earlier f32 design (every product an FFMA on the CUDA cores, 4.0 ms
// bound above) is bsattn_ffma.cuh, built only into a copy of this file by
// python -m repro_torch.kernels.bsattn.tiles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kTiny = 1e-30f;
constexpr float kLog2e = 1.4426950408889634f;

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

// Rows [row0, row0 + n) of a [*, d] matrix of T into a [ROWS][LD] tile of
// THREADS threads, zero past n rows and d columns: by cp.async in 16-byte
// pieces where vec (d a multiple of 16 bytes and 16-byte aligned rows), by
// plain loads otherwise.
template <typename T, int DT, int LD, int ROWS, int THREADS>
__device__ __forceinline__ void load_rows(T* dst, const T* __restrict__ src,
                                          size_t row0, int n, int d,
                                          bool vec) {
  if (vec) {
    constexpr int PER = 16 / sizeof(T);
    constexpr int PIECES = DT / PER;
    for (int e = threadIdx.x; e < ROWS * PIECES; e += THREADS) {
      const int r = e / PIECES;
      const int c = (e - r * PIECES) * PER;
      const bool ok = r < n && c < d;
      cp_async16(smem_addr(dst + r * LD + c),
                 ok ? src + (row0 + r) * d + c : src, ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * DT; e += THREADS) {
      const int r = e / DT;
      const int c = e - r * DT;
      dst[r * LD + c] = (r < n && c < d) ? src[(row0 + r) * d + c] : T{};
    }
  }
}

namespace tc {

using bf16 = __nv_bfloat16;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileQ = kWarps * 16;  // 64 q rows per CTA, 16 per warp
constexpr int kStages = 2;           // K / V chunks in flight

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
    load_rows<bf16, DT, LD, KEYS, kThreads>(Ks + stage * L::KV_ELEMS, k,
                                            row0, nk, d, vec);
    load_rows<bf16, DT, LD, KEYS, kThreads>(Vs + stage * L::KV_ELEMS, v,
                                            row0, nk, d, vec);
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
    load_rows<bf16, DT, LD, kTileQ, kThreads>(
        Qs, q, static_cast<size_t>(bh) * s + q0, nr, d, vec);
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

namespace tf32 {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kKeys = 32;  // keys a chunk

// Warps a CTA, and warps that share a group of 16 q rows, each with
// DT / kSplit of the output columns.  O is D / 2 floats a thread for a
// warp that owns all of D, which at D = 256 leaves no registers for the
// per-chunk fold of P V (below): there two warps share each 16 rows, add
// their halves of the scores through shared memory, and own 128 output
// columns each.  At D = 256 the CTA is 8 warps and 64 q rows (70 KB), with
// one chunk each of K and V (68 KB) and the partial scores (16 KB); below,
// 4 warps and 64-row tiles (D = 128: 72 KB a CTA, three an SM).
template <int DT>
constexpr int kWarps = DT == 256 ? 8 : 4;
template <int DT>
constexpr int kSplit = DT == 256 ? 2 : 1;

template <int DT>
struct Tile {
  static constexpr int WARPS = kWarps<DT>;
  static constexpr int THREADS = WARPS * 32;
  static constexpr int SPLIT = kSplit<DT>;
  static constexpr int DW = DT / SPLIT;            // output columns a warp
  static constexpr int ROWS = WARPS / SPLIT * 16;  // q rows a CTA
  // Row strides in floats.  Q and K fragments are float4 reads of one row
  // per 4 lanes: a stride of 16 mod 32 puts the two rows a quarter-warp
  // reads on distinct banks.  V fragments are float4 reads of rows 2 t and
  // 2 t + 1 at columns 4 g: 4 mod 16 puts the four rows a quarter-warp
  // reads 8 banks apart.
  static constexpr int LDK = DT + 16;
  static constexpr int LDV = DT + 4;
  static constexpr int Q_ELEMS = ROWS * LDK;
  static constexpr int K_ELEMS = kKeys * LDK;
  static constexpr int V_ELEMS = kKeys * LDV;
  // each warp's 16 x kKeys partial scores, where two warps share the rows
  static constexpr int X_ELEMS = SPLIT > 1 ? WARPS * 16 * kKeys : 0;
  static constexpr size_t bytes =
      sizeof(float) *
      (static_cast<size_t>(Q_ELEMS) + K_ELEMS + V_ELEMS + X_ELEMS);
};

// f32 bits rounded to TF32 (the low 13 mantissa bits 0), to nearest with
// ties away from zero: cvt.rna's rounding for finite x, with an integer
// add and a mask, which issue at the ALU's rate where cvt runs at the
// conversion unit's lower one.
__device__ __forceinline__ uint32_t round_tf32(uint32_t bits) {
  return (bits + 0x1000u) & 0xffffe000u;
}

// x as hi + lo, both TF32: hi is x rounded to TF32 and lo is x - hi (exact
// in f32) rounded to TF32, so x - hi - lo is at most 2^-22 |x|.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = round_tf32(__float_as_uint(x));
  lo = round_tf32(__float_as_uint(x - __uint_as_float(hi)));
}

// d += a (16 x 8, row-major) * b (8 x 8, column-major), TF32 operands, f32
// accumulator
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b with f32 operands split as above: the three products that
// matter (lo lo is below 2^-22 of the product), the small ones first.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           uint32_t b0_hi, uint32_t b1_hi,
                                           uint32_t b0_lo, uint32_t b1_lo) {
  mma_tf32(d, a_lo, b0_hi, b1_hi);
  mma_tf32(d, a_hi, b0_lo, b1_lo);
  mma_tf32(d, a_hi, b0_hi, b1_hi);
}

template <int DT>
__global__ void __launch_bounds__(Tile<DT>::THREADS, DT == 256 ? 1 : 2)
    bsattn_tf32_kernel(const int* __restrict__ ell_idx,
                       const int* __restrict__ valid,
                       const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       int s, int d, int n_slots, int block_q, int block_kv,
                       int group, int causal, int window, float scale_log2,
                       int vec) {
  using L = Tile<DT>;
  constexpr int KEYS = kKeys;
  constexpr int LDK = L::LDK;
  constexpr int LDV = L::LDV;
  constexpr int ROWS = L::ROWS;
  constexpr int THREADS = L::THREADS;
  constexpr int DW = L::DW;
  constexpr int NS = KEYS / 8;  // 8-key n-tiles of a warp's scores
  constexpr int NG = DW / 32;   // 32-column groups of its output
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;             // [ROWS][LDK]
  float* Ks = Qs + L::Q_ELEMS;  // [KEYS][LDK]
  float* Vs = Ks + L::K_ELEMS;  // [KEYS][LDV]
  // [WARPS][NS][32 lanes] float4: partial scores (SPLIT > 1)
  float4* Xs = reinterpret_cast<float4*>(Vs + L::V_ELEMS);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // fragment rows g and g + 8
  const int t4 = lane % 4;  // fragment columns
  const int col0 = warp % L::SPLIT * DW;  // this warp's d columns

  const int tiles = (block_q + ROWS - 1) / ROWS;
  const int nq = s / block_q;
  const int qi = nq - 1 - static_cast<int>(blockIdx.x) / tiles;
  const int q0 = qi * block_q + (blockIdx.x % tiles) * ROWS;
  const int nr = min(ROWS, (qi + 1) * block_q - q0);  // live rows
  const int bh = blockIdx.y;
  const size_t kv_row0 = static_cast<size_t>(bh / group) * s;
  const int* slot_idx = ell_idx + static_cast<size_t>(qi) * n_slots;
  const int* slot_ok = valid + static_cast<size_t>(qi) * n_slots;
  const int q_last = q0 + nr - 1;
  const int w0 = warp / L::SPLIT * 16;  // this warp's first tile row
  const bool warp_live = w0 < nr;
  const int wq0 = q0 + w0;                    // its first position
  const int wq1 = q0 + min(w0 + 15, nr - 1);  // its last live position

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
  // the chunk at (w, c0) of K, then of V, into its tile; one cp.async group
  // each
  auto load_k = [&](int w, int c0) {
    load_rows<float, DT, LDK, KEYS, THREADS>(
        Ks, k, kv_row0 + static_cast<size_t>(slot_idx[w]) * block_kv + c0,
        min(KEYS, block_kv - c0), d, vec);
    cp_async_commit();
  };
  auto load_v = [&](int w, int c0) {
    load_rows<float, DT, LDV, KEYS, THREADS>(
        Vs, v, kv_row0 + static_cast<size_t>(slot_idx[w]) * block_kv + c0,
        min(KEYS, block_kv - c0), d, vec);
    cp_async_commit();
  };

  // O: output column col0 + 32 G + 4 (fragment column) + i of 32-column
  // group G sits in n-tile i (see the P V products below)
  float o[NG][4][4];
#pragma unroll
  for (int G = 0; G < NG; ++G)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[G][i][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // rows g and g + 8, scaled by log2(e)
  float l[2] = {0.f, 0.f};          // this thread's part of the row sums

  int w = 0, c0 = -KEYS;
  bool have = next_chunk(w, c0);
  if (have) {
    load_rows<float, DT, LDK, ROWS, THREADS>(
        Qs, q, static_cast<size_t>(bh) * s + q0, nr, d, vec);
    load_k(w, c0);  // with Q in its group
    load_v(w, c0);
  }
  // Fragments.  An m16n8k8 product sums over 8 indices k; which column of
  // the data each k names is free as long as both operands agree.  For
  // S = Q K^T, the d columns 4 t, 4 t + 1 (then 4 t + 2, 4 t + 3) of a
  // 16-column step are k = t and t + 4 of two products, so a thread reads
  // Q rows g, g + 8 and K key g as one float4 each.  For O += P V, keys
  // 2 t, 2 t + 1 of an 8-key n-tile are k = t and t + 4: that is where the
  // S accumulator already holds p, so P needs no shuffle; and the output
  // columns 4 g + i of a 32-column group are n = g of n-tile i, so a
  // thread reads V keys 2 t and 2 t + 1 as one float4 each.  A warp reads
  // its own DW columns of Q, K and V.
  const float* q_frag = Qs + (w0 + g) * LDK + 4 * t4 + col0;
  const float* k_frag = Ks + g * LDK + 4 * t4 + col0;
  const float* v_frag = Vs + 2 * t4 * LDV + 4 * g + col0;

  // K and V of a chunk land apart, one tile each: the next chunk's K loads
  // while this chunk's P V is multiplied, and its V while its Q K^T is
  // (at D = 256 two stages of both would not fit beside the q tile).
  while (have) {
    int nw = w, nc0 = c0;
    const bool more = next_chunk(nw, nc0);
    cp_async_wait<1>();  // this chunk's K; its V may still be landing
    __syncthreads();

    const int kf = slot_idx[w] * block_kv + c0;  // the chunk's first key
    const int nk = min(KEYS, block_kv - c0);
    // a warp whose rows the chunk masks entirely skips it (exact)
    const bool skip = !warp_live || (causal && kf > wq1) ||
                      (window > 0 && kf + nk - 1 <= wq0 - window);
    float sc[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    if (!skip) {
#pragma unroll
      for (int kk = 0; kk < DW; kk += 16) {
        const float4 x0 = *reinterpret_cast<const float4*>(q_frag + kk);
        const float4 x1 =
            *reinterpret_cast<const float4*>(q_frag + 8 * LDK + kk);
        float4 y[NS];
#pragma unroll
        for (int j = 0; j < NS; ++j)
          y[j] = *reinterpret_cast<const float4*>(k_frag + j * 8 * LDK + kk);
        // two 8-column steps: columns 4 t, 4 t + 1, then 4 t + 2, 4 t + 3
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t ah[4], al[4];
          split(h ? x0.z : x0.x, ah[0], al[0]);
          split(h ? x1.z : x1.x, ah[1], al[1]);
          split(h ? x0.w : x0.y, ah[2], al[2]);
          split(h ? x1.w : x1.y, ah[3], al[3]);
#pragma unroll
          for (int j = 0; j < NS; ++j) {
            uint32_t bh0, bl0, bh1, bl1;
            split(h ? y[j].z : y[j].x, bh0, bl0);
            split(h ? y[j].w : y[j].y, bh1, bl1);
            mma_3xtf32(sc[j], ah, al, bh0, bh1, bl0, bl1);
          }
        }
      }
    }
    if (L::SPLIT > 1 && !skip) {  // for the warp that shares the rows
      float4* x = Xs + warp * NS * 32 + lane;
#pragma unroll
      for (int j = 0; j < NS; ++j)
        x[j * 32] = make_float4(sc[j][0], sc[j][1], sc[j][2], sc[j][3]);
    }
    __syncthreads();  // every warp is done with this K
    if (more) {
      load_k(nw, nc0);
      cp_async_wait<1>();  // this chunk's V; the next K may still land
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (!skip) {
      if (L::SPLIT > 1) {  // its partner's half of d: both add the same two
        const float4* x = Xs + (warp ^ 1) * NS * 32 + lane;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const float4 y = x[j * 32];
          sc[j][0] += y.x;
          sc[j][1] += y.y;
          sc[j][2] += y.z;
          sc[j][3] += y.w;
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
      // p in f32 into the row sums, and split as the A fragments of P V:
      // (p of rows g, g + 8 at keys 2 t, then 2 t + 1) of each 8-key n-tile
      uint32_t ph[NS][4], pl[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = (dead >> (4 * j + e)) & 1u ? 0.f
                                            : exp2f(sc[j][e] - m[e >> 1]);
          l[e >> 1] += p[e];
        }
        split(p[0], ph[j][0], pl[j][0]);
        split(p[2], ph[j][1], pl[j][1]);
        split(p[1], ph[j][2], pl[j][2]);
        split(p[3], ph[j][3], pl[j][3]);
      }
      // O = alpha O + P V.  The chunk's P V is summed on the tensor cores
      // from 0 and folded into O with one fmaf an element: the tensor
      // cores add f32 with truncation, so O summed there over every chunk
      // of a long row would drift.
#pragma unroll
      for (int G = 0; G < NG; ++G) {
        float po[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) po[i][e] = 0.f;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const float* vj = v_frag + j * 8 * LDV + G * 32;
          const float4 va = *reinterpret_cast<const float4*>(vj);
          const float4 vb = *reinterpret_cast<const float4*>(vj + LDV);
          uint32_t b0h[4], b0l[4], b1h[4], b1l[4];
          split(va.x, b0h[0], b0l[0]);
          split(va.y, b0h[1], b0l[1]);
          split(va.z, b0h[2], b0l[2]);
          split(va.w, b0h[3], b0l[3]);
          split(vb.x, b1h[0], b1l[0]);
          split(vb.y, b1h[1], b1l[1]);
          split(vb.z, b1h[2], b1l[2]);
          split(vb.w, b1h[3], b1l[3]);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            mma_3xtf32(po[i], ph[j], pl[j], b0h[i], b1h[i], b0l[i], b1l[i]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[G][i][e] = fmaf(o[G][i][e], alpha[e >> 1], po[i][e]);
      }
    }
    __syncthreads();  // every warp is done with this V
    if (more) load_v(nw, nc0);
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
    float* orow = out + (static_cast<size_t>(bh) * s + q0 + r) * d;
#pragma unroll
    for (int G = 0; G < NG; ++G)
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // columns 32 G + 8 t + 4 h + (0..3)
        const int col = col0 + G * 32 + 8 * t4 + 4 * h;
        float x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] = o[G][e][2 * i + h] / den;
        if (vec && col < d) {  // col + 3 < d too: d % 4 == 0
          *reinterpret_cast<float4*>(orow + col) =
              make_float4(x[0], x[1], x[2], x[3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (col + e < d) orow[col + e] = x[e];
        }
      }
  }
}

template <int DT>
cudaError_t launch(const int* ell_idx, const int* valid, const void* q,
                   const void* k, const void* v, void* out, int bh, int bkv,
                   int s, int d, int n_slots, int block_q, int block_kv,
                   int causal, int window, float scale, cudaStream_t stream) {
  using L = Tile<DT>;
  auto kernel = bsattn_tf32_kernel<DT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::bytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const auto addr = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p);
  };
  const int vec =
      d % 4 == 0 && (addr(q) | addr(k) | addr(v) | addr(out)) % 16 == 0;
  const int tiles = (block_q + L::ROWS - 1) / L::ROWS;
  const dim3 grid((s / block_q) * tiles, bh);
  kernel<<<grid, L::THREADS, L::bytes, stream>>>(
      ell_idx, valid, static_cast<const float*>(q),
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), s, d, n_slots, block_q, block_kv, bh / bkv,
      causal, window, scale * kLog2e, vec);
  return cudaGetLastError();
}

}  // namespace tf32

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
  return d <= 64    ? run(tf32::launch<64>)
         : d <= 128 ? run(tf32::launch<128>)
                    : run(tf32::launch<256>);
}
