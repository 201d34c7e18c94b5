// Transposed Block-ELL SpMM (N1) for sm_90a: Y = Aᵀ H with A in Block-ELL,
// reading A's blocks in place, transposed, and summing every output element
// in one fixed order.
//
// No Pallas kernel of the JAX package computes this product: its backward
// runs it in jnp, as an einsum over the transposed Block-COO view followed
// by a segment sum (src/repro/sparse/paths.py:162-181, 53-59), and its
// pruned MLP products reach the same function (x @ W = (Wᵀ xᵀ)ᵀ,
// src/repro/models/layers.py:91-104).  The port ran the same two steps
// (einsum + index_add_), and on CUDA index_add_ sums in an unspecified
// order, so a training step's gradients differed in their last bits from
// run to run.  This kernel computes the same function with no atomics.
//
//   Y[j-block, :] = sum over the list of block column j, in order, of
//                   blocks[s]ᵀ @ H[(s / w)-block, :]
//
// The list of block column j holds the slots s = i * w + t of A whose
// block column is j, the padded slots left out (t >= nblocks[i]), in
// ascending block-row i; the wrapper builds it once per structure
// (kernels/spmm/transposed.py).  Blocks, H and Y are one element type T
// (f32, bf16 or f16; the wrapper promotes mixed operands to their common
// type).  Sums are f32 and Y is rounded once, at the store.
//
// Three paths compute it; the wrapper picks one by a rule on D, the dtype,
// the block shape and the structure's shape alone (transposed.n1_plan), so
// the same inputs always take the same path, no launch reads the values
// or syncs with the host, and two launches give equal bits.  The rule:
// D <= 8 the stream path; D >= 64 on 64-column blocks of 16k rows the mma
// path; else the sparse path.  Crossovers measured on an H100 (700 W) by
// python -m repro_torch.kernels.spmm.transposed_parts, f32: on graph (a)
// (10 % fill) the stream path takes 0.34 ms at D = 1 to 8 against the
// sparse path's 0.87-1.06 and the mma path's 1.25-1.33; the sparse path
// beats the mma path at D = 16 and 32 (1.06 against 1.24 ms), ties it at
// D = 64 and loses at D = 128 (1.56 against 1.24); on the pruned LM's
// full 64 x 64 tiles the mma path takes 0.25-0.27 ms at D = 2048 and
// 1.70-1.79 ms at D = 16384 against the sparse path's 1.24-1.26 and
// 8.8-9.7, and the stream path 0.011-0.014 ms at D = 4 and 8 against the
// mma path's 0.038-0.061.
//
//  (a) mma: tensor cores, for wide D on 64-column blocks (bn = 64, bm a
//      multiple of 16).  What bounds it: operations.  At the pruned
//      gemma3-4b's prefill (D = B S = 16384, 640 real 64 x 64 blocks a
//      weight) a product is 86 GFLOP, and f32 at f32 accuracy takes three
//      TF32 products per product: 0.52 ms at 495 TFLOP/s, against 0.25 ms
//      of bytes (H and Y, 840 MB).  Design:
//       - A CTA owns a 64 x 128 tile of Y (block column j, D-tile t) and
//         walks j's list: per slot, the staged block read transposed is
//         the mma's A (64 x bm) and H's bm x 128 tile its B.  Eight
//         consumer warps own 32 x 32 each (2 along the block's columns,
//         4 along D); a producer warp streams each slot's block and H
//         tile into a ring of shared-memory stages with 2-D TMA copies
//         (cp.async.bulk.tensor, one per 128-byte-wide box: f32 2 + 4,
//         16-bit 1 + 2) in the 128-byte swizzle, which keeps the
//         fragment reads free of bank conflicts.  (One 1-D bulk copy a
//         padded row, 128 a stage, issued a copy every ~70 cycles, and
//         16-byte cp.async from the producer's lanes were slower still:
//         either way the ring alone took 90 % of the path's time.)
//       - f32: error-compensated TF32 (tf32x3.cuh; K9's f32 arithmetic):
//         each operand split where its fragment is read into hi + lo, and
//         lo(a) hi(b) + hi(a) lo(b) + hi(a) hi(b) summed by three mma.sync
//         m16n8k8.  Fragments are permuted as K9's are, so each is one
//         float4 read: with c(g) = g / 2 + 4 (g % 2), mma row r of m-tile
//         j (of the warp's two) is the block's column 4 c(r % 8) + 2 j +
//         r / 8 of the warp's 32, and mma column n of n-tile i (of four)
//         is D column 4 c(n) + i, so a thread's A fragments are two
//         float4 (16-byte chunk c(g) of block rows k + t and k + t + 4),
//         its B fragments two float4 of H rows, and it stores float4s;
//         the 8 lanes of a quarter-warp then read 8 distinct swizzled
//         chunk positions.  bf16 / f16: mma.sync m16n8k16 with f32 sums,
//         both operands read by ldmatrix.trans (the block is A transposed
//         and H's tile is row-major).  mma.sync, not wgmma: wgmma takes
//         TF32 only K-major from shared memory, and here both operands
//         are MN-major.
//       - The tensor cores add with truncation, so each slot's product is
//         summed from 0 and added to the f32 accumulator with one fadd an
//         element: a long list's error does not grow with the list.
//       - Persistent CTAs (one an SM, grid = SMs) walk the (j, t) tiles
//         D-tile-major, so the CTAs that run together share one D-slice
//         of H (bm x 128 per block-row) and H, the operand that does not
//         fit in L2, is read from device memory about once; the ring
//         runs on across a CTA's tiles.
//  (b) stream: D <= 8, every fill.  What bounds it: the bytes of the
//      blocks (at the LM's decode, 10.7 MB of f32 blocks a weight: 3.2 us;
//      on graph (a) of chip_smoke.py 1.07 GB: 0.32 ms).  No row bits and
//      no compaction: each slot's block is read once from device memory,
//      coalesced (lane l of a warp reads columns l, l + 32, ... of a
//      block row: Y's rows), each unit of 16 block rows with all its
//      loads in flight before its sums, while the unit's H rows (<= 8
//      columns) are staged in shared memory and read broadcast.  A
//      column's list is cut into `chunks` near-equal runs (entries
//      len * q / chunks .. len * (q + 1) / chunks of the list), one CTA
//      each, so that at least 132 CTAs run where the lists allow (the
//      LM's wo: 40 block columns of 16 slots); 8 warps take a chunk's
//      units in turn and add their partial sums in warp order; where a
//      column has several chunks, the CTA writes its f32 partial and a
//      second kernel adds the chunks' partials in chunk order.
//  (c) sparse: the nonzero-granular FFMA body below, for the other block
//      shapes and mid D.  What bounds it: the bytes of `blocks`, read
//      once (1.07 GB of f32 on graph (a), 0.32 ms at 3.35 TB/s); H (8 MB)
//      stays in the 50 MB L2.  The design follows K1's (spmm_blockell.cu),
//      with the compaction turned by 90 degrees:
//  - Ring.  A producer warp walks the CTA's list and streams each slot's
//    block and the bm x DT tile of H its block-row names into a ring of
//    shared-memory stages with 1-D bulk copies (cp.async.bulk), completing
//    on the stage's mbarrier; sixteen consumer warps release a stage
//    through a second mbarrier.  A pointer or width that is not 16-byte
//    aligned is copied by the producer's lanes instead.
//  - Compaction by column, without bank conflicts.  A column of a staged
//    block lies on one shared-memory bank (its rows are bn elements
//    apart), so no warp reads a whole column.  Instead the sixteen
//    consumer warps read the block by rows (warp w rows w, w + 16, ...; a
//    lane a column: conflict-free) and __ballot_sync each 32-column
//    segment into a word of row bits; after a barrier of the consumer
//    warps, the warp that owns column c takes bit c of every row's word
//    (a lane a row), and one more ballot and a popc per 32 rows place each
//    nonzero row's (H-row offset, value) in the column's list in shared
//    memory, in ascending row: the transpose of K1's per-row compaction.
//    Only the nonzero lanes read the column's values.
//  - Sums.  Output row c (A's tile column c) belongs to warp c % 16.  LG
//    lanes per output row, 4 columns of D a lane (LG = 32 for a D-tile
//    above 64 columns, 16 above 32, else 8: then 2 or 4 output rows at
//    once).  A lane group adds value(r, c) x H-tile row r over its
//    column's list, four entries (H rows) in flight, the lists summed
//    together padded with zero-row entries as K1 pads them (a walk of the
//    column masks themselves, without lists, spent more instructions per
//    nonzero, popping bits of 64-bit masks, than it hid).  At D <= 4 the
//    8 lanes of a group
//    split a column's list (entries k, k + 8, ...) and add their partial
//    sums at the end.  Zeros in a block cost nothing; padded slots are not
//    in the list.
//  - One read of each block.  A CTA owns an output block-row's whole D up
//    to 128 columns (64 where bn > 64); wider D is cut into D-tiles whose
//    CTAs are neighbours in launch order, so the second read hits L2.
// Stored zeros: (a) and (b) multiply them, so where H holds inf or NaN
// they give what the plain version's einsum gives; (c) skips them.
// Order: every path sums each output element in one order fixed by the
// list, the block and the launch's shape: (a) per slot in the tensor
// cores' order, the slots then added in list order; (b) per warp in unit
// order, the warps in warp order, the chunks in chunk order; (c) fmaf
// from 0 over the list in order (ascending source block-row), within a
// block in ascending source row (at D <= 4 per lane of a group, entries
// k, k + 8, ..., the lanes then added in a fixed tree).
// Occupancy: (a) and (c) one CTA an SM, up to 227 KB of shared memory
// ((c): 17 warps, the row bits, a zero H row, the lists and the ring;
// (a): 9 warps and the ring, 4 stages of 48 KB in f32, 8 of 24 KB in
// 16-bit); (b) 8 warps and up to 36 KB, several an SM.  An operand that
// is not 16-byte aligned (or H rows that are not a multiple of 16 bytes)
// is copied by the producer's lanes on every path: (a) into the same
// swizzled layout, (c) as it lands.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "blockell_ring.cuh"
#include "tf32x3.cuh"

namespace {

using namespace ring;  // NOLINT: the ring primitives, shared with K1 and K7

constexpr int kWarps = 16;                   // consumer warps
constexpr int kThreads = (kWarps + 1) * 32;  // + the producer warp
constexpr int kMaxDT = 128;                  // D columns per CTA: 4 a lane
constexpr int kMaxStages = 8;
constexpr int kBarrierBytes = 2 * kMaxStages * 8;  // full[], empty[]
constexpr int kMaxBlock = 128;  // largest bm / bn: masks of 2 x 64 rows
constexpr size_t kMaxSmem = 227 * 1024;  // one CTA per SM
constexpr unsigned kFull = 0xffffffffu;
constexpr int kConsumerBarrier = 1;  // named barrier of the consumer warps

struct Params {
  const int* col_ptr;    // int32[nbc + 1]: list of block column j
  const int* col_slots;  // int32[col_ptr[nbc]]: slots i * w + t
  const void* blocks;    // [nbr * w, bm, bn]
  const void* h;         // [nbr * bm, d]
  void* y;               // [nbc * bn, d]
  int w, bm, bn, d;
  int dt;       // D columns per CTA (the D-tile)
  int n_dt;     // D-tiles
  int stages;   // ring depth
  int hs;       // row stride of a staged H tile, in elements
  int a_bytes;  // one staged block, padded to 16
  int h_bytes;  // one staged H tile, padded to 16
  int bulk_a;   // blocks copied by the bulk engine (else by lanes)
  int bulk_h;   // H tiles copied by the bulk engine (else by lanes)
  int nwc;      // words of a row's bits: ceil(bn / 32)
  int bits_at;  // byte offset of the row bits, kMaxStages x bm x nwc words
  int zero_at;   // byte offset of a zero H row (hs elements)
  int list_len;  // entries of one (offset, value) list: a column's rows
  int lists_at;  // byte offset of the lists, kWarps x RPS x list_len
  int ring_at;   // byte offset of the ring
};

// Lanes per output row: 4 columns a lane, so 32 lanes cover a 128-column
// D-tile and 8 lanes a 16- or 32-column one (four rows at once).
__host__ __device__ constexpr int lanes_per_row(int dt) {
  return dt > 64 ? 32 : dt > 32 ? 16 : 8;
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync %0, %1;" ::"n"(kConsumerBarrier),
               "n"(kWarps * 32)
               : "memory");
}

// Row bits of the staged block: word hw of row r has bit l set where
// column 32 hw + l is nonzero.  Warp `warp` does rows warp, warp + 16, ...
template <class T>
__device__ __forceinline__ void row_bits(const T* __restrict__ as,
                                         uint32_t* __restrict__ bits,
                                         const Params& p, int warp,
                                         int lane) {
  for (int r = warp; r < p.bm; r += kWarps)
    for (int hw = 0; hw < p.nwc; ++hw) {
      const int c = 32 * hw + lane;
      const bool nz = c < p.bn && Elem<T>::to_f(as[r * p.bn + c]) != 0.f;
      const unsigned b = __ballot_sync(kFull, nz);
      if (lane == 0) bits[r * p.nwc + hw] = b;
    }
}

// Compacts column c of the staged block into `list` (lanes = rows, 32 at
// a time, `words[k]` holding the row bits of row 32 k + lane in which bit
// sh is column c's): (byte offset of H row r in the staged tile, value)
// for each nonzero row r, in ascending r.  Returns the count.
template <class T, int NW>
__device__ __forceinline__ int compact_column(
    const T* __restrict__ as, const uint32_t (&words)[NW], const Params& p,
    int c, int sh, int lane, int2* list) {
  const int row_bytes = p.hs * static_cast<int>(sizeof(T));
  const unsigned below = (1u << lane) - 1;
  int n = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    if (32 * k < p.bm) {  // the same for every lane
      const int r = 32 * k + lane;
      const bool on = c < p.bn && ((words[k] >> sh) & 1u);
      const unsigned b = __ballot_sync(kFull, on);
      if (on)
        list[n + __popc(b & below)] = make_int2(
            r * row_bytes, __float_as_int(Elem<T>::to_f(as[r * p.bn + c])));
      n += __popc(b);
    }
  }
  return n;
}

// One slot for one consumer warp: its output rows (A's tile columns) c =
// warp + 16 q, q = st * RPS + lane / LG at step st.  Each step's RPS
// columns are compacted from the row bits into the warp's lists; then LG
// lanes per column (4 columns of D each) add the list's entries, E per
// iteration (E H rows in flight).  The lists summed together are padded
// to the same multiple of E with entries naming the zero H row and the
// value 0, so every load and fmaf is unconditional (as in K1).  With
// SPLIT > 1 (D <= 4: the LG lanes of a group would all read the same
// columns of H) lane k of a group adds only the entries k, k + SPLIT, ...
// of its column's list; the partial sums are added at the end.  NW words
// of 32 rows or columns cover the block (2 up to 64 x 64, else 4).
template <class T, int R, int LG, int SPLIT, int NW>
__device__ __forceinline__ void consume(
    const T* __restrict__ as, const T* __restrict__ hs_tile,
    const T* __restrict__ zero_row, const uint32_t* __restrict__ bits,
    const Params& p, int warp, int lane, int col, int2* lists,
    float (&acc)[(R * LG + 31) / 32][4]) {
  constexpr int RPS = 32 / LG;  // output rows summed at once
  constexpr int STEPS = (R * LG + 31) / 32;
  constexpr int E = R >= 8 ? 2 : 4;
  const int g = lane / LG;
  const unsigned char* hl =
      reinterpret_cast<const unsigned char*>(hs_tile + col);
  const int pad = static_cast<int>((zero_row - hs_tile) * sizeof(T));
  // the row bits of rows 32 k + lane, word hw (column c's word is c / 32
  // = q / 2, since c = warp + 16 q with warp < 16)
  uint32_t rw[NW][NW];
#pragma unroll
  for (int k = 0; k < NW; ++k)
#pragma unroll
    for (int hw = 0; hw < NW; ++hw)
      rw[k][hw] = 32 * k + lane < p.bm && hw < p.nwc
                      ? bits[(32 * k + lane) * p.nwc + hw]
                      : 0u;
#pragma unroll
  for (int st = 0; st < STEPS; ++st) {
    int cnt[RPS];
#pragma unroll
    for (int kk = 0; kk < RPS; ++kk) {
      const int q = st * RPS + kk;
      // a column past 32 NW is past bn: its bits are never read
      const int hw = (q >> 1) < NW ? q >> 1 : NW - 1;
      uint32_t words[NW];
#pragma unroll
      for (int k = 0; k < NW; ++k) words[k] = rw[k][hw];
      cnt[kk] = compact_column<T, NW>(as, words, p, warp + kWarps * q,
                               warp + kWarps * (q & 1), lane,
                               lists + kk * p.list_len);
    }
    int most = 0, mine = 0;
#pragma unroll
    for (int kk = 0; kk < RPS; ++kk) {
      most = max(most, cnt[kk]);
      if (kk == g) mine = cnt[kk];
    }
    const int2* list = lists + g * p.list_len;
    if (SPLIT > 1) {
      __syncwarp();
#pragma unroll 1
      for (int e = lane % SPLIT; e < mine; e += SPLIT) {
        const int2 en = list[e];
        const float v = __int_as_float(en.y);
        const float4 x = Elem<T>::load4(reinterpret_cast<const T*>(hl + en.x));
        acc[st][0] = fmaf(v, x.x, acc[st][0]);
        acc[st][1] = fmaf(v, x.y, acc[st][1]);
        acc[st][2] = fmaf(v, x.z, acc[st][2]);
        acc[st][3] = fmaf(v, x.w, acc[st][3]);
      }
    } else {
      const int len = (most + E - 1) / E * E;
      for (int e = mine + lane % LG; e < len; e += LG)
        lists[g * p.list_len + e] = make_int2(pad, 0);
      __syncwarp();
#pragma unroll 1
      for (int j = 0; j < len; j += E) {
        int4 en[E / 2];
#pragma unroll
        for (int u = 0; u < E / 2; ++u)
          en[u] = *reinterpret_cast<const int4*>(&list[j + 2 * u]);
        float4 x[E];
#pragma unroll
        for (int u = 0; u < E / 2; ++u) {
          x[2 * u] = Elem<T>::load4(reinterpret_cast<const T*>(hl + en[u].x));
          x[2 * u + 1] =
              Elem<T>::load4(reinterpret_cast<const T*>(hl + en[u].z));
        }
#pragma unroll
        for (int u = 0; u < E; ++u) {
          const float v = __int_as_float(u % 2 ? en[u / 2].w : en[u / 2].y);
          acc[st][0] = fmaf(v, x[u].x, acc[st][0]);
          acc[st][1] = fmaf(v, x[u].y, acc[st][1]);
          acc[st][2] = fmaf(v, x[u].z, acc[st][2]);
          acc[st][3] = fmaf(v, x[u].w, acc[st][3]);
        }
      }
    }
    __syncwarp();  // the lists are rewritten at the next step
  }
}

// Output row `row`, columns col0 .. col0 + 3 (those below col_end),
// rounded once to T.
template <class T>
__device__ __forceinline__ void store4(const Params& p, size_t row, int col0,
                                       int col_end, const float (&z)[4]) {
  T* y = static_cast<T*>(p.y);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (col0 + j < col_end) y[row * p.d + col0 + j] = Elem<T>::from_f(z[j]);
}

// The producer warp's fill of ring stage it % stages with list entry e0 +
// it: the slot's block and the bm x dt tile of H its block-row names; lane
// 0 arms the stage's mbarrier with the bytes to come.
template <class T>
__device__ __forceinline__ void fill_stage(const Params& p,
                                           unsigned char* ring,
                                           uint64_t* full, int e0, int it,
                                           int d0, int dt, int lane,
                                           uint64_t stream, uint64_t keep) {
  const int st = it % p.stages;
  const size_t at = static_cast<size_t>(st) * (p.a_bytes + p.h_bytes);
  T* as = reinterpret_cast<T*>(ring + at);
  T* hst = reinterpret_cast<T*>(ring + at + p.a_bytes);
  const int s = p.col_slots[e0 + it];
  const int i = s / p.w;
  const int block_elems = p.bm * p.bn;
  const T* a_src =
      static_cast<const T*>(p.blocks) + static_cast<size_t>(s) * block_elems;
  const T* h_src = static_cast<const T*>(p.h) +
                   static_cast<size_t>(i) * p.bm * p.d + d0;
  const uint32_t a_exact = block_elems * sizeof(T);
  const uint32_t h_row = dt * sizeof(T);
  if (!p.bulk_a)
    for (int e = lane; e < block_elems; e += 32) as[e] = a_src[e];
  if (!p.bulk_h)
    for (int e = lane; e < p.bm * dt; e += 32) {
      const int k = e / dt;
      hst[k * p.hs + (e - k * dt)] =
          h_src[static_cast<size_t>(k) * p.d + (e - k * dt)];
    }
  if (!p.bulk_a || !p.bulk_h) __threadfence_block();
  __syncwarp();
  if (lane == 0)
    mbar_arrive_expect_tx(
        &full[st], (p.bulk_a ? a_exact : 0) +
                       (p.bulk_h ? static_cast<uint32_t>(p.bm) * h_row : 0));
  __syncwarp();
  if (p.bulk_a && lane == 0) bulk_copy(as, a_src, a_exact, &full[st], stream);
  if (p.bulk_h) {
    if (dt == p.d) {  // the H tile is one contiguous run
      if (lane == 0) bulk_copy(hst, h_src, p.bm * h_row, &full[st], keep);
    } else {
      for (int k = lane; k < p.bm; k += 32)
        bulk_copy(hst + k * p.hs, h_src + static_cast<size_t>(k) * p.d,
                  h_row, &full[st], keep);
    }
  }
}

// Grid: one CTA per (output block-row j, D-tile t), x = j * n_dt + t.
template <class T, int R, int LG, int SPLIT, int NW>
__global__ void __launch_bounds__(kThreads, 1)
    spmm_blockell_t_kernel(const Params p) {
  constexpr int RPS = 32 / LG;
  constexpr int STEPS = (R * LG + 31) / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  uint32_t* bits_all = reinterpret_cast<uint32_t*>(smem + p.bits_at);
  T* zero_row = reinterpret_cast<T*>(smem + p.zero_at);
  int2* lists = reinterpret_cast<int2*>(smem + p.lists_at) +
                (threadIdx.x / 32) * RPS * p.list_len;
  unsigned char* ring = smem + p.ring_at;

  const int j = blockIdx.x / p.n_dt;
  const int d0 = (blockIdx.x % p.n_dt) * p.dt;
  const int dt = min(p.dt, p.d - d0);
  const int e0 = p.col_ptr[j];
  const int n_ent = p.col_ptr[j + 1] - e0;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  for (int e = threadIdx.x; e < p.hs; e += kThreads)
    zero_row[e] = Elem<T>::from_f(0.f);
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  float acc[STEPS][4];
#pragma unroll
  for (int s = 0; s < STEPS; ++s)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[s][k] = 0.f;
  // this lane's 4 columns of the D-tile (with SPLIT, columns 0-3 for
  // every lane of a group); lanes past dt read column 0's and store
  // nothing
  const int col = SPLIT > 1 ? 0 : 4 * (lane % LG);

  if (warp == kWarps) {
    // producer: entry it into stage it % stages once the consumers have
    // released what that stage held
    const uint64_t stream = l2_policy(true), keep = l2_policy(false);
    for (int it = 0; it < n_ent; ++it) {
      if (it >= p.stages)
        mbar_wait(&empty[it % p.stages], ((it / p.stages) - 1) & 1);
      fill_stage<T>(p, ring, full, e0, it, d0, dt, lane, stream, keep);
    }
    return;
  }
  for (int it = 0; it < n_ent; ++it) {
    const int st = it % p.stages;
    mbar_wait(&full[st], (it / p.stages) & 1);
    const unsigned char* base =
        ring + static_cast<size_t>(st) * (p.a_bytes + p.h_bytes);
    const T* as = reinterpret_cast<const T*>(base);
    // a stage's row bits are written again `stages` entries later, after
    // every consumer warp has passed this entry's barrier and the next
    uint32_t* bits = bits_all + static_cast<size_t>(st) * p.bm * p.nwc;
    row_bits<T>(as, bits, p, warp, lane);
    consumer_sync();
    consume<T, R, LG, SPLIT, NW>(
        as, reinterpret_cast<const T*>(base + p.a_bytes), zero_row, bits, p,
        warp, lane, col < dt ? col : 0, lists, acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }
  if (SPLIT > 1) {  // the row classes' partial sums, in a fixed tree
#pragma unroll
    for (int s = 0; s < STEPS; ++s)
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int o = SPLIT / 2; o > 0; o /= 2)
          acc[s][k] += __shfl_xor_sync(kFull, acc[s][k], o);
  }
  if (col < dt && lane % SPLIT == 0) {
    const size_t row0 = static_cast<size_t>(j) * p.bn;
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      const int c = warp + kWarps * (s * RPS + lane / LG);
      if (c < p.bn) store4<T>(p, row0 + c, d0 + col, d0 + dt, acc[s]);
    }
  }
}

size_t round16(size_t bytes) { return (bytes + 15) / 16 * 16; }

template <class T, int R, int LG, int SPLIT>
cudaError_t launch(const Params& p, int nbc, cudaStream_t stream) {
  // words of 32 rows (and of 32 columns) that cover a block
  auto kernel = p.bm > 64 || p.bn > 64
                    ? spmm_blockell_t_kernel<T, R, LG, SPLIT, 4>
                    : spmm_blockell_t_kernel<T, R, LG, SPLIT, 2>;
  const size_t smem = p.ring_at + static_cast<size_t>(p.stages) *
                                      (p.a_bytes + p.h_bytes);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMaxSmem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(nbc) * p.n_dt, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <class T, int LG, int SPLIT>
cudaError_t dispatch_cols(const Params& p, int nbc, cudaStream_t stream) {
  const int cols = (p.bn + kWarps - 1) / kWarps;  // output rows a warp owns
  if (cols <= 1) return launch<T, 1, LG, SPLIT>(p, nbc, stream);
  if (cols <= 2) return launch<T, 2, LG, SPLIT>(p, nbc, stream);
  if (cols <= 4) return launch<T, 4, LG, SPLIT>(p, nbc, stream);
  // 8 output rows a warp take a D-tile of at most 64 columns (see run)
  if constexpr (LG < 32)
    if (cols <= 8) return launch<T, 8, LG, SPLIT>(p, nbc, stream);
  return cudaErrorInvalidValue;
}

template <class T>
cudaError_t run(Params p, int nbc, cudaStream_t stream) {
  const size_t es = sizeof(T);
  const auto aligned = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  p.bulk_a = aligned(p.blocks) &&
             (static_cast<size_t>(p.bm) * p.bn * es) % 16 == 0;
  p.bulk_h = aligned(p.h) && (static_cast<size_t>(p.d) * es) % 16 == 0;
  p.a_bytes = static_cast<int>(round16(static_cast<size_t>(p.bm) * p.bn * es));
  p.nwc = (p.bn + 31) / 32;
  // a list holds a column's nonzeros padded to a multiple of 4; its
  // stride, 2 entries more, puts the lists a warp reads at once on other
  // banks
  p.list_len = (p.bm + 3) / 4 * 4 + 2;
  p.bits_at = kBarrierBytes;
  p.zero_at = p.bits_at + static_cast<int>(round16(
                              static_cast<size_t>(kMaxStages) * p.bm * p.nwc *
                              sizeof(uint32_t)));
  // the widest D-tile (<= 128 columns, a multiple of 8) of which two
  // stages fit; blocks of more than 64 columns (8 output rows a warp) take
  // at most 64, so their accumulator tile fits in the registers
  const int d8 = (p.d + 7) / 8 * 8;
  for (int cand = p.bn > 4 * kWarps ? kMaxDT / 2 : kMaxDT;; cand /= 2) {
    p.dt = cand < d8 ? cand : d8;
    p.n_dt = (p.d + p.dt - 1) / p.dt;
    p.hs = p.n_dt == 1 && p.bulk_h ? p.d : p.dt;
    p.h_bytes = static_cast<int>(round16(static_cast<size_t>(p.bm) * p.hs * es));
    p.lists_at = p.zero_at + static_cast<int>(round16(p.hs * es));
    const int rps = 32 / (p.d <= 4 ? 8 : lanes_per_row(p.dt));
    p.ring_at = p.lists_at + kWarps * rps * p.list_len * 8;
    const size_t stage = p.a_bytes + p.h_bytes;
    if (p.ring_at + 2 * stage <= kMaxSmem || cand <= 8) {
      size_t n = (kMaxSmem - p.ring_at) / stage;
      if (n > kMaxStages) n = kMaxStages;
      p.stages = static_cast<int>(n);
      break;
    }
  }
  if (p.stages < 2) return cudaErrorInvalidValue;
  // D <= 4: the 8 lanes of a group split a column's rows (see consume)
  if (p.d <= 4) return dispatch_cols<T, 8, 8>(p, nbc, stream);
  switch (lanes_per_row(p.dt)) {
    case 32:
      return dispatch_cols<T, 32, 1>(p, nbc, stream);
    case 16:
      return dispatch_cols<T, 16, 1>(p, nbc, stream);
    default:
      return dispatch_cols<T, 8, 1>(p, nbc, stream);
  }
}


// ---------------------------------------------------------------------------
// (a) mma: tensor cores over whole blocks, for wide D (bn = 64)
// ---------------------------------------------------------------------------

namespace mma_path {

using namespace tc3;  // NOLINT: the split and the mma wrappers

constexpr int kWarps = 8;                    // consumer warps: 2 x 4
constexpr int kThreads = (kWarps + 1) * 32;  // + the producer warp
constexpr int kBn = 64;                      // Y rows of a tile
constexpr int kDT = 128;                     // D columns of a tile
constexpr int kBox = 128;  // bytes of a staged row of one box (swizzled)
constexpr int kMaxStages = 8;
constexpr int kRingAlign = 1024;  // the 128-byte swizzle's period
constexpr size_t kSlack = kRingAlign;  // for aligning the ring up

struct Params {
  CUtensorMap map_a;     // blocks as [nbr * w * bm, 64], boxes bm x 128 B
  CUtensorMap map_h;     // H as [nbr * bm, d], boxes bm x 128 B
  const int* col_ptr;    // int32[nbc + 1]: list of block column j
  const int* col_slots;  // int32[col_ptr[nbc]]: slots i * w + t
  const void* blocks;    // [nbr * w, bm, 64]
  const void* h;         // [nbr * bm, d]
  void* y;               // [nbc * 64, d]
  int nbc, w, bm, d;
  int items;    // tiles: nbc x ceil(d / 128), D-tile-major
  int stages;   // ring depth
  int a_bytes;  // one staged block: 64 columns in boxes of 128 B rows
  int h_bytes;  // one staged H tile: 128 columns in boxes of 128 B rows
  int tma_a;    // blocks copied by the TMA (else by the producer's lanes)
  int tma_h;    // H tiles copied by the TMA (else by the producer's lanes)
};

// A staged operand is kept as the TMA's 128-byte swizzle lays it out: its
// columns in boxes of 128 bytes (32 f32 or 64 bf16 / f16), box b holding
// rows 0..bm-1 of its columns at 128 bytes a row, and the 16-byte chunk c
// of row r at chunk position c ^ (r % 8) (each box 1024-byte aligned).
// The element offset of (row, col) in that layout:
template <class T>
__device__ __forceinline__ int swizzled(int row, int col, int rows) {
  constexpr int kW = kBox / sizeof(T);    // elements a box row
  constexpr int kE = 16 / sizeof(T);      // elements a chunk
  const int cc = col % kW;
  return (col / kW) * rows * kW + row * kW + (((cc / kE) ^ (row & 7)) * kE) +
         cc % kE;
}

// One 2-D TMA copy of the box at (column c0, row c1) of `map` into dst,
// completing on `bar`.
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar))
      : "memory");
}

// The producer's fill of stage st with slot s: the block (bm x 64) and the
// bm x 128 tile of H at block-row s / w, columns d0.. (past d: zeros from
// the TMA), by one TMA copy a box (f32: 2 + 4, 16-bit: 1 + 2); lane 0
// arms the stage's mbarrier with their bytes.  An operand the TMA cannot
// take (a row or base not 16-byte aligned) is copied by the lanes into
// the same swizzled layout first.
template <class T>
__device__ __forceinline__ void fill_stage(const Params& p,
                                           unsigned char* ring, uint64_t* full,
                                           int st, int s, int d0, int dt,
                                           int lane) {
  constexpr int kW = kBox / sizeof(T);
  T* as = reinterpret_cast<T*>(ring + static_cast<size_t>(st) *
                                          (p.a_bytes + p.h_bytes));
  T* hs = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(as) +
                               p.a_bytes);
  const int i = s / p.w;
  if (!p.tma_a) {
    const T* src = static_cast<const T*>(p.blocks) +
                   static_cast<size_t>(s) * p.bm * kBn;
    for (int e = lane; e < p.bm * kBn; e += 32)
      as[swizzled<T>(e / kBn, e % kBn, p.bm)] = src[e];
  }
  if (!p.tma_h) {
    const T* src = static_cast<const T*>(p.h) +
                   static_cast<size_t>(i) * p.bm * p.d + d0;
    for (int e = lane; e < p.bm * dt; e += 32) {
      const int r = e / dt, c = e - r * dt;
      hs[swizzled<T>(r, c, p.bm)] = src[static_cast<size_t>(r) * p.d + c];
    }
  }
  if (!p.tma_a || !p.tma_h) __threadfence_block();
  __syncwarp();
  if (lane == 0) {
    const uint32_t box = p.bm * kBox;
    mbar_arrive_expect_tx(&full[st], (p.tma_a ? kBn / kW * box : 0u) +
                                         (p.tma_h ? kDT / kW * box : 0u));
    if (p.tma_a)
      for (int b = 0; b < kBn / kW; ++b)
        tma_2d(as + b * p.bm * kW, &p.map_a, b * kW, s * p.bm, &full[st]);
    if (p.tma_h)
      for (int b = 0; b < kDT / kW; ++b)
        tma_2d(hs + b * p.bm * kW, &p.map_h, d0 + b * kW, i * p.bm,
               &full[st]);
  }
}

// The 16-byte chunk of its box a thread (fragment row g) reads: g's pairs
// (2 q, 2 q + 1) take chunks q and q + 4, so the 8 lanes of a quarter-warp
// (two g, four rows t4) read 8 distinct chunk positions c ^ t4: no bank
// conflict under the swizzle.
__device__ __forceinline__ int chunk_of(int g) {
  return (g >> 1) | ((g & 1) << 2);
}

// One staged slot into `sum` (zeroed here) for the warp's 32 x 32: f32 as
// three TF32 products on permuted fragments (see the note at the top).
__device__ __forceinline__ void slot_product(const float* __restrict__ as,
                                             const float* __restrict__ hs,
                                             const Params& p, int wm, int wn,
                                             int g, int t4,
                                             float (&sum)[2][4][4]) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) sum[j][i][c] = 0.f;
  // box wm of the block, box wn of the H tile; rows k + t4 and k + t4 + 4
  // (k a multiple of 8) sit at chunk positions chunk ^ t4, chunk ^ (t4 + 4)
  const int c = chunk_of(g);
  const float* a_at = as + wm * p.bm * 32 + t4 * 32;
  const float* h_at = hs + wn * p.bm * 32 + t4 * 32;
  const int lo = (c ^ t4) * 4, hi = (c ^ (t4 + 4)) * 4;
#pragma unroll 2
  for (int k = 0; k < p.bm; k += 8) {
    const float4 a0 = *reinterpret_cast<const float4*>(a_at + k * 32 + lo);
    const float4 a1 =
        *reinterpret_cast<const float4*>(a_at + (k + 4) * 32 + hi);
    const float4 b0 = *reinterpret_cast<const float4*>(h_at + k * 32 + lo);
    const float4 b1 =
        *reinterpret_cast<const float4*>(h_at + (k + 4) * 32 + hi);
    // m-tile j: rows g, g + 8 are the block's columns 4 c + 2 j, + 1
    uint32_t ah[2][4], al[2][4];
    split(a0.x, ah[0][0], al[0][0]);
    split(a0.y, ah[0][1], al[0][1]);
    split(a1.x, ah[0][2], al[0][2]);
    split(a1.y, ah[0][3], al[0][3]);
    split(a0.z, ah[1][0], al[1][0]);
    split(a0.w, ah[1][1], al[1][1]);
    split(a1.z, ah[1][2], al[1][2]);
    split(a1.w, ah[1][3], al[1][3]);
    // n-tile i: column g is D column 4 c + i
    const float bx0[4] = {b0.x, b0.y, b0.z, b0.w};
    const float bx1[4] = {b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t h0, l0, h1, l1;
      split(bx0[i], h0, l0);
      split(bx1[i], h1, l1);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        mma_3xtf32(sum[j][i], ah[j], al[j], h0, h1, l0, l1);
    }
  }
}

// The same for bf16 / f16 (BF16 selects which): m16n8k16 on ldmatrix.trans
// fragments, unpermuted, their rows found through the swizzle.
template <bool BF16>
__device__ __forceinline__ void slot_product16(
    const uint16_t* __restrict__ as, const uint16_t* __restrict__ hs,
    const Params& p, int wm, int wn, int lane, float (&sum)[2][4][4]) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) sum[j][i][c] = 0.f;
  const int q = lane >> 3, rr = lane & 7;
  // matrices of A: (k 0-7 | 8-15) x (m 0-7 | 8-15), m fastest; of B: (k
  // 0-7 | 8-15) x (n 0-7 | 8-15), k fastest.  A row's chunk position is
  // chunk ^ rr (the row's k is a multiple of 8 plus rr).
  const int a_row = (q >> 1) * 8 + rr, h_row = (q & 1) * 8 + rr;
  const int a_chunk = 4 * wm + (q & 1);      // + 2 j
  const int h_col = 32 * wn + (q >> 1) * 8;  // + 16 pr
  const uint16_t* h_box = hs + (h_col / 64) * p.bm * 64;
  const int h_chunk = (h_col % 64) / 8;      // + 2 pr
#pragma unroll 2
  for (int k = 0; k < p.bm; k += 16) {
    uint32_t a[2][4], b[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
      ldsm_x4_trans(a[j], as + (k + a_row) * 64 +
                              (((a_chunk + 2 * j) ^ rr) * 8));
#pragma unroll
    for (int pr = 0; pr < 2; ++pr)
      ldsm_x4_trans(b[pr], h_box + (k + h_row) * 64 +
                               (((h_chunk + 2 * pr) ^ rr) * 8));
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mma_16bit<BF16>(sum[j][i], a[j], b[i / 2][2 * (i % 2)],
                        b[i / 2][2 * (i % 2) + 1]);
  }
}

// Y's element (row, col) of the tile (col < dt), rounded once.
template <class T>
__device__ __forceinline__ void store1(const Params& p, size_t row, int col,
                                       int dt, int d0, float z) {
  if (col < dt) static_cast<T*>(p.y)[row * p.d + d0 + col] =
      Elem<T>::from_f(z);
}

// Grid: persistent, one CTA an SM; tile `item` is (block column item %
// nbc, D-tile item / nbc).
template <class T>
__global__ void __launch_bounds__(kThreads, 1)
    spmm_blockell_t_mma_kernel(const __grid_constant__ Params p) {
  constexpr bool kF32 = sizeof(T) == 4;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem) + 2 * kMaxStages * 8 +
       kRingAlign - 1) /
      kRingAlign * kRingAlign);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kWarps) {  // producer
    int it = 0;
    for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
      const int j = item % p.nbc;
      const int d0 = item / p.nbc * kDT;
      const int dt = min(kDT, p.d - d0);
      for (int e = p.col_ptr[j]; e < p.col_ptr[j + 1]; ++e, ++it) {
        const int st = it % p.stages;
        if (it >= p.stages)
          mbar_wait(&empty[st], ((it / p.stages) - 1) & 1);
        fill_stage<T>(p, ring, full, st, p.col_slots[e], d0, dt, lane);
      }
    }
    return;
  }
  const int wm = warp / 4, wn = warp % 4;  // the warp's 32 x 32
  const int g = lane / 4, t4 = lane % 4;
  int it = 0;
  for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
    const int j = item % p.nbc;
    const int d0 = item / p.nbc * kDT;
    const int dt = min(kDT, p.d - d0);
    float acc[2][4][4], sum[2][4][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][i][c] = 0.f;
    const int n_ent = p.col_ptr[j + 1] - p.col_ptr[j];
    for (int e = 0; e < n_ent; ++e, ++it) {
      const int st = it % p.stages;
      mbar_wait(&full[st], (it / p.stages) & 1);
      const unsigned char* base =
          ring + static_cast<size_t>(st) * (p.a_bytes + p.h_bytes);
      if constexpr (kF32)
        slot_product(reinterpret_cast<const float*>(base),
                     reinterpret_cast<const float*>(base + p.a_bytes), p, wm,
                     wn, g, t4, sum);
      else
        slot_product16<std::is_same<T, __nv_bfloat16>::value>(
            reinterpret_cast<const uint16_t*>(base),
            reinterpret_cast<const uint16_t*>(base + p.a_bytes), p, wm, wn,
            lane, sum);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][i][c] += sum[a][i][c];
    }
    const size_t row0 = static_cast<size_t>(j) * kBn + 32 * wm;
    if constexpr (kF32) {
      // rows 4 chunk_of(g) + 2 a + hh; columns 4 t4 + i (c = 2 hh) and
      // 16 + 4 t4 + i (c = 2 hh + 1) of the warp's 32 x 32
      const bool vec = p.d % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(p.y) % 16 == 0;
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const size_t row = row0 + 4 * chunk_of(g) + 2 * a + hh;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int col = 32 * wn + 16 * half + 4 * t4;
            const int c = 2 * hh + half;
            if (vec && col + 3 < dt) {
              *reinterpret_cast<float4*>(static_cast<float*>(p.y) +
                                         row * p.d + d0 + col) =
                  make_float4(acc[a][0][c], acc[a][1][c], acc[a][2][c],
                              acc[a][3][c]);
            } else {
#pragma unroll
              for (int i = 0; i < 4; ++i)
                store1<T>(p, row, col + i, dt, d0, acc[a][i][c]);
            }
          }
        }
    } else {
      // rows 16 a + g (+ 8), columns 8 i + 2 t4 (+ 1)
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = 32 * wn + 8 * i + 2 * t4;
          const size_t row = row0 + 16 * a + g;
          store1<T>(p, row, col, dt, d0, acc[a][i][0]);
          store1<T>(p, row, col + 1, dt, d0, acc[a][i][1]);
          store1<T>(p, row + 8, col, dt, d0, acc[a][i][2]);
          store1<T>(p, row + 8, col + 1, dt, d0, acc[a][i][3]);
        }
    }
  }
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 132;
  return n;
}

// libcuda's cuTensorMapEncodeTiled, found once through the runtime (no
// link to libcuda).
PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      ptr = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
  }();
  return fn;
}

// A 2-D map of a row-major [rows, cols] matrix of T (rows `ld` elements
// apart), boxes of `box_rows` rows x 128 bytes, 128-byte swizzle, zeros
// past the edges.  False where the encoding is refused.
template <class T>
bool encode(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols,
            uint64_t ld, uint32_t box_rows) {
  const auto fn = encode_tiled();
  if (fn == nullptr) return false;
  const CUtensorMapDataType type =
      sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
      : std::is_same<T, __nv_bfloat16>::value
          ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
          : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  cuuint64_t dims[2] = {cols, rows};
  cuuint64_t strides[1] = {ld * sizeof(T)};
  cuuint32_t box[2] = {static_cast<cuuint32_t>(kBox / sizeof(T)), box_rows};
  cuuint32_t step[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class T>
cudaError_t run(Params p, int n_slots, int n_rows, cudaStream_t stream) {
  const size_t es = sizeof(T);
  const auto aligned = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  p.tma_a = aligned(p.blocks) &&
            encode<T>(&p.map_a, p.blocks,
                      static_cast<uint64_t>(n_slots) * p.bm, kBn, kBn, p.bm);
  p.tma_h = aligned(p.h) && (static_cast<size_t>(p.d) * es) % 16 == 0 &&
            encode<T>(&p.map_h, p.h, n_rows, p.d, p.d, p.bm);
  p.a_bytes = p.bm * kBox * (kBn * static_cast<int>(es) / kBox);
  p.h_bytes = p.bm * kBox * (kDT * static_cast<int>(es) / kBox);
  const int n_dt = (p.d + kDT - 1) / kDT;
  p.items = p.nbc * n_dt;
  const size_t head = 2 * kMaxStages * 8 + kSlack;
  size_t n = (kMaxSmem - head) / (p.a_bytes + p.h_bytes);
  p.stages = static_cast<int>(n < kMaxStages ? n : kMaxStages);
  if (p.stages < 2) return cudaErrorInvalidValue;
  const size_t smem =
      head + static_cast<size_t>(p.stages) * (p.a_bytes + p.h_bytes);
  auto kernel = spmm_blockell_t_mma_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int grid = p.items < sm_count() ? p.items : sm_count();
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace mma_path

// ---------------------------------------------------------------------------
// (b) stream: D <= 8, each block read once, no compaction
// ---------------------------------------------------------------------------

namespace stream_path {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16;  // block rows of a unit

struct Params {
  const int* col_ptr;
  const int* col_slots;
  const void* blocks;  // [nbr * w, bm, bn]
  const void* h;       // [nbr * bm, d]
  void* y;             // [nbc * bn, d]
  float* part;         // [nbc * chunks, bn, d] where chunks > 1
  int nbc, w, bm, bn, d;
  int chunks;  // runs each column's list is cut into
};

// Grid: one CTA per chunk q of block column j, x = j * chunks + q.  DD >= d
// columns of H, NC words of 32 of the block's columns.
template <class T, int DD, int NC>
__global__ void __launch_bounds__(kThreads)
    spmm_blockell_t_stream_kernel(const Params p) {
  __shared__ float red[kWarps][NC * 32][DD];
  __shared__ __align__(16) float hs[kWarps][kRows][DD];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int j = blockIdx.x / p.chunks;
  const int q = blockIdx.x % p.chunks;
  const int beg = p.col_ptr[j];
  const long long len = p.col_ptr[j + 1] - beg;
  const int e0 = beg + static_cast<int>(len * q / p.chunks);
  const int e1 = beg + static_cast<int>(len * (q + 1) / p.chunks);
  const int rs = (p.bm + kRows - 1) / kRows;  // units a slot
  const int units = (e1 - e0) * rs;
  float acc[NC][DD];
#pragma unroll
  for (int k = 0; k < NC; ++k)
#pragma unroll
    for (int c = 0; c < DD; ++c) acc[k][c] = 0.f;
  for (int u = warp; u < units; u += kWarps) {
    const int s = p.col_slots[e0 + u / rs];
    const int r0 = (u % rs) * kRows;
    const int nr = min(kRows, p.bm - r0);
    const T* blk = static_cast<const T*>(p.blocks) +
                   (static_cast<size_t>(s) * p.bm + r0) * p.bn;
    const T* hr = static_cast<const T*>(p.h) +
                  (static_cast<size_t>(s / p.w) * p.bm + r0) * p.d;
    for (int x = lane; x < kRows * DD; x += 32) {
      const int r = x / DD, c = x % DD;
      hs[warp][r][c] = r < nr && c < p.d
                           ? Elem<T>::to_f(hr[static_cast<size_t>(r) * p.d + c])
                           : 0.f;
    }
    float a[kRows][NC];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const int c = lane + 32 * k;
        a[r][k] = r < nr && c < p.bn ? Elem<T>::to_f(blk[r * p.bn + c]) : 0.f;
      }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float x[DD];
      if constexpr (DD >= 4) {
#pragma unroll
        for (int c = 0; c < DD; c += 4) {
          const float4 v = *reinterpret_cast<const float4*>(&hs[warp][r][c]);
          x[c] = v.x;
          x[c + 1] = v.y;
          x[c + 2] = v.z;
          x[c + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int c = 0; c < DD; ++c) x[c] = hs[warp][r][c];
      }
#pragma unroll
      for (int k = 0; k < NC; ++k)
#pragma unroll
        for (int c = 0; c < DD; ++c) acc[k][c] = fmaf(a[r][k], x[c], acc[k][c]);
    }
    __syncwarp();  // hs is written again for the next unit
  }
#pragma unroll
  for (int k = 0; k < NC; ++k)
#pragma unroll
    for (int c = 0; c < DD; ++c) red[warp][lane + 32 * k][c] = acc[k][c];
  __syncthreads();
  for (int x = threadIdx.x; x < p.bn * p.d; x += kThreads) {
    const int c = x / p.d, dd = x % p.d;
    float z = red[0][c][dd];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) z += red[w][c][dd];
    if (p.chunks == 1)
      static_cast<T*>(p.y)[static_cast<size_t>(j) * p.bn * p.d + x] =
          Elem<T>::from_f(z);
    else
      p.part[static_cast<size_t>(blockIdx.x) * p.bn * p.d + x] = z;
  }
}

// Y = the chunks' partials of each column added in chunk order, rounded
// once; per_col = bn * d elements a block column.
template <class T>
__global__ void __launch_bounds__(256)
    spmm_blockell_t_combine_kernel(const float* __restrict__ part, T* y,
                                   int chunks, int per_col, long long total) {
  const long long x = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (x >= total) return;
  const long long j = x / per_col;
  const float* src = part + j * chunks * per_col + (x - j * per_col);
  float z = src[0];
  for (int q = 1; q < chunks; ++q) z += src[static_cast<size_t>(q) * per_col];
  y[x] = Elem<T>::from_f(z);
}

template <class T, int DD>
cudaError_t launch_dd(const Params& p, cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>(p.nbc) * p.chunks;
  if (p.bn <= 32)
    spmm_blockell_t_stream_kernel<T, DD, 1><<<grid, kThreads, 0, stream>>>(p);
  else if (p.bn <= 64)
    spmm_blockell_t_stream_kernel<T, DD, 2><<<grid, kThreads, 0, stream>>>(p);
  else
    spmm_blockell_t_stream_kernel<T, DD, 4><<<grid, kThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.chunks == 1) return err;
  const long long total = static_cast<long long>(p.nbc) * p.bn * p.d;
  spmm_blockell_t_combine_kernel<T>
      <<<static_cast<unsigned>((total + 255) / 256), 256, 0, stream>>>(
          p.part, static_cast<T*>(p.y), p.chunks, p.bn * p.d, total);
  return cudaGetLastError();
}

template <class T>
cudaError_t run(const Params& p, cudaStream_t stream) {
  if (p.d > 8 || p.chunks < 1 || (p.chunks > 1 && p.part == nullptr))
    return cudaErrorInvalidValue;
  if (p.d == 1) return launch_dd<T, 1>(p, stream);
  if (p.d == 2) return launch_dd<T, 2>(p, stream);
  if (p.d <= 4) return launch_dd<T, 4>(p, stream);
  return launch_dd<T, 8>(p, stream);
}

}  // namespace stream_path

}  // namespace

// dtype: 0 f32, 1 bf16, 2 f16, for blocks, h and y alike.  path: 0 sparse
// (c), 1 mma (a: bn = 64, bm a multiple of 16), 2 stream (b: d <= 8).
// col_ptr int32[nbc + 1] and col_slots int32[col_ptr[nbc]] (slots i * w +
// t of blocks [nbr * w, bm, bn], ascending i within each block column); h
// [nbr * bm, d]; y [nbc * bn, d].  chunks: runs of each column's list (the
// stream path; 1 otherwise), with part f32 [nbc * chunks, bn, d] where
// chunks > 1.  Returns the cudaError_t of the launch.
extern "C" int spmm_blockell_t(int dtype, int path, const int* col_ptr,
                               const int* col_slots, const void* blocks,
                               const void* h, void* y, void* part, int nbr,
                               int nbc, int w, int bm, int bn, int d,
                               int chunks, void* stream) {
  if (nbc == 0 || d == 0) return cudaSuccess;
  if (bm < 1 || bn < 1 || bm > kMaxBlock || bn > kMaxBlock || w < 1 ||
      dtype < 0 || dtype > 2)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (path == 1) {
    if (bn != mma_path::kBn || bm % 16 != 0) return cudaErrorInvalidValue;
    mma_path::Params p = {};
    p.col_ptr = col_ptr;
    p.col_slots = col_slots;
    p.blocks = blocks;
    p.h = h;
    p.y = y;
    p.nbc = nbc;
    p.w = w;
    p.bm = bm;
    p.d = d;
    // the slots and rows the maps span: every slot of the blocks, H's rows
    const int n_slots = nbr * w, n_rows = nbr * bm;
    return static_cast<int>(
        dtype == 0   ? mma_path::run<float>(p, n_slots, n_rows, st)
        : dtype == 1 ? mma_path::run<__nv_bfloat16>(p, n_slots, n_rows, st)
                     : mma_path::run<__half>(p, n_slots, n_rows, st));
  }
  if (path == 2) {
    stream_path::Params p = {};
    p.col_ptr = col_ptr;
    p.col_slots = col_slots;
    p.blocks = blocks;
    p.h = h;
    p.y = y;
    p.part = static_cast<float*>(part);
    p.nbc = nbc;
    p.w = w;
    p.bm = bm;
    p.bn = bn;
    p.d = d;
    p.chunks = chunks;
    return static_cast<int>(
        dtype == 0   ? stream_path::run<float>(p, st)
        : dtype == 1 ? stream_path::run<__nv_bfloat16>(p, st)
                     : stream_path::run<__half>(p, st));
  }
  if (path != 0) return cudaErrorInvalidValue;
  Params p = {};
  p.col_ptr = col_ptr;
  p.col_slots = col_slots;
  p.blocks = blocks;
  p.h = h;
  p.y = y;
  p.w = w;
  p.bm = bm;
  p.bn = bn;
  p.d = d;
  switch (dtype) {
    case 0:
      return static_cast<int>(run<float>(p, nbc, st));
    case 1:
      return static_cast<int>(run<__nv_bfloat16>(p, nbc, st));
    default:
      return static_cast<int>(run<__half>(p, nbc, st));
  }
}
