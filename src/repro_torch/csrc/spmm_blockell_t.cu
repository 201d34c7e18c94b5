// Transposed Block-ELL SpMM (N1) for sm_90a: Y = Aᵀ H with A in Block-ELL,
// reading A's blocks in place, transposed, and summing every output element
// in one fixed order.
//
// No Pallas kernel of the JAX package computes this product: its backward
// runs it in jnp, as an einsum over the transposed Block-COO view followed
// by a segment sum (src/repro/sparse/paths.py:162-181, 53-59).  The port
// ran the same two steps (einsum + index_add_), and on CUDA index_add_ sums
// in an unspecified order, so a training step's gradients differed in their
// last bits from run to run.  This kernel computes the same function with
// no atomics.
//
//   Y[j-block, :] = sum over the list of block column j, in order, of
//                   blocks[s]ᵀ @ H[(s / w)-block, :]
//
// The list of block column j holds the slots s = i * w + t of A whose
// block column is j, the padded slots left out (t >= nblocks[i]), in
// ascending block-row i; the wrapper builds it once per structure
// (kernels/spmm/transposed.py).  Blocks, H and Y are one element type T
// (f32, bf16 or f16; the wrapper promotes mixed operands to their common
// type).  Sums are f32 (fmaf) and Y is rounded once, at the store.
//
// What bounds it on an H100: the bytes of `blocks`, read once from device
// memory (1.07 GB of f32 on graph (a) of chip_smoke.py, 0.32 ms at
// 3.35 TB/s); H (8 MB) stays in the 50 MB L2.  The design follows K1's
// (spmm_blockell.cu), with the compaction turned by 90 degrees:
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
// Order: each output element is fmaf-summed from 0 over the list in order
// (ascending source block-row), within a block in ascending source row
// (at D <= 4 per lane of a group, entries k, k + 8, ..., the lanes then
// added in a fixed tree), so two launches give equal bits.
// Occupancy: one CTA of 17 warps (544 threads) per SM, up to 227 KB of
// shared memory (the row bits, a zero H row, the lists and the ring).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "blockell_ring.cuh"

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

}  // namespace

// dtype: 0 f32, 1 bf16, 2 f16, for blocks, h and y alike.  col_ptr
// int32[nbc + 1] and col_slots int32[col_ptr[nbc]] (slots i * w + t of
// blocks [nbr * w, bm, bn], ascending i within each block column); h
// [nbr * bm, d]; y [nbc * bn, d].  Returns the cudaError_t of the launch.
extern "C" int spmm_blockell_t(int dtype, const int* col_ptr,
                               const int* col_slots, const void* blocks,
                               const void* h, void* y, int nbc, int w,
                               int bm, int bn, int d, void* stream) {
  if (nbc == 0 || d == 0) return cudaSuccess;
  if (bm < 1 || bn < 1 || bm > kMaxBlock || bn > kMaxBlock || w < 1)
    return cudaErrorInvalidValue;
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(run<float>(p, nbc, st));
    case 1:
      return static_cast<int>(run<__nv_bfloat16>(p, nbc, st));
    case 2:
      return static_cast<int>(run<__half>(p, nbc, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
