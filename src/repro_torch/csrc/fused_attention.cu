// One-pass fused graph attention for sm_90a, nonzero-granular: K7 streams
// the blocks of a Block-ELL pattern, K8 walks the row view of a SELL-C-sigma
// packing.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   K7 fused_attn_blockell_kernel  (src/repro/kernels/fused/attention.py:99)
//   K8 fused_attn_sell_kernel      (src/repro/kernels/fused/attention.py:281)
// Both compute, for every output row r,
//
//   Y[r, :] = sum_j softmax_j(act(q[r] . kT[:, j])) V[j, :]
//
// over A's nonzeros j of row r, with the online softmax of the reference:
// a running max m, its exp-sum l and the accumulator, rescaled by
// exp(m - m') when the max grows, and Y = acc / max(l, 1e-12) at the only
// store, so a row with no edge comes out exactly 0 and a masked entry
// weighs exactly 0.  A's values (K7: the blocks; K8: slot_vals) are only
// the mask: an entry is live where its value is nonzero (a stored zero
// masks out), read as the value's bits (f32, or bf16 / f16 alike).  q, kT,
// V and Y share one element type T (f32, bf16 or f16; the wrapper promotes
// mixed operands to their common type).  Scores, exponentials and sums are
// f32 (fmaf, expf without fast-math, no TF32), and Y is rounded once.
//
// What bounds them on an H100.  K7: the bytes of A's blocks, read once
// (1.07 GB of f32 on the serving graph, 0.32 ms at 3.35 TB/s); about 10 %
// of each block is live there, and a live entry costs a dk-wide score, an
// expf and a D-wide multiply-add.  K8: the row arrays, each nonzero's
// column and value, q, kT, V and Y, a few MB (the TPU kernel multiplied
// dense 64 x 64 tiles holding 4.6 nonzeros each on the same graph); the
// gathers of kT's columns and V's rows from L2 are the floor.
//
// K7 (fused_attn_blockell_kernel) is K1/K5's stream (spmm_blockell.cu)
// with the online softmax between its compaction and its sums:
//  - Ring.  A producer warp streams each slot's block, its bn x DT tile of
//    V and its dk x bn piece of kT into a ring of up to 8 stages of shared
//    memory with 1-D bulk copies (blockell_ring.cuh), the block hinted
//    evict-first in L2, V and kT evict-last; 16 consumer warps release a
//    stage through a second mbarrier.  Where two stages with kT do not fit
//    (dk = 48 on 128 x 128 f32 blocks), kT is read from L2 instead.  The
//    block-row's q is staged once, in f32.
//  - Compaction.  As K5: a consumer warp owns rows warp, warp + 16, ... of
//    the block-row and compacts them two at a time, a half-warp a row, 4
//    columns a lane: __ballot_sync on the mask writes each row's list of
//    (offset of V row j in the staged tile, j) in ascending j, with
//    predicated stores (a dead column writes a spare entry), not branches.
//  - Softmax over the lists.  8 lanes a list take a warp's four lists at
//    once, two entries a lane in registers (a loop past 16): they score
//    them, act(q[r] . kT[:, j]), and take p = exp(s - m) against the row's
//    current max m while one vote asks whether any score of the four rows
//    beats it.  Only then is the group's max m' reduced, the scale
//    exp(m - m') taken and p redone; a row's max grows in a few of its
//    slots, so most slots need neither.  Each lane keeps its part of l
//    (rescaled with the row), added across the 8 lanes once, at the end:
//    one expf a live entry, and no shuffle in the common slot.  The lanes
//    that sum a row take its scale (only where a max grew) and its l by a
//    shuffle.
//  - Sums.  As K5: E entries of each row per iteration, p V added to acc,
//    the lists padded with entries that name a zero row with p = 0.
//  - One read of each block: a CTA owns a block-row's whole D up to 128
//    columns; a wider D is cut into D-tiles whose CTAs are neighbours in
//    launch order (the second read hits L2), each recomputing the dk-wide
//    scores, so every D-tile sees the same m and l.  K1/K5's cluster split
//    of a block-row's slots is left out: merging the parts would need their
//    (m, l) as well, and the serving graph's 256 block-rows take a split
//    of 1 there.
//
// K8 (fused_attn_rows_kernel) is K4's dots and K6's gathers
// (spmm_sell.cu) with the online softmax between them.  Row r's nonzeros
// are slots row_slot[r] .. + row_nnz[r] of the packing, in ascending
// column.  A group of L lanes owns a row (L = 32 at D > 64, D/4 below
// that, at least 4) and runs across D with 16-byte (f32) or 8-byte loads of
// V's rows.  For each batch of 32 nonzeros the group loads the (col, val)
// pairs coalesced, each lane scores its own (q's first 4 values kept in
// registers, kT's column read from L2 through kT's strides, so the
// model's k.T needs no copy and its dk values sit side by side), the
// group's max rescales acc and l
// once, each lane takes p = exp(s - m), and the (col, p) pairs are handed
// out with __shfl_sync while kBatch V rows are in flight per lane.  Rows
// above heavy_nnz (SellCS.tile_heavy_rows) get a CTA each: its groups run
// contiguous chunks of the row with their own (m, l, acc), merged in chunk
// order through shared memory (m = max m_c, l = sum l_c e^(m_c - m),
// acc = sum acc_c e^(m_c - m)).
//
// Determinism: no atomics; every output is the same sum in the same order
// on every run.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "blockell_ring.cuh"

namespace {

using namespace ring;  // NOLINT: the ring primitives, shared with K1/K5

constexpr float kNegInf = -1e30f;  // finite: masked - masked stays nan-free
constexpr float kEps = 1e-12f;
constexpr unsigned kFull = 0xffffffffu;

// An entry of A is live where its value is nonzero: -0.0 is not, NaN is.
__device__ __forceinline__ bool live_bits(uint32_t u) {
  return (u & 0x7fffffffu) != 0;
}
__device__ __forceinline__ bool live_bits16(uint32_t u) {
  return (u & 0x7fffu) != 0;
}

// ---------------------------------------------------------------------------
// K7: Block-ELL, streaming
// ---------------------------------------------------------------------------

constexpr int kWarps = 16;                   // consumer warps
constexpr int kThreads = (kWarps + 1) * 32;  // + the producer warp
constexpr int kMaxDT = 128;                  // D columns per CTA: 4 a lane
constexpr int kMaxStages = 8;
constexpr int kBarrierBytes = 2 * kMaxStages * 8;  // full[], empty[]
constexpr int kLists = 4;  // rows a consumer warp compacts at once
constexpr int kSL = 32 / kLists;  // lanes a list in the softmax pass
constexpr int kSegs = 2;   // 64-column passes over a block row (bn <= 128)
constexpr size_t kMaxSmem = 227 * 1024;  // one CTA per SM

struct EllParams {
  const int* idx;
  const void* blocks;  // the mask, a_es bytes an element
  const void* q;       // T [nbr*bm, dk]
  const void* kt;      // T [dk, n]
  const void* v;       // T [n, d]
  void* y;             // T [nbr*bm, d]
  int w, bm, bn, dk, n, d;
  int a_es;      // bytes of a block element: 4 or 2
  int dt;        // D columns per CTA (the D-tile)
  int n_dt;      // D-tiles
  int stages;    // ring depth
  int hs;        // row stride of a staged V tile, in elements
  int a_bytes;   // one staged block, padded to 16
  int h_bytes;   // one staged V tile, padded to 16
  int k_bytes;   // one staged dk x bn piece of kT, padded to 16 (0: not
                 // staged, read from L2)
  int bulk_a;    // blocks copied by the bulk engine (else by lanes)
  int bulk_h;    // V tiles copied by the bulk engine (else by lanes)
  int bulk_k;    // kT pieces copied by the bulk engine (else by lanes)
  int list_len;  // entries of one list: (V row offset, column, then p)
  int q_at;      // byte offset of the f32 q tile [bm][dk]
  int zero_at;   // byte offset of the zero V row
  int ring_at;   // byte offset of the ring
  int act;
  float slope;
};

__host__ __device__ constexpr int lanes_per_row(int dt) {
  return dt > 64 ? 32 : dt > 32 ? 16 : 8;
}

// Whether row r of the staged block is live at columns c0 .. c0 + 3 (dead
// past bm or bn).
__device__ __forceinline__ void row_live(const unsigned char* __restrict__ as,
                                         const EllParams& p, int r, int c0,
                                         bool (&x)[4]) {
  if (r < p.bm && c0 < p.bn && p.bn % 4 == 0) {
    if (p.a_es == 4) {
      const uint4 u = *reinterpret_cast<const uint4*>(
          as + (static_cast<size_t>(r) * p.bn + c0) * 4);
      x[0] = live_bits(u.x);
      x[1] = live_bits(u.y);
      x[2] = live_bits(u.z);
      x[3] = live_bits(u.w);
    } else {
      const uint2 u = *reinterpret_cast<const uint2*>(
          as + (static_cast<size_t>(r) * p.bn + c0) * 2);
      x[0] = live_bits16(u.x);
      x[1] = live_bits16(u.x >> 16);
      x[2] = live_bits16(u.y);
      x[3] = live_bits16(u.y >> 16);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const size_t e = static_cast<size_t>(r) * p.bn + c0 + j;
      x[j] = r < p.bm && c0 + j < p.bn &&
             (p.a_es == 4
                  ? live_bits(reinterpret_cast<const uint32_t*>(as)[e])
                  : live_bits16(reinterpret_cast<const uint16_t*>(as)[e]));
    }
  }
}

// Compacts row r into `list` (the half-warp of `lane` does it, 4 columns
// a lane, 64 columns a pass): (byte offset of V row j in the staged tile,
// j) for each live column j, in ascending j.  Returns the count.
__device__ __forceinline__ int compact_row(const unsigned char* __restrict__ as,
                                           const EllParams& p, int r,
                                           int lane, int row_bytes,
                                           int2* list) {
  const int half = lane >> 4;
  const unsigned half_mask = 0xffffu << (16 * half);
  const unsigned below = ((1u << lane) - 1) & half_mask;
  int n = 0;
#pragma unroll
  for (int seg = 0; seg < kSegs; ++seg) {
    if (seg * 64 < p.bn) {
      const int c0 = seg * 64 + 4 * (lane & 15);
      bool x[4];
      row_live(as, p, r, c0, x);
      int pos = n;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned b = __ballot_sync(kFull, x[j]);
        pos += __popc(b & below);
        n += __popc(b & half_mask);
      }
      // branch-free: a dead column writes the list's last entry, which no
      // pass reads (the stride's two spare entries)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        list[x[j] ? pos : p.list_len - 1] =
            make_int2((c0 + j) * row_bytes, c0 + j);
        pos += x[j];
      }
    }
  }
  return n;
}

// One slot for one consumer warp: rows warp + 16q of the staged block, four
// at a time.  The four are compacted two at a time (a half-warp each) into
// the warp's four lists of (V row offset, column j).  Then kSL lanes a list
// take the four rows at once: they score the row's entries, act(q[r] .
// kT[:, j]) with kT at kb (row stride ks), take p = exp(s - m) against the
// row's max m, and only where a score beats it reduce the new max m' and
// redo p with the scale exp(m - m'); p replaces the column in the list.
// The row's m lives in lanes kSL li .. kSL li + kSL - 1 of list li (ms[c]
// for chunk c), each of them with its part of l (ls[c]).  Last, LG lanes a
// row (4 columns each) scale acc by the row's scale (a shuffle from those
// lanes, only where a max grew) and add p V over 32/LG rows at once, E
// entries of each row per iteration, the lists padded with entries that
// name a zero row with p = 0.
template <class T, int R, int LG>
__device__ __forceinline__ void consume(
    const unsigned char* __restrict__ as, const T* __restrict__ vs_tile,
    const T* __restrict__ zero_row, const T* kb, size_t ks,
    const float* __restrict__ qs, const EllParams& p, int warp, int lane,
    int col, int2* lists, float (&acc)[(R * LG + 31) / 32][4],
    float (&ms)[(R + kLists - 1) / kLists],
    float (&ls)[(R + kLists - 1) / kLists]) {
  constexpr int RPS = 32 / LG;        // rows summed at once
  constexpr int SPC = kLists / RPS;   // steps a chunk of kLists rows takes
  constexpr int CHUNKS = (R + kLists - 1) / kLists;
  constexpr int E = R >= 8 ? 2 : 4;
  static_assert(R * LG <= 128, "the accumulator tile must fit");
  const int g = lane / LG;
  const unsigned char* vl =
      reinterpret_cast<const unsigned char*>(vs_tile + col);
  const int pad = static_cast<int>((zero_row - vs_tile) * sizeof(T));
  const int row_bytes = p.hs * static_cast<int>(sizeof(T));
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    int cnt[kLists];
#pragma unroll
    for (int pp = 0; pp < kLists / 2; ++pp) {
      const int li = 2 * pp + (lane >> 4);
      const int n = compact_row(as, p, warp + (c * kLists + li) * kWarps,
                                lane, row_bytes, lists + li * p.list_len);
      cnt[2 * pp] = __shfl_sync(kFull, n, 0);
      cnt[2 * pp + 1] = __shfl_sync(kFull, n, 16);
    }
    __syncwarp();  // the lists are read by other lanes below
    float scale;
    bool any_grew;  // the max of one of the warp's four rows grew
    {  // the softmax lanes: list li = lane / kSL
      const int li = lane / kSL;
      const int r = warp + (c * kLists + li) * kWarps;
      int n = 0;
#pragma unroll
      for (int k = 0; k < kLists; ++k)
        if (k == li) n = cnt[k];
      int2* list = lists + li * p.list_len;
      // entries e0 and e1 = e0 + kSL in registers, both in flight at once
      // and branch-free (a lane past n scores column 0 and keeps
      // kNegInf); a row of more than 2 kSL live entries loops over the
      // rest through its list
      const int e0 = lane % kSL, e1 = e0 + kSL;
      const bool on0 = e0 < n, on1 = e1 < n;
      const int j0 = on0 ? list[e0].y : 0;
      const int j1 = on1 ? list[e1].y : 0;
      const float* q_row = qs + (r < p.bm ? r : 0) * p.dk;
      float d0 = 0.f, d1 = 0.f;
      for (int kk = 0; kk < p.dk; ++kk) {
        const float qv = q_row[kk];
        d0 = fmaf(qv, Elem<T>::to_f(kb[kk * ks + j0]), d0);
        d1 = fmaf(qv, Elem<T>::to_f(kb[kk * ks + j1]), d1);
      }
      const float s0 = on0 ? apply_act(d0, p.act, p.slope) : kNegInf;
      const float s1 = on1 ? apply_act(d1, p.act, p.slope) : kNegInf;
      // p against the row's current max, while the max is reduced; redone
      // where it grew (a few slots of a row's 256 on the serving graph)
      const float m_old = ms[c];
      float x0 = expf(s0 - m_old), x1 = expf(s1 - m_old);
      float mx = fmaxf(s0, s1);
      for (int e = e1 + kSL; e < n; e += kSL) {
        const int j = list[e].y;
        float dot = 0.f;
        for (int kk = 0; kk < p.dk; ++kk)
          dot = fmaf(q_row[kk], Elem<T>::to_f(kb[kk * ks + j]), dot);
        const float sc = apply_act(dot, p.act, p.slope);
        list[e].y = __float_as_int(sc);
        mx = fmaxf(mx, sc);
      }
      // the group's max, unless no score of the warp's four rows beats
      // its row's max (one vote instead of three shuffles)
      float m_new = m_old;
      any_grew = __any_sync(kFull, mx > m_old);
      if (any_grew) {
#pragma unroll
        for (int o = kSL / 2; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
        m_new = fmaxf(m_old, mx);
      }
      const bool grew = m_new > m_old;
      scale = grew ? expf(m_old - m_new) : 1.f;
      if (grew) {
        x0 = expf(s0 - m_new);
        x1 = expf(s1 - m_new);
      }
      ms[c] = m_new;
      const float p0 = on0 ? x0 : 0.f, p1 = on1 ? x1 : 0.f;
      if (on0) list[e0].y = __float_as_int(p0);
      if (on1) list[e1].y = __float_as_int(p1);
      float sum = p0 + p1;
      for (int e = e1 + kSL; e < n; e += kSL) {
        const float pv = expf(__int_as_float(list[e].y) - m_new);
        list[e].y = __float_as_int(pv);
        sum += pv;
      }
      // this lane's part of l; the parts are added once, at the end
      ls[c] = fmaf(ls[c], scale, sum);
    }
    __syncwarp();  // the p are read by the summing lanes
#pragma unroll
    for (int t = 0; t < SPC; ++t) {
      const int st = c * SPC + t;  // the step: acc[st], rows st * RPS + g
      if (st * RPS < R) {
        int most = 0, mine = 0;
#pragma unroll
        for (int k = 0; k < RPS; ++k) {
          most = max(most, cnt[t * RPS + k]);
          if (k == g) mine = cnt[t * RPS + k];
        }
        if (any_grew) {  // warp-uniform
          const float my_scale =
              __shfl_sync(kFull, scale, (t * RPS + g) * kSL);
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[st][j] *= my_scale;
        }
        const int len = (most + E - 1) / E * E;
        int2* list = lists + (t * RPS + g) * p.list_len;
        for (int e = mine + lane % LG; e < len; e += LG)
          list[e] = make_int2(pad, 0);
        __syncwarp();
#pragma unroll 1
        for (int j = 0; j < len; j += E) {
          int4 e[E / 2];
#pragma unroll
          for (int u = 0; u < E / 2; ++u)
            e[u] = *reinterpret_cast<const int4*>(&list[j + 2 * u]);
          float4 x[E];
#pragma unroll
          for (int u = 0; u < E / 2; ++u) {
            x[2 * u] = Elem<T>::load4(reinterpret_cast<const T*>(vl + e[u].x));
            x[2 * u + 1] =
                Elem<T>::load4(reinterpret_cast<const T*>(vl + e[u].z));
          }
#pragma unroll
          for (int u = 0; u < E; ++u) {
            const float pv = __int_as_float(u % 2 ? e[u / 2].w : e[u / 2].y);
            acc[st][0] = fmaf(pv, x[u].x, acc[st][0]);
            acc[st][1] = fmaf(pv, x[u].y, acc[st][1]);
            acc[st][2] = fmaf(pv, x[u].z, acc[st][2]);
            acc[st][3] = fmaf(pv, x[u].w, acc[st][3]);
          }
        }
      }
    }
    __syncwarp();  // the lists are rewritten for the next chunk
  }
}

// The producer warp's fill of ring stage it % stages with slot slot0 + it:
// the block, the bn x dt tile of V its column index names and, where kT
// is staged, its dk x bn piece of kT; lane 0 arms the stage's mbarrier
// with the bytes to come.
template <class T>
__device__ __forceinline__ void fill_stage(const EllParams& p,
                                           unsigned char* ring,
                                           uint64_t* full, size_t slot0,
                                           int it, int d0, int dt, int lane,
                                           uint64_t stream, uint64_t keep) {
  const int st = it % p.stages;
  const size_t at =
      static_cast<size_t>(st) * (p.a_bytes + p.h_bytes + p.k_bytes);
  unsigned char* as = ring + at;
  T* vst = reinterpret_cast<T*>(ring + at + p.a_bytes);
  T* kst = reinterpret_cast<T*>(ring + at + p.a_bytes + p.h_bytes);
  const size_t s = slot0 + it;
  const int block_elems = p.bm * p.bn;
  const uint32_t a_exact = block_elems * p.a_es;
  const unsigned char* a_src =
      static_cast<const unsigned char*>(p.blocks) + s * a_exact;
  const size_t col0 = static_cast<size_t>(p.idx[s]) * p.bn;
  const T* v_src = static_cast<const T*>(p.v) + col0 * p.d + d0;
  const T* k_src = static_cast<const T*>(p.kt) + col0;
  const uint32_t v_row = dt * sizeof(T);
  const uint32_t k_row = p.bn * sizeof(T);
  const bool stage_k = p.k_bytes > 0;
  if (!p.bulk_a) {
    if (p.a_es == 4)
      for (int e = lane; e < block_elems; e += 32)
        reinterpret_cast<uint32_t*>(as)[e] =
            reinterpret_cast<const uint32_t*>(a_src)[e];
    else
      for (int e = lane; e < block_elems; e += 32)
        reinterpret_cast<uint16_t*>(as)[e] =
            reinterpret_cast<const uint16_t*>(a_src)[e];
  }
  if (!p.bulk_h)
    for (int e = lane; e < p.bn * dt; e += 32) {
      const int k = e / dt;
      vst[k * p.hs + (e - k * dt)] =
          v_src[static_cast<size_t>(k) * p.d + (e - k * dt)];
    }
  if (stage_k && !p.bulk_k)
    for (int e = lane; e < p.dk * p.bn; e += 32) {
      const int kk = e / p.bn;
      kst[e] = k_src[static_cast<size_t>(kk) * p.n + (e - kk * p.bn)];
    }
  if (!p.bulk_a || !p.bulk_h || (stage_k && !p.bulk_k))
    __threadfence_block();
  __syncwarp();
  if (lane == 0)
    mbar_arrive_expect_tx(
        &full[st],
        (p.bulk_a ? a_exact : 0) +
            (p.bulk_h ? static_cast<uint32_t>(p.bn) * v_row : 0) +
            (stage_k && p.bulk_k ? static_cast<uint32_t>(p.dk) * k_row : 0));
  __syncwarp();
  if (p.bulk_a && lane == 0) bulk_copy(as, a_src, a_exact, &full[st], stream);
  if (p.bulk_h) {
    if (dt == p.d) {  // the V tile is one contiguous run
      if (lane == 0) bulk_copy(vst, v_src, p.bn * v_row, &full[st], keep);
    } else {
      for (int k = lane; k < p.bn; k += 32)
        bulk_copy(vst + k * p.hs, v_src + static_cast<size_t>(k) * p.d,
                  v_row, &full[st], keep);
    }
  }
  if (stage_k && p.bulk_k)
    for (int kk = lane; kk < p.dk; kk += 32)
      bulk_copy(kst + kk * p.bn, k_src + static_cast<size_t>(kk) * p.n, k_row,
                &full[st], keep);
}

// Grid: one CTA per (block-row i, D-tile t), x = i * n_dt + t, so the
// D-tiles of a block-row are neighbours.
template <class T, int R, int LG>
__global__ void __launch_bounds__(kThreads, 1)
    fused_attn_blockell_kernel(const EllParams p) {
  constexpr int RPS = 32 / LG;
  constexpr int STEPS = (R * LG + 31) / 32;  // rows a lane sums
  constexpr int CHUNKS = (R + kLists - 1) / kLists;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  unsigned char* ring = smem + p.ring_at;
  float* qs = reinterpret_cast<float*>(smem + p.q_at);

  const int i = blockIdx.x / p.n_dt;
  const int d0 = (blockIdx.x % p.n_dt) * p.dt;
  const int dt = min(p.dt, p.d - d0);
  const size_t slot0 = static_cast<size_t>(i) * p.w;
  const size_t row0 = static_cast<size_t>(i) * p.bm;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  T* zero_row = reinterpret_cast<T*>(smem + p.zero_at);
  for (int e = threadIdx.x; e < p.hs; e += kThreads)
    zero_row[e] = Elem<T>::from_f(0.f);
  const T* q = static_cast<const T*>(p.q) + row0 * p.dk;
  for (int e = threadIdx.x; e < p.bm * p.dk; e += kThreads)
    qs[e] = Elem<T>::to_f(q[e]);
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kWarps) {
    // producer: slot it into stage it % stages once the consumers have
    // released what that stage held
    const uint64_t stream = l2_policy(true), keep = l2_policy(false);
    for (int it = 0; it < p.w; ++it) {
      if (it >= p.stages)
        mbar_wait(&empty[it % p.stages], ((it / p.stages) - 1) & 1);
      fill_stage<T>(p, ring, full, slot0, it, d0, dt, lane, stream, keep);
    }
    return;
  }

  // this lane's 4 columns of the D-tile; lanes past dt read column 0's
  // and store nothing
  const int col = 4 * (lane % LG);
  const bool lane_on = col < dt;
  float acc[STEPS][4], ms[CHUNKS], ls[CHUNKS];
#pragma unroll
  for (int s = 0; s < STEPS; ++s)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[s][j] = 0.f;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    ms[c] = kNegInf;
    ls[c] = 0.f;
  }
  int2* lists = reinterpret_cast<int2*>(smem + kBarrierBytes) +
                warp * kLists * p.list_len;
  const T* kt = static_cast<const T*>(p.kt);
  for (int it = 0; it < p.w; ++it) {
    const int st = it % p.stages;
    const unsigned char* base = ring + static_cast<size_t>(st) *
                                           (p.a_bytes + p.h_bytes + p.k_bytes);
    const T* vs = reinterpret_cast<const T*>(base + p.a_bytes);
    mbar_wait(&full[st], (it / p.stages) & 1);
    // kT's columns of the slot: staged (row stride bn; a pointer the
    // compiler sees is shared, so shared-memory loads) or in L2 (stride n)
    if (p.k_bytes > 0)
      consume<T, R, LG>(base, vs, zero_row,
                        reinterpret_cast<const T*>(vs) + p.h_bytes / sizeof(T),
                        p.bn, qs, p, warp, lane, lane_on ? col : 0, lists,
                        acc, ms, ls);
    else
      consume<T, R, LG>(base, vs, zero_row,
                        kt + static_cast<size_t>(p.idx[slot0 + it]) * p.bn,
                        p.n, qs, p, warp, lane, lane_on ? col : 0, lists, acc,
                        ms, ls);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // each row's l: the parts of its list's softmax lanes, added, then
  // taken by the lanes that hold its acc
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
    for (int o = kSL / 2; o > 0; o >>= 1)
      ls[c] += __shfl_xor_sync(kFull, ls[c], o);
  float den[STEPS];
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const int li = (s * RPS + lane / LG) % kLists;
    den[s] = fmaxf(__shfl_sync(kFull, ls[s * RPS / kLists], li * kSL), kEps);
  }
  if (!lane_on) return;
  T* y = static_cast<T*>(p.y);
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const int r = warp + (s * RPS + lane / LG) * kWarps;
    if (r < p.bm) {
      const size_t at = (row0 + r) * p.d + d0 + col;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (col + j < dt) y[at + j] = Elem<T>::from_f(acc[s][j] / den[s]);
    }
  }
}

size_t round16(size_t bytes) { return (bytes + 15) / 16 * 16; }

template <class T, int R, int LG>
cudaError_t launch_ell(const EllParams& p, int nbr, cudaStream_t stream) {
  auto kernel = fused_attn_blockell_kernel<T, R, LG>;
  const size_t smem =
      p.ring_at + static_cast<size_t>(p.stages) *
                      (p.a_bytes + p.h_bytes + p.k_bytes);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMaxSmem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(nbr) * p.n_dt, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <class T, int LG>
cudaError_t ell_rows(const EllParams& p, int nbr, cudaStream_t stream) {
  const int rows = (p.bm + kWarps - 1) / kWarps;
  if (rows <= 1) return launch_ell<T, 1, LG>(p, nbr, stream);
  if (rows <= 2) return launch_ell<T, 2, LG>(p, nbr, stream);
  if (rows <= 4) return launch_ell<T, 4, LG>(p, nbr, stream);
  // 8 rows a warp take a D-tile of at most 64 columns (see plan_ell)
  if constexpr (LG < 32)
    if (rows <= 8) return launch_ell<T, 8, LG>(p, nbr, stream);
  return cudaErrorInvalidValue;
}

bool aligned(const void* ptr, size_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

// The widest D-tile (<= 128 columns, a multiple of 8) of which two stages
// fit in one CTA's shared memory, and the ring depth; blocks of more than
// 64 rows (8 a warp) take at most 64 columns, so their accumulator tile
// fits in the registers.  Returns the stages (< 2: they do not fit).
template <class T>
int plan_ell(EllParams& p) {
  const size_t es = sizeof(T);
  const int d8 = (p.d + 7) / 8 * 8;
  for (int cand = p.bm > 4 * kWarps ? kMaxDT / 2 : kMaxDT;; cand /= 2) {
    p.dt = cand < d8 ? cand : d8;
    p.n_dt = (p.d + p.dt - 1) / p.dt;
    p.hs = p.n_dt == 1 && p.bulk_h ? p.d : p.dt;
    p.h_bytes =
        static_cast<int>(round16(static_cast<size_t>(p.bn) * p.hs * es));
    p.ring_at = p.zero_at + static_cast<int>(round16(p.hs * es));
    const size_t stage = p.a_bytes + p.h_bytes + p.k_bytes;
    if (p.ring_at + 2 * stage <= kMaxSmem || cand <= 8) {
      size_t n = p.ring_at < kMaxSmem ? (kMaxSmem - p.ring_at) / stage : 0;
      return static_cast<int>(n > kMaxStages ? kMaxStages : n);
    }
  }
}

template <class T>
cudaError_t run_ell(EllParams p, int nbr, cudaStream_t stream) {
  const size_t es = sizeof(T);
  p.bulk_a = aligned(p.blocks, 16) &&
             (static_cast<size_t>(p.bm) * p.bn * p.a_es) % 16 == 0;
  p.bulk_h = aligned(p.v, 16) && (static_cast<size_t>(p.d) * es) % 16 == 0;
  p.bulk_k = aligned(p.kt, 16) && (static_cast<size_t>(p.n) * es) % 16 == 0 &&
             (static_cast<size_t>(p.bn) * es) % 16 == 0;
  p.a_bytes =
      static_cast<int>(round16(static_cast<size_t>(p.bm) * p.bn * p.a_es));
  // a list holds a row's live entries padded to a multiple of 4; its
  // stride, 2 entries more, puts the lists a warp reads at once on other
  // banks
  p.list_len = (p.bn + 3) / 4 * 4 + 2;
  p.q_at = kBarrierBytes + kWarps * kLists * p.list_len * 8;
  p.zero_at = p.q_at + static_cast<int>(round16(
                           static_cast<size_t>(p.bm) * p.dk * sizeof(float)));
  // kT's piece of a slot is staged with it where two stages still fit
  // (at dk = 2 it is 512 bytes); otherwise the consumers read it from L2
  p.k_bytes =
      static_cast<int>(round16(static_cast<size_t>(p.dk) * p.bn * es));
  p.stages = plan_ell<T>(p);
  if (p.stages < 2) {
    p.k_bytes = 0;
    p.stages = plan_ell<T>(p);
  }
  if (p.stages < 2) return cudaErrorInvalidValue;
  switch (lanes_per_row(p.dt)) {
    case 32:
      return ell_rows<T, 32>(p, nbr, stream);
    case 16:
      return ell_rows<T, 16>(p, nbr, stream);
    default:
      return ell_rows<T, 8>(p, nbr, stream);
  }
}

// ---------------------------------------------------------------------------
// K8: SELL-C-sigma, one row at a time over the row view
// ---------------------------------------------------------------------------

constexpr int kRowThreads = 256;
constexpr int kBatch = 8;  // V rows in flight per lane
constexpr int kQReg = 4;   // q values a lane keeps in registers

struct RowParams {
  const int* row_slot;
  const int* row_nnz;
  const int* heavy_rows;
  const int* cols;
  const void* vals;  // the mask, v_es bytes an element
  const void* q;     // T [n_rows, dk], compact row order
  const void* kt;    // T [dk, n]: element (kk, c) at kk * kt_sk + c * kt_sc
  const void* v;     // T [n, d]
  void* y;           // T [n_rows, d]
  int n_rows, n_heavy, heavy_nnz, dk, n, d;
  int kt_sk, kt_sc;  // kT's strides, in elements
  int v_es;  // bytes of a value: 4 or 2
  int act;
  float slope;
};

__device__ __forceinline__ bool live_slot(const RowParams& p, int s) {
  return p.v_es == 4
             ? live_bits(__ldg(static_cast<const uint32_t*>(p.vals) + s))
             : live_bits16(__ldg(static_cast<const uint16_t*>(p.vals) + s));
}

// W columns of T at p (16- or 8-byte aligned where W = 4).
template <class T, int W>
__device__ __forceinline__ void load_cols(const T* __restrict__ p,
                                          float (&x)[W]) {
  if constexpr (W == 4) {
    const float4 v = Elem<T>::load4(p);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
    x[0] = Elem<T>::to_f(*p);
  }
}

// The online softmax of one group of L lanes over its entries k < count
// (slots slot + k), into (m, l, acc); count_max is the warp's largest
// count, so every lane runs the same shuffles.  The group's lane sub holds
// columns col .. col + W - 1 of acc.  q_row: the row's q.
template <class T, int L, int W>
__device__ __forceinline__ void attend(const RowParams& p,
                                       const T* __restrict__ q_row, int slot,
                                       int count, int count_max, int col,
                                       float& m, float& l, float (&acc)[W]) {
  constexpr int P = 32 / L;  // entries each lane holds per round of 32
  const int sub = threadIdx.x % L;
  const T* kt = static_cast<const T*>(p.kt);
  const T* v = static_cast<const T*>(p.v);
  const size_t ld = static_cast<size_t>(p.d);
  float qr[kQReg];
#pragma unroll
  for (int kk = 0; kk < kQReg; ++kk)
    qr[kk] = count > 0 && kk < p.dk ? Elem<T>::to_f(q_row[kk]) : 0.f;
  m = kNegInf;
  l = 0.f;
#pragma unroll
  for (int w = 0; w < W; ++w) acc[w] = 0.f;

  for (int base = 0; base < count_max; base += 32) {
    int cq[P];
    float pq[P];
    bool live[P];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int k = base + j * L + sub;
      const bool ok = k < count;
      cq[j] = ok ? __ldg(p.cols + slot + k) : 0;
      live[j] = ok && live_slot(p, slot + k);
      float dot = 0.f;
      const T* kt_col = kt + static_cast<size_t>(cq[j]) * p.kt_sc;
      if (live[j]) {
#pragma unroll
        for (int kk = 0; kk < kQReg; ++kk)
          if (kk < p.dk)
            dot = fmaf(qr[kk], Elem<T>::to_f(kt_col[kk * p.kt_sk]), dot);
        for (int kk = kQReg; kk < p.dk; ++kk)
          dot = fmaf(Elem<T>::to_f(q_row[kk]),
                     Elem<T>::to_f(kt_col[kk * p.kt_sk]), dot);
      }
      pq[j] = live[j] ? apply_act(dot, p.act, p.slope) : kNegInf;
      mx = fmaxf(mx, pq[j]);
    }
#pragma unroll
    for (int o = L / 2; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
    const float m_new = fmaxf(m, mx);
    if (m_new > m) {  // the max grew: rescale what was summed
      const float sc = expf(m - m_new);
      l *= sc;
#pragma unroll
      for (int w = 0; w < W; ++w) acc[w] *= sc;
      m = m_new;
    }
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      pq[j] = live[j] ? expf(pq[j] - m) : 0.f;
      sum += pq[j];
    }
#pragma unroll
    for (int o = L / 2; o > 0; o >>= 1)
      sum += __shfl_xor_sync(kFull, sum, o);
    l += sum;

    const int n_round = min(32, count_max - base);
#pragma unroll
    for (int j0 = 0; j0 < 32; j0 += kBatch) {
      if (j0 >= n_round) break;  // warp-uniform
      int c[kBatch];
      float pv[kBatch];
      float x[kBatch][W];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int j = j0 + b;
        c[b] = __shfl_sync(kFull, cq[j / L], j % L, L);
        pv[b] = __shfl_sync(kFull, pq[j / L], j % L, L);
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (pv[b] != 0.f && col < p.d) {
          load_cols<T, W>(v + static_cast<size_t>(c[b]) * ld + col, x[b]);
        } else {
#pragma unroll
          for (int w = 0; w < W; ++w) x[b][w] = 0.f;
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
#pragma unroll
        for (int w = 0; w < W; ++w) acc[w] = fmaf(pv[b], x[b][w], acc[w]);
    }
  }
}

// acc / max(l, eps) at row, columns col .. col + W - 1 (those below d).
template <class T, int W>
__device__ __forceinline__ void store_row(const RowParams& p, int row, int col,
                                          float l, const float (&acc)[W]) {
  T* y = static_cast<T*>(p.y) + static_cast<size_t>(row) * p.d;
  const float den = fmaxf(l, kEps);
#pragma unroll
  for (int w = 0; w < W; ++w)
    if (col + w < p.d) y[col + w] = Elem<T>::from_f(acc[w] / den);
}

// Light rows (at most heavy_nnz nonzeros): one group of L lanes a row,
// 32 / L rows a warp; wider D takes passes of L * W columns, each
// recomputing the scores.
template <class T, int L, int W>
__device__ __forceinline__ void light_rows(const RowParams& p, int block) {
  const int lane = threadIdx.x & 31;
  const int sub = lane % L;
  const int warp = (block * kRowThreads + threadIdx.x) >> 5;
  const int row = warp * (32 / L) + lane / L;
  const int count = row < p.n_rows ? p.row_nnz[row] : 0;
  const bool mine = row < p.n_rows && count <= p.heavy_nnz;  // else a CTA's
  const int nnz = mine ? count : 0;
  const int slot = mine ? p.row_slot[row] : 0;
  const int nnz_max = __reduce_max_sync(kFull, nnz);
  const T* q_row =
      static_cast<const T*>(p.q) + static_cast<size_t>(mine ? row : 0) * p.dk;
  for (int c0 = 0; c0 < p.d; c0 += L * W) {
    const int col = c0 + sub * W;
    float m, l, acc[W];
    attend<T, L, W>(p, q_row, slot, nnz, nnz_max, col, m, l, acc);
    if (mine && col < p.d) store_row<T, W>(p, row, col, l, acc);
  }
}

// One heavy row for the whole CTA: its kRowThreads / L groups each run one
// contiguous chunk of the nonzeros with their own (m, l, acc); the chunks
// are merged in chunk order through shared memory.
template <class T, int L, int W>
__device__ __forceinline__ void heavy_row(const RowParams& p, int row) {
  constexpr int G = kRowThreads / L;  // chunks
  constexpr int C = L * W;            // columns per pass
  __shared__ float part[G][C];
  __shared__ float part_m[G], part_l[G];
  const int g = threadIdx.x / L;
  const int sub = threadIdx.x % L;
  const int nnz = p.row_nnz[row];
  const int chunk = (nnz + G - 1) / G;
  const int lo = min(nnz, g * chunk);
  const int hi = min(nnz, lo + chunk);
  const int count_max = __reduce_max_sync(kFull, hi - lo);
  const T* q_row = static_cast<const T*>(p.q) + static_cast<size_t>(row) * p.dk;
  T* y = static_cast<T*>(p.y) + static_cast<size_t>(row) * p.d;
  for (int c0 = 0; c0 < p.d; c0 += C) {
    float m, l, acc[W];
    attend<T, L, W>(p, q_row, p.row_slot[row] + lo, hi - lo, count_max,
                    c0 + sub * W, m, l, acc);
#pragma unroll
    for (int w = 0; w < W; ++w) part[g][sub * W + w] = acc[w];
    if (sub == 0) {
      part_m[g] = m;
      part_l[g] = l;
    }
    __syncthreads();
    for (int t = threadIdx.x; t < C && c0 + t < p.d; t += kRowThreads) {
      float mm = kNegInf;
      for (int k = 0; k < G; ++k) mm = fmaxf(mm, part_m[k]);
      float ll = 0.f, z = 0.f;
      for (int k = 0; k < G; ++k) {  // chunk order: fixed
        const float e = expf(part_m[k] - mm);
        ll = fmaf(part_l[k], e, ll);
        z = fmaf(part[k][t], e, z);
      }
      y[c0 + t] = Elem<T>::from_f(z / fmaxf(ll, kEps));
    }
    __syncthreads();
  }
}

// The first n_heavy blocks own one heavy row each, so their long sums start
// first; each block after them owns kRowThreads / L consecutive rows.  Two
// CTAs an SM (at most 128 registers): the gathers wait on L2, and more
// warps in flight hide more of that wait.
template <class T, int L, int W>
__global__ void __launch_bounds__(kRowThreads, 2)
    fused_attn_rows_kernel(const RowParams p) {
  const int block = static_cast<int>(blockIdx.x);
  if (block < p.n_heavy)
    heavy_row<T, L, W>(p, p.heavy_rows[block]);
  else
    light_rows<T, L, W>(p, block - p.n_heavy);
}

template <class T, int L, int W>
cudaError_t launch_rows(const RowParams& p, cudaStream_t stream) {
  constexpr int rows_per_block = kRowThreads / L;
  const int n_light = (p.n_rows + rows_per_block - 1) / rows_per_block;
  fused_attn_rows_kernel<T, L, W>
      <<<n_light + p.n_heavy, kRowThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// Lanes a row: the fewest powers of two from 4 to 32 that cover d / W
// columns (wider rows take passes of 32 * W columns).
template <class T, int W>
cudaError_t rows_lanes(const RowParams& p, cudaStream_t stream) {
  const int need = (p.d + W - 1) / W;
  if (need <= 4) return launch_rows<T, 4, W>(p, stream);
  if (need <= 8) return launch_rows<T, 8, W>(p, stream);
  if (need <= 16) return launch_rows<T, 16, W>(p, stream);
  return launch_rows<T, 32, W>(p, stream);
}

template <class T>
cudaError_t run_rows(const RowParams& p, cudaStream_t stream) {
  const bool vec = p.d % 4 == 0 && aligned(p.v, 4 * sizeof(T));
  return vec ? rows_lanes<T, 4>(p, stream) : rows_lanes<T, 1>(p, stream);
}

}  // namespace

// dtype: 0 f32, 1 bf16, 2 f16, for q, kt, v and y alike; a_es: bytes of a
// block element (4 or 2), read only as the mask.  idx int32[nbr, w];
// blocks [nbr, w, bm, bn]; q [nbr*bm, dk]; kt [dk, n] and v [n, d] with n
// a multiple of bn; y [nbr*bm, d].  Returns the cudaError_t of the launch.
extern "C" int fused_attn_blockell(int dtype, int a_es, const int* idx,
                                   const void* blocks, const void* q,
                                   const void* kt, const void* v, void* y,
                                   int nbr, int w, int bm, int bn, int dk,
                                   int n, int d, int act, float slope,
                                   void* stream) {
  if (nbr == 0 || d == 0) return cudaSuccess;
  if (bm < 1 || bn < 1 || bm > 128 || bn > 128 || dk < 1 ||
      (a_es != 4 && a_es != 2))
    return cudaErrorInvalidValue;
  EllParams p = {};
  p.idx = idx;
  p.blocks = blocks;
  p.q = q;
  p.kt = kt;
  p.v = v;
  p.y = y;
  p.w = w;
  p.bm = bm;
  p.bn = bn;
  p.dk = dk;
  p.n = n;
  p.d = d;
  p.a_es = a_es;
  p.act = act;
  p.slope = slope;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(run_ell<float>(p, nbr, st));
    case 1:
      return static_cast<int>(run_ell<__nv_bfloat16>(p, nbr, st));
    case 2:
      return static_cast<int>(run_ell<__half>(p, nbr, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dtype as above for q, kt, v and y; v_es: bytes of a value (4 or 2), read
// only as the mask.  row_slot, row_nnz int32[n_rows]: first slot and count
// of each compact row's nonzeros; heavy_rows int32[n_heavy]: exactly the
// rows with more than heavy_nnz nonzeros (each gets a CTA); cols int32[S]
// (each < n), vals [S]; q [n_rows, dk]; kt [dk, n] at element strides
// (kt_sk, kt_sc); v [n, d]; y [n_rows, d].  Returns the cudaError_t of the
// launch.
extern "C" int fused_attn_sell(int dtype, int v_es, const int* row_slot,
                               const int* row_nnz, const int* heavy_rows,
                               const int* cols, const void* vals,
                               const void* q, const void* kt, int kt_sk,
                               int kt_sc, const void* v, void* y, int n_rows,
                               int n_heavy, int heavy_nnz, int dk, int n,
                               int d, int act, float slope, void* stream) {
  if (n_rows == 0 || d == 0) return cudaSuccess;
  if (dk < 1 || (v_es != 4 && v_es != 2)) return cudaErrorInvalidValue;
  const RowParams p{row_slot, row_nnz, heavy_rows, cols,  vals,  q,
                    kt,       v,       y,          n_rows, n_heavy,
                    heavy_nnz, dk,     n,          d,     kt_sk, kt_sc,
                    v_es,     act,     slope};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(run_rows<float>(p, st));
    case 1:
      return static_cast<int>(run_rows<__nv_bfloat16>(p, st));
    case 2:
      return static_cast<int>(run_rows<__half>(p, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
