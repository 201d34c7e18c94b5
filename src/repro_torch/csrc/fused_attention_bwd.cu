// K7b: the backward of the fused graph attention over a Block-ELL pattern
// (K7's), its whole per-edge chain in one pass over each block-row, for
// sm_90a.
//
// Replaces no Pallas kernel.  The JAX package runs this chain in jnp
// (src/repro/sparse/autodiff.py, the fused-attention rule): a score
// recompute (an SDDMM at K = dk), a row softmax, dα = ḡ Vᵀ at the pattern
// (an SDDMM at K = D), the softmax JVP and dq = de k (an SpMM), each an
// array in A's block layout.  On the card that was K3, K3p, K1 and some
// fifteen PyTorch passes over [nbr, W, bm, bn] f32 arrays a layer (1.07 GB
// each on the 16384-node, 10 %-dense graph).  For every row i of A and
// its live entries j (A's pattern, as occupancy bits):
//
//   s_ij  = act(z_ij),  z_ij = q_i . kT[:, j]     fmaf from 0, ascending dk
//   m_i   = max_j s_ij,  l_i = sum_j exp(s_ij - m_i)
//   α_ij  = exp(s_ij - m_i) / max(l_i, 1e-12)
//   dα_ij = ḡ_i . V_j                             fmaf from 0, ascending D
//   de_ij = (dα_ij - rowdot_i) α_ij act'(z_ij)
//   dq_i  = sum_j de_ij kT[:, j]
//
// α and de leave in A's Block-ELL layout, written whole (exact 0 at dead
// cells and padded slots): the rule's transposed products dV = αᵀ ḡ and
// dk = deᵀ q read them (N1).  dq leaves as [m, dk].  Everything is f32
// (fmaf, expf and division without fast-math, no TF32); the wrapper
// widens narrow operands first, exactly.  dα is K3p's dot bit for bit
// (csrc/sddmm.cu: the same fmaf chain, the same zero terms past a ragged
// D); s, α and de are the composed rule's on the card but for l's order.
//
// What bounds it on an H100: its two stores.  α and de are 2 x 1.07 GB
// on the serving graph (0.64 ms at 3.35 TB/s); the pattern is read as
// bits (33.5 MB, 1/32 of one store) twice, V and ḡ come from L2.  The
// arithmetic is the dots, nnz x D multiply-adds (3.4 G at D = 128, 0.10 ms
// of FP32), bounded in practice by shared memory: each dot reads a row of
// ḡ and a row of V.  The design:
//  - one CTA of 256 threads a block-row (A's rows i*bm .. i*bm + bm - 1),
//    so the row statistics need no second kernel and no atomics; its
//    shared memory fits two CTAs an SM at 64 x 64 blocks and D = 128, the
//    serving graph's 256 block-rows one wave;
//  - sweep 1 keeps nothing but (m, l): the block-row's bit words and kT
//    pieces stream through shared memory by cp.async, a few slots a step;
//    a thread owns (row, 32-column word, share of the slots) units, scores
//    each set bit and keeps a running max and exp-sum (rescaled where the
//    max grows), in ascending slot and column; the units are merged in one
//    fixed order;
//  - sweep 2 walks the slots in order, each slot's bits, kT piece and V
//    rows (bn x D, or D in chunks of 128) staged by cp.async one slot
//    ahead where two stages keep as many CTAs on an SM as one, ḡ's bm x D
//    block staged once.  The slot's live cells are listed by column mod
//    8, as K3p lists them (a quarter warp's V rows fall in 8 distinct bank
//    groups; rows padded to an odd number of 16-byte vectors); each lane
//    sums whole dots, then takes its cells' α and de (the score
//    recomputed, dk multiply-adds) into two f32 tiles;
//  - both tiles leave whole, 0 where no bit is set, in 16-byte streaming
//    stores; de stays for dq, whose (row, kk) sums are each owned by one
//    thread and walk the set bits in ascending column.  No other per-edge
//    quantity leaves the chip.
// Measured on the serving graph (PERF.md): 3.2 ms at D = 128, 2.0 at
// D = 16.  Each of its parts costs about what it costs alone (sweep 1,
// the staging and lists, the dots, the stores): they do not overlap, and
// a pipelined variant (one barrier a slot, one CTA an SM) was slower.
//
// Determinism: no atomics; every output is the same sum in the same order
// on every run.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kResidues = 8;     // 16-byte vectors a row of 32 banks holds
constexpr int kChunk = 128;      // D columns of a staged row (512 bytes)
constexpr int kMaxSmem = 232448;  // what one block may use on sm_90
constexpr int kMaxBlock = 128;
constexpr int kStatUnits = 4;
constexpr float kNegInf = -1e30f;  // finite: masked - masked stays nan-free
constexpr float kEps = 1e-12f;
// act codes, as ACT_CODES in kernels/spmm/kernel.py: 0 identity
constexpr int kActRelu = 1;
constexpr int kActLeakyRelu = 2;

__device__ __forceinline__ float apply_act(float z, int act, float slope) {
  if (act == kActRelu) return fmaxf(z, 0.f);
  if (act == kActLeakyRelu) return z >= 0.f ? z : slope * z;
  return z;
}

// d act / dz at z, as kernels/fused/epilogue.act_grad_from_out reads it
__device__ __forceinline__ float act_grad(float z, int act, float slope) {
  if (act == kActRelu) return z > 0.f ? 1.f : 0.f;
  if (act == kActLeakyRelu) return z >= 0.f ? 1.f : slope;
  return 1.f;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__host__ __device__ constexpr unsigned up16(unsigned x) {
  return (x + 15u) & ~15u;
}

// The dynamic shared memory of one block, byte offsets: the block-row's
// column indices (w ints); ḡ's chunk (bm rows) and `stages` V chunks (bn
// rows), each row kc floats padded to an odd number of 16-byte vectors (rs
// bytes), sweep 1's `stages` stages of `parts` slots' bit words and kT
// pieces in their place; `stages` slots of bit words and of kT pieces
// (k's rows, [bn][dk]); the current slot's bit words and kT piece; the de
// and α tiles (rows of ysr floats; sweep 1's units' (m, l) in their
// place); the slot's nonzeros (row << 8 | column) in kResidues lists of
// cap entries, and their lengths; q, dq's sums and the row statistics (m,
// max(l, eps), rowdot).
struct Layout {
  unsigned rs, ow, cap, ysr, parts, units, s1_part, idx, g, v, bits, ks, cur,
      kcur, y, a, list, len, q, dq, stat, s1, um, ul, bytes;
};

__host__ __device__ inline Layout layout(int bm, int bn, int dk, int kc,
                                         int stages, int w) {
  Layout l;
  const unsigned vecs = static_cast<unsigned>(kc) / 4;
  l.rs = 16 * (vecs | 1u);
  l.ow = (bn + 31) / 32;
  l.cap = bm * ((bn + kResidues - 1) / kResidues);
  l.ysr = bn % 4 == 0 ? bn : bn + 1;
  const unsigned urw = bm * l.ow;
  // sweep 1 reads kStatUnits units a thread a step: parts slots a step
  l.parts = urw < kStatUnits * kThreads ? kStatUnits * kThreads / urw : 1;
  if (l.parts > kThreads) l.parts = kThreads;
  l.units = l.parts * urw;
  l.s1_part = up16(urw * 4) + up16(dk * bn * 4);
  const unsigned v_bytes = stages * bn * l.rs;
  const unsigned s1_bytes = stages * l.parts * l.s1_part;
  l.idx = 0;
  l.g = l.idx + up16(w * 4);
  l.v = l.g + bm * l.rs;
  l.s1 = l.v;  // sweep 1 is over before sweep 2 stages V
  l.bits = l.v + (v_bytes > s1_bytes ? v_bytes : s1_bytes);
  l.ks = l.bits + up16(stages * urw * 4);
  l.cur = l.ks + stages * up16(dk * bn * 4);
  l.kcur = l.cur + up16(urw * 4);
  l.y = l.kcur + up16(dk * bn * 4);
  // sweep 1's (m, l) of its units live where sweep 2's tiles will
  const unsigned tile = up16(bm * l.ysr * 4) > up16(l.units * 4)
                            ? up16(bm * l.ysr * 4)
                            : up16(l.units * 4);
  l.a = l.y + tile;
  l.um = l.y;
  l.ul = l.a;
  l.list = l.a + tile;
  l.len = l.list + up16(kResidues * l.cap * 2);
  l.q = l.len + up16(kResidues * 4);
  l.dq = l.q + up16(bm * dk * 4);
  l.stat = l.dq + up16(bm * dk * 4);
  l.bytes = l.stat + up16(3 * bm * 4);
  return l;
}

struct Params {
  const int* idx;         // [nbr, w] block columns
  const unsigned* occ;    // [nbr * w, bm, ow] bit words
  const float* q;         // [m, dk]
  const float* kt;        // kT [dk, n] through strides ks0, ks1
  const float* v;         // [n, d]
  const float* g;         // [m, d]
  const float* rowdot;    // [m]
  float* alpha;           // [nbr, w, bm, bn]
  float* de;              // [nbr, w, bm, bn]
  float* dq;              // [m, dk]
  int ks0, ks1;
  int w, bm, bn, dk, m, n, d;
  int kc, stages;
  int act;
  float slope;
  bool vec_in, vec_out, vec_bits, vec_k;
  Layout L;
};

// The set bits of word `wd` of a tile row that lie below bn.
__device__ __forceinline__ unsigned word_mask(int bn, int wd) {
  const int left = bn - 32 * wd;
  return left >= 32 ? ~0u : (1u << left) - 1u;
}

// z = q_r . kT[:, j] from q's row in shared memory and a staged kT piece
// (k's rows j of the slot, dk floats each), fmaf from 0 in ascending dk.
__device__ __forceinline__ float score_dot(const float* __restrict__ qr,
                                           const float* __restrict__ kp,
                                           int dk, int j) {
  float z = 0.f;
  for (int kk = 0; kk < dk; ++kk) z = fmaf(qr[kk], kp[j * dk + kk], z);
  return z;
}

// Rows [0, n_rows) of a chunk of kn floats (row stride ld) into shared rows
// of rs bytes, padded with zeros to whole 16-byte vectors: by 16-byte
// cp.async where ASYNC and vec (ld a multiple of 4, 16-byte aligned base),
// by 16-byte loads where vec only, else element by element.
template <bool ASYNC>
__device__ __forceinline__ void load_rows(unsigned char* dst,
                                          const float* __restrict__ src,
                                          int n_rows, int kn, int ld,
                                          unsigned rs, bool vec) {
  const int pieces = (kn + 3) / 4;
  if (vec) {
    for (int e = threadIdx.x; e < n_rows * pieces; e += kThreads) {
      const int r = e / pieces;
      const int pc = e - r * pieces;
      const float* from = src + static_cast<size_t>(r) * ld + pc * 4;
      unsigned char* to = dst + r * rs + pc * 16;
      if constexpr (ASYNC)
        cp_async16(smem_addr(to), from);
      else
        *reinterpret_cast<float4*>(to) =
            __ldg(reinterpret_cast<const float4*>(from));
    }
  } else {
    const int wdt = pieces * 4;
    for (int e = threadIdx.x; e < n_rows * wdt; e += kThreads) {
      const int r = e / wdt;
      const int i = e - r * wdt;
      reinterpret_cast<float*>(dst + r * rs)[i] =
          i < kn ? src[static_cast<size_t>(r) * ld + i] : 0.f;
    }
  }
}

// Slot s's bit words and its kT piece (k's rows col * bn .. + bn, dk
// floats each, [bn][dk]; rows at or past n left unwritten: no bit is set
// there) into shared memory by cp.async, the threads from `t0` on, `nt`
// of them; 16 bytes a copy where p.vec_bits / p.vec_k allow.
__device__ __forceinline__ void stage_slot(const Params& p, size_t slot,
                                           int col, unsigned* bits,
                                           float* kp, int t0, int nt) {
  const int me = static_cast<int>(threadIdx.x) - t0;
  if (me < 0 || me >= nt) return;
  const int words = p.bm * static_cast<int>(p.L.ow);
  const unsigned* from = p.occ + slot * words;
  if (p.vec_bits)
    for (int e = 4 * me; e < words; e += 4 * nt)
      cp_async16(smem_addr(bits + e), from + e);
  else
    for (int e = me; e < words; e += nt)
      cp_async4(smem_addr(bits + e), from + e);
  const long long col0 = static_cast<long long>(col) * p.bn;
  const long long left = p.n - col0;
  const int rows = left <= 0 ? 0 : left < p.bn ? static_cast<int>(left)
                                               : p.bn;
  int e0 = 0;  // floats staged 16 bytes a copy
  if (p.vec_k) {  // kT is k.T of a contiguous k: its rows lie side by side
    const float* k0 = p.kt + col0 * p.dk;
    e0 = rows * p.dk / 4 * 4;
    for (int e = 4 * me; e < e0; e += 4 * nt)
      cp_async16(smem_addr(kp + e), k0 + e);
  }
  {
    for (int e = e0 + me; e < rows * p.dk; e += nt) {
      const int j = e / p.dk;
      const int kk = e - j * p.dk;
      cp_async4(smem_addr(kp + e), p.kt + static_cast<long long>(kk) * p.ks0 +
                                       (col0 + j) * p.ks1);
    }
  }
}

// Sweep 1: each row's max m and max(l, eps), into mrow and den, in one
// read of the block-row's bits and kT pieces (`parts` slots a step, by
// cp.async, one step ahead where there are two stages).  A unit is (part,
// row, word): it owns the running (m, l) of word `wd` of row r over slots
// part, part + parts, ... in ascending slot (l rescaled by exp(m - m')
// when the max grows); the units of a row are merged in (part, word)
// order: m = max m_u, l = sum l_u exp(m_u - m).
__device__ __forceinline__ void row_stats(const Params& p, size_t slot0,
                                          const int* __restrict__ cols,
                                          const float* __restrict__ qs,
                                          unsigned char* smem, float* mrow,
                                          float* den) {
  const Layout& L = p.L;
  const int ow = static_cast<int>(L.ow);
  const int urw = p.bm * ow;
  const int parts = static_cast<int>(L.parts);
  float* um = reinterpret_cast<float*>(smem + L.um);
  float* ul = reinterpret_cast<float*>(smem + L.ul);
  const auto part_at = [&](int stg, int pp) {
    return smem + L.s1 + (stg * parts + pp) * L.s1_part;
  };
  for (int u = threadIdx.x; u < static_cast<int>(L.units); u += kThreads) {
    um[u] = kNegInf;
    ul[u] = 0.f;
  }
  const int steps = (p.w + parts - 1) / parts;
  // step st's slots into stage st % stages, part pp by threads pp * nt ..
  const int nt = kThreads / parts;
  const auto issue = [&](int st) {
    if (st < steps) {
      for (int pp = 0; pp < parts; ++pp) {
        const int s = st * parts + pp;
        if (s < p.w) {
          unsigned char* at = part_at(st % p.stages, pp);
          stage_slot(p, slot0 + s, cols[s], reinterpret_cast<unsigned*>(at),
                     reinterpret_cast<float*>(at + up16(urw * 4)), pp * nt,
                     nt);
        }
      }
    }
    cp_async_commit();
  };
  if (p.stages == 2) issue(0);
  for (int st = 0; st < steps; ++st) {
    if (p.stages == 2) {
      cp_async_wait_all();
      __syncthreads();  // stage st landed; step st - 1 is done with the other
      issue(st + 1);
    } else {
      __syncthreads();  // step st - 1 is done with the stage
      issue(st);
      cp_async_wait_all();
      __syncthreads();  // stage st landed
    }
    for (int u = threadIdx.x; u < static_cast<int>(L.units); u += kThreads) {
      const int pp = u / urw;
      const int rw = u - pp * urw;
      if (st * parts + pp >= p.w) continue;
      const int r = rw / ow;
      const int wd = rw - r * ow;
      const unsigned char* at = part_at(st % p.stages, pp);
      const unsigned bits =
          reinterpret_cast<const unsigned*>(at)[rw] & word_mask(p.bn, wd);
      if (!bits) continue;
      const float* kp = reinterpret_cast<const float*>(at + up16(urw * 4));
      const float* qr = qs + r * p.dk;
      float m = um[u], l = ul[u];
      for (unsigned x = bits; x; x &= x - 1) {
        const float sc = apply_act(
            score_dot(qr, kp, p.dk, 32 * wd + __ffs(x) - 1), p.act,
            p.slope);
        if (sc > m) {
          l = l * expf(m - sc) + 1.f;
          m = sc;
        } else {
          l += expf(sc - m);
        }
      }
      um[u] = m;
      ul[u] = l;
    }
  }
  cp_async_wait_all();
  __syncthreads();
  for (int r = threadIdx.x; r < p.bm; r += kThreads) {
    float m = kNegInf;
    for (int pp = 0; pp < parts; ++pp)
      for (int wd = 0; wd < ow; ++wd) m = fmaxf(m, um[pp * urw + r * ow + wd]);
    float l = 0.f;
    for (int pp = 0; pp < parts; ++pp)
      for (int wd = 0; wd < ow; ++wd) {
        const int u = pp * urw + r * ow + wd;
        l += ul[u] * expf(um[u] - m);
      }
    mrow[r] = m;
    den[r] = fmaxf(l, kEps);
  }
  __syncthreads();
}

// Grid: one CTA per block-row.
__global__ void __launch_bounds__(kThreads, 2)
    fused_attn_blockell_bwd_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout& L = p.L;
  int* cols = reinterpret_cast<int*>(smem + L.idx);
  unsigned char* gs = smem + L.g;
  unsigned* cur = reinterpret_cast<unsigned*>(smem + L.cur);
  float* kcur = reinterpret_cast<float*>(smem + L.kcur);
  float* ys = reinterpret_cast<float*>(smem + L.y);
  float* as = reinterpret_cast<float*>(smem + L.a);
  unsigned short* list = reinterpret_cast<unsigned short*>(smem + L.list);
  int* lens = reinterpret_cast<int*>(smem + L.len);
  float* qs = reinterpret_cast<float*>(smem + L.q);
  float* dqs = reinterpret_cast<float*>(smem + L.dq);
  float* mrow = reinterpret_cast<float*>(smem + L.stat);
  float* den = mrow + p.bm;
  float* rd = den + p.bm;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int ow = static_cast<int>(L.ow);
  const int words = p.bm * ow;
  const int cells = p.bm * p.bn;
  const int kp_floats = static_cast<int>(up16(p.dk * p.bn * 4)) / 4;
  const size_t slot0 = static_cast<size_t>(blockIdx.x) * p.w;
  const int row0 = blockIdx.x * p.bm;
  const int g_rows = max(0, min(p.bm, p.m - row0));

  for (int s = tid; s < p.w; s += kThreads) cols[s] = p.idx[slot0 + s];
  for (int e = tid; e < p.bm * p.dk; e += kThreads) {
    const int r = e / p.dk;
    qs[e] = r < g_rows ? p.q[static_cast<size_t>(row0) * p.dk + e] : 0.f;
    dqs[e] = 0.f;
  }
  for (int r = tid; r < p.bm; r += kThreads)
    rd[r] = r < g_rows ? p.rowdot[row0 + r] : 0.f;
  __syncthreads();
  row_stats(p, slot0, cols, qs, smem, mrow, den);

  const int n_chunks = max(1, (p.d + p.kc - 1) / p.kc);
  const long long steps = static_cast<long long>(p.w) * n_chunks;
  const float* g_blk = p.g + static_cast<size_t>(row0) * p.d;
  if (n_chunks == 1)  // ḡ's block stays for every slot
    load_rows<false>(gs, g_blk, g_rows, p.d, p.d, L.rs, p.vec_in);

  // step st's V chunk, and its slot's bit words and kT piece at the first
  // chunk, into stage st % stages; one cp.async group a step, empty past
  // the end
  const auto issue = [&](long long st) {
    if (st < steps) {
      const int s = static_cast<int>(st / n_chunks);
      const int c = static_cast<int>(st % n_chunks);
      const int stg = static_cast<int>(st % p.stages);
      const int k0 = c * p.kc;
      const int kn = max(0, min(p.kc, p.d - k0));
      const long long col0 = static_cast<long long>(cols[s]) * p.bn;
      const long long left = p.n - col0;
      const int v_rows = left <= 0 ? 0 : left < p.bn ? static_cast<int>(left)
                                                     : p.bn;
      load_rows<true>(smem + L.v + stg * p.bn * L.rs,
                      p.v + col0 * p.d + k0, v_rows, kn, p.d, L.rs,
                      p.vec_in);
      if (c == 0)
        stage_slot(p, slot0 + s, cols[s],
                   reinterpret_cast<unsigned*>(smem + L.bits) + stg * words,
                   reinterpret_cast<float*>(smem + L.ks) + stg * kp_floats,
                   0, kThreads);
    }
    cp_async_commit();
  };

  if (p.stages == 2) issue(0);
  for (long long st = 0; st < steps; ++st) {
    if (p.stages == 2) {
      cp_async_wait_all();
      __syncthreads();  // stage st landed; step st - 1 is done with it all
      issue(st + 1);
    } else {
      __syncthreads();  // step st - 1 is done with the stage, tile, lists
      issue(st);
      cp_async_wait_all();
      __syncthreads();  // stage st landed
    }
    const int s = static_cast<int>(st / n_chunks);
    const int c = static_cast<int>(st % n_chunks);
    const int stg = static_cast<int>(st % p.stages);
    const int k0 = c * p.kc;
    const int kn = max(0, min(p.kc, p.d - k0));
    if (c == 0) {
      const unsigned* o =
          reinterpret_cast<const unsigned*>(smem + L.bits) + stg * words;
      for (int e = tid; e < words; e += kThreads)
        cur[e] = o[e] & word_mask(p.bn, e % ow);
      const float* kp =
          reinterpret_cast<const float*>(smem + L.ks) + stg * kp_floats;
      for (int e = tid; e < p.dk * p.bn; e += kThreads) kcur[e] = kp[e];
      if (warp < kResidues) {
        // warp q lists the nonzeros of columns q, q + 8, ...: lane l
        // those of rows l * rpl .. + rpl - 1, placed by one warp scan
        const unsigned qbits = 0x01010101u << warp;
        unsigned short* lq = list + warp * L.cap;
        const int rpl = (p.bm + 31) / 32;
        const int r0 = min(p.bm, lane * rpl), r1 = min(p.bm, r0 + rpl);
        int n = 0;
        for (int r = r0; r < r1; ++r)
          for (int i = 0; i < ow; ++i)
            n += __popc(o[r * ow + i] & word_mask(p.bn, i) & qbits);
        int incl = n;
#pragma unroll
        for (int dd = 1; dd < 32; dd <<= 1) {
          const int up = __shfl_up_sync(0xffffffffu, incl, dd);
          if (lane >= dd) incl += up;
        }
        int at = incl - n;
        for (int r = r0; r < r1; ++r)
          for (int i = 0; i < ow; ++i)
            for (unsigned x = o[r * ow + i] & word_mask(p.bn, i) & qbits; x;
                 x &= x - 1)
              lq[at++] = static_cast<unsigned short>(
                  (r << 8) | (i * 32 + __ffs(x) - 1));
        if (lane == 31) lens[warp] = incl;
      }
    }
    if (n_chunks > 1)
      load_rows<false>(gs, g_blk + k0, g_rows, kn, p.d, L.rs, p.vec_in);
    __syncthreads();  // the lists, the bits and ḡ's chunk are in place

    // the dots: a warp takes 4 consecutive entries of every list, lane l
    // entry 4 b + l / 8 of list l % 8; each lane sums a whole dot (over
    // this chunk, from its running value) with fmaf in ascending D, and at
    // the last chunk takes the entry's α and de into the two tiles
    const bool last = c == n_chunks - 1;
    {
      const int q = lane % kResidues;
      const int len = lens[q];
      int longest = 0;
#pragma unroll
      for (int i = 0; i < kResidues; ++i) longest = max(longest, lens[i]);
      const unsigned char* vs = smem + L.v + stg * p.bn * L.rs;
      const int nv = (kn + 3) / 4;
      for (int b0 = warp * 4; b0 < longest; b0 += kThreads / kResidues) {
        const int pos = b0 + lane / kResidues;
        if (pos >= len) continue;
        const int code = list[q * L.cap + pos];
        const int r = code >> 8;
        const int j = code & 0xff;
        const int at = r * L.ysr + j;
        const float4* gp = reinterpret_cast<const float4*>(gs + r * L.rs);
        const float4* vp = reinterpret_cast<const float4*>(vs + j * L.rs);
        float acc = c == 0 ? 0.f : ys[at];
#pragma unroll 4
        for (int vv = 0; vv < nv; ++vv) {
          const float4 a = gp[vv], b = vp[vv];
          acc = fmaf(a.x, b.x, acc);
          acc = fmaf(a.y, b.y, acc);
          acc = fmaf(a.z, b.z, acc);
          acc = fmaf(a.w, b.w, acc);
        }
        if (last) {  // acc is dα
          const float z = score_dot(qs + r * p.dk, kcur, p.dk, j);
          const float a =
              expf(apply_act(z, p.act, p.slope) - mrow[r]) / den[r];
          float t = acc - rd[r];
          t = t * a;
          acc = t * act_grad(z, p.act, p.slope);
          as[at] = a;
        }
        ys[at] = acc;
      }
    }
    if (!last) continue;
    __syncthreads();  // α and de of every live cell are in the tiles

    // every cell of both tiles out, 0 where no bit is set, in streaming
    // stores; then dq: (row r, kk) owned by one thread, its set bits in
    // ascending column
    float* a_out = p.alpha + (slot0 + s) * cells;
    float* d_out = p.de + (slot0 + s) * cells;
    if (p.vec_out) {  // bn % 4 == 0: four cells of one row
      for (int vq = tid; vq < cells / 4; vq += kThreads) {
        const int e0 = 4 * vq;
        const int r = e0 / p.bn;
        const int j0 = e0 - r * p.bn;
        const unsigned bits = (cur[r * ow + (j0 >> 5)] >> (j0 & 31)) & 0xfu;
        float4 av = make_float4(0.f, 0.f, 0.f, 0.f), dv = av;
        if (bits) {
          const float4 at = *reinterpret_cast<const float4*>(
              as + r * L.ysr + j0);
          const float4 dt = *reinterpret_cast<const float4*>(
              ys + r * L.ysr + j0);
          av = make_float4(bits & 1u ? at.x : 0.f, bits & 2u ? at.y : 0.f,
                           bits & 4u ? at.z : 0.f, bits & 8u ? at.w : 0.f);
          dv = make_float4(bits & 1u ? dt.x : 0.f, bits & 2u ? dt.y : 0.f,
                           bits & 4u ? dt.z : 0.f, bits & 8u ? dt.w : 0.f);
        }
        __stcs(reinterpret_cast<float4*>(a_out + e0), av);
        __stcs(reinterpret_cast<float4*>(d_out + e0), dv);
      }
    } else {
      for (int e = tid; e < cells; e += kThreads) {
        const int r = e / p.bn;
        const int jl = e - r * p.bn;
        const bool on = cur[r * ow + (jl >> 5)] >> (jl & 31) & 1u;
        a_out[e] = on ? as[r * L.ysr + jl] : 0.f;
        d_out[e] = on ? ys[r * L.ysr + jl] : 0.f;
      }
    }
    for (int e = tid; e < p.bm * p.dk; e += kThreads) {
      const int kk = e / p.bm;
      const int r = e - kk * p.bm;
      float acc = dqs[r * p.dk + kk];
      for (int wd = 0; wd < ow; ++wd)
        for (unsigned x = cur[r * ow + wd]; x; x &= x - 1) {
          const int jl = 32 * wd + __ffs(x) - 1;
          acc = fmaf(ys[r * L.ysr + jl], kcur[jl * p.dk + kk], acc);
        }
      dqs[r * p.dk + kk] = acc;
    }
  }
  cp_async_wait_all();
  __syncthreads();
  for (int e = tid; e < g_rows * p.dk; e += kThreads)
    p.dq[static_cast<size_t>(row0) * p.dk + e] = dqs[e];
}

bool aligned16(const void* x) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

}  // namespace

// idx int32[nbr, w] (block columns, each below ceil(n / bn)); occ
// int32[nbr * w, bm, ceil(bn / 32)] (bit i of word t of slot s's row r set
// where cell (r, 32 t + i) is live: SparseMatrix.tile_occupancy); q
// f32[m, dk], kt f32 kT [dk, n] at strides (ks0, ks1); v f32[n, d] and g
// f32[m, d], contiguous; rowdot f32[m]; alpha, de f32[nbr, w, bm, bn],
// written whole; dq f32[m, dk].  m <= nbr * bm; bm, bn <= 128; dk >= 1.
// Rows of A at or past m and columns at or past n must have no set bit.
// Returns the cudaError_t of the launch.
extern "C" int fused_attn_blockell_bwd(
    const int* idx, const void* occ, const float* q, const float* kt,
    int ks0, int ks1, const float* v, const float* g, const float* rowdot,
    float* alpha, float* de, float* dq, int nbr, int w, int bm, int bn,
    int dk, int m, int n, int d, int act, float slope, void* stream) {
  if (nbr == 0) return cudaSuccess;
  if (bm < 1 || bn < 1 || bm > kMaxBlock || bn > kMaxBlock || dk < 1 ||
      d < 0 || w < 0)
    return cudaErrorInvalidValue;
  Params p{};
  p.idx = idx;
  p.occ = static_cast<const unsigned*>(occ);
  p.q = q;
  p.kt = kt;
  p.v = v;
  p.g = g;
  p.rowdot = rowdot;
  p.alpha = alpha;
  p.de = de;
  p.dq = dq;
  p.ks0 = ks0;
  p.ks1 = ks1;
  p.w = w;
  p.bm = bm;
  p.bn = bn;
  p.dk = dk;
  p.m = m;
  p.n = n;
  p.d = d;
  p.act = act;
  p.slope = slope;
  const auto bytes = [&](int kc, int stages) {
    return layout(bm, bn, dk, kc, stages, w).bytes;
  };
  // the D chunk: whole rows up to kChunk floats, halved (in 16-byte
  // vectors) until the block's shared memory fits
  int kc = std::max(4, std::min((d + 3) / 4 * 4, kChunk));
  while (bytes(kc, 1) > kMaxSmem && kc > 4)
    kc = std::max(4, (kc / 2 + 3) / 4 * 4);
  if (bytes(kc, 1) > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_attn_blockell_bwd_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  // two stages unless one lets more blocks share an SM
  int per_sm[3] = {0, 0, 0};
  for (int st = 1; st <= 2 && err == cudaSuccess; ++st)
    if (bytes(kc, st) <= kMaxSmem)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm[st], fused_attn_blockell_bwd_kernel, kThreads,
          bytes(kc, st));
  p.stages = per_sm[2] >= per_sm[1] && per_sm[2] > 0 ? 2 : 1;
  if (err != cudaSuccess) return err;
  p.kc = kc;
  p.L = layout(bm, bn, dk, kc, p.stages, w);
  p.vec_in = d % 4 == 0 && aligned16(v) && aligned16(g);
  p.vec_out = bn % 4 == 0 && aligned16(alpha) && aligned16(de);
  p.vec_bits = bm * ((bn + 31) / 32) % 4 == 0 && aligned16(occ);
  p.vec_k = ks0 == 1 && ks1 == dk && bn * dk % 4 == 0 && aligned16(kt);
  fused_attn_blockell_bwd_kernel<<<nbr, kThreads, p.L.bytes,
                                   static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}
