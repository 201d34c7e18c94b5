// SDDMM for sm_90a: Block-COO tiles (K3) and SELL-C-sigma slots (K4).
//
// Replaces two Pallas TPU kernels of the JAX package:
//   K3 sddmm_blockcoo_kernel  (src/repro/kernels/sddmm/kernel.py:52)
//   K4 sddmm_sell_kernel      (src/repro/kernels/sddmm/sell.py:58)
//
// K3, for every listed tile t of a Block-COO operand (B [Mp, K]):
//
//   Y[t] = round(mask[t] * round(B[rows[t]-block, :] @ C[:, cols[t]-block]))
//
// with A's values as the mask (a weighted mask is allowed), or with no mask
// (a null pointer): then every cell of each tile is sampled, which is what
// the ones array the ELL path used to build per call gave, bit for bit
// (1.0f * acc == acc).  round is the output dtype's rounding; the dot is
// rounded before the mask multiplies it (a no-op in f32), so one weighted
// launch equals the unweighted launch followed by values * dots in f32,
// rounded once, in every dtype.  B and C share one element type TB, the
// mask and Y another, TO (f32, bf16 or f16 each; the wrapper widens a
// mixed pair, exactly); dots sum in f32 with fmaf from 0 in ascending K.
//
// What bounds it on an H100: bytes.  At GAT's K = 2 an output element
// costs 2 multiply-adds against 4 bytes written (8 with a mask read), far
// below the card's ~20 FLOP per byte, and B and C (K * 64 KB a side on the
// serving graph) stay in L2: the time is the tiles out and the mask in.
// The first design was one CTA per 64 x 64 tile that staged B and C
// through shared memory behind two barriers per 16-wide K chunk, stored
// 4-byte scalars and always read a mask.  Now two kernels:
//  - sddmm_stream_kernel (K <= 16, tile rows of whole 16-byte vectors,
//    16-byte aligned pointers): no shared memory and no barrier.  Each
//    thread owns 16-byte vectors of output (VEC elements of one tile row)
//    and reads its B row and VEC columns of C, K values each, straight into
//    registers through the read-only path (L1 / L2 hits); a warp stores 512
//    contiguous bytes at once, with streaming stores (st.global.cs: nothing
//    re-reads the tiles), and reads the mask with 16-byte streaming loads.
//    A grid-stride loop over tiles with the CTAs the SMs hold at once lets
//    one tile's stores drain while the next tile's loads issue.
//  - sddmm_staged_kernel (any other K or tile): that first loop, one CTA per
//    tile, a (bm x 16) slice of B and a (16 x bn) slice of C staged
//    through shared memory per K chunk, each thread R x R elements (rows
//    ty + 16 i, columns tx + 16 j, R up to 8 = bm, bn up to 128), now with
//    native element types, the optional mask and streaming stores.  The
//    last K chunk is ragged and masked, so any K >= 1 works (the Pallas
//    wrapper needed K % bk == 0 and fell back to bk = K).
// Both sum each dot in the same order, so they agree bit for bit.
//
// K3 at a pattern (sddmm_pattern_kernel, entry sddmm_pattern): the same
// unweighted tiles, but only at the cells an occupancy bit marks, exact 0
// elsewhere.  It replaces sddmm_staged_kernel on the training step's
// sampling (autodiff.sample_pattern_exec: dA = pattern(A) ⊙ (ḡ Hᵀ) and
// the attention backward's dα = ḡ Vᵀ at K = D), whose callers mask every
// cell off A's pattern straight after.  On the serving graph (65,536
// tiles of 64 x 64, 10 % filled) at K = 128 the staged kernel summed
// 268 M dots for 26.9 M nonzeros, FFMA over a predicated register grid.
// The occupancy is one bit per cell, 32-bit words per tile row, built
// once per matrix (SparseMatrix.tile_occupancy): a row's nonzeros come
// out of __popc / __ffs without a search, words load with 4-byte
// cp.async, and the array is 1/32 of the tiles' f32 bytes (32 MiB there).
// What bounds it on an H100: the 1 GiB of output tiles, written whole
// (0.32 ms at 3.35 TB/s); the nonzeros' 6.9 GFLOP are 0.10 ms of FP32.
// Behind the store, operand traffic: each dot reads a row of B and a
// column of C, K values each.  The design:
//  - B's block-row slice (bm x K, 32 KiB at 64 x 128 f32) stays in
//    shared memory for all the tiles of a block row (a block walks a
//    contiguous range of tiles, so it reloads B only where the block row
//    changes);
//  - C is read as its transpose (each column of C one contiguous row of
//    the caller's V, H or k, with no copy) and staged per tile by
//    cp.async: one tile ahead where two stages still let as many blocks
//    share an SM, else one stage (64 x 64 tiles at K = 128 f32: 92 KB a
//    block, two blocks an SM), so that one block's dots cover the other's
//    loads, barriers and stores (one block an SM with two stages was
//    1.3x slower on the serving graph: kernels/sddmm/parts.py);
//  - work is assigned by nonzero, and by what the nonzero reads: shared
//    memory serves a quarter warp's 16-byte reads at once only where they
//    fall in 8 distinct groups of 4 banks, and a random column pattern
//    puts several of 8 lanes' C rows in one group.  So each tile's set
//    bits are listed by column mod 8 (one warp a list, a warp scan over
//    the rows), and a quarter warp takes one entry of each list: its C
//    rows fall in 8 distinct bank groups, its B rows (a few rows apart)
//    mostly too.  Each lane sums whole dots, reading B and C as 16-byte
//    vectors along K;
//  - the dots land in an f32 tile in shared memory, which leaves in
//    16-byte streaming stores, zeros included.
// What is left: the residue lists scatter a quarter warp's B rows, and
// their bank conflicts are about a fifth of the time at K = 128
// (kernels/sddmm/parts.py: B read from one row instead).
// Each dot is summed in f32 with fmaf from 0 in ascending K, the same
// expression as the two kernels above, so at every set bit it equals
// their element bit for bit.  K above the chunk (512 bytes of a row, less
// for the widest tiles) is summed chunk by chunk into the same running
// value: the order does not change.  Where K is not a multiple of the
// 16-byte vector, the padded terms are fmaf(0, 0, acc), which leave acc
// unchanged.  Any K >= 1, bm, bn <= 128, f32 / bf16 / f16 in and out.
//
// K4 (sddmm_slots_kernel), the raw dots at the structural nonzeros of a
// SELL packing, in slot order:
//
//   y[row_slot[r] + j] = B[perm[r], :] . C[:, cols[row_slot[r] + j]]
//   for every compact row r and j < row_nnz[r]
//
// (the row view built once at packing: a row's nonzeros are the first
// slots of its packed row; perm gives its logical row of B).  Other slots,
// padding and those of pruned slices, are left to the caller, which
// zeroes y.  The Pallas kernel multiplied a dense 64 x 64 tile per live
// tile, ~4.6 nonzeros each on a skewed graph, behind a 0/1 tile mask and
// into a tile output that the caller gathered back to slots: a GB each way
// at 16384 nodes.  What bounds K4 on an H100: bytes, and only a few MB of
// them: the row arrays, each nonzero's column and dot, B and C (K = 2:
// 2 multiply-adds per nonzero).  One warp owns a row: it reads the row's
// B once (into registers when K is 2), its lanes stride over the row's
// nonzeros kSlotBatch at a time (that many column loads, then that many
// C-column gathers, in flight per lane: the gathers wait on L2), and each
// dot is summed over K in ascending order with fmaf from 0, as K3's tile
// loop does, so a dot equals the tile kernel's element bit for bit.  SELL
// orders its buckets by ascending width, so the heaviest rows are the last
// compact rows: the warps walk the rows from the last, and those start
// first.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  __device__ static float to_f(float x) { return x; }
  __device__ static float from_f(float x) { return x; }
};

template <>
struct Elem<__nv_bfloat16> {
  __device__ static float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 from_f(float x) {
    return __float2bfloat16_rn(x);
  }
};

template <>
struct Elem<__half> {
  __device__ static float to_f(__half x) { return __half2float(x); }
  __device__ static __half from_f(float x) { return __float2half_rn(x); }
};

// x rounded to T, back in f32
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return Elem<T>::to_f(Elem<T>::from_f(x));
}

// The output element: the dot rounded to TO, times the mask, rounded once.
template <typename TO, bool MASK>
__device__ __forceinline__ TO sample(float acc, TO m) {
  if constexpr (MASK)
    return Elem<TO>::from_f(Elem<TO>::to_f(m) * round_to<TO>(acc));
  else
    return Elem<TO>::from_f(acc);
}

// An unsigned type of B bytes, for vector loads and stores.
template <int B>
struct Bits;
template <>
struct Bits<16> {
  using type = uint4;
};
template <>
struct Bits<8> {
  using type = uint2;
};
template <>
struct Bits<4> {
  using type = unsigned int;
};
template <>
struct Bits<2> {
  using type = unsigned short;
};

// N elements of T at p (aligned to their size) through the read-only path.
template <typename T, int N>
__device__ __forceinline__ void ldg_vec(const T* p, T (&v)[N]) {
  using B = typename Bits<sizeof(T) * N>::type;
  const B raw = __ldg(reinterpret_cast<const B*>(p));
  memcpy(v, &raw, sizeof raw);
}

// Streaming load and store (.cs: evict first, nothing reads them again).
template <typename T, int N>
__device__ __forceinline__ void ldcs_vec(const T* p, T (&v)[N]) {
  using B = typename Bits<sizeof(T) * N>::type;
  const B raw = __ldcs(reinterpret_cast<const B*>(p));
  memcpy(v, &raw, sizeof raw);
}

template <typename T, int N>
__device__ __forceinline__ void stcs_vec(T* p, const T (&v)[N]) {
  using B = typename Bits<sizeof(T) * N>::type;
  B raw;
  memcpy(&raw, v, sizeof raw);
  __stcs(reinterpret_cast<B*>(p), raw);
}

constexpr int kStreamMaxK = 16;

// Output elements per 16-byte vector: the wider of TB and TO sets it, so
// that VEC columns of C are at most 16 bytes too.
template <typename TB, typename TO>
constexpr int kVec = 16 / (sizeof(TB) > sizeof(TO) ? sizeof(TB) : sizeof(TO));

template <typename TB, typename TO, bool MASK>
__global__ void __launch_bounds__(kThreads)
    sddmm_stream_kernel(const int* __restrict__ rows,
                        const int* __restrict__ cols,
                        const TO* __restrict__ mask,
                        const TB* __restrict__ b, const TB* __restrict__ c,
                        TO* __restrict__ y, int n_tiles, int bm, int bn, int k,
                        int n) {
  constexpr int VEC = kVec<TB, TO>;
  const int vpr = bn / VEC;  // vectors per tile row
  const int nvec = bm * vpr;
  // this thread's first vector (row r0, vector v0 of it) and the step of
  // kThreads vectors as (rows, vectors)
  const int r0 = static_cast<int>(threadIdx.x) / vpr;
  const int v0 = static_cast<int>(threadIdx.x) - r0 * vpr;
  const int dr = kThreads / vpr;
  const int dv = kThreads - dr * vpr;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const TB* btile = b + static_cast<size_t>(rows[t]) * bm * k;
    const TB* ctile = c + static_cast<size_t>(cols[t]) * bn;
    const size_t tile0 = static_cast<size_t>(t) * bm * bn;
    int r = r0, v = v0;
    for (int e = threadIdx.x; e < nvec; e += kThreads) {
      const int col = v * VEC;
      const TB* brow = btile + static_cast<size_t>(r) * k;
      float acc[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < k; ++kk) {
        TB bv[1], cv[VEC];
        ldg_vec(brow + kk, bv);
        ldg_vec(ctile + static_cast<size_t>(kk) * n + col, cv);
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          acc[i] = fmaf(Elem<TB>::to_f(bv[0]), Elem<TB>::to_f(cv[i]), acc[i]);
      }
      const size_t at = tile0 + static_cast<size_t>(r) * bn + col;
      TO m[VEC] = {}, out[VEC];
      if constexpr (MASK) ldcs_vec(mask + at, m);
#pragma unroll
      for (int i = 0; i < VEC; ++i) out[i] = sample<TO, MASK>(acc[i], m[i]);
      stcs_vec(y + at, out);
      r += dr;
      v += dv;
      if (v >= vpr) {
        v -= vpr;
        ++r;
      }
    }
  }
}

constexpr int kSide = 16;  // the staged kernel's thread grid is kSide^2
constexpr int kBK = 16;    // K chunk staged per step
constexpr int kMaxR = 8;   // elements a thread owns per side: 128 / kSide

template <typename TB, typename TO, bool MASK>
__global__ void __launch_bounds__(kThreads)
    sddmm_staged_kernel(const int* __restrict__ rows,
                        const int* __restrict__ cols,
                        const TO* __restrict__ mask,
                        const TB* __restrict__ b, const TB* __restrict__ c,
                        TO* __restrict__ y, int bm, int bn, int k, int n) {
  __shared__ float Bs[kMaxR * kSide][kBK + 1];
  __shared__ float Cs[kBK][kMaxR * kSide];
  const int t = blockIdx.x;
  const int tx = threadIdx.x % kSide;
  const int ty = threadIdx.x / kSide;
  const int ri = (bm + kSide - 1) / kSide;  // rows ty + 16 i, i < ri
  const int rj = (bn + kSide - 1) / kSide;  // columns tx + 16 j, j < rj
  const size_t brow0 = static_cast<size_t>(rows[t]) * bm;
  const size_t ccol0 = static_cast<size_t>(cols[t]) * bn;

  float acc[kMaxR][kMaxR];
#pragma unroll
  for (int i = 0; i < kMaxR; ++i)
#pragma unroll
    for (int j = 0; j < kMaxR; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kBK) {
    const int kc = min(kBK, k - k0);
    for (int e = threadIdx.x; e < bm * kc; e += kThreads) {
      const int r = e / kc;
      const int kk = e - r * kc;
      Bs[r][kk] = Elem<TB>::to_f(b[(brow0 + r) * k + k0 + kk]);
    }
    for (int e = threadIdx.x; e < kc * bn; e += kThreads) {
      const int kk = e / bn;
      const int col = e - kk * bn;
      Cs[kk][col] =
          Elem<TB>::to_f(c[static_cast<size_t>(k0 + kk) * n + ccol0 + col]);
    }
    __syncthreads();
    for (int kk = 0; kk < kc; ++kk) {
      float bv[kMaxR], cv[kMaxR];
#pragma unroll
      for (int i = 0; i < kMaxR; ++i) {
        const int r = ty + i * kSide;
        bv[i] = i < ri && r < bm ? Bs[r][kk] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kMaxR; ++j) {
        const int col = tx + j * kSide;
        cv[j] = j < rj && col < bn ? Cs[kk][col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kMaxR; ++i)
#pragma unroll
        for (int j = 0; j < kMaxR; ++j)
          if (i < ri && j < rj) acc[i][j] = fmaf(bv[i], cv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const size_t tile0 = static_cast<size_t>(t) * bm * bn;
#pragma unroll
  for (int i = 0; i < kMaxR; ++i) {
    const int r = ty + i * kSide;
    if (i >= ri || r >= bm) continue;
#pragma unroll
    for (int j = 0; j < kMaxR; ++j) {
      const int col = tx + j * kSide;
      if (j >= rj || col >= bn) continue;
      const size_t at = tile0 + static_cast<size_t>(r) * bn + col;
      TO m[1] = {}, out[1];
      if constexpr (MASK) ldcs_vec(mask + at, m);
      out[0] = sample<TO, MASK>(acc[i][j], m[0]);
      stcs_vec(y + at, out);
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename TB, typename TO, bool MASK>
cudaError_t launch_tiles(const int* rows, const int* cols, const void* mask,
                         const void* b, const void* c, void* y, int n_tiles,
                         int bm, int bn, int k, int n, cudaStream_t stream) {
  const auto* m = static_cast<const TO*>(mask);
  const auto* bp = static_cast<const TB*>(b);
  const auto* cp = static_cast<const TB*>(c);
  auto* yp = static_cast<TO*>(y);
  if (k <= kStreamMaxK && bn % kVec<TB, TO> == 0 && aligned16(c) &&
      aligned16(y) && (!MASK || aligned16(mask))) {
    auto kernel = sddmm_stream_kernel<TB, TO, MASK>;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, 0);
    if (err != cudaSuccess) return err;
    const int grid = std::min(n_tiles, sms * std::max(per_sm, 1));
    kernel<<<grid, kThreads, 0, stream>>>(rows, cols, m, bp, cp, yp, n_tiles,
                                          bm, bn, k, n);
  } else {
    sddmm_staged_kernel<TB, TO, MASK><<<n_tiles, kThreads, 0, stream>>>(
        rows, cols, m, bp, cp, yp, bm, bn, k, n);
  }
  return cudaGetLastError();
}

// The instance for B / C's element type TB (code 0 f32, 1 bf16, 2 f16),
// Y's and the mask's TO, and whether there is a mask.
template <typename TB>
cudaError_t dispatch_out(int out_dtype, bool has_mask, const int* rows,
                         const int* cols, const void* mask, const void* b,
                         const void* c, void* y, int n_tiles, int bm, int bn,
                         int k, int n, cudaStream_t s) {
  const auto run = [&](auto launch) {
    return launch(rows, cols, mask, b, c, y, n_tiles, bm, bn, k, n, s);
  };
  switch (out_dtype) {
    case 0:
      return has_mask ? run(launch_tiles<TB, float, true>)
                      : run(launch_tiles<TB, float, false>);
    case 1:
      return has_mask ? run(launch_tiles<TB, __nv_bfloat16, true>)
                      : run(launch_tiles<TB, __nv_bfloat16, false>);
    case 2:
      return has_mask ? run(launch_tiles<TB, __half, true>)
                      : run(launch_tiles<TB, __half, false>);
  }
  return cudaErrorInvalidValue;
}

// --- sddmm_pattern_kernel: K3 at the structural nonzeros of each tile ---

constexpr int kPatThreads = 256;
constexpr int kPatChunkBytes = 512;   // K chunk of a staged operand row
constexpr int kPatMaxSmem = 232448;   // what one block may use on sm_90

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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__host__ __device__ constexpr unsigned up16(unsigned x) {
  return (x + 15u) & ~15u;
}

// The dynamic shared memory of one block, in bytes: B's chunk (bm rows),
// `stages` C chunks (bn rows each), each operand row kc elements padded
// to an odd number of 16-byte vectors (so that rows r and r + 1 start 4
// banks apart, and any 8 rows of distinct r mod 8 read vector v from 8
// distinct groups of 4 banks); the f32 tile of dots; `stages` tiles of
// occupancy words; the tile's nonzeros (row << 8 | column, 16 bits each)
// in kResidues lists, one per column mod kResidues, cap entries each, and
// their lengths.
constexpr int kResidues = 8;  // 16-byte vectors a row of 32 banks holds

struct PatLayout {
  unsigned rs, ow, cap, b, c, y, occ, list, len, bytes;
};

__host__ __device__ inline PatLayout pat_layout(int bm, int bn, int kc,
                                                int esize, int stages) {
  PatLayout l;
  const unsigned vecs = static_cast<unsigned>(kc * esize) / 16;
  l.rs = 16 * (vecs + (vecs % 2 == 0 ? 1 : 2));
  l.ow = (bn + 31) / 32;
  l.cap = bm * ((bn + kResidues - 1) / kResidues);
  l.b = 0;
  l.c = l.b + bm * l.rs;
  l.y = l.c + stages * bn * l.rs;
  l.occ = l.y + up16(bm * bn * 4);
  l.list = l.occ + up16(stages * bm * l.ow * 4);
  l.len = l.list + up16(kResidues * l.cap * 2);
  l.bytes = l.len + up16(kResidues * 4);
  return l;
}

// Rows [0, n) of a chunk of kn elements (row stride k in global memory)
// into shared rows of rs bytes, padded with zeros to whole 16-byte
// vectors.  Where vec (k a multiple of the vector, 16-byte aligned
// base): 16-byte pieces, by cp.async where ASYNC, else by loads through
// the read-only path; otherwise element by element, synchronously.
template <typename TB, bool ASYNC>
__device__ __forceinline__ void load_chunk(unsigned char* dst,
                                           const TB* __restrict__ src, int n,
                                           int kn, int k, unsigned rs,
                                           bool vec) {
  constexpr int VEC = 16 / sizeof(TB);
  const int pieces = (kn + VEC - 1) / VEC;
  if (vec) {
    for (int e = threadIdx.x; e < n * pieces; e += kPatThreads) {
      const int r = e / pieces;
      const int p = e - r * pieces;
      const TB* from = src + static_cast<size_t>(r) * k + p * VEC;
      unsigned char* to = dst + r * rs + p * 16;
      if constexpr (ASYNC)
        cp_async16(smem_addr(to), from);
      else
        *reinterpret_cast<uint4*>(to) =
            __ldg(reinterpret_cast<const uint4*>(from));
    }
  } else {
    const int w = pieces * VEC;
    for (int e = threadIdx.x; e < n * w; e += kPatThreads) {
      const int r = e / w;
      const int i = e - r * w;
      reinterpret_cast<TB*>(dst + r * rs)[i] =
          i < kn ? src[static_cast<size_t>(r) * k + i] : TB{};
    }
  }
}

// A block walks a contiguous range of tiles, each in K chunks of kc
// elements (one chunk where K fits): a step is one (tile, chunk).  Step s
// finds C's chunk (and, at a tile's first chunk, its occupancy words) in
// stage s % stages, loaded by cp.async one step ahead where there are two
// stages, or at the step's start where one stage lets more blocks share an
// SM (the other blocks' work then covers the wait); B's chunk is
// loaded when the block row changes (or every step where K takes several
// chunks).  At a tile's first chunk warp q lists the tile's nonzeros of
// the columns j = q mod kResidues, row by row (a warp scan gives each row
// its place).  Then a warp takes 4 consecutive entries of every list,
// lane l entry 4 b + l / 8 of list l % 8, so that the 8 lanes of each
// quarter warp read C rows of 8 distinct residues (no bank conflict) and
// B rows a few rows apart; each lane sums its dot over the chunk, from
// the dot's running value in the f32 tile, with fmaf in ascending K.
// After the last chunk the tile leaves as 16-byte streaming stores (zeros
// where no bit is set) and the f32 tile is zeroed for the next.
template <typename TB, typename TO>
__global__ void __launch_bounds__(kPatThreads)
    sddmm_pattern_kernel(const int* __restrict__ rows,
                         const int* __restrict__ cols,
                         const unsigned* __restrict__ occ,
                         const TB* __restrict__ b, const TB* __restrict__ ct,
                         TO* __restrict__ y, int n_tiles, int bm, int bn,
                         int k, int kc, int stages, bool vec_in,
                         bool vec_out) {
  constexpr int VEC = 16 / sizeof(TB);
  extern __shared__ __align__(16) unsigned char smem[];
  const PatLayout L = pat_layout(bm, bn, kc, sizeof(TB), stages);
  unsigned char* bs = smem + L.b;
  float* ys = reinterpret_cast<float*>(smem + L.y);
  unsigned* os = reinterpret_cast<unsigned*>(smem + L.occ);
  unsigned short* list = reinterpret_cast<unsigned short*>(smem + L.list);
  int* lens = reinterpret_cast<int*>(smem + L.len);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int cells = bm * bn;
  const int words = bm * static_cast<int>(L.ow);
  for (int e = tid; e < cells; e += kPatThreads) ys[e] = 0.f;

  const long long t0 =
      static_cast<long long>(blockIdx.x) * n_tiles / gridDim.x;
  const long long t1 =
      static_cast<long long>(blockIdx.x + 1) * n_tiles / gridDim.x;
  const int n_chunks = (k + kc - 1) / kc;
  const long long steps = (t1 - t0) * n_chunks;

  // step s's C chunk, and its tile's occupancy at the first chunk, into
  // stage s % stages; one cp.async group a step, empty past the end
  const auto issue = [&](long long s) {
    if (s < steps) {
      const long long t = t0 + s / n_chunks;
      const int c = static_cast<int>(s % n_chunks);
      const int st = static_cast<int>(s % stages);
      const int k0 = c * kc;
      load_chunk<TB, true>(
          smem + L.c + st * bn * L.rs,
          ct + static_cast<size_t>(cols[t]) * bn * k + k0, bn,
          min(kc, k - k0), k, L.rs, vec_in);
      if (c == 0) {
        const unsigned* from = occ + static_cast<size_t>(t) * words;
        unsigned* to = os + st * words;
        for (int e = tid; e < words; e += kPatThreads)
          cp_async4(smem_addr(to + e), from + e);
      }
    }
    cp_async_commit();
  };

  if (stages == 2) issue(0);
  int b_row = -1;  // the block row of B in shared memory
  for (long long s = 0; s < steps; ++s) {
    if (stages == 2) {
      cp_async_wait<0>();
      __syncthreads();  // stage s landed; step s - 1 is done with B, lists
      issue(s + 1);
    } else {
      __syncthreads();  // step s - 1 is done with the stage, B and lists
      issue(s);
      cp_async_wait<0>();
      __syncthreads();  // stage s landed
    }
    const long long t = t0 + s / n_chunks;
    const int c = static_cast<int>(s % n_chunks);
    const int st = static_cast<int>(s % stages);
    const int k0 = c * kc;
    const int kn = min(kc, k - k0);
    if (c == 0 && warp < kResidues) {
      // warp q lists the nonzeros of columns q, q + 8, ... row by row
      const unsigned* o = os + st * words;
      const unsigned qbits = 0x01010101u << warp;
      unsigned short* lq = list + warp * L.cap;
      int base = 0;
      for (int r0 = 0; r0 < bm; r0 += 32) {
        const int r = r0 + lane;
        unsigned w[4];
        int n = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // bits at or past bn are ignored
          const int left = r < bm ? bn - 32 * i : 0;
          w[i] = left <= 0   ? 0u
                 : left < 32 ? o[r * L.ow + i] & ((1u << left) - 1u)
                             : o[r * L.ow + i];
          w[i] &= qbits;
          n += __popc(w[i]);
        }
        int incl = n;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int up = __shfl_up_sync(0xffffffffu, incl, d);
          if (lane >= d) incl += up;
        }
        int at = base + incl - n;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          for (unsigned x = w[i]; x; x &= x - 1)
            lq[at++] = static_cast<unsigned short>(
                (r << 8) | (i * 32 + __ffs(x) - 1));
        }
        base += __shfl_sync(0xffffffffu, incl, 31);
      }
      if (lane == 0) lens[warp] = base;
    }
    const int row = rows[t];
    if (n_chunks > 1 || row != b_row) {
      load_chunk<TB, false>(bs, b + static_cast<size_t>(row) * bm * k + k0,
                            bm, kn, k, L.rs, vec_in);
      b_row = row;
    }
    __syncthreads();  // the lists and B's chunk are in place
    const int q = lane % kResidues;
    const int len = lens[q];
    int longest = 0;
#pragma unroll
    for (int i = 0; i < kResidues; ++i) longest = max(longest, lens[i]);
    const unsigned char* cs = smem + L.c + st * bn * L.rs;
    const int nv = (kn + VEC - 1) / VEC;
    constexpr int kPerList = 32 / kResidues;  // entries a warp takes
    for (int b0 = warp * kPerList; b0 < longest;
         b0 += kPatThreads / kResidues) {
      const int pos = b0 + lane / kResidues;
      if (pos >= len) continue;
      const int code = list[q * L.cap + pos];
      const int r = code >> 8;
      const int j = code & 0xff;
      const uint4* bp = reinterpret_cast<const uint4*>(bs + r * L.rs);
      const uint4* cp = reinterpret_cast<const uint4*>(cs + j * L.rs);
      float acc = ys[r * bn + j];
#pragma unroll 4
      for (int v = 0; v < nv; ++v) {
        const uint4 braw = bp[v], craw = cp[v];
        TB bv[VEC], cv[VEC];
        memcpy(bv, &braw, sizeof braw);
        memcpy(cv, &craw, sizeof craw);
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          acc = fmaf(Elem<TB>::to_f(bv[i]), Elem<TB>::to_f(cv[i]), acc);
      }
      ys[r * bn + j] = acc;
    }
    if (c == n_chunks - 1) {
      __syncthreads();  // every dot of the tile is in ys
      TO* yt = y + static_cast<size_t>(t) * cells;
      if (vec_out) {
        constexpr int VO = 16 / sizeof(TO);
        for (int v = tid; v < cells / VO; v += kPatThreads) {
          float4* src = reinterpret_cast<float4*>(ys + v * VO);
          TO out[VO];
#pragma unroll
          for (int q = 0; q < VO / 4; ++q) {
            const float4 f = src[q];
            out[4 * q] = Elem<TO>::from_f(f.x);
            out[4 * q + 1] = Elem<TO>::from_f(f.y);
            out[4 * q + 2] = Elem<TO>::from_f(f.z);
            out[4 * q + 3] = Elem<TO>::from_f(f.w);
            src[q] = make_float4(0.f, 0.f, 0.f, 0.f);
          }
          stcs_vec(yt + v * VO, out);
        }
      } else {
        for (int e = tid; e < cells; e += kPatThreads) {
          yt[e] = Elem<TO>::from_f(ys[e]);
          ys[e] = 0.f;
        }
      }
    }
  }
  cp_async_wait<0>();
}

template <typename TB, typename TO>
cudaError_t launch_pattern(const int* rows, const int* cols,
                           const unsigned* occ, const void* b,
                           const void* ct, void* y, int n_tiles, int bm,
                           int bn, int k, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(TB);
  // the K chunk: whole operand rows up to kPatChunkBytes, halved (in
  // 16-byte vectors) until the block's shared memory fits
  int kcb = std::min((k + VEC - 1) / VEC * 16, kPatChunkBytes);
  const auto bytes = [&](int cb, int stages) {
    return pat_layout(bm, bn, cb / static_cast<int>(sizeof(TB)),
                      sizeof(TB), stages).bytes;
  };
  while (bytes(kcb, 1) > kPatMaxSmem && kcb > 16)
    kcb = std::max(16, (kcb / 2 + 15) / 16 * 16);
  if (bytes(kcb, 1) > kPatMaxSmem) return cudaErrorInvalidValue;
  auto kernel = sddmm_pattern_kernel<TB, TO>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kPatMaxSmem);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // two stages unless one lets more blocks share an SM
  int per_sm[3] = {0, 0, 0};
  for (int st = 1; st <= 2 && err == cudaSuccess; ++st)
    if (bytes(kcb, st) <= kPatMaxSmem)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm[st], kernel, kPatThreads, bytes(kcb, st));
  if (err != cudaSuccess) return err;
  const int stages = per_sm[2] >= per_sm[1] ? 2 : 1;
  const unsigned smem = bytes(kcb, stages);
  const int grid = std::min(n_tiles, sms * std::max(per_sm[stages], 1));
  const bool vec_in = k % VEC == 0 && aligned16(b) && aligned16(ct);
  const bool vec_out = bm * bn % (16 / sizeof(TO)) == 0 && aligned16(y);
  kernel<<<grid, kPatThreads, smem, stream>>>(
      rows, cols, occ, static_cast<const TB*>(b), static_cast<const TB*>(ct),
      static_cast<TO*>(y), n_tiles, bm, bn, k,
      kcb / static_cast<int>(sizeof(TB)), stages, vec_in, vec_out);
  return cudaGetLastError();
}

template <typename TB>
cudaError_t pattern_out(int out_dtype, const int* rows, const int* cols,
                        const unsigned* occ, const void* b, const void* ct,
                        void* y, int n_tiles, int bm, int bn, int k,
                        cudaStream_t s) {
  switch (out_dtype) {
    case 0:
      return launch_pattern<TB, float>(rows, cols, occ, b, ct, y, n_tiles,
                                       bm, bn, k, s);
    case 1:
      return launch_pattern<TB, __nv_bfloat16>(rows, cols, occ, b, ct, y,
                                               n_tiles, bm, bn, k, s);
    case 2:
      return launch_pattern<TB, __half>(rows, cols, occ, b, ct, y, n_tiles,
                                        bm, bn, k, s);
  }
  return cudaErrorInvalidValue;
}

constexpr int kSlotBatch = 4;  // nonzeros in flight per lane

// KS: K fixed at compile time (B's row then lives in registers), or 0.
template <int KS>
__global__ void __launch_bounds__(kThreads)
    sddmm_slots_kernel(const int* __restrict__ row_slot,
                       const int* __restrict__ row_nnz,
                       const int* __restrict__ perm,
                       const int* __restrict__ cols,
                       const float* __restrict__ b,
                       const float* __restrict__ c, float* __restrict__ y,
                       int n_rows, int k, int n) {
  const int warp = static_cast<int>(
      (static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x) / 32);
  if (warp >= n_rows) return;
  const int lane = threadIdx.x % 32;
  const int r = n_rows - 1 - warp;  // the heaviest rows first
  const int nnz = row_nnz[r];
  if (nnz == 0) return;
  const int s0 = row_slot[r];
  const float* brow = b + static_cast<size_t>(perm[r]) * k;
  const int kk_n = KS > 0 ? KS : k;
  float breg[KS > 0 ? KS : 1];
  if constexpr (KS > 0) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) breg[kk] = __ldg(brow + kk);
  }
  for (int j0 = lane; j0 < nnz; j0 += 32 * kSlotBatch) {
    int col[kSlotBatch];
    float acc[kSlotBatch];
#pragma unroll
    for (int t = 0; t < kSlotBatch; ++t) {
      const int j = j0 + 32 * t;
      col[t] = j < nnz ? __ldg(cols + s0 + j) : -1;
      acc[t] = 0.f;
    }
#pragma unroll(KS > 0 ? KS : 1)
    for (int kk = 0; kk < kk_n; ++kk) {
      float bv;
      if constexpr (KS > 0)
        bv = breg[kk];
      else
        bv = __ldg(brow + kk);
      const float* crow = c + static_cast<size_t>(kk) * n;
#pragma unroll
      for (int t = 0; t < kSlotBatch; ++t)
        if (col[t] >= 0) acc[t] = fmaf(bv, __ldg(crow + col[t]), acc[t]);
    }
#pragma unroll
    for (int t = 0; t < kSlotBatch; ++t)
      if (col[t] >= 0) y[s0 + j0 + 32 * t] = acc[t];
  }
}

}  // namespace

// rows, cols int32[n_tiles]; mask [n_tiles, bm, bn] in Y's dtype, or null
// (every cell sampled); b [*, k] with rows[t] * bm + bm <= its row count and
// c [k, n] with n a multiple of bn, both of dtype b_dtype; y [n_tiles, bm,
// bn] of dtype out_dtype (codes 0 f32, 1 bf16, 2 f16).  bm, bn <= 128.
// Returns the cudaError_t of the launch.
extern "C" int sddmm_tiles(const int* rows, const int* cols, const void* mask,
                           const void* b, const void* c, void* y, int n_tiles,
                           int bm, int bn, int k, int n, int b_dtype,
                           int out_dtype, void* stream) {
  if (n_tiles == 0) return cudaSuccess;
  if (bm < 1 || bn < 1 || bm > kMaxR * kSide || bn > kMaxR * kSide || k < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool has_mask = mask != nullptr;
  switch (b_dtype) {
    case 0:
      return dispatch_out<float>(out_dtype, has_mask, rows, cols, mask, b, c,
                                 y, n_tiles, bm, bn, k, n, s);
    case 1:
      return dispatch_out<__nv_bfloat16>(out_dtype, has_mask, rows, cols,
                                         mask, b, c, y, n_tiles, bm, bn, k,
                                         n, s);
    case 2:
      return dispatch_out<__half>(out_dtype, has_mask, rows, cols, mask, b,
                                  c, y, n_tiles, bm, bn, k, n, s);
  }
  return cudaErrorInvalidValue;
}

// rows, cols int32[n_tiles]; occ int32[n_tiles, bm, ceil(bn / 32)], bit i
// of word w of tile t's row r set where cell (r, 32 w + i) is sampled; b
// [*, k] with rows[t] * bm + bm <= its row count and ct [*, k] (C's
// transpose) with cols[t] * bn + bn <= its row count, both of dtype b_dtype
// and contiguous; y [n_tiles, bm, bn] of dtype out_dtype (codes 0 f32,
// 1 bf16, 2 f16), written whole.  bm, bn <= 128.  Returns the cudaError_t
// of the launch.
extern "C" int sddmm_pattern(const int* rows, const int* cols,
                             const void* occ, const void* b, const void* ct,
                             void* y, int n_tiles, int bm, int bn, int k,
                             int b_dtype, int out_dtype, void* stream) {
  if (n_tiles == 0) return cudaSuccess;
  if (bm < 1 || bn < 1 || bm > kMaxR * kSide || bn > kMaxR * kSide || k < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* o = static_cast<const unsigned*>(occ);
  switch (b_dtype) {
    case 0:
      return pattern_out<float>(out_dtype, rows, cols, o, b, ct, y, n_tiles,
                                bm, bn, k, s);
    case 1:
      return pattern_out<__nv_bfloat16>(out_dtype, rows, cols, o, b, ct, y,
                                        n_tiles, bm, bn, k, s);
    case 2:
      return pattern_out<__half>(out_dtype, rows, cols, o, b, ct, y, n_tiles,
                                 bm, bn, k, s);
  }
  return cudaErrorInvalidValue;
}

// row_slot, row_nnz, perm int32[n_rows]; cols int32[n_slots]; b f32[m, k]
// with perm[r] < m wherever row_nnz[r] > 0; c f32[k, n] with every column
// a row reads below n; y f32[n_slots], zeroed by the caller (only the
// nonzeros' slots are written).  Returns the cudaError_t of the launch.
extern "C" int sddmm_sell_slots_f32(const int* row_slot, const int* row_nnz,
                                    const int* perm, const int* cols,
                                    const float* b, const float* c, float* y,
                                    int n_rows, int k, int n, void* stream) {
  if (n_rows == 0 || k == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int warps_per_cta = kThreads / 32;
  const int grid = (n_rows + warps_per_cta - 1) / warps_per_cta;
  if (k == 2)
    sddmm_slots_kernel<2><<<grid, kThreads, 0, s>>>(
        row_slot, row_nnz, perm, cols, b, c, y, n_rows, k, n);
  else
    sddmm_slots_kernel<0><<<grid, kThreads, 0, s>>>(
        row_slot, row_nnz, perm, cols, b, c, y, n_rows, k, n);
  return cudaGetLastError();
}
