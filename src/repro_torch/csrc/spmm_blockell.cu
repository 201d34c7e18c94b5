// Block-ELL SpMM with a fused epilogue, for sm_90a: one streaming kernel
// that reads each block once and works only on its nonzeros.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   K1 spmm_blockell_kernel           (src/repro/kernels/spmm/kernel.py:64)
//   K5 spmm_blockell_epilogue_kernel  (src/repro/kernels/fused/spmm.py:82)
// K1 is this kernel with act = identity and no bias or residual.
//
//   Y[i-block, :] = act(sum_w blocks[i, w] @ H[idx[i, w]-block, :]
//                       + bias + res[i-block, :])
//
// Blocks, H and Y are one element type T (f32, bf16 or f16; the wrapper
// promotes mixed operands to their common type); bias and res are f32.
// Sums are f32 (fmaf, no TF32, no tensor cores) and Y is rounded once, at
// the only store, after the epilogue.
//
// What bounds it on an H100: the bytes of `blocks`, read once from device
// memory (1.07 GB of f32 on the serving graph, 0.32 ms at 3.35 TB/s).  The
// nonzeros (about 10 % of each block there) need far less arithmetic, and
// H (8 MB) stays in the 50 MB L2.  The TPU kernel multiplied every block
// densely, once per D-tile; this one does neither:
//  - Ring.  A producer warp streams each slot's block and its bn x DT
//    tile of H into a ring of as many stages as fit (up to 8) in shared
//    memory with 1-D bulk copies (cp.async.bulk, the TMA's linear mode),
//    completing on the stage's mbarrier; the block is hinted evict-first
//    in L2, H evict-last.  Sixteen consumer warps release a stage through
//    a second mbarrier, so loads run ahead of the arithmetic.  A pointer
//    or width that is not 16-byte aligned is copied by the producer's
//    lanes instead (same ring, slower).
//  - Compaction.  A consumer warp owns rows warp, warp + 16, ... of the
//    block-row.  Per slot it compacts them two at a time, a half-warp a
//    row, 4 columns a lane: __ballot_sync marks the nonzeros and each lane
//    writes its own at the count of nonzeros below them, so a row's list
//    of (offset of H row k in the staged tile, value) is in ascending k.
//  - Sums.  LG lanes per row, 4 columns a lane (LG = 32 for a D-tile
//    above 64 columns, 16 above 32, else 8: then 2 or 4 rows at once), add
//    E entries of each row per iteration (E H rows in flight).  The lists
//    summed together are padded to the same multiple of E with entries
//    naming a zero row and the value 0, so every load and fmaf is
//    unconditional; a zero in the block costs nothing, padding slots
//    (zero blocks, valid indices) add no work, and a finite row sums the
//    same nonzero terms in the same order (ascending k, slots in order) as
//    the dense loop did.
//  - One read of each block.  A CTA owns a block-row's whole D up to 128
//    columns; wider D (or a width whose two stages do not fit, or blocks
//    of more than 64 rows: at most 64 columns) is cut into D-tiles whose
//    CTAs are neighbours in launch order, so they read the same blocks at
//    about the same time and the second read hits L2.
//  - Split.  Where it takes fewer waves for the same work (a grid
//    smaller than the card holds at once, or one a little over a whole
//    number of waves; a wave counts the clusters the card holds, which
//    sit within a GPC), the W slots of a block-row are split over a
//    cluster of 2 or 4 CTAs (contiguous slot ranges).  Each writes its
//    partial tile to its shared memory; after a cluster barrier, CTA c
//    reduces rows r with r % split == c by reading the partials through
//    distributed shared memory in rank order 0, 1, ..., applies the
//    epilogue and stores.  On an H100, 16 block-rows of 256 slots take
//    3.6x less time split over 4, 150 block-rows 1.5x less
//    (kernels/spmm/splits.py); the serving graph's 256 block-rows take 1.
// Occupancy: one CTA of 17 warps (544 threads) per SM, so at most 96
// registers a thread (17 warps over the SM's 4 register files), and up to
// 227 KB of shared memory (the lists, a zero row, the ring).
// Determinism: no atomics; every output element is the same sum in the
// same order on every run (slot order within a CTA, then rank order).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "blockell_ring.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace ring;  // NOLINT: the ring primitives, shared with K7

constexpr int kWarps = 16;                 // consumer warps
constexpr int kThreads = (kWarps + 1) * 32;  // + the producer warp
constexpr int kMaxDT = 128;  // D columns per CTA: 4 per lane
constexpr int kMaxStages = 8;
constexpr int kBarrierBytes = 2 * kMaxStages * 8;  // full[], empty[]
constexpr int kLists = 4;  // rows a consumer warp compacts at once
constexpr int kMaxSplit = 4;  // CTAs per block-row at most
constexpr size_t kMaxSmem = 227 * 1024;  // one CTA per SM
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const int* idx;
  const void* blocks;
  const void* h;
  const float* bias;  // f32[d] or null
  const float* res;   // f32[nbr*bm, d] or null
  void* y;
  int w, bm, bn, d;
  int dt;        // D columns per CTA (the D-tile)
  int n_dt;      // D-tiles
  int split;     // CTAs per block-row (a cluster when > 1)
  int stages;    // ring depth
  int hs;        // row stride of a staged H tile, in elements
  int a_bytes;   // one staged block, padded to 16
  int h_bytes;   // one staged H tile, padded to 16
  int bulk_a;    // blocks copied by the bulk engine (else by lanes)
  int bulk_h;    // H tiles copied by the bulk engine (else by lanes)
  int list_len;  // entries of one (offset, value) list, a row's nonzeros
  int zero_at;   // byte offset of the zero H row in shared memory
  int ring_at;   // byte offset of the ring in shared memory
  int act;
  float slope;
};

// Lanes per output row in the sums: 4 columns a lane, so 32 lanes cover a
// 128-column D-tile (one row at a time) and 8 lanes a 16- or 32-column one
// (four rows at a time).
__host__ __device__ constexpr int lanes_per_row(int dt) {
  return dt > 64 ? 32 : dt > 32 ? 16 : 8;
}


// Values of row r of the staged block at columns c0 .. c0 + 3 (0 past bm
// or bn): one 16-byte (f32) or 8-byte load where bn % 4 == 0.
template <class T>
__device__ __forceinline__ void row_values(const T* __restrict__ as,
                                           const Params& p, int r, int c0,
                                           float (&x)[4]) {
  if (r < p.bm && c0 < p.bn && p.bn % 4 == 0) {
    const float4 v = Elem<T>::load4(as + r * p.bn + c0);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      x[j] = r < p.bm && c0 + j < p.bn ? Elem<T>::to_f(as[r * p.bn + c0 + j])
                                       : 0.f;
  }
}

// Compacts row r into `list` (the half-warp of lane `lane` does it, 4
// columns a lane, 64 columns a pass): (byte offset of H row k in the staged
// tile, value) for each nonzero, in ascending k.  Returns the count.
template <class T>
__device__ __forceinline__ int compact_row(const T* __restrict__ as,
                                           const Params& p, int r,
                                           int lane, int2* list) {
  const int half = lane >> 4;
  const unsigned half_mask = 0xffffu << (16 * half);
  const unsigned below = ((1u << lane) - 1) & half_mask;
  const int row_bytes = p.hs * static_cast<int>(sizeof(T));
  int n = 0;
#pragma unroll
  for (int seg = 0; seg < kMaxDT / 64; ++seg) {
    if (seg * 64 < p.bn) {
      const int c0 = seg * 64 + 4 * (lane & 15);
      float x[4];
      row_values(as, p, r, c0, x);
      int pos = n;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned b = __ballot_sync(kFull, x[j] != 0.f);
        pos += __popc(b & below);
        n += __popc(b & half_mask);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (x[j] != 0.f)
          list[pos++] = make_int2((c0 + j) * row_bytes, __float_as_int(x[j]));
    }
  }
  return n;
}

// One slot for one consumer warp: the rows warp + 16q of the staged block,
// four at a time.  The four are compacted two at a time (a half-warp each)
// into the warp's four lists; then LG lanes per row (4 columns each) add
// the nonzeros of 32/LG rows at once, E entries of each row per iteration
// (E H rows in flight; 2 where a warp owns 8 rows, to stay within the
// registers).  Every load and fmaf is unconditional: the
// lists summed together are padded to the same multiple of E with entries
// that name a zero H row and the value 0, which add 0 x 0.
template <class T, int R, int LG>
__device__ __forceinline__ void consume(const T* __restrict__ as,
                                        const T* __restrict__ hs_tile,
                                        const T* __restrict__ zero_row,
                                        const Params& p, int warp, int lane,
                                        int col, int2* lists,
                                        float (&acc)[(R * LG + 31) / 32][4]) {
  constexpr int RPS = 32 / LG;        // rows summed at once
  constexpr int SPC = kLists / RPS;   // steps a chunk of kLists rows takes
  constexpr int CHUNKS = (R + kLists - 1) / kLists;
  constexpr int E = R >= 8 ? 2 : 4;
  static_assert(R * LG <= 128, "the accumulator tile must fit");
  const int g = lane / LG;
  const unsigned char* hl =
      reinterpret_cast<const unsigned char*>(hs_tile + col);
  const int pad = static_cast<int>((zero_row - hs_tile) * sizeof(T));
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    int cnt[kLists];
#pragma unroll
    for (int pp = 0; pp < kLists / 2; ++pp) {
      const int li = 2 * pp + (lane >> 4);
      const int n = compact_row(as, p, warp + (c * kLists + li) * kWarps,
                                lane, lists + li * p.list_len);
      cnt[2 * pp] = __shfl_sync(kFull, n, 0);
      cnt[2 * pp + 1] = __shfl_sync(kFull, n, 16);
    }
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
            x[2 * u] = Elem<T>::load4(reinterpret_cast<const T*>(hl + e[u].x));
            x[2 * u + 1] =
                Elem<T>::load4(reinterpret_cast<const T*>(hl + e[u].z));
          }
#pragma unroll
          for (int u = 0; u < E; ++u) {
            const float v = __int_as_float(u % 2 ? e[u / 2].w : e[u / 2].y);
            acc[st][0] = fmaf(v, x[u].x, acc[st][0]);
            acc[st][1] = fmaf(v, x[u].y, acc[st][1]);
            acc[st][2] = fmaf(v, x[u].z, acc[st][2]);
            acc[st][3] = fmaf(v, x[u].w, acc[st][3]);
          }
        }
      }
    }
    __syncwarp();  // the lists are rewritten for the next chunk
  }
}

// act(z + bias + res) for output row `row`, columns col0..col0+3 (those
// below col_end), rounded once to T.
template <class T>
__device__ __forceinline__ void store4(const Params& p, size_t row, int col0,
                                       int col_end, float z0, float z1,
                                       float z2, float z3) {
  const float z[4] = {z0, z1, z2, z3};
  T* y = static_cast<T*>(p.y);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = col0 + j;
    if (col < col_end) {
      float v = z[j];
      if (p.bias != nullptr) v += p.bias[col];
      if (p.res != nullptr) v += p.res[row * p.d + col];
      y[row * p.d + col] = Elem<T>::from_f(apply_act(v, p.act, p.slope));
    }
  }
}

// The producer warp's fill of ring stage it % stages with slot slot0 + it:
// the block and the bn x dt tile of H its column index names; lane 0 arms
// the stage's mbarrier with the bytes to come.
template <class T>
__device__ __forceinline__ void fill_stage(const Params& p,
                                           unsigned char* ring,
                                           uint64_t* full, size_t slot0,
                                           int it, int d0, int dt, int lane,
                                           uint64_t stream, uint64_t keep) {
  const int st = it % p.stages;
  const size_t at = static_cast<size_t>(st) * (p.a_bytes + p.h_bytes);
  T* as = reinterpret_cast<T*>(ring + at);
  T* hst = reinterpret_cast<T*>(ring + at + p.a_bytes);
  const size_t s = slot0 + it;
  const int block_elems = p.bm * p.bn;
  const T* a_src = static_cast<const T*>(p.blocks) + s * block_elems;
  const T* h_src = static_cast<const T*>(p.h) +
                   static_cast<size_t>(p.idx[s]) * p.bn * p.d + d0;
  const uint32_t a_exact = block_elems * sizeof(T);
  const uint32_t h_row = dt * sizeof(T);
  if (!p.bulk_a)
    for (int e = lane; e < block_elems; e += 32) as[e] = a_src[e];
  if (!p.bulk_h)
    for (int e = lane; e < p.bn * dt; e += 32) {
      const int k = e / dt;
      hst[k * p.hs + (e - k * dt)] =
          h_src[static_cast<size_t>(k) * p.d + (e - k * dt)];
    }
  if (!p.bulk_a || !p.bulk_h) __threadfence_block();
  __syncwarp();
  if (lane == 0)
    mbar_arrive_expect_tx(
        &full[st], (p.bulk_a ? a_exact : 0) +
                       (p.bulk_h ? static_cast<uint32_t>(p.bn) * h_row : 0));
  __syncwarp();
  if (p.bulk_a && lane == 0) bulk_copy(as, a_src, a_exact, &full[st], stream);
  if (p.bulk_h) {
    if (dt == p.d) {  // the H tile is one contiguous run
      if (lane == 0) bulk_copy(hst, h_src, p.bn * h_row, &full[st], keep);
    } else {
      for (int k = lane; k < p.bn; k += 32)
        bulk_copy(hst + k * p.hs, h_src + static_cast<size_t>(k) * p.d,
                  h_row, &full[st], keep);
    }
  }
}

// Grid: one CTA per (block-row i, D-tile t, rank c), x = (i * n_dt + t) *
// split + c, so the CTAs of a block-row are neighbours (and a cluster).
template <class T, int R, int LG>
__global__ void __launch_bounds__(kThreads, 1)
    spmm_blockell_kernel(const Params p) {
  constexpr int RPS = 32 / LG;
  constexpr int STEPS = (R * LG + 31) / 32;  // rows a lane sums
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  unsigned char* ring = smem + p.ring_at;

  const int rank = blockIdx.x % p.split;
  const int tile = blockIdx.x / p.split;
  const int i = tile / p.n_dt;
  const int d0 = (tile % p.n_dt) * p.dt;
  const int dt = min(p.dt, p.d - d0);
  const int per = (p.w + p.split - 1) / p.split;
  const int s_begin = min(p.w, rank * per);
  const int n_slots = min(p.w, s_begin + per) - s_begin;
  const size_t slot0 = static_cast<size_t>(i) * p.w + s_begin;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  T* zero_row = reinterpret_cast<T*>(smem + p.zero_at);
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
    for (int j = 0; j < 4; ++j) acc[s][j] = 0.f;
  // this lane's 4 columns of the D-tile; lanes past dt read column 0's
  // and store nothing
  const int col = 4 * (lane % LG);
  const bool lane_on = col < dt;

  if (warp == kWarps) {
    // producer: slot it into stage it % stages once the consumers have
    // released what that stage held
    const uint64_t stream = l2_policy(true), keep = l2_policy(false);
    for (int it = 0; it < n_slots; ++it) {
      if (it >= p.stages)
        mbar_wait(&empty[it % p.stages], ((it / p.stages) - 1) & 1);
      fill_stage<T>(p, ring, full, slot0, it, d0, dt, lane, stream, keep);
    }
  } else {
    int2* lists = reinterpret_cast<int2*>(smem + kBarrierBytes) +
                  warp * kLists * p.list_len;
    for (int it = 0; it < n_slots; ++it) {
      const int st = it % p.stages;
      mbar_wait(&full[st], (it / p.stages) & 1);
      const unsigned char* base =
          ring + static_cast<size_t>(st) * (p.a_bytes + p.h_bytes);
      consume<T, R, LG>(reinterpret_cast<const T*>(base),
                        reinterpret_cast<const T*>(base + p.a_bytes),
                        zero_row, p, warp, lane, lane_on ? col : 0, lists,
                        acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
  }

  // the lane's rows: warp + 16 q with q = s * RPS + lane / LG
  const size_t row0 = static_cast<size_t>(i) * p.bm;
  if (p.split == 1) {
    if (warp < kWarps && lane_on) {
#pragma unroll
      for (int s = 0; s < STEPS; ++s) {
        const int r = warp + (s * RPS + lane / LG) * kWarps;
        if (r < p.bm)
          store4<T>(p, row0 + r, d0 + col, d0 + dt, acc[s][0], acc[s][1],
                    acc[s][2], acc[s][3]);
      }
    }
    return;
  }

  // split > 1: partial tiles through distributed shared memory.  Every
  // stage has been consumed, so the ring is free for the partial tile
  // [bm][ps] in f32.
  cg::cluster_group cluster = cg::this_cluster();
  const int ps = (p.dt + 3) / 4 * 4;
  float* part = reinterpret_cast<float*>(ring);
  __syncthreads();
  if (warp < kWarps && lane_on) {
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      const int r = warp + (s * RPS + lane / LG) * kWarps;
      if (r < p.bm)
        *reinterpret_cast<float4*>(&part[r * ps + col]) =
            make_float4(acc[s][0], acc[s][1], acc[s][2], acc[s][3]);
    }
  }
  cluster.sync();
  const int c4 = (dt + 3) / 4;
  const int my_rows = (p.bm - rank + p.split - 1) / p.split;
  for (int e = threadIdx.x; e < my_rows * c4; e += kThreads) {
    const int r = rank + (e / c4) * p.split;
    const int c = (e % c4) * 4;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < p.split; ++k) {  // rank order: fixed
      const float4 v = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(&part[r * ps + c], k));
      if (k == 0) {
        sum = v;
      } else {
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
    }
    store4<T>(p, row0 + r, d0 + c, d0 + dt, sum.x, sum.y, sum.z, sum.w);
  }
  cluster.sync();  // no CTA leaves while another reads its partial tile
}

size_t round16(size_t bytes) { return (bytes + 15) / 16 * 16; }

template <class T, int R, int LG>
cudaError_t launch(Params p, int nbr, cudaStream_t stream) {
  auto kernel = spmm_blockell_kernel<T, R, LG>;
  const size_t ring = static_cast<size_t>(p.stages) * (p.a_bytes + p.h_bytes);
  size_t smem = p.ring_at + ring;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMaxSmem));
  if (err != cudaSuccess) return err;
  // the split s of a block-row's slots (1, 2 or 4 CTAs, two slots a CTA
  // at least) that takes the fewest waves for the same work,
  // ceil(units / clusters of s the card holds at once) / s; ties go to
  // the smaller split
  // a split CTA reuses the ring for its f32 partial tile [bm][dt]
  const size_t part_end = p.ring_at + static_cast<size_t>(p.bm) *
                                          ((p.dt + 3) / 4 * 4) * sizeof(float);
  const size_t smem_split = part_end > smem ? part_end : smem;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const auto set_split = [&](int s) {
    attr[0].val.clusterDim.x = s;
    cfg.dynamicSmemBytes = s > 1 ? smem_split : smem;
  };
  const long units = static_cast<long>(nbr) * p.n_dt;
  long waves[kMaxSplit + 1] = {};
  int split = 1;
  for (int s = 1; s <= kMaxSplit && (s == 1 || p.w >= 2 * s); s *= 2) {
    set_split(s);
    cfg.gridDim = dim3(s);
    int clusters = 0;
    if ((err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg)) !=
        cudaSuccess)
      return err;
    if (clusters < 1) continue;
    waves[s] = (units + clusters - 1) / clusters;
    if (s > 1 && waves[s] * split < waves[split] * s) split = s;
  }
  p.split = split;
  set_split(split);
  cfg.gridDim = dim3(static_cast<unsigned>(nbr) * p.n_dt * split);
  cfg.numAttrs = split > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <class T, int LG>
cudaError_t dispatch_rows(const Params& p, int nbr, cudaStream_t stream) {
  const int rows = (p.bm + kWarps - 1) / kWarps;
  if (rows <= 1) return launch<T, 1, LG>(p, nbr, stream);
  if (rows <= 2) return launch<T, 2, LG>(p, nbr, stream);
  if (rows <= 4) return launch<T, 4, LG>(p, nbr, stream);
  // 8 rows a warp take a D-tile of at most 64 columns (see run)
  if constexpr (LG < 32)
    if (rows <= 8) return launch<T, 8, LG>(p, nbr, stream);
  return cudaErrorInvalidValue;
}

template <class T>
cudaError_t run(Params p, int nbr, cudaStream_t stream) {
  const size_t es = sizeof(T);
  const auto aligned = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  p.bulk_a = aligned(p.blocks) &&
             (static_cast<size_t>(p.bm) * p.bn * es) % 16 == 0;
  p.bulk_h = aligned(p.h) && (static_cast<size_t>(p.d) * es) % 16 == 0;
  p.a_bytes = static_cast<int>(round16(static_cast<size_t>(p.bm) * p.bn * es));
  // a list holds a row's nonzeros padded to a multiple of 4; its stride,
  // 2 entries more, puts the lists a warp reads at once on other banks
  p.list_len = (p.bn + 3) / 4 * 4 + 2;
  // the widest D-tile (<= 128 columns, a multiple of 8) of which two
  // stages fit in one CTA's shared memory; blocks of more than 64 rows
  // (8 a warp) take at most 64 columns, so their accumulator tile fits
  // in the registers
  const int d8 = (p.d + 7) / 8 * 8;
  for (int cand = p.bm > 4 * kWarps ? kMaxDT / 2 : kMaxDT;; cand /= 2) {
    p.dt = cand < d8 ? cand : d8;
    p.n_dt = (p.d + p.dt - 1) / p.dt;
    p.hs = p.n_dt == 1 && p.bulk_h ? p.d : p.dt;
    p.h_bytes = static_cast<int>(round16(static_cast<size_t>(p.bn) * p.hs * es));
    p.zero_at = kBarrierBytes + kWarps * kLists * p.list_len * 8;
    p.ring_at = p.zero_at + static_cast<int>(round16(p.hs * es));
    const size_t stage = p.a_bytes + p.h_bytes;
    if (p.ring_at + 2 * stage <= kMaxSmem || cand <= 8) {
      size_t n = (kMaxSmem - p.ring_at) / stage;
      if (n > kMaxStages) n = kMaxStages;
      p.stages = static_cast<int>(n);
      break;
    }
  }
  if (p.stages < 2) return cudaErrorInvalidValue;
  switch (lanes_per_row(p.dt)) {
    case 32:
      return dispatch_rows<T, 32>(p, nbr, stream);
    case 16:
      return dispatch_rows<T, 16>(p, nbr, stream);
    default:
      return dispatch_rows<T, 8>(p, nbr, stream);
  }
}

}  // namespace
// dtype: 0 f32, 1 bf16, 2 f16, for blocks, h and y alike.  idx
// int32[nbr, w]; blocks [nbr, w, bm, bn]; h [n, d] with n a multiple of
// bn; bias f32[d] or null; res f32[nbr*bm, d] or null; y [nbr*bm, d].
// Returns the cudaError_t of the launch.
extern "C" int spmm_blockell(int dtype, const int* idx, const void* blocks,
                             const void* h, const float* bias,
                             const float* res, void* y, int nbr, int w,
                             int bm, int bn, int d, int act, float slope,
                             void* stream) {
  if (nbr == 0 || d == 0) return cudaSuccess;
  if (bm < 1 || bn < 1 || bm > 128 || bn > 128) return cudaErrorInvalidValue;
  Params p = {};
  p.idx = idx;
  p.blocks = blocks;
  p.h = h;
  p.bias = bias;
  p.res = res;
  p.y = y;
  p.w = w;
  p.bm = bm;
  p.bn = bn;
  p.d = d;
  p.act = act;
  p.slope = slope;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(run<float>(p, nbr, st));
    case 1:
      return static_cast<int>(run<__nv_bfloat16>(p, nbr, st));
    case 2:
      return static_cast<int>(run<__half>(p, nbr, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
