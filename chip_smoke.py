#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one card

Phases, each of which must pass or the script exits non-zero:

  1. Device and build: the card's name and power limit, torch and CUDA
     versions, and the build of every CUDA kernel from ``csrc/``, with
     ptxas's usage; every instance that spills is printed, and no K1/K5
     instance (``spmm_blockell``) nor K9 instance may spill.
  2. Kernels against their plain PyTorch versions on the card, at ragged
     small shapes (m not a multiple of bm): K1/K2/K5/K6 at D = 16 and 48
     with bias and residual (K2/K6 on their slot operands, held besides
     to the tile-granular plain versions of the same matrix); K1/K5's
     streaming kernel besides at block fills 0, 1 %, 10 % and 100 %, an
     all-padding block-row, D = 16, 48, 128 and 130, in f32, bf16 and f16,
     launched twice for equal bits; N1 (the transposed SpMM, A's Block-ELL
     blocks read in place) at the same fills with an empty block column,
     D = 2, 16, 128 and 130, f32, bf16 and f16, launched twice for equal
     bits, and K2 over Aᵀ's row view (the sell path's transposed SpMM)
     against the element route, launched twice for equal bits; K3/K4 at
     K = 2 and 48 (K3 with a weighted mask, with none and on bf16
     operands; K4 on its slot operands, held
     besides, exactly, to the tile kernel gathered to slots, with padding
     and edge-less rows' slots exactly 0); K3 at a pattern (K3p) at
     K = 2, 48 and 130, in f32 and bf16, over a Block-ELL form's Block-COO
     view and its occupancy bits, equal bit for bit to K3 without a mask
     at every set bit and exactly 0 elsewhere, launched twice for equal
     bits; K7/K8 at dk = 2 and 48,
     D = 16 and 48, in f32 and bf16, with edge-less rows (exactly 0) and
     all three edge activations, each launched twice for equal bits (K8
     on its row view, held besides to the tile-granular plain version);
     K9 in f32 and bf16 at S = 256, GQA
     8:2, D = 64 and 256, blocks (64, 64), (64, 32) and (128, 64),
     windows 0 and 64, causal and not, and a custom ELL pattern with
     invalid slots and fully masked rows (exactly 0).
  3. On two graphs of N = 16384 nodes at the paper's full width
     (``CONFIG``: 256 -> 128 -> 128 -> 16, 64 x 64 blocks, numpy-seeded He
     weights), each packed once and used by every path below:
       (a) uniform density 0.1, planned onto the Block-ELL path
           (GCN: K5, K1; SDDMM: K3; GAT: K7);
       (b) ``random_graph(16384, 16, seed=1)``, > 99 % sparse, planned
           onto the SELL-C-σ path (GCN: K6, K2; SDDMM: K4; GAT: K8).
     Per graph and path, each kernel at the serving shapes against its
     plain version, timed beside it, beside one PyTorch call computing
     the same function where there is one (``torch.sparse.mm`` for the
     SpMM kernels, ``torch.sparse.sampled_addmm`` for K4 and for K3
     without a mask; printed here, never called by the port) and beside
     its bound from
     bytes and the FP32 operations its nonzeros need (K1/K5 and K7: the
     blocks once, with K1/K5's bytes by their design printed beside,
     counted from the shapes, not read from a counter; K2/K6: the two row
     arrays, each nonzero's column and value, H and Y; K4: the row arrays,
     each nonzero's column, B, C and the slot output; K8: the row arrays,
     each nonzero's column and value, q, kT, V and Y; K2/K6 also with
     every row cut to the p99 count, to show what the heaviest rows
     cost; K7/K8 at D = 128 and 16, the widths of a GAT request).  Then,
     with the kernel launch counts set to 0 just before and read just
     after:
       GCN: 8 requests through ``GNNServingEngine``, logits held to a
            dense f32 oracle (TF32 off), and one request with
            ``fuse=False``; one more request profiled, which must call
            neither ``sell_tile_blocks`` nor ``sell_row_ptr`` (the tile
            view's helpers);
       SDDMM: one ``repro_torch.sparse.ops.sddmm`` call at K = 2, its
            plan and values held to a dense f32 oracle of A ⊙ (B C), its
            peak memory beyond the inputs printed (on (a) at most its
            output tiles plus ``SDDMM_ELL_SLACK_BYTES``: no mask array;
            on (b) at most ``SDDMM_SELL_EXTRA_BYTES``: no tile mask or
            tile output; K4 also equals the tile kernel there, and
            ``sample_sell_blocked`` samples the same without the
            packing's tile view).  Before it, on (a), K3 is timed as
            ``sample_exec`` launches it (no mask, against
            ``sampled_addmm``) and as the entry point launches it (A's
            values as the mask: the kernel row);
       GAT: 8 requests through ``GNNServingEngine(model="gat")``, logits
            held to a dense f32 masked-softmax oracle; then 5 requests
            with ``fuse=False`` (no kernel: it samples on the csr
            pattern) in turns with 5 fused ones, held to the fused
            logits, the two medians printed side by side, and the
            unfused request's time and peak memory with A's dense array
            memoized and with the memo emptied first; one more request
            profiled, which must call neither tile-view helper.
     After serving, the ``obs`` counters of the dispatcher and the plan
     memo (``dispatch_plans_total``, ``plan_cache_{hits,misses}_total``),
     which must not be empty.
  4. Block-sparse attention at gemma3-4b width (the port's
     ``configs.gemma3_4b.CONFIG``: 8 q heads on 4 kv heads, head dim 256,
     window 1024, 512 x 512 blocks), batch 1, q, k and v standard normal
     from numpy (seed ``SEED``), scores scaled by 1/√D.  With the launch
     counts set to 0 just before and read just after each call, one
     ``block_sparse_flash_attention`` (K9 x1):
       (i)  S = 32768, window 1024: held to K9's plain version and to the
            port's ``local_block_attention`` in f32 on the same inputs (an
            independent oracle);
       (ii) S = 8192, window 0 (full causal): held to the plain version
            and to the port's ``flash_attention`` in f32;
     each in bf16 and then in f32; and
       (iii) S = 32768, window 0 (a global layer's mask at the same
            length), f32 only: the longest rows, the last q block of
            every head (32257 to 32768 keys each), held to an f64 oracle.
     Every output row is held to its own norm; f32 besides to
     1e-4 x max|want|, and bf16 element by element to the plain version
     (rtol 1e-2, atol 2e-3).
     Each timed beside its bound (the live query-key pairs at the bf16
     tensor-core peak; in f32 three TF32 products per product at the TF32
     peak, with the FFMA bound printed beside), the plain version and
     ``scaled_dot_product_attention`` in the same dtype (the dense ELL
     mask at (i), ``is_causal`` at (ii); printed here, never called by the
     port), with its TFLOP/s, its share of the bound and its ratio to
     SDPA.
  5. Training, on each graph of phase 3 right after its serving (the
     same packing): GCN and GAT, fused, with seeded weights, planted
     labels and ``repro_torch.train.gnn``'s step (full-batch NLL, plain
     SGD at ``TRAIN_LR``).  One step whose gradients are held, parameter
     by parameter, to a dense f32 autograd oracle on the card (TF32 off;
     GAT's oracle chunked as ``gat_oracle`` is, its peak memory printed),
     then ``TRAIN_STEPS`` timed steps (median step time with a sync,
     nodes/s, the peak device memory of a step) and one profiled step.
     The loss must fall (but on ``LOSS_FLAT``), and each step's launches
     are asserted (``TRAIN_LAUNCHES``; they join the kernel rows'
     launches).  The step held to the oracle is run once more, without
     ``torch.use_deterministic_algorithms``, and every gradient must be
     equal per ``torch.equal``.  On (a), GAT's first-step gradients must
     also equal, per ``torch.equal``, those of the every-cell route
     (``PATTERN_MIN_K`` out of reach, so every sampled product runs K3
     without a mask), without and with deterministic mode.  Then the
     backward's kernels at their own shapes, each held to its plain
     version beside its bound and its library call: the SDDMM at K = 128
     (dα = ḡ Vᵀ) against ``sampled_addmm`` (on (a) K3 at the pattern, the
     step's launch with C a transposed view, its bound counted from the
     nonzeros, beside K3's staged kernel on every cell, the two equal at
     every nonzero; and the two routes at K = 2, 4, 8 and 16, the widths
     below 128 that set ``PATTERN_MIN_K`` (a step samples at 2 and 16);
     K4 on (b)), the
     SpMM (K1, K2) at D = 2 (GAT's dq) against ``torch.sparse.mm``, and
     the transposed SpMM at D = 128 (dH, dV) and D = 2 (dk), N1 on (a)
     and K2 over Aᵀ's row view on (b), beside its bound, ``torch.sparse.mm``
     on a CSR of Aᵀ and the plain route it replaced.
  6. A JSON line of the backward shapes, a JSON line of the kernels, the
     card line, and the final JSON line.

Without a CUDA device, or without the repository around it, the script
exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import math
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, FP32 FLOP/s outside
# the tensor cores, bf16 and TF32 on them.  Bounds are stated against
# these, at 700 W.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12  # tensor cores, dense
PEAK_TF32_FLOP_PER_S = 495e12  # tensor cores, dense
# logits (and SDDMM values) vs the dense oracle, relative to their own
# scale: |got - want| <= ORACLE_RTOL * max|want| + ORACLE_ATOL (f32 sums
# over up to 16384 terms, and for GAT the softmax's exp, taken in
# another order)
ORACLE_RTOL = 1e-4
ORACLE_ATOL = 1e-7
KERNEL_TOL = dict(rtol=1e-4, atol=1e-5)  # kernel vs its plain version
# K4 vs the tile route it replaced: both sum each dot over K in ascending
# order with fmaf from 0, so they agree bit for bit
TILE_PATH_TOL = dict(rtol=0.0, atol=0.0)
# the (b) SDDMM call may allocate this much beyond its inputs: its output
# and K4's slot vector, a few MB (a tile mask alone would be ≈ 1 GB)
SDDMM_SELL_EXTRA_BYTES = 64 * 2**20
# the (a) SDDMM call may allocate its output tiles (1 GiB) and this much
# more: the padded B and C and the Block-COO row ids, a few MB (a mask or a
# second tile array would be another 1 GiB)
SDDMM_ELL_SLACK_BYTES = 64 * 2**20
BF16_TOL = dict(rtol=2e-2, atol=2e-2)  # K9 in bf16 vs its plain version
# K1/K5 in bf16 / f16 vs their plain versions: both sum in f32 and round
# once, so they differ by at most one ulp of the output (2^-7 relative in
# bf16) beyond the f32 sums' own order
NARROW_TOL = dict(rtol=1e-2, atol=1e-3)
BLOCKELL_FILLS = (0.0, 0.01, 0.1, 1.0)
# phase 4 outputs.  Every row, in both dtypes, against the plain version
# and the f32 oracle: ||got_r - want_r|| <= ATTN_ROW_RTOL * ||want_r|| +
# ATTN_ATOL, so a late row that averages thousands of small values is held
# to its own scale.  f32, besides: |got - want| <= ATTN_F32_RTOL * max|want|
# + ATTN_ATOL (the same sums in another order).  bf16 (p and the output
# rounded to bf16), besides, element by element against the plain version,
# which rounds the same way: ATTN_BF16_TOL (one bf16 ulp is at most
# 2^-7 |x|).
ATTN_ROW_RTOL = {"float32": 1e-4, "bfloat16": 1e-2}
ATTN_F32_RTOL = 1e-4
ATTN_BF16_TOL = dict(rtol=1e-2, atol=2e-3)
ATTN_ATOL = 1e-6
REQUESTS = 8
TURNS = 5  # fused and fuse=False GAT requests timed in turns
TRAIN_STEPS = 5  # timed SGD steps after the step held to the oracle
TRAIN_LR = 0.05  # repro_torch.train.gnn's default
# phase 5: each parameter's first-step gradient vs the dense f32 autograd
# oracle, |got - want| <= ORACLE_RTOL * max|want| + GRAD_ATOL: the same
# f32 sums over up to 16384 terms as the logits, the backward's sums (dH,
# dq, dk, dV over a node's edges; dW over all nodes) taken in another
# order, and for GAT the softmax's exp.  GRAD_ATOL is the fused-attention
# rule's own residual: it takes rowdot_i = ḡ_i · out_i from the forward's
# output (as the reference does), so sum_j de_ij is ḡ_i · (sum_j α_ij v_j
# - out_i), f32 rounding, where it is 0 exactly; ds_src and ds_dst sum it
# into d a_src and d a_dst.  On (a)'s last layer no row's scores mix
# signs, so the true d a_src is 0, and the port's is 5.0e-11 (H100;
# ``python -m repro_torch.train.precision`` holds both to an f64 oracle);
# GRAD_ATOL is 10x that.  Besides, the tolerance of a gradient above
# GRAD_ATOL may be at most GRAD_TOL_SHARE of its max|want|, so a zeroed
# gradient fails; one at or below GRAD_ATOL is zero at f32 resolution,
# and the port's must be too
GRAD_ATOL = 5e-10
GRAD_TOL_SHARE = 1e-2
# graph path and model whose loss need not fall over the steps: (a)'s
# uniform neighbourhoods average each node's own features away, so GCN
# cannot learn the planted labels there and a step moves its f32 mean NLL
# by ≈ 2e-9, below one f32 ulp of ln 16 (2.4e-7); its gradients are held
# to the oracle all the same
LOSS_FLAT = {("ell", "gcn")}
# kernel launches one training step makes, per graph path and model: the
# forward's (K5 x2 + K1, K6 x2 + K2, K7 / K8 x3), GAT's backward K3 / K4
# twice a layer (the score recompute at K = 2 and dα at K = D: 128, 128,
# 16) and K1 / K2 once (dq); on (a) the sampling at K >= PATTERN_MIN_K
# (dα) runs K3 at the pattern (K3p), the score recompute K3's streaming
# kernel; every transposed product runs N1 on (a) and K2 over Aᵀ's row
# view on (b): GCN's dH once a layer, GAT's dk and dV once a layer each;
# A's values take no gradient, so no dA is sampled
TRAIN_LAUNCHES = {
    ("ell", "gcn"): {"K5": 2, "K1": 1, "N1": 3},
    ("sell", "gcn"): {"K6": 2, "K2": 4},
    ("ell", "gat"): {"K7": 3, "K3": 3, "K3p": 3, "K1": 3, "N1": 6},
    ("sell", "gat"): {"K8": 3, "K4": 6, "K2": 9},
}
SEED = 0
N_NODES = 16384
S_LOCAL = 32768   # phase 4 (i): the prefill_32k length, local-layer window
S_GLOBAL = 8192   # phase 4 (ii): the global-layer mask (full causal)
S_LONG = 32768    # phase 4 (iii): the global-layer mask at S_LOCAL's length
DEVICE = "cuda"
# ≈ 0.5 ms of the card's clock cycles (about 1 GHz or more under load):
# longer than a wrapper's host work, so a timed call's launches queue
# behind it
HOST_COVER_CYCLES = 1_000_000

KERNELS = {
    "K1": ("spmm_blockell_kernel", "src/repro_torch/csrc/spmm_blockell.cu",
           "src/repro/kernels/spmm/kernel.py:64"),
    "K2": ("spmm_sell_kernel", "src/repro_torch/csrc/spmm_sell.cu",
           "src/repro/kernels/spmm/sell.py:66"),
    "K5": ("spmm_blockell_epilogue_kernel",
           "src/repro_torch/csrc/spmm_blockell.cu",
           "src/repro/kernels/fused/spmm.py:82"),
    "K6": ("spmm_sell_epilogue_kernel", "src/repro_torch/csrc/spmm_sell.cu",
           "src/repro/kernels/fused/spmm.py:207"),
    "K3": ("sddmm_blockcoo_kernel", "src/repro_torch/csrc/sddmm.cu",
           "src/repro/kernels/sddmm/kernel.py:52"),
    "K3p": ("sddmm_pattern_kernel", "src/repro_torch/csrc/sddmm.cu",
            "src/repro/kernels/sddmm/kernel.py:52"),
    "K4": ("sddmm_sell_kernel", "src/repro_torch/csrc/sddmm.cu",
           "src/repro/kernels/sddmm/sell.py:58"),
    "K7": ("fused_attn_blockell_kernel",
           "src/repro_torch/csrc/fused_attention.cu",
           "src/repro/kernels/fused/attention.py:99"),
    "K8": ("fused_attn_sell_kernel", "src/repro_torch/csrc/fused_attention.cu",
           "src/repro/kernels/fused/attention.py:281"),
    "K9": ("bsattn_kernel", "src/repro_torch/csrc/bsattn.cu",
           "src/repro/kernels/bsattn/kernel.py:93"),
    # no Pallas kernel: the reference's jnp route it takes the place of
    "N1": ("spmm_blockell_t_kernel", "src/repro_torch/csrc/spmm_blockell_t.cu",
           "src/repro/sparse/paths.py:162"),
}
ACTS = ("identity", "relu", "leaky_relu")


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Port:
    """The port's modules, imported once ``src/`` is on the path."""

    def __init__(self):
        from repro_torch.configs import gemma3_4b, paper_gnn
        from repro_torch.core import attention as lm_attention
        from repro_torch.core.formats import (SELL_HEAVY_ROW_NNZ, BlockELL,
                                              SellCS)
        from repro_torch.data.pipeline import random_graph
        from repro_torch.dispatch import dispatcher
        from repro_torch.core.formats import BlockCOO
        from repro_torch.kernels import _build
        from repro_torch.kernels.bsattn import kernel as bsattn_kernel
        from repro_torch.kernels.bsattn import ops as bsattn_ops
        from repro_torch.kernels.bsattn import ref as bsattn_ref
        from repro_torch.kernels.bsattn import tiles as bsattn_tiles
        from repro_torch.kernels.fused import attention
        from repro_torch.kernels.fused import spmm as fused
        from repro_torch.kernels.fused.epilogue import Epilogue
        from repro_torch.kernels.sddmm import kernel as sddmm_kernel
        from repro_torch.kernels.sddmm import ref as sddmm_ref
        from repro_torch.kernels.sddmm import sell as sddmm_sell
        from repro_torch.kernels.spmm import kernel, ref, sell, transposed
        from repro_torch.models import gnn
        from repro_torch import obs
        from repro_torch.serve import engine
        from repro_torch.sparse import autodiff, matrix, ops, paths
        from repro_torch.train import gnn as train

        self.cfg = paper_gnn.CONFIG
        self.lm_cfg = gemma3_4b.CONFIG
        self.lm_attention = lm_attention
        self.bsattn, self.bsattn_kernel = bsattn_ops, bsattn_kernel
        self.dense_mask_from_ell = bsattn_ref.dense_mask_from_ell
        self.random_graph = random_graph
        self.BlockELL, self.SellCS, self.BlockCOO = BlockELL, SellCS, BlockCOO
        self.heavy_nnz = SELL_HEAVY_ROW_NNZ
        self.build = _build
        self.fused, self.ref, self.sell = fused, ref, sell
        self.attention = attention
        self.sddmm_ref, self.sddmm_sell = sddmm_ref, sddmm_sell
        self.sddmm_kernel = sddmm_kernel
        self.ptxas_usage = bsattn_tiles.ptxas_usage
        self.spill_bytes = bsattn_tiles.spill_bytes
        self.Epilogue = Epilogue
        self.gnn, self.engine, self.train = gnn, engine, train
        self.ops, self.paths, self.dispatcher = ops, paths, dispatcher
        self.autodiff, self.matrix = autodiff, matrix
        self.transposed, self.obs = transposed, obs
        self.wrappers = {
            "K1": kernel.spmm_blockell_kernel,
            "K2": sell.spmm_sell_kernel,
            "K5": fused.spmm_blockell_epilogue_kernel,
            "K6": fused.spmm_sell_epilogue_kernel,
            "K3": sddmm_kernel.sddmm_blockcoo_kernel,
            "K3p": sddmm_kernel.sddmm_pattern_kernel,
            "K4": sddmm_sell.sddmm_sell_kernel,
            "K7": attention.fused_attn_blockell_kernel,
            "K8": attention.fused_attn_sell_kernel,
            "K9": bsattn_kernel.bsattn_kernel,
            "N1": transposed.spmm_blockell_t_kernel,
        }

    def reset_counts(self):
        for w in self.wrappers.values():
            w.launches = 0

    def counts(self):
        return {k: w.launches for k, w in self.wrappers.items()}


def ptxas_instances(log_text: str) -> dict:
    """Kernel instance (its mangled name's template arguments) -> its
    spill and register lines in an ``nvcc -Xptxas -v`` log."""
    usage, inst = {}, None
    for line in log_text.splitlines():
        if "Function properties for" in line:
            inst = line.split("Function properties for", 1)[1].strip()
            inst = inst.split("_kernel", 1)[-1][:48] or inst[-48:]
            usage[inst] = []
        elif inst is not None and ("spill" in line or "Used" in line):
            usage[inst].append(line.split(":", 1)[-1].strip())
    return usage


def time_ms(torch, fn, iters=20, warmup=3) -> float:
    """Median device time of one call, from CUDA events around each.  The
    card first spins for ``HOST_COVER_CYCLES`` (``torch.cuda._sleep``), so
    the call's launches are queued before the start event is reached: a
    kernel shorter than its wrapper's host work is timed on the device,
    not at the host's pace."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOST_COVER_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: int, flops: int, peak_flops: float = PEAK_FP32_FLOP_PER_S):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def oracle_tol(want) -> float:
    return ORACLE_RTOL * float(want.abs().max()) + ORACLE_ATOL


def check_close(torch, name, got, want, tol=KERNEL_TOL) -> float:
    torch.cuda.synchronize()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if got.shape != want.shape or not torch.allclose(got, want, **tol):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version, max_abs_err {err:.3e} (tol {tol})")
    return err


def ragged_checks(torch, np, port):
    """Phase 2: each kernel vs its plain version at a ragged small shape."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED)
    m, bm = 1000, 64
    for d in (16, 48):
        # Block-ELL: K1, and K5 with relu + bias + residual
        a = np.where(rng.random((m, m)) < 0.05, rng.standard_normal((m, m)),
                     0).astype(np.float32)
        ell = port.BlockELL.from_dense(a, bm, bm, device=dev)
        ops = (ell.indices, ell.blocks, torch.randn(ell.shape[1], d,
                                                    device=dev))
        epi = port.Epilogue(act="relu", has_bias=True, has_residual=True)
        tail = (torch.randn(d, device=dev),
                torch.randn(ell.shape[0], d, device=dev))
        errs = {
            "K1": check_close(torch, f"K1 ragged d={d}",
                              port.wrappers["K1"](*ops),
                              port.ref.spmm_blockell_ref(*ops)),
            "K5": check_close(
                torch, f"K5 ragged d={d}",
                port.wrappers["K5"](*ops, *tail, epi=epi),
                port.fused.spmm_blockell_epilogue_ref(*ops, *tail, epi=epi)),
        }
        # SELL: K2, and K6 with leaky_relu + bias + residual, on their
        # slot operands; held to their plain versions and to the
        # tile-granular plain versions of the same matrix
        a = np.where(rng.random((m, m)) < 0.003, rng.standard_normal((m, m)),
                     0).astype(np.float32)
        sell = port.SellCS.from_dense(a, block=(bm, bm), device=dev)
        h = torch.randn(m, d, device=dev)
        ops = (*port.sell.sell_row_operands(sell), h)
        kw = dict(n_live_block_rows=sell.n_live_block_rows)
        tiles = (sell.tile_rows, sell.tile_cols,
                 port.sell.sell_tile_blocks(sell),
                 torch.nn.functional.pad(h, (0, 0, 0, -(-m // bm) * bm - m)))
        epi = port.Epilogue(act="leaky_relu", negative_slope=0.2,
                            has_bias=True, has_residual=True)
        tail = (torch.randn(d, device=dev),
                torch.randn(sell.n_live_block_rows * bm, d, device=dev))
        heavy = dict(heavy_rows=sell.tile_heavy_rows)
        got = port.wrappers["K2"](*ops, **heavy)
        errs["K2"] = check_close(torch, f"K2 ragged d={d}", got,
                                 port.sell.spmm_sell_slots_ref(*ops))
        check_close(torch, f"K2 ragged d={d} vs tiles", got,
                    port.sell.spmm_sell_tiles_ref(*tiles, **kw))
        got = port.wrappers["K6"](*ops, *tail, epi=epi, **heavy)
        errs["K6"] = check_close(
            torch, f"K6 ragged d={d}", got,
            port.fused.spmm_sell_epilogue_slots_ref(*ops, *tail, epi=epi))
        check_close(torch, f"K6 ragged d={d} vs tiles", got,
                    port.fused.spmm_sell_epilogue_ref(*tiles, *tail, epi=epi,
                                                      **kw))
        log(f"ragged m={m} d={d} (SELL tiles {sell.n_tiles}, live "
            f"block-rows {sell.n_live_block_rows}, largest row "
            f"{int(sell.tile_row_nnz.max())} nonzeros): max_abs_err "
            + " ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + " (K2/K6 also held to the tile-granular plain versions)")


def ell_sums_close(torch, port, name, got, want, ops) -> float:
    """K1/K5 against their plain version: sums of up to W*bn f32 terms in
    two orders (the kernel's, nonzeros in ascending k and slots in order,
    and einsum's) differ by about √n · eps · Σ|term|, which for a full
    block-row that cancels is far above KERNEL_TOL's atol; held to twice
    that on top of the dtype's tolerance.  Returns the largest error."""
    torch.cuda.synchronize()
    idx, blocks, h = ops
    tol = KERNEL_TOL if got.dtype == torch.float32 else NARROW_TOL
    mag = port.ref.spmm_blockell_ref(idx, blocks.abs(), h.abs()).float()
    n = blocks.shape[1] * blocks.shape[3]
    diff = (got.float() - want.float()).abs()
    bound = tol["atol"] + tol["rtol"] * want.float().abs() \
        + 2 * torch.finfo(torch.float32).eps * n ** 0.5 * mag
    worst = float((diff / bound).max()) if diff.numel() else 0.0
    if got.shape != want.shape or got.dtype != want.dtype or worst > 1:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version, an element is {worst:.2f}x its "
                             f"tolerance ({tol} + 2 eps √n Σ|term|)")
    return float(diff.max()) if diff.numel() else 0.0


def ragged_checks_blockell(torch, np, port):
    """Phase 2 for the streaming K1/K5 kernel: block fills 0, 1 %, 10 %
    and 100 % with an all-padding block-row, D = 16, 48, 128 (one D-tile)
    and 130 (two, not 16-byte rows), f32, bf16 and f16; every launch twice,
    for equal bits."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED + 5)
    m, n, bm = 1000, 700, 64
    epi = port.Epilogue(act="leaky_relu", negative_slope=0.2, has_bias=True,
                        has_residual=True)
    k1, k5 = port.wrappers["K1"], port.wrappers["K5"]
    for fill in BLOCKELL_FILLS:
        a = np.where(rng.random((m, n)) < fill, rng.standard_normal((m, n)),
                     0).astype(np.float32)
        if fill == 1.0:
            a[a == 0] = 1.0
        a[bm:2 * bm] = 0.0  # block-row 1: padding slots only
        ell = port.BlockELL.from_dense(a, bm, bm, device=dev)
        worst = {}
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            for d in (16, 48, 128, 130):
                h = torch.randn(ell.shape[1], d, device=dev).to(dtype)
                tail = (torch.randn(d, device=dev),
                        torch.randn(ell.shape[0], d, device=dev))
                ops = (ell.indices, ell.blocks.to(dtype), h)
                what = f"fill={fill} {dtype} d={d}"
                for name, run, plain in (
                        ("K1", lambda: k1(*ops), port.ref.spmm_blockell_ref(
                            *ops)),
                        ("K5", lambda: k5(*ops, *tail, epi=epi),
                         port.fused.spmm_blockell_epilogue_ref(
                             *ops, *tail, epi=epi))):
                    got, again = run(), run()
                    if not torch.equal(got, again):
                        raise AssertionError(f"{name} {what}: two launches "
                                             "gave different bits")
                    err = ell_sums_close(torch, port, f"{name} {what}", got,
                                         plain, ops)
                    if not torch.equal(got[bm:2 * bm], plain[bm:2 * bm]):
                        raise AssertionError(f"{name} {what}: the padding "
                                             "block-row is not act(bias + "
                                             "res)")
                    key = f"{name} {str(dtype).split('.')[-1]}"
                    worst[key] = max(worst.get(key, 0.0), err)
        log(f"ragged K1/K5 m={m} fill={fill} (W={ell.ell_width}, a "
            "padding block-row; D = 16, 48, 128, 130; two launches equal "
            "bit for bit): max_abs_err "
            + " ".join(f"{k} {v:.3e}" for k, v in worst.items()))


def transposed_sums_close(torch, port, name, got, want, ops) -> float:
    """N1 against its plain version: sums of up to nbr*bm f32 terms in two
    orders (the kernel's, list order then ascending row, and the plain
    version's per-position einsum), held as ``ell_sums_close`` holds K1:
    twice √n · eps · Σ|term| on top of the dtype's tolerance.  Returns the
    largest error."""
    torch.cuda.synchronize()
    col_ptr, col_slots, blocks, h = ops
    tol = KERNEL_TOL if got.dtype == torch.float32 else NARROW_TOL
    mag = port.ref.spmm_blockell_t_ref(col_ptr, col_slots, blocks.abs(),
                                       h.abs()).float()
    diff = (got.float() - want.float()).abs()
    bound = tol["atol"] + tol["rtol"] * want.float().abs() \
        + 2 * torch.finfo(torch.float32).eps * h.shape[0] ** 0.5 * mag
    worst = float((diff / bound).max()) if diff.numel() else 0.0
    if got.shape != want.shape or got.dtype != want.dtype or worst > 1:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version, an element is {worst:.2f}x its "
                             f"tolerance ({tol} + 2 eps √n Σ|term|)")
    return float(diff.max()) if diff.numel() else 0.0


def ragged_checks_transposed(torch, np, port):
    """Phase 2 for N1 (the transposed SpMM): block fills 0, 1 %, 10 % and
    100 % with a padding block-row (padded slots) and an empty block
    column, D = 2, 16, 128 and 130, f32, bf16 and f16, every launch twice
    for equal bits; and K2 over Aᵀ's row view (the sell path's transposed
    SpMM) against the element route, heavy rows of Aᵀ included."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED + 6)
    m, n, bm = 1000, 700, 64
    n1 = port.wrappers["N1"]
    for fill in BLOCKELL_FILLS:
        a = np.where(rng.random((m, n)) < fill, rng.standard_normal((m, n)),
                     0).astype(np.float32)
        if fill == 1.0:
            a[a == 0] = 1.0
        a[bm:2 * bm] = 0.0  # block-row 1: padding slots only
        a[:, bm:2 * bm] = 0.0  # block column 1: in no list
        ell = port.BlockELL.from_dense(a, bm, bm, device=dev)
        col_ptr, col_slots = port.transposed.blockell_columns(ell)
        worst = {}
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            for d in (2, 16, 128, 130):
                ops = (col_ptr, col_slots, ell.blocks.to(dtype),
                       torch.randn(ell.shape[0], d, device=dev).to(dtype))
                what = f"N1 fill={fill} {dtype} d={d}"
                got, again = n1(*ops), n1(*ops)
                if not torch.equal(got, again):
                    raise AssertionError(f"{what}: two launches gave "
                                         "different bits")
                if bool((got[bm:2 * bm] != 0).any()):
                    raise AssertionError(f"{what}: the empty block column "
                                         "is not 0")
                err = transposed_sums_close(
                    torch, port, what, got,
                    port.ref.spmm_blockell_t_ref(*ops), ops)
                key = str(dtype).split(".")[-1]
                worst[key] = max(worst.get(key, 0.0), err)
        log(f"ragged N1 {m}x{n} fill={fill} (W={ell.ell_width}, a padding "
            "block-row, an empty block column; D = 2, 16, 128, 130; two "
            "launches equal bit for bit): max_abs_err "
            + " ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    a = np.where(rng.random((m, n)) < 0.003, rng.standard_normal((m, n)),
                 0).astype(np.float32)
    a[: 2 * port.heavy_nnz, 7] = 1.0  # a row of Aᵀ above the heavy count
    sell = port.SellCS.from_dense(a, block=(bm, bm), device=dev)
    for d in (2, 16, 128):
        h = torch.randn(m, d, device=dev)
        got, again = port.transposed.spmm_sell_t(sell, h), \
            port.transposed.spmm_sell_t(sell, h)
        if not torch.equal(got, again):
            raise AssertionError(f"K2 over Aᵀ's row view d={d}: two "
                                 "launches gave different bits")
        err = check_close(torch, f"K2 over Aᵀ's row view d={d}", got,
                          port.paths.spmm_elements(
                              sell.slot_cols, sell.slot_rows,
                              sell.slot_vals, h, n))
        log(f"ragged K2 over Aᵀ's row view {m}x{n} d={d} (heavy rows of "
            f"Aᵀ {port.transposed.sell_t_operands(sell)[4].numel()}; two "
            f"launches equal): max_abs_err vs the element route {err:.3e}")


def ragged_checks_sddmm_attention(torch, np, port):
    """Phase 2 for K3/K4 (K = 2 and 48) and K7/K8 (dk = 2 and 48, D = 16
    and 48, f32 and bf16, edge-less rows, every edge activation, each
    launched twice for equal bits; K8 on its row view) at m = 1000."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED + 1)
    m, bm = 1000, 64
    n_pad = -(-m // bm) * bm

    def sparse(density):
        a = np.where(rng.random((m, m)) < density,
                     rng.standard_normal((m, m)), 0).astype(np.float32)
        a[[3, 500, 999]] = 0.0  # edge-less rows
        return a

    a_blk, a_sell = sparse(0.05), sparse(0.003)
    coo = port.BlockCOO.from_dense(a_blk, bm, bm, device=dev)  # weighted
    ell = port.BlockELL.from_dense(a_blk, bm, bm, device=dev)
    sell = port.SellCS.from_dense(a_sell, block=(bm, bm), device=dev)
    live = sell.n_live_block_rows
    pattern = (port.sell.sell_tile_blocks(sell) != 0).float()
    rows8 = port.attention.fused_attn_sell_operands(sell)
    k3, k3_plain = port.wrappers["K3"], port.sddmm_ref.sddmm_blockcoo_ref
    for k in (2, 48):
        ops = (coo.rows, coo.cols, coo.blocks,
               torch.randn(n_pad, k, device=dev),
               torch.randn(k, n_pad, device=dev))
        errs = {"K3": check_close(torch, f"K3 ragged k={k}", k3(*ops),
                                  k3_plain(*ops))}
        # K3 with no mask (every cell sampled), and on bf16 operands, which
        # it reads natively (both round each dot once to bf16)
        bare = (*ops[:2], None, *ops[3:])
        kw = dict(block=(bm, bm), out_dtype=torch.float32)
        errs["K3 no mask"] = check_close(torch, f"K3 no mask k={k}",
                                         k3(*bare, **kw),
                                         k3_plain(*bare, **kw))
        b16 = (*ops[:2], *(t.bfloat16() for t in ops[2:]))
        errs["K3 bf16"] = check_close(torch, f"K3 bf16 k={k}",
                                      k3(*b16).float(),
                                      k3_plain(*b16).float(), NARROW_TOL)
        # K4 on its slot operands: held to its plain version and, exactly,
        # to the tile route it replaced
        b, c = torch.randn(m, k, device=dev), torch.randn(k, m, device=dev)
        ops = (*port.sddmm_sell.sddmm_sell_operands(sell), b, c)
        got = port.wrappers["K4"](*ops)
        errs["K4"] = check_close(torch, f"K4 ragged k={k}", got,
                                 port.sddmm_sell.sddmm_sell_slots_ref(*ops))
        check_close(torch, f"K4 ragged k={k} vs the tile kernel", got,
                    sell_tile_path(torch, port, sell, b, c), TILE_PATH_TOL)
        if bool(got[sell.slot_vals == 0].any()):
            raise AssertionError("K4: a slot off the nonzeros is not 0")
        log(f"ragged m={m} k={k} (COO blocks {coo.nnzb}, SELL tiles "
            f"{sell.n_tiles}): max_abs_err "
            + " ".join(f"{n} {e:.3e}" for n, e in errs.items())
            + " (K3 weighted, without a mask and on bf16 operands; K4 also "
            "equal to the tile kernel gathered to slots; padding and "
            "edge-less rows' slots exactly 0)")
    att = port.attention
    edgeless = sell.tile_row_nnz == 0  # edge-less and padding rows
    for dk in (2, 48):
        for d in (16, 48):
            errs = {"K7": 0.0, "K8": 0.0}
            for act, dtype in itertools.product(
                    ACTS, (torch.float32, torch.bfloat16)):
                kw = dict(act=act, slope=0.2)
                what = f"dk={dk} d={d} {act} {str(dtype).split('.')[-1]}"
                tol = KERNEL_TOL if dtype == torch.float32 else NARROW_TOL
                ops = (ell.indices, ell.blocks.to(dtype),
                       *(torch.randn(shape, device=dev).to(dtype) for shape
                         in ((n_pad, dk), (dk, n_pad), (n_pad, d))))
                got = port.wrappers["K7"](*ops, **kw)
                err = check_close(torch, f"K7 ragged {what}", got.float(),
                                  att.fused_attn_blockell_ref(*ops, **kw)
                                  .float(), tol)
                if bool(got[[3, 500, 999]].any()):
                    raise AssertionError("K7: edge-less rows are not 0")
                if not torch.equal(got, port.wrappers["K7"](*ops, **kw)):
                    raise AssertionError(f"K7 {what}: two launches gave "
                                         "different bits")
                errs["K7"] = max(errs["K7"], err)
                # K8 on the row view, held to its plain version and to the
                # tile-granular one over the same matrix
                q, kt, v = (torch.randn(shape, device=dev).to(dtype)
                            for shape in ((live * bm, dk), (dk, n_pad),
                                          (n_pad, d)))
                ops = (*rows8, q, kt[:, :m].contiguous(), v[:m])
                got = port.wrappers["K8"](
                    *ops, heavy_rows=sell.tile_heavy_rows, **kw)
                errs["K8"] = max(errs["K8"], check_close(
                    torch, f"K8 ragged {what}", got.float(),
                    att.fused_attn_sell_rows_ref(*ops, **kw).float(), tol))
                check_close(torch, f"K8 ragged {what} vs tiles", got.float(),
                            att.fused_attn_sell_tiles_ref(
                                sell.tile_rows, sell.tile_cols, pattern, q,
                                kt, v, n_live_block_rows=live, **kw).float(),
                            tol)
                if bool(got[edgeless].any()):
                    raise AssertionError("K8: edge-less rows are not 0")
                if not torch.equal(got, port.wrappers["K8"](
                        *ops, heavy_rows=sell.tile_heavy_rows, **kw)):
                    raise AssertionError(f"K8 {what}: two launches gave "
                                         "different bits")
            log(f"ragged m={m} dk={dk} d={d} ({', '.join(ACTS)}; f32 and "
                "bf16; edge-less rows exactly 0; two launches equal; K8 "
                "also held to the tile-granular plain version): max_abs_err "
                + " ".join(f"{n} {e:.3e}" for n, e in errs.items()))


def bits(torch, x):
    """x's bit patterns, for comparisons that tell -0 from 0."""
    return x.view(torch.int32 if x.element_size() == 4 else torch.int16)


def hold_pattern(torch, name, got, every, keep):
    """K3 at a pattern against K3 without a mask: equal bit for bit at
    every set bit, exactly 0 at every other cell."""
    torch.cuda.synchronize()
    if not torch.equal(bits(torch, got[keep]), bits(torch, every[keep])):
        raise AssertionError(f"{name}: a dot differs from K3's without a "
                             "mask")
    if bool(bits(torch, got[~keep]).any()):
        raise AssertionError(f"{name}: a cell off the pattern is not 0")


def ragged_checks_pattern(torch, np, port):
    """Phase 2 for K3 at a pattern (K3p): K = 2, 48 and 130, f32 and bf16,
    over the Block-COO view of a Block-ELL form with an all-padding
    block-row and edge-less rows, m = 1000; held to its plain version and
    to K3 without a mask, launched twice for equal bits."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED + 3)
    m, bm = 1000, 64
    a = np.where(rng.random((m, m)) < 0.05, rng.standard_normal((m, m)),
                 0).astype(np.float32)
    a[bm:2 * bm] = 0.0  # an all-padding block-row
    a[[3, 500, 999]] = 0.0
    ell = port.BlockELL.from_dense(a, bm, bm, device=dev)
    coo = port.paths.ell_to_coo(ell)
    occ = port.sddmm_ref.pack_occupancy(ell.blocks)
    keep = coo.blocks != 0
    if not torch.equal(port.sddmm_ref.unpack_occupancy(occ, bm), keep):
        raise AssertionError("the occupancy bits are not blocks != 0")
    k3p = port.wrappers["K3p"]
    errs = {}
    for k, dtype in itertools.product((2, 48, 130),
                                      (torch.float32, torch.bfloat16)):
        b = torch.randn(coo.shape[0], k, device=dev).to(dtype)
        c = torch.randn(coo.shape[1], k, device=dev).to(dtype).T
        ops = (coo.rows, coo.cols, occ, b, c)
        kw = dict(block=(bm, bm), out_dtype=dtype)
        what = f"K3p ragged k={k} {str(dtype).split('.')[-1]}"
        got = k3p(*ops, **kw)
        tol = KERNEL_TOL if dtype == torch.float32 else NARROW_TOL
        errs[what] = check_close(
            torch, what, got.float(),
            port.sddmm_ref.sddmm_pattern_ref(*ops, **kw).float(), tol)
        hold_pattern(torch, what, got, port.sddmm_kernel.launch_tiles(
            coo.rows, coo.cols, None, b, c.contiguous(), what,
            **kw), keep)
        if not torch.equal(bits(torch, got), bits(torch, k3p(*ops, **kw))):
            raise AssertionError(f"{what}: two launches gave different "
                                 "bits")
    log(f"ragged m={m} (COO tiles {coo.nnzb}, an all-padding block-row): "
        "K3p equal bit for bit to K3 without a mask at every set bit, 0 "
        "elsewhere, two launches equal; max_abs_err vs plain "
        + " ".join(f"{n} {e:.3e}" for n, e in errs.items()))


def sell_tile_path(torch, port, sell, b, c):
    """The route K4 replaced: the tile kernel (K3's, not counted) over the
    0/1 tile mask and B gathered to packed row order, gathered back to
    slot order (dead cells read an appended zero)."""
    bn = sell.bn
    tiles = port.sddmm_kernel.launch_tiles(
        sell.tile_rows, sell.tile_cols,
        (sell.tile_slot_map < sell.n_slots).float(),
        torch.cat([b, b.new_zeros((1, b.shape[1]))])[sell.perm].contiguous(),
        port.paths.pad_cols(c, -(-c.shape[1] // bn) * bn).contiguous(),
        "the tile kernel over the SELL tiles")
    return torch.cat([tiles.reshape(-1), tiles.new_zeros(1)])[
        sell.slot_tile_pos]


def ragged_checks_bsattn(torch, np, port):
    """Phase 2 for K9: f32 and bf16, D = 64 and 256, GQA 8:2, every block
    pair, window and causal flag, and a custom ELL pattern."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED + 4)
    s, bh, bkv = 256, 8, 2
    k9, plain = port.wrappers["K9"], port.bsattn_kernel.bsattn_ref
    # block-row 1 has no valid slot; block-row 2's only block lies above
    # the diagonal: rows 64..191 are fully masked and must be exactly 0
    ell_c = torch.tensor([[0, 2, 3], [1, 0, 0], [3, 3, 1], [2, 0, 3]],
                         dtype=torch.int32, device=dev)
    val_c = torch.tensor([[1, 0, 1], [0, 0, 0], [1, 0, 0], [1, 1, 1]],
                         dtype=torch.int32, device=dev)
    for dtype, tol in ((torch.float32, KERNEL_TOL), (torch.bfloat16,
                                                     BF16_TOL)):
        for d in (64, 256):
            q, k, v = (torch.from_numpy(rng.standard_normal(
                (n, s, d), dtype=np.float32)).to(dev, dtype)
                for n in (bh, bkv, bkv))
            worst, n_cases = 0.0, 0
            for (bq, bk), window, causal in itertools.product(
                    ((64, 64), (64, 32), (128, 64)), (0, 64), (True, False)):
                ell, val = (torch.from_numpy(a).to(dev)
                            for a in port.bsattn.banded_ell(s, bq, bk, window))
                kw = dict(block_q=bq, block_kv=bk, causal=causal,
                          window=window)
                worst = max(worst, check_close(
                    torch, f"K9 ragged {dtype} d={d} blocks=({bq}, {bk}) "
                    f"window={window} causal={causal}",
                    k9(ell, val, q, k, v, **kw).float(),
                    plain(ell, val, q, k, v, scale=1 / math.sqrt(d),
                          **kw).float(), tol))
                n_cases += 1
            kw = dict(block_q=64, block_kv=64, causal=True, window=0)
            got = k9(ell_c, val_c, q, k, v, **kw)
            worst = max(worst, check_close(
                torch, f"K9 custom pattern {dtype} d={d}", got.float(),
                plain(ell_c, val_c, q, k, v, scale=1 / math.sqrt(d),
                      **kw).float(), tol))
            if bool(got[:, 64:192].any()):
                raise AssertionError("K9: fully masked rows are not 0")
            log(f"ragged K9 {str(dtype).split('.')[-1]} S={s} GQA {bh}:{bkv} "
                f"d={d}: {n_cases} banded cases + custom pattern (fully "
                f"masked rows exactly 0), max_abs_err {worst:.3e} (tol "
                f"{tol})")


def normalized_dense(np, adj):
    """Â = D^-1/2 (A + I) D^-1/2, written out here for the oracle."""
    a = adj + np.eye(adj.shape[0], dtype=np.float32)
    dinv = 1.0 / np.sqrt(a.sum(1))
    return (a * dinv[:, None] * dinv[None, :]).astype(np.float32)


def oracle_logits(torch, a_dense, params, x):
    h = x
    n_layers = len(params["w"])
    for i, w in enumerate(params["w"]):
        h = a_dense @ (h @ w)
        if i < n_layers - 1:
            h = torch.relu(h)
    return h


def library_csr(torch, graph):
    """A as a torch CSR tensor, for the ``torch.sparse.mm`` yardstick."""
    rows, cols, vals = graph.adj.form("csr")
    n = graph.n_nodes
    crow = torch.zeros(n + 1, dtype=torch.int64, device=rows.device)
    crow[1:] = torch.cumsum(torch.bincount(rows.long(), minlength=n), 0)
    return torch.sparse_csr_tensor(crow, cols.long(), vals, size=(n, n))


def nbytes_of(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def kernel_rows(torch, port, graph, path):
    """Each SpMM kernel of this graph's path at the serving shapes: held to
    its plain version, timed beside it, ``torch.sparse.mm`` and its
    bound."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cfg = port.cfg
    relu = port.Epilogue(act="relu")
    if path == "ell":
        ell = graph.adj.form("ell")
        n_h, (bm, bn) = ell.shape[1], (ell.bm, ell.bn)
        slots = int(ell.nblocks.sum())
        fixed, n_out_rows = (ell.indices, ell.blocks), ell.shape[0]
        # the work this data needs: one multiply-add per nonzero of the
        # blocks and column of H (the dense tile work is printed apart)
        nnz = int((ell.blocks != 0).sum())
        fixed_bytes = nbytes_of(*fixed)
        shape = (f"nbr={ell.n_block_rows} W={ell.ell_width} block={bm}x{bn}"
                 f"; {nnz} nonzeros")
        plain = {"K1": port.ref.spmm_blockell_ref,
                 "K5": port.fused.spmm_blockell_epilogue_ref}
        specs = [("K5", cfg.hidden, relu), ("K1", cfg.n_classes, None)]
    else:
        sell = graph.adj.form("sell")
        n_h = sell.shape[1]  # K2/K6 take H's logical rows
        fixed = port.sell.sell_row_operands(sell)
        row_slot, row_nnz = fixed[:2]
        heavy = sell.tile_heavy_rows
        n_out_rows = row_slot.shape[0]
        nnz = int(row_nnz.sum())
        # what K2/K6 read: the row arrays and each nonzero's column and
        # value (padding slots are never read), then H and Y
        fixed_bytes = nbytes_of(row_slot, row_nnz, heavy) + nnz * (
            fixed[2].element_size() + fixed[3].element_size())
        counts = row_nnz.float()
        p99 = int(torch.quantile(counts[counts > 0], 0.99))
        shape = (f"rows={n_out_rows} ({sell.n_live_block_rows} live "
                 f"block-rows of {sell.bm}); {nnz} nonzeros; nonzeros per "
                 f"row: mean {float(counts.mean()):.1f}, p99 {p99}, largest "
                 f"{int(row_nnz.max())}; {heavy.shape[0]} rows above "
                 f"{port.heavy_nnz} get a CTA each")
        plain = {"K2": port.sell.spmm_sell_slots_ref,
                 "K6": port.fused.spmm_sell_epilogue_slots_ref}
        specs = [("K6", cfg.hidden, relu), ("K2", cfg.n_classes, None)]
    a_lib = library_csr(torch, graph)
    rows = {}
    for name, d, epi in specs:
        h = torch.randn(n_h, d, device=dev, generator=gen)
        args = (*fixed, h) if epi is None else (*fixed, h, None, None)
        kwargs = {} if epi is None else dict(epi=epi)
        kernel_kw = kwargs if path == "ell" else dict(kwargs,
                                                      heavy_rows=heavy)
        n_out = n_out_rows * d
        nbytes = fixed_bytes + nbytes_of(h) + n_out * 4
        if path == "ell":
            tile_flops = 2 * slots * bm * bn * d
            what = (f"{shape}; D={d}; dense tile work "
                    f"{tile_flops / 1e9:.2f} GFLOP, "
                    f"{tile_flops / PEAK_FP32_FLOP_PER_S * 1e3:.4f} ms at "
                    "the FP32 peak")
        else:
            what = f"{shape}; D={d}"
        rows[name] = measure(
            torch, name, lambda: port.wrappers[name](*args, **kernel_kw),
            lambda: plain[name](*args, **kwargs),
            lambda: torch.sparse.mm(a_lib, h[: graph.n_nodes]), nbytes,
            2 * nnz * d + (0 if epi is None else n_out),
            what + "; library: torch.sparse.mm")
        if path == "ell":
            blockell_moves(torch, port, ell, h, nnz, epi, name, args)
        if path == "sell":
            # what do the heaviest rows cost?  The same launch with every
            # row cut to the p99 count, so none is heavy (a diagnostic,
            # not a check)
            cap = min(p99, port.heavy_nnz)
            cut = (row_slot, torch.clamp(row_nnz, max=cap), *fixed[2:])
            cut_args = (*cut, *args[len(cut):])
            cut_ms = time_ms(torch, lambda: port.wrappers[name](
                *cut_args, **kwargs, heavy_rows=heavy[:0]))
            log(f"  {name} with every row cut to {cap} nonzeros (none "
                f"heavy): {cut_ms:.4f} ms")
    return rows


def blockell_moves(torch, port, ell, h, nnz, epi, name, args):
    """What K1/K5's design moves beside their byte bound, counted from the
    shapes (no device counter is read): the blocks once and H once through
    HBM, each slot's H tile from L2 into shared memory, each nonzero's H
    row from shared memory; and K5 on bf16 blocks and H."""
    nbr, w, bm, bn = ell.blocks.shape
    d = h.shape[1]
    hbm = nbytes_of(ell.indices, ell.blocks, h) + nbr * bm * d * 4
    l2 = nbr * w * bn * d * 4
    log(f"  {name} by its design (counted from the shapes, not measured): "
        f"{hbm / 1e9:.3f} GB through HBM (blocks once, H once, Y), "
        f"{l2 / 1e9:.3f} GB of H tiles staged from L2, "
        f"{nnz * d * 4 / 1e9:.3f} GB of H rows read from shared memory")
    if epi is not None:
        b16 = (args[0], args[1].bfloat16(), args[2].bfloat16()) + args[3:]
        ms = time_ms(torch, lambda: port.fused.spmm_blockell_epilogue_kernel(
            *b16, epi=epi))
        log(f"  {name} on bf16 blocks and H (half the block bytes; a "
            f"diagnostic): {ms:.4f} ms")
        del b16


# sell_row_ptr is gone from the port; a request that calls either builds
# tile data (or a row pointer and its host sync) per call
TILE_VIEW_HELPERS = ("sell_tile_blocks", "sell_row_ptr")


@contextlib.contextmanager
def count_calls(names):
    """Count calls of the port's functions ``names`` (every module of
    ``repro_torch`` that holds one, wrapped while the block runs)."""
    calls = dict.fromkeys(names, 0)
    patched = []

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    for mod_name, module in list(sys.modules.items()):
        if mod_name.split(".")[0] != "repro_torch":
            continue
        for name in names:
            fn = getattr(module, name, None)
            if fn is not None:
                patched.append((module, name, fn))
                setattr(module, name, counted(name, fn))
    try:
        yield calls
    finally:
        for module, name, fn in patched:
            setattr(module, name, fn)


def profile_request(torch, eng, x, label):
    """One more request under ``torch.profiler``: device time by kernel
    and the device's busy share of the request's wall time.  Returns the
    calls of ``TILE_VIEW_HELPERS`` the request made."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof, count_calls(TILE_VIEW_HELPERS) as calls:
        t0 = time.perf_counter()
        eng.infer(x)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    log(f"graph ({label}) profiled request: calls of the tile-view helpers "
        f"{calls}")
    log_device_time(prof, wall, f"graph ({label}) profile of one request")
    return calls


def log_device_time(prof, wall, what):
    """The device's busy share of ``wall`` ms and its largest items, from
    a ``torch.profiler`` run."""
    dev_ms = {}
    for ev in prof.key_averages():
        if str(ev.device_type).endswith("CUDA"):
            t = getattr(ev, "self_device_time_total", None)
            if t is None:
                t = getattr(ev, "self_cuda_time_total", 0)
            if t > 0:
                dev_ms[ev.key] = t / 1e3
    if not dev_ms:
        log(f"{what}: the profiler saw no device time (device busy share "
            "not measured)")
        return
    busy = sum(dev_ms.values())
    top = sorted(dev_ms.items(), key=lambda kv: -kv[1])[:8]
    log(f"{what}: wall {wall:.3f} ms under the profiler, device busy "
        f"{busy:.3f} ms ({100 * busy / wall:.1f} %); by device time: "
        + "; ".join(f"{k[:70]} {v:.3f} ms" for k, v in top))


def expected(port, per_call, calls):
    """Launch counts over every wrapper: ``per_call`` times ``calls``."""
    return {k: per_call.get(k, 0) * calls for k in port.wrappers}


def measure(torch, name, run, plain, library, nbytes, flops, what,
            close=None):
    """One kernel row: held to its plain version (by ``close(name, got,
    want)``, else ``check_close``), timed beside it and beside the library
    call (``library`` None: there is none), with the bound from ``nbytes``
    and ``flops``."""
    close = close or (lambda *a: check_close(torch, *a))
    err = close(name, run(), plain())
    row = dict(max_abs_err=err, ms=time_ms(torch, run),
               plain_ms=time_ms(torch, plain),
               library_ms=None if library is None else time_ms(torch, library))
    row["bound_ms"], row["bound_by"] = bound(nbytes, flops)
    lib = "no single PyTorch call" if library is None \
        else f"{row['library_ms']:.4f} ms"
    log(f"{name} [{what}]: max_abs_err {err:.3e} | kernel {row['ms']:.4f} "
        f"ms | plain {row['plain_ms']:.4f} ms | library {lib} | bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}: {nbytes / 1e9:.3f} "
        f"GB, {flops / 1e9:.3f} GFLOP)")
    return row


def serve_requests(torch, eng, xs):
    """Each request through ``eng.infer``, host clock around it plus a
    sync; returns the outputs and the latencies in ms."""
    outs, lat = [], []
    for x in xs:
        t0 = time.perf_counter()
        outs.append(eng.infer(x))
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    return outs, lat


def latency_text(lat, n):
    med = statistics.median(lat)
    p90 = sorted(lat)[min(len(lat) - 1, int(0.9 * len(lat)))]
    return (f"latency median {med:.3f} ms p90 {p90:.3f} ms (all: "
            f"{', '.join(f'{t:.3f}' for t in lat)}); {n / med * 1e3:.0f} "
            "nodes/s")


def hold_to_oracle(torch, label, outs, oracle, shape):
    """Every output finite, of ``shape`` and within ``oracle_tol`` of the
    oracle; returns (worst error, tightest tolerance, max|want|)."""
    worst, worst_tol, top = 0.0, float("inf"), 0.0
    for i, got in enumerate(outs):
        want = oracle(i)
        err = float((got - want).abs().max())
        tol = oracle_tol(want)
        if tuple(got.shape) != shape or not bool(torch.isfinite(got).all()) \
                or err > tol:
            raise AssertionError(f"graph ({label}) off the dense oracle: "
                                 f"max_abs_err {err:.3e} > {tol:.3e}")
        worst, worst_tol = max(worst, err), min(worst_tol, tol)
        top = max(top, float(want.abs().max()))
    return worst, worst_tol, top


def gcn_phase(torch, port, graph, a_dense, label, want_path, expect, xs):
    """GCN serving on one graph; returns its kernel rows with launches."""
    dev = torch.device(DEVICE)
    n = graph.n_nodes
    params = port.gnn.init_gcn(port.cfg, seed=SEED, device=DEVICE)
    eng = port.engine.GNNServingEngine(params, graph)
    report = eng.dispatch_report()
    log(f"graph ({label}) GCN plan {report['path']} ({report['reason']})")
    if eng.plan.path != want_path:
        raise AssertionError(f"graph ({label}) planned {eng.plan.path!r}, "
                             f"expected {want_path!r}")
    rows = kernel_rows(torch, port, graph, want_path)
    torch.cuda.synchronize()
    port.reset_counts()
    outs, lat = serve_requests(torch, eng, xs)
    counts = port.counts()
    log(f"graph ({label}) GCN launches over {REQUESTS} requests: {counts}")
    if counts != expected(port, expect, REQUESTS):
        raise AssertionError(f"graph ({label}) GCN launch counts {counts}, "
                             f"expected {expected(port, expect, REQUESTS)}")
    worst, worst_tol, top = hold_to_oracle(
        torch, label, outs,
        lambda i: oracle_logits(torch, a_dense, params,
                                torch.from_numpy(xs[i]).to(dev)),
        (n, port.cfg.n_classes))
    log(f"graph ({label}) GCN serving: logits vs dense f32 oracle (TF32 "
        f"off) max_abs_err {worst:.3e}, max|logit| {top:.3e}, tightest tol "
        f"{worst_tol:.3e} ({ORACLE_RTOL} x max|logit| + {ORACLE_ATOL}); "
        + latency_text(lat, n))

    unfused = port.engine.GNNServingEngine(
        params, graph, port.engine.GNNServeConfig(fuse=False))
    port.reset_counts()
    got = unfused.infer(xs[0])
    torch.cuda.synchronize()
    ucounts = port.counts()
    plain_kernel = "K1" if want_path == "ell" else "K2"
    err = float((got - outs[0]).abs().max())
    log(f"graph ({label}) GCN fuse=False: launches {ucounts}, max_abs_err "
        f"vs fused {err:.3e}")
    if ucounts != expected(port, {plain_kernel: 3}, 1) \
            or err > oracle_tol(outs[0]):
        raise AssertionError(f"graph ({label}) GCN fuse=False run off: "
                             f"{ucounts}, err {err:.3e}")
    calls = profile_request(torch, eng, xs[0], f"{label}, GCN")
    if any(calls.values()):
        raise AssertionError(f"graph ({label}) GCN request built tile data "
                             f"or a row pointer: {calls}")
    log(f"graph ({label}) GCN request: no sell_tile_blocks gather and no "
        "row-pointer sync")
    for name in rows:
        rows[name]["launches"] = counts[name]
    return rows


def sddmm_phase(torch, port, graph, a_dense, label, want_path):
    """The SDDMM entry point at K = 2 on one graph; returns its kernel
    row (K3 on the ell path, K4 on the sell path) with launches."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    n, k = graph.n_nodes, 2
    b = torch.randn(n, k, device=dev, generator=gen)
    c = torch.randn(k, n, device=dev, generator=gen)
    paths = port.paths
    a_lib = library_csr(torch, graph)
    sampled = lambda: torch.sparse.sampled_addmm(  # noqa: E731
        a_lib, b, c, beta=0.0)
    # the kernel at the operands the path hands it (autodiff.sample_exec,
    # autodiff.sddmm_values)
    if want_path == "ell":
        name, plain = "K3", port.sddmm_ref.sddmm_blockcoo_ref
        coo = paths.ell_to_coo(graph.adj.form("ell"))
        bp = paths.pad_rows(b, coo.shape[0])
        cp = paths.pad_cols(c, coo.shape[1]).contiguous()
        nnz = coo.nnzb * coo.bm * coo.bn  # every cell of every tile
        tile_bytes = nnz * 4  # the f32 output tiles
        nbytes = nbytes_of(coo.rows, coo.cols, bp, cp) + tile_bytes
        # the launch sample_exec makes (no mask, every cell sampled), on
        # a line of its own beside sampled_addmm, the same function
        bare = (coo.rows, coo.cols, None, bp, cp)
        kw = dict(block=(coo.bm, coo.bn), out_dtype=torch.float32)
        measure(torch, "K3 no mask (sample_exec's launch)",
                lambda: port.wrappers[name](*bare, **kw),
                lambda: plain(*bare, **kw), sampled, nbytes, 2 * k * nnz,
                f"nnzb={coo.nnzb} blocks {coo.bm}x{coo.bn} K={k}; {nnz} "
                "sampled entries; library: sampled_addmm")
        del bare
        # the kernel row: the launch the entry point makes, A's values as
        # the mask, read once (8 bytes an element); no single PyTorch call
        # computes the weighted product
        args = (coo.rows, coo.cols, coo.blocks, bp, cp)
        row = measure(torch, name, lambda: port.wrappers[name](*args),
                      lambda: plain(*args), None,
                      nbytes + nbytes_of(coo.blocks), 2 * k * nnz + nnz,
                      f"nnzb={coo.nnzb} blocks {coo.bm}x{coo.bn} K={k}; "
                      f"{nnz} sampled entries; A's values read as the mask "
                      "(the sddmm entry point's launch)")
    else:
        name, plain = "K4", port.sddmm_sell.sddmm_sell_slots_ref
        sell = graph.adj.form("sell")
        args = (*port.sddmm_sell.sddmm_sell_operands(sell), b, c)
        row_slot, row_nnz, perm, slot_cols = args[:4]
        nnz = int(row_nnz.sum())
        # what K4 reads and writes: the row arrays, each nonzero's column,
        # B, C and the slot output (padding slots are never read)
        nbytes = nbytes_of(row_slot, row_nnz, perm, b, c) \
            + nnz * slot_cols.element_size() + sell.n_slots * 4
        row = measure(
            torch, name, lambda: port.wrappers[name](*args),
            lambda: plain(*args), sampled, nbytes, 2 * k * nnz,
            f"rows={row_slot.shape[0]} slots={sell.n_slots} nonzeros={nnz} "
            f"K={k}; sampled entries {nnz}; library: sampled_addmm")
    if want_path == "sell":
        got = port.wrappers[name](*args)
        err = check_close(torch, "K4 vs the tile kernel", got,
                          sell_tile_path(torch, port, sell, b, c),
                          TILE_PATH_TOL)
        # sampling reads no tile view: a packing without one gives the same
        bare = dataclasses.replace(sell, tile_slot_map=None,
                                   slot_tile_pos=None)
        check_close(torch, "sample_sell_blocked without the tile view",
                    port.sddmm_sell.sample_sell_blocked(bare, b, c), got,
                    TILE_PATH_TOL)
        log(f"  K4 equals the tile kernel gathered to slots (max_abs_err "
            f"{err:.3e}); sample_sell_blocked reads neither tile_slot_map "
            "nor slot_tile_pos")
        del got, bare
    del args

    cand = port.gnn.graph_candidates(graph.adj)
    torch.cuda.synchronize()
    prior_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    port.reset_counts()
    s = port.ops.sddmm(graph.adj, b, c, candidates=cand)
    torch.cuda.synchronize()
    counts = port.counts()
    extra = torch.cuda.max_memory_allocated() - base
    plan = port.dispatcher.last_plan("sddmm")
    log(f"graph ({label}) SDDMM K={k}: plan {plan.path} ({plan.reason}); "
        f"launches {counts}; peak device memory beyond the inputs "
        f"{extra / 2**20:.1f} MiB")
    if plan.path != want_path or s.formats != (want_path,) \
            or counts != expected(port, {name: 1}, 1):
        raise AssertionError(f"graph ({label}) SDDMM ran {plan.path!r} with "
                             f"{counts}, expected {want_path!r} and {name} x1")
    if want_path == "sell" and extra > SDDMM_SELL_EXTRA_BYTES:
        raise AssertionError(f"graph ({label}) SDDMM allocated "
                             f"{extra / 2**20:.1f} MiB: a tile mask or tile "
                             "output was built")
    if want_path == "ell" and extra > tile_bytes + SDDMM_ELL_SLACK_BYTES:
        raise AssertionError(f"graph ({label}) SDDMM allocated "
                             f"{extra / 2**20:.1f} MiB beyond the "
                             f"{tile_bytes / 2**20:.0f} MiB of its output "
                             "tiles: a mask or a second tile array was built")
    worst, tol, top = hold_to_oracle(
        torch, label, [s.densify()], lambda _: a_dense * (b @ c), (n, n))
    del s
    lat = []
    for _ in range(5):
        t0 = time.perf_counter()
        port.ops.sddmm(graph.adj, b, c, candidates=cand)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    log(f"graph ({label}) SDDMM values vs dense f32 oracle A ⊙ (B C): "
        f"max_abs_err {worst:.3e}, max|value| {top:.3e}, tol {tol:.3e}; "
        f"entry point median {statistics.median(lat):.3f} ms over 5 calls "
        f"(all: {', '.join(f'{t:.3f}' for t in lat)})")
    row["launches"] = counts[name]
    return {name: row}, prior_peak


def gat_oracle(torch, pattern, params, x, chunk=2048):
    """Dense f32 GAT (the counterpart of ``fused_attn_dense``, elu between
    layers), row chunk by row chunk: scores s_src[i] + s_dst[j], leaky
    relu 0.2, a softmax over each row's edges (exactly 0 off the
    pattern), then the weighted sum of h."""
    h = x
    n_layers = len(params["w"])
    for i, w in enumerate(params["w"]):
        h = h @ w
        s_src = (h @ params["a_src"][i])[:, 0]
        s_dst = (h @ params["a_dst"][i])[:, 0]
        out = torch.empty_like(h)
        for r0 in range(0, h.shape[0], chunk):
            mask = pattern[r0:r0 + chunk]
            e = torch.nn.functional.leaky_relu(
                s_src[r0:r0 + chunk, None] + s_dst[None, :], 0.2)
            e = torch.where(mask, e, -1e30)
            p = torch.where(mask, torch.exp(e - e.amax(1, keepdim=True)),
                            0.0)
            out[r0:r0 + chunk] = (p / p.sum(1, keepdim=True).clamp_min(
                1e-12)) @ h
        h = torch.nn.functional.elu(out) if i < n_layers - 1 else out
    return h


def gat_phase(torch, port, graph, pattern, label, want_path, xs):
    """GAT serving on one graph; returns its kernel row (K7 on the ell
    path, K8 on the sell path) with launches."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    n, cfg = graph.n_nodes, port.cfg
    params = port.gnn.init_gat(cfg, seed=SEED, device=DEVICE)
    eng = port.engine.GNNServingEngine(
        params, graph, port.engine.GNNServeConfig(model="gat"))
    report = eng.dispatch_report()
    log(f"graph ({label}) GAT plan {report['plan_op']} -> {report['path']} "
        f"({report['reason']})")
    if (eng.plan.path, eng.plan.op) != (want_path, "fused_attn"):
        raise AssertionError(f"graph ({label}) GAT planned {eng.plan.op} -> "
                             f"{eng.plan.path!r}, expected {want_path!r}")
    att, dk, d = port.attention, 2, cfg.hidden
    kw = dict(act="leaky_relu", slope=0.2)
    if want_path == "ell":
        name, plain = "K7", att.fused_attn_blockell_ref
        ell = graph.adj.form("ell")
        topo, n_rows, n_keys = (ell.indices, ell.blocks), ell.shape[0], \
            ell.shape[1]
        nnz = int((ell.blocks != 0).sum())
        # K7's bound: the blocks once (and the small operands once)
        topo_bytes = nbytes_of(*topo)
        kernel_kw = kw
        what = f"nbr={ell.n_block_rows} W={ell.ell_width} block=" \
            f"{ell.bm}x{ell.bn} dk={dk}"
    else:
        name, plain = "K8", att.fused_attn_sell_rows_ref
        sell = graph.adj.form("sell")
        topo = att.fused_attn_sell_operands(sell)
        row_slot, row_nnz, slot_cols, slot_vals = topo
        heavy = sell.tile_heavy_rows
        n_rows, n_keys = row_slot.shape[0], n  # kT and V: logical rows
        nnz = int(row_nnz.sum())
        # K8's bound: the row arrays and each nonzero's column and value
        # (padding slots are never read), then q, kT, V and Y
        topo_bytes = nbytes_of(row_slot, row_nnz, heavy) + nnz * (
            slot_cols.element_size() + slot_vals.element_size())
        kernel_kw = dict(kw, heavy_rows=heavy)
        what = (f"rows={n_rows} ({sell.n_live_block_rows} live block-rows "
                f"of {sell.bm}), {heavy.shape[0]} rows above "
                f"{port.heavy_nnz} a CTA each; dk={dk}")
    row = None
    for width in (d, cfg.n_classes):  # the hidden layers' D, the last's
        args = topo + (torch.randn(n_rows, dk, device=dev, generator=gen),
                       torch.randn(dk, n_keys, device=dev, generator=gen),
                       torch.randn(n_keys, width, device=dev, generator=gen))
        nbytes = topo_bytes + nbytes_of(*args[len(topo):]) \
            + n_rows * width * 4  # the output
        # per nonzero: dk + D multiply-adds, and the act, max, exp and sum
        flops = nnz * (2 * dk + 2 * width + 4)
        timed = measure(
            torch, f"{name} D={width}",
            lambda: port.wrappers[name](*args, **kernel_kw),
            lambda: plain(*args, **kw), None, nbytes, flops,
            f"{what}; D={width}; nonzeros {nnz}")
        row = row or timed  # the kernel row: D = hidden, ×2 a request
        del args

    torch.cuda.synchronize()
    port.reset_counts()
    outs, lat = serve_requests(torch, eng, xs)
    counts = port.counts()
    log(f"graph ({label}) GAT launches over {REQUESTS} requests: {counts}")
    if counts != expected(port, {name: 3}, REQUESTS):
        raise AssertionError(f"graph ({label}) GAT launch counts {counts}, "
                             f"expected {expected(port, {name: 3}, REQUESTS)}")
    worst, worst_tol, top = hold_to_oracle(
        torch, label, outs,
        lambda i: gat_oracle(torch, pattern, params,
                             torch.from_numpy(xs[i]).to(dev)),
        (n, cfg.n_classes))
    log(f"graph ({label}) GAT serving: logits vs dense f32 masked-softmax "
        f"oracle (TF32 off) max_abs_err {worst:.3e}, max|logit| {top:.3e}, "
        f"tightest tol {worst_tol:.3e} ({ORACLE_RTOL} x max|logit| + "
        f"{ORACLE_ATOL}); " + latency_text(lat, n))

    # fuse=False beside the fused request, in turns, so both meet the same
    # host; the unfused requests launch no kernel
    unfused = port.engine.GNNServingEngine(
        params, graph, port.engine.GNNServeConfig(model="gat", fuse=False))
    port.reset_counts()
    flat, ulat, err = [], [], 0.0
    for x in xs[:TURNS]:
        (fused_out,), (t_fused,) = serve_requests(torch, eng, [x])
        (got,), (t_unfused,) = serve_requests(torch, unfused, [x])
        flat.append(t_fused)
        ulat.append(t_unfused)
        err = max(err, float((got - fused_out).abs().max()))
    ucounts = port.counts()
    log(f"graph ({label}) GAT fuse=False (paths "
        f"{sorted({p.path for p in port.dispatcher.dispatch_log()[-6:]})}) "
        f"in turns with the fused request, {TURNS} each: launches "
        f"{ucounts}, max_abs_err vs fused {err:.3e}")
    if ucounts != expected(port, {name: 3}, TURNS) \
            or err > oracle_tol(outs[0]):
        raise AssertionError(f"graph ({label}) GAT fuse=False run off: "
                             f"{ucounts}, err {err:.3e}")
    log(f"graph ({label}) GAT request median, in turns: fused "
        f"{statistics.median(flat):.3f} ms, unfused "
        f"{statistics.median(ulat):.3f} ms (fused: "
        f"{', '.join(f'{t:.3f}' for t in flat)}; unfused: "
        f"{', '.join(f'{t:.3f}' for t in ulat)})")
    # the unfused request's time and peak memory beyond its inputs with
    # A's dense array memoized (SparseMatrix.densify), and with the memo
    # emptied first, which is what every request paid before the memo
    seen = []
    for memo in ("memoized", "emptied first"):
        if memo != "memoized":
            port.matrix._DENSE_MEMO.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        (_,), (t,) = serve_requests(torch, unfused, [xs[0]])
        seen.append(f"{memo}: {t:.3f} ms, peak beyond its inputs "
                    f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.3f}"
                    " GiB")
    log(f"graph ({label}) GAT fuse=False request, densify memo " +
        "; ".join(seen))
    calls = profile_request(torch, eng, xs[0], f"{label}, GAT")
    if any(calls.values()):
        raise AssertionError(f"graph ({label}) GAT request built tile data "
                             f"or a row pointer: {calls}")
    row["launches"] = counts[name]
    return {name: row}


def oracle_grads(torch, port, kind, a_dense, pattern, params, x, labels):
    """Loss and parameter gradients of the dense f32 oracle (TF32 off):
    ``oracle_logits`` for GCN, ``gat_oracle`` (chunked) for GAT, through
    torch.autograd on the card; returns them with the oracle's peak device
    memory beyond what was allocated before it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    own = {k: [p.detach().clone().requires_grad_(True) for p in v]
           for k, v in params.items()}
    logits = oracle_logits(torch, a_dense, own, x) if kind == "gcn" \
        else gat_oracle(torch, pattern, own, x)
    loss = torch.nn.functional.cross_entropy(logits, labels)
    grads = torch.autograd.grad(
        loss, [p for _, p in port.train.named_parameters(own)])
    torch.cuda.synchronize()
    return loss.item(), grads, torch.cuda.max_memory_allocated() - base


def train_phase(torch, np, port, graph, adj, x_np, label, want_path):
    """Phase 5 on one graph: GCN and GAT training steps through
    ``repro_torch.train.gnn``; returns the kernel launches of the counted
    steps."""
    dev = torch.device(DEVICE)
    n, cfg = graph.n_nodes, port.cfg
    x = torch.from_numpy(x_np).to(dev)
    labels = torch.from_numpy(port.train.planted_labels(n, cfg.n_classes)) \
        .to(dev)
    a_dense = torch.from_numpy(normalized_dense(np, adj)).to(dev)
    pattern = a_dense != 0
    launches = dict.fromkeys(port.wrappers, 0)
    for kind in ("gcn", "gat"):
        what = f"graph ({label}) {kind.upper()} training"
        per_step = TRAIN_LAUNCHES[want_path, kind]
        params = port.train.init_params(kind, cfg, seed=SEED, device=DEVICE)
        kw = dict(kind=kind)
        # one step held to the dense oracle
        torch.cuda.synchronize()
        port.reset_counts()
        loss0, acc0, grads = port.train.loss_and_grads(params, graph, x,
                                                       labels, **kw)
        torch.cuda.synchronize()
        counts = port.counts()
        if counts != expected(port, per_step, 1):
            raise AssertionError(f"{what}: launches {counts} in the first "
                                 f"step, expected {expected(port, per_step, 1)}")
        want_loss, want_grads, oracle_peak = oracle_grads(
            torch, port, kind, a_dense, pattern, params, x, labels)
        errs, bad = [], []
        for (name, got), want in zip(port.train.named_parameters(grads),
                                     want_grads):
            scale = float(want.abs().max())
            err = float((got - want).abs().max())
            tol = ORACLE_RTOL * scale + GRAD_ATOL
            zero = scale <= GRAD_ATOL
            errs.append(f"{name} {err:.2e} (max|want| {scale:.3e}"
                        + (", zero at f32 resolution)" if zero else ")"))
            if got.shape != want.shape or not bool(torch.isfinite(got).all())\
                    or not err <= tol:
                bad.append(f"d{name} max_abs_err {err:.3e} > {tol:.3e}")
            if not zero and tol > GRAD_TOL_SHARE * scale:
                bad.append(f"d{name}: tol {tol:.3e} is over {GRAD_TOL_SHARE}"
                           f" of max|want| {scale:.3e}")
        log(f"{what}: step 1 launches {counts}; loss {float(loss0):.8f} "
            f"(oracle {want_loss:.8f}), acc {float(acc0):.4f}; gradients vs "
            f"the dense f32 autograd oracle (TF32 off; each within "
            f"{ORACLE_RTOL} x max|want| + {GRAD_ATOL}): " + ", ".join(errs)
            + f"; the oracle's peak device memory {oracle_peak / 2**30:.2f} "
            "GiB")
        if bad:
            raise AssertionError(f"{what}: off the dense oracle: "
                                 + ", ".join(bad))
        if abs(float(loss0) - want_loss) > ORACLE_RTOL * abs(want_loss):
            raise AssertionError(f"{what}: loss {float(loss0)} vs the "
                                 f"oracle's {want_loss}")
        same_bits_again(torch, port, params, graph, x, labels, kind, grads,
                        per_step, what)
        if (want_path, kind) == ("ell", "gat"):
            every_cell_grads_equal(torch, port, params, graph, x, labels,
                                   what)
        port.train.sgd_update(params, grads, TRAIN_LR)
        del grads, want_grads
        for k, v in counts.items():
            launches[k] += v

        # the timed steps, each its own peak
        losses, times, peak = [float(loss0)], [], 0
        port.reset_counts()
        for _ in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            loss, _ = port.train.train_step(params, graph, x, labels,
                                            lr=TRAIN_LR, **kw)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            peak = max(peak, torch.cuda.max_memory_allocated() - base)
            losses.append(float(loss))
        counts = port.counts()
        if counts != expected(port, per_step, TRAIN_STEPS):
            raise AssertionError(
                f"{what}: launches {counts} over {TRAIN_STEPS} steps, "
                f"expected {expected(port, per_step, TRAIN_STEPS)}")
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{what}: a loss is not finite: {losses}")
        if (want_path, kind) not in LOSS_FLAT and not losses[-1] < losses[0]:
            raise AssertionError(f"{what}: the loss did not fall: {losses}")
        for k, v in counts.items():
            launches[k] += v
        med = statistics.median(times)
        log(f"{what}: {TRAIN_STEPS} steps, launches {counts}; step median "
            f"{med:.3f} ms (all: {', '.join(f'{t:.3f}' for t in times)}); "
            f"{n / med * 1e3:.0f} nodes/s; peak device memory of a step "
            f"beyond its inputs {peak / 2**30:.2f} GiB; loss "
            + " -> ".join(f"{v:.10f}" for v in losses))
        profile_step(torch, port, lambda: port.train.train_step(
            params, graph, x, labels, lr=TRAIN_LR, **kw), per_step, what)
        del params
        torch.cuda.empty_cache()
    return launches


def same_bits_again(torch, port, params, graph, x, labels, kind, grads,
                    per_step, what):
    """The step held to the oracle, run once more without
    ``torch.use_deterministic_algorithms``: every parameter's gradient
    equal, per ``torch.equal`` (every kernel of the step, the transposed
    products included, sums in one fixed order).  Its launches are
    checked, not counted."""
    if torch.are_deterministic_algorithms_enabled():
        raise AssertionError(f"{what}: deterministic mode is on")
    port.reset_counts()
    again = port.train.loss_and_grads(params, graph, x, labels,
                                      kind=kind)[2]
    torch.cuda.synchronize()
    if port.counts() != expected(port, per_step, 1):
        raise AssertionError(f"{what}: the second run launched "
                             f"{port.counts()}")
    named = port.train.named_parameters
    bad = [name for (name, g), (_, w) in zip(named(again), named(grads))
           if not torch.equal(g, w)]
    if bad:
        raise AssertionError(f"{what}: a second run of the step gave other "
                             f"gradient bits, without deterministic mode: "
                             f"{bad}")
    log(f"{what}: the step run twice without deterministic mode gives "
        f"equal gradients, torch.equal, all {len(named(grads))} parameters")


def every_cell_grads_equal(torch, port, params, graph, x, labels, what):
    """The first step's gradients through the pattern route and through
    the every-cell route (``PATTERN_MIN_K`` out of reach: every sampled
    product on K3 without a mask), equal per ``torch.equal``: without
    deterministic mode (every transposed product runs N1), and again
    under ``torch.use_deterministic_algorithms`` (warnings only).  Their
    launches are checked, not counted."""
    autodiff = port.autodiff
    min_k = autodiff.PATTERN_MIN_K
    expect = {"pattern": expected(port, TRAIN_LAUNCHES["ell", "gat"], 1),
              "every cell": expected(port, {"K7": 3, "K3": 6, "K1": 3,
                                            "N1": 6}, 1)}
    was = torch.are_deterministic_algorithms_enabled()
    grads = {}
    try:
        for mode in (False, True):
            torch.use_deterministic_algorithms(mode, warn_only=True)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                for route, k in (("pattern", min_k),
                                 ("every cell", 1 << 30)):
                    autodiff.PATTERN_MIN_K = k
                    port.reset_counts()
                    grads[route, mode] = port.train.loss_and_grads(
                        params, graph, x, labels, kind="gat")[2]
                    torch.cuda.synchronize()
                    if port.counts() != expect[route]:
                        raise AssertionError(f"{what}: the {route} route "
                                             f"launched {port.counts()}")
    finally:
        autodiff.PATTERN_MIN_K = min_k
        torch.use_deterministic_algorithms(was)
    named = port.train.named_parameters
    want = named(grads["pattern", False])
    bad = [(key, name) for key in grads
           for (name, g), (_, w) in zip(named(grads[key]), want)
           if not torch.equal(g, w)]
    if bad:
        raise AssertionError(f"{what}: the routes' gradients differ: {bad}")
    log(f"{what}: first-step gradients of the pattern route (K3p x3 + K3 "
        "x3) equal those of the every-cell route (K3 x6), torch.equal, "
        "every parameter, without and with deterministic mode")


def profile_step(torch, port, step, per_step, what):
    """One more training step under ``torch.profiler`` (its launches
    checked, not counted)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    port.reset_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    if port.counts() != expected(port, per_step, 1):
        raise AssertionError(f"{what}: the profiled step launched "
                             f"{port.counts()}")
    log_device_time(prof, wall, f"{what}, profile of one step")


def transposed_csr(torch, graph):
    """Aᵀ as a torch CSR tensor, for the ``torch.sparse.mm`` yardstick."""
    rows, cols, vals = graph.adj.form("csr")
    n = graph.n_nodes
    return torch.sparse_coo_tensor(
        torch.stack([cols.long(), rows.long()]), vals,
        (n, n)).coalesce().to_sparse_csr()


def pattern_rows(torch, port, graph, a_lib, gen):
    """On (a): K3 at the pattern (K3p) at K = 128 as the step launches it
    (dα = ḡ Vᵀ: B = ḡ, C = Vᵀ a transposed view, the matrix's memoized
    occupancy), held to its plain version and timed beside it, beside
    ``sampled_addmm`` and beside its bound counted from the nonzeros; K3's
    staged kernel on every cell at the same K (the route it replaced: C
    made contiguous, as ``sample_exec`` hands it over), the two equal at
    every nonzero; then both routes at K = 2, 4, 8 and 16 (K3's streaming
    kernel there), which set ``PATTERN_MIN_K``.  Returns the rows by
    name."""
    dev = torch.device(DEVICE)
    n, k = graph.n_nodes, port.cfg.hidden
    paths = port.paths
    coo = paths.ell_to_coo(graph.adj.form("ell"))
    occ = graph.adj.tile_occupancy()
    keep = coo.blocks != 0
    nnz = int(keep.sum())
    cells = coo.nnzb * coo.bm * coo.bn  # every cell of every tile
    kw = dict(block=(coo.bm, coo.bn), out_dtype=torch.float32)
    rows, lines = {}, []
    for kk in (k, 2, 4, 8, 16):
        b = torch.randn(n, kk, device=dev, generator=gen)
        v = torch.randn(n, kk, device=dev, generator=gen)
        bp = paths.pad_rows(b, coo.shape[0])
        c = paths.pad_rows(v, coo.shape[1]).T  # a view, as the step's
        cp = c.contiguous()
        pat = (coo.rows, coo.cols, occ, bp, c)
        bare = (coo.rows, coo.cols, None, bp, cp)
        run = lambda: port.wrappers["K3p"](*pat, **kw)  # noqa: E731
        every = lambda: port.wrappers["K3"](*bare, **kw)  # noqa: E731
        hold_pattern(torch, f"K3p at K={kk}", run(), every(), keep)
        if kk != k:
            ms, every_ms = time_ms(torch, run), time_ms(torch, every)
            lines.append(f"K={kk}: K3p {ms:.4f} ms, K3 streaming (every "
                         f"cell) {every_ms:.4f} ms")
            rows[f"K3p K={kk}"] = dict(ms=ms, every_cell_ms=every_ms)
            continue
        sampled = lambda: torch.sparse.sampled_addmm(  # noqa: E731
            a_lib, b, v.T, beta=0.0)
        # what the work needs: the tile output written whole, the
        # occupancy, B and C once; 2 K FLOP per nonzero
        rows["K3p"] = measure(
            torch, f"K3p at K={kk} (dα = ḡ Vᵀ at the pattern)", run,
            lambda: port.sddmm_ref.sddmm_pattern_ref(*pat, **kw), sampled,
            nbytes_of(coo.rows, coo.cols, occ, bp, cp) + cells * 4,
            2 * kk * nnz, f"nnzb={coo.nnzb} blocks {coo.bm}x{coo.bn} "
            f"K={kk}; {nnz} nonzeros sampled, the rest written 0; "
            "library: sampled_addmm")
        rows["K3"] = measure(
            torch, f"K3 at K={kk} (the staged kernel, every cell)", every,
            lambda: port.sddmm_ref.sddmm_blockcoo_ref(*bare, **kw), sampled,
            nbytes_of(coo.rows, coo.cols, bp, cp) + cells * 4,
            2 * kk * cells, f"nnzb={coo.nnzb} blocks {coo.bm}x{coo.bn} "
            f"K={kk}; {cells} sampled entries (no mask); library: "
            "sampled_addmm")
        # the library call on a row-major C, the layout sample_exec hands
        # the staged kernel (C made contiguous)
        rows["K3p"]["library_row_major_c_ms"] = time_ms(
            torch, lambda: torch.sparse.sampled_addmm(a_lib, b, cp[:, :n],
                                                      beta=0.0))
        log(f"  K3p at K={kk}: {rows['K3']['ms'] / rows['K3p']['ms']:.2f}x "
            f"faster than the staged kernel; sampled_addmm takes "
            f"{rows['K3p']['library_ms'] / rows['K3p']['ms']:.2f}x its time "
            f"on C = Vᵀ (a view, the step's operand) and "
            f"{rows['K3p']['library_row_major_c_ms'] / rows['K3p']['ms']:.2f}"
            f"x on C row-major ({rows['K3p']['library_row_major_c_ms']:.4f} "
            f"ms); {rows['K3p']['ms'] / rows['K3p']['bound_ms']:.2f}x its "
            f"bound; equal to the staged kernel at all {nnz} nonzeros")
    log("K3p against K3's streaming kernel, each equal to it at every "
        "nonzero (the step samples at PATTERN_MIN_K = "
        f"{port.autodiff.PATTERN_MIN_K} and up at the pattern): "
        + "; ".join(lines))
    return rows


def backward_rows(torch, port, graph, want_path):
    """The kernels at the shapes a training step gives them, each held to
    its plain version beside its bound and its library call: the SDDMM
    (K3p / K4) at K = 128 (dα = ḡ Vᵀ), the SpMM (K1 / K2) at D = 2 (dq)
    and the transposed SpMM (``transposed_rows``).  Returns the rows by
    name."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    n, k, d = graph.n_nodes, port.cfg.hidden, 2
    paths = port.paths
    a_lib = library_csr(torch, graph)
    b = torch.randn(n, k, device=dev, generator=gen)
    c = torch.randn(n, k, device=dev, generator=gen).T.contiguous()
    h2 = torch.randn(n, d, device=dev, generator=gen)
    sampled = lambda: torch.sparse.sampled_addmm(  # noqa: E731
        a_lib, b, c, beta=0.0)
    rows = {}
    if want_path == "ell":
        ell = graph.adj.form("ell")
        rows.update(pattern_rows(torch, port, graph, a_lib, gen))
        hp = paths.pad_rows(h2, ell.shape[1])
        args = (ell.indices, ell.blocks, hp)
        nnz = int((ell.blocks != 0).sum())
        rows["K1"] = measure(
            torch, "K1 at D=2 (dq)", lambda: port.wrappers["K1"](*args),
            lambda: port.ref.spmm_blockell_ref(*args),
            lambda: torch.sparse.mm(a_lib, h2),
            nbytes_of(*args) + ell.shape[0] * d * 4, 2 * nnz * d,
            f"nbr={ell.n_block_rows} W={ell.ell_width} D={d}; {nnz} "
            "nonzeros; library: torch.sparse.mm")
        del args, hp
    else:
        sell = graph.adj.form("sell")
        args = (*port.sddmm_sell.sddmm_sell_operands(sell), b, c)
        row_slot, row_nnz, perm, slot_cols = args[:4]
        nnz = int(row_nnz.sum())
        rows["K4"] = measure(
            torch, "K4 at K=128 (dα = ḡ Vᵀ)",
            lambda: port.wrappers["K4"](*args),
            lambda: port.sddmm_sell.sddmm_sell_slots_ref(*args), sampled,
            nbytes_of(row_slot, row_nnz, perm, b, c)
            + nnz * slot_cols.element_size() + sell.n_slots * 4,
            2 * k * nnz, f"rows={row_slot.shape[0]} nonzeros={nnz} K={k}; "
            "library: sampled_addmm")
        ops = (*port.sell.sell_row_operands(sell), h2)
        heavy = sell.tile_heavy_rows
        rows["K2"] = measure(
            torch, "K2 at D=2 (dq)",
            lambda: port.wrappers["K2"](*ops, heavy_rows=heavy),
            lambda: port.sell.spmm_sell_slots_ref(*ops),
            lambda: torch.sparse.mm(a_lib, h2),
            nbytes_of(ops[0], ops[1], heavy, h2) + nnz * (
                ops[2].element_size() + ops[3].element_size())
            + ops[0].shape[0] * d * 4, 2 * nnz * d,
            f"rows={ops[0].shape[0]} nonzeros={nnz} D={d}; library: "
            "torch.sparse.mm")
        del args, ops
    rows.update(transposed_rows(torch, port, graph, want_path, gen))
    return rows


def transposed_rows(torch, port, graph, want_path, gen):
    """The transposed SpMM at the step's widths, D = 128 (dH, dV) and
    D = 2 (dk): on (a) N1, held to its plain version; on (b) K2 over Aᵀ's
    row view (with the per-call gather of the values), held to K2's plain
    version; each beside its bound, ``torch.sparse.mm`` on a CSR of Aᵀ
    and the plain route it replaced (``einsum`` + ``index_add_`` on the
    transposed Block-COO, or the element route).  Returns the rows: "N1"
    at D = 128 on (a), "N1 D=2", "K2 Aᵀ D=128", "K2 Aᵀ D=2"."""
    dev = torch.device(DEVICE)
    n, nnz = graph.n_nodes, graph.stats.nnz
    paths, tr = port.paths, port.transposed
    lib_t = transposed_csr(torch, graph)
    rows, at = {}, graph.adj.T
    for d in (port.cfg.hidden, 2):
        g = torch.randn(n, d, device=dev, generator=gen)
        out_bytes = n * d * 4
        library = lambda: torch.sparse.mm(lib_t, g)  # noqa: E731
        if want_path == "ell":
            ell = graph.adj.form("ell")
            ops = (*tr.blockell_columns(ell), ell.blocks,
                   paths.pad_rows(g, ell.shape[0]))
            name = "N1" if d == port.cfg.hidden else f"N1 D={d}"
            row = measure(
                torch, f"N1 at D={d} (Aᵀ ḡ on A's Block-ELL blocks)",
                lambda: port.wrappers["N1"](*ops),
                lambda: port.ref.spmm_blockell_t_ref(*ops), library,
                nbytes_of(*ops) + out_bytes, 2 * nnz * d,
                f"nbc={ops[0].shape[0] - 1} list entries "
                f"{ops[1].shape[0]} blocks {ell.bm}x{ell.bn} D={d}; {nnz} "
                "nonzeros; library: torch.sparse.mm on a CSR of Aᵀ",
                close=lambda *a: transposed_sums_close(torch, port, *a,
                                                       ops))
            coo = at.form("coo")
            replaced = lambda: paths.spmm_coo(  # noqa: E731
                coo, paths.pad_rows(g, coo.shape[1]))
            old = "einsum + index_add_ on the transposed Block-COO"
        else:
            sell = graph.adj.form("sell")
            row_slot, row_nnz, cols, perm, heavy = tr.sell_t_operands(sell)
            ops = (row_slot, row_nnz, cols, sell.slot_vals[perm], g)
            name = f"K2 Aᵀ D={d}"
            row = measure(
                torch, f"K2 over Aᵀ's row view at D={d} (with the gather "
                "of the values)", lambda: tr.spmm_sell_t(sell, g),
                lambda: port.sell.spmm_sell_slots_ref(*ops), library,
                nbytes_of(row_slot, row_nnz, heavy, g) + nnz * (
                    cols.element_size() + perm.element_size()
                    + 2 * sell.slot_vals.element_size()) + out_bytes,
                2 * nnz * d, f"rows={n} nonzeros={nnz} D={d}, "
                f"{heavy.shape[0]} heavy rows; library: torch.sparse.mm "
                "on a CSR of Aᵀ")
            r, c, v = at.form("csr")
            replaced = lambda: paths.spmm_elements(r, c, v, g, n)  # noqa
            old = "gather + index_add_ on the transposed slot triplet"
        row["replaced_ms"] = time_ms(torch, replaced)
        rows[name] = row
        log(f"  {name}: {row['replaced_ms'] / row['ms']:.2f}x faster than "
            f"the plain route it replaced ({old}, {row['replaced_ms']:.4f} "
            f"ms; not deterministic on CUDA); torch.sparse.mm takes "
            f"{row['library_ms'] / row['ms']:.2f}x its time; "
            f"{row['ms'] / row['bound_ms']:.2f}x its bound")
        del g, ops
    return rows


def serve_graph(torch, np, port, label, adj, want_path, expect):
    """Phase 3 for one graph: pack it once, then GCN serving, the SDDMM
    entry point and GAT serving on it; returns the kernel rows."""
    dev = torch.device(DEVICE)
    n = adj.shape[0]
    t0 = time.perf_counter()
    graph = port.gnn.build_graph(adj, port.cfg, device=DEVICE)
    torch.cuda.synchronize()
    log(f"graph ({label}): N={n} nnz={graph.stats.nnz} sparsity "
        f"{graph.stats.sparsity:.5f} forms={graph.adj.formats} host packing "
        f"{time.perf_counter() - t0:.2f} s")
    a_dense = torch.from_numpy(normalized_dense(np, adj)).to(dev)
    xs = [np.random.default_rng(SEED + i).standard_normal(
        (n, port.cfg.in_features)).astype(np.float32)
        for i in range(REQUESTS)]
    rows = gcn_phase(torch, port, graph, a_dense, label, want_path, expect,
                     xs)
    sddmm_rows, peak = sddmm_phase(torch, port, graph, a_dense, label,
                                   want_path)
    rows.update(sddmm_rows)
    pattern = a_dense != 0
    del a_dense
    rows.update(gat_phase(torch, port, graph, pattern, label, want_path, xs))
    counters = port.obs.snapshot()["metrics"]["counters"]
    series = {name: counters.get(name, {}) for name in (
        "dispatch_plans_total", "plan_cache_hits_total",
        "plan_cache_misses_total")}
    log(f"graph ({label}) obs counters after serving: {json.dumps(series)}")
    if not all(series.values()):
        raise AssertionError(f"graph ({label}): the dispatcher's or the "
                             f"plan memo's obs counters are empty: {series}")
    peak = max(peak, torch.cuda.max_memory_allocated())
    log(f"graph ({label}) peak device memory {peak / 2**30:.2f} GiB")
    del pattern
    torch.cuda.empty_cache()
    # phase 5 on the same graph; its launches join the kernel rows (K3p's
    # row is its backward shape's, K = 128)
    launches = train_phase(torch, np, port, graph, adj, xs[0], label,
                           want_path)
    backward = backward_rows(torch, port, graph, want_path)
    for name in ("K3p", "N1"):  # rows at the backward's shapes
        if name in backward:
            rows[name] = dict(backward[name], launches=0)
    for name, count in launches.items():
        if count and name not in rows:
            raise AssertionError(f"training on ({label}) launched {name}, "
                                 "a kernel of the other path")
        if count:
            rows[name]["launches"] += count
    return rows, backward


def live_pairs(np, ell, val, block_q, block_kv, window) -> int:
    """Causal query-key pairs per head that the valid ELL slots and the
    window (``window > 0``) allow: the work this data needs."""
    total = 0
    qpos = np.arange(block_q)
    for qi, (slots, ok) in enumerate(zip(ell, val)):
        hi = qi * block_q + qpos
        lo = hi - window + 1 if window > 0 else np.zeros_like(hi)
        for ki in slots[ok > 0]:
            k0 = int(ki) * block_kv
            total += int(np.clip(np.minimum(hi, k0 + block_kv - 1)
                                 - np.maximum(lo, k0) + 1, 0, None).sum())
    return total


def hold_attention(torch, what, got, want, dtype_name, same_rounding):
    """``got`` finite, of ``want``'s shape and within the phase 4
    tolerances of it (element by element in bf16 only where ``want``
    rounds as K9 does); returns the largest element error."""
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: shape {tuple(got.shape)} or "
                             "non-finite values")
    diff = got - want
    err = float(diff.abs().max())
    row_err = torch.linalg.vector_norm(diff, dim=-1)
    row_want = torch.linalg.vector_norm(want, dim=-1)
    row_rtol = ATTN_ROW_RTOL[dtype_name]
    worst_row = float((row_err / row_want.clamp_min(1e-30)).max())
    faults = []
    if not bool((row_err <= row_rtol * row_want + ATTN_ATOL).all()):
        faults.append(f"a row is off by {worst_row:.3e} of its norm "
                      f"(tol {row_rtol:.0e})")
    if dtype_name == "float32":
        tol = ATTN_F32_RTOL * float(want.abs().max()) + ATTN_ATOL
        text = f"tol {tol:.3e}"
        if err > tol:
            faults.append(f"max_abs_err {err:.3e} > {tol:.3e}")
    elif same_rounding:
        text = f"tol {ATTN_BF16_TOL} element by element"
        if not torch.allclose(got, want, **ATTN_BF16_TOL):
            ratio = float((diff.abs() / (ATTN_BF16_TOL["atol"]
                          + ATTN_BF16_TOL["rtol"] * want.abs())).max())
            faults.append(f"an element is {ratio:.2f}x its tolerance "
                          f"{ATTN_BF16_TOL}")
    else:
        text = "rows only (p rounds to bf16 here, not in the oracle)"
    if faults:
        raise AssertionError(f"{what}: " + "; ".join(faults))
    log(f"  {what}: max_abs_err {err:.3e} (max|want| "
        f"{float(want.abs().max()):.3e}, {text}); worst row "
        f"{worst_row:.3e} of its norm (tol {row_rtol:.0e})")
    return err


def time_sdpa(torch, q, k, v, sdpa_kw, out, backends):
    """``scaled_dot_product_attention`` on K9's inputs in their dtype, on a
    fused backend only (the math one would build the S x S scores): with
    ``enable_gqa``, else (f32, where only the memory-efficient backend
    runs) on K and V repeated to the query heads outside the timed call.
    Returns its time in ms and a description."""
    from torch.nn.attention import sdpa_kernel

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rep = q.shape[0] // k.shape[0]
    tries = [("enable_gqa", lambda: sdpa(q[None], k[None], v[None],
                                         enable_gqa=True, **sdpa_kw))]
    if q.dtype == torch.float32:
        kr, vr = (t.repeat_interleave(rep, 0)[None] for t in (k, v))
        tries.append(("K and V repeated to the query heads",
                      lambda: sdpa(q[None], kr, vr, **sdpa_kw)))
    for how, library in tries:
        with sdpa_kernel(backends), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            try:
                got = library()
            except RuntimeError:
                continue
            lib_err = float((got[0].float() - out.float()).abs().max())
            del got
            ms = time_ms(torch, library)
        return ms, (f"{ms:.4f} ms ({how}; max_abs_err vs K9 "
                    f"{lib_err:.3e})")
    return None, "not timed (no fused SDPA backend took these inputs)"


def long_rows(torch, np, port, rng):
    """Phase 4 (iii): K9 f32 on S_LONG keys under the full causal mask;
    the last q block of every head (the rows that sum the most keys) held
    row by row to an f64 oracle."""
    dev = torch.device(DEVICE)
    cfg = port.lm_cfg
    h, hkv, d, blk = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, \
        cfg.attn_block
    s = S_LONG
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (n, s, d), dtype=np.float32)).to(dev) for n in (h, hkv, hkv))
    ell, val = (torch.from_numpy(a).to(dev)
                for a in port.bsattn.banded_ell(s, blk, blk, 0))
    torch.cuda.synchronize()
    port.reset_counts()
    out = port.bsattn.block_sparse_flash_attention(
        q, k, v, window=0, block_q=blk, block_kv=blk)
    torch.cuda.synchronize()
    counts = port.counts()
    if counts != expected(port, {"K9": 1}, 1):
        raise AssertionError(f"bsattn (iii): launch counts {counts}, "
                             "expected K9 x1")
    r0 = s - blk
    keep = torch.arange(s, device=dev)[None, :] \
        <= torch.arange(r0, s, device=dev)[:, None]
    want = torch.empty((h, blk, d), dtype=torch.float64, device=dev)
    for i in range(h):
        j = i // (h // hkv)
        sc = (q[i, r0:].double() @ k[j].double().T) / math.sqrt(d)
        sc = sc.masked_fill(~keep, -math.inf)
        want[i] = torch.softmax(sc, dim=-1) @ v[j].double()
    hold_attention(torch, f"(iii) S={s} window=0 float32, rows {r0}..{s - 1} "
                   "of every head vs an f64 oracle", out[:, r0:], want,
                   "float32", same_rounding=False)
    ms = time_ms(torch, lambda: port.wrappers["K9"](
        ell, val, q, k, v, block_q=blk, block_kv=blk, causal=True,
        window=0))
    log(f"K9 [(iii) S={s} window=0 H={h} Hkv={hkv} D={d} float32]: kernel "
        f"{ms:.4f} ms, launches {counts}")
    del q, k, v, out, want
    torch.cuda.empty_cache()


def bsattn_phase(torch, np, port):
    """Phase 4: block-sparse attention at gemma3-4b width through the
    entry point; returns K9's row at (i) in bf16, with launches."""
    from torch.nn.attention import SDPBackend

    dev = torch.device(DEVICE)
    cfg = port.lm_cfg
    h, hkv, d, blk = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, \
        cfg.attn_block
    scale = 1 / math.sqrt(d)
    fused_sdpa = [SDPBackend.FLASH_ATTENTION,
                  SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION]
    rng = np.random.default_rng(SEED)
    k9_row = None
    for label, s, window in (("i", S_LOCAL, cfg.window), ("ii", S_GLOBAL, 0)):
        x32 = [torch.from_numpy(rng.standard_normal(
            (n, s, d), dtype=np.float32)).to(dev) for n in (h, hkv, hkv)]
        ell_np, val_np = port.bsattn.banded_ell(s, blk, blk, window)
        ell, val = (torch.from_numpy(a).to(dev) for a in (ell_np, val_np))
        pairs = live_pairs(np, ell_np, val_np, blk, blk, window)
        flops = 4 * d * pairs * h  # 2D for q.k and 2D for p.v per pair
        kw = dict(block_q=blk, block_kv=blk, causal=True, window=window)
        shape = (f"({label}) S={s} window={window} blocks {blk}x{blk} "
                 f"H={h} Hkv={hkv} D={d}, W={ell_np.shape[1]} slots "
                 f"({int(val_np.sum())} valid), {pairs} live pairs per "
                 f"head")
        if label == "i":
            sdpa_kw = dict(attn_mask=torch.from_numpy(
                port.dense_mask_from_ell(ell_np, val_np, s, blk, blk,
                                         causal=True, window=window)).to(dev))
        else:
            sdpa_kw = dict(is_causal=True)
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            q, k, v = (t.to(dtype) for t in x32)
            torch.cuda.synchronize()
            port.reset_counts()
            t0 = time.perf_counter()
            out = port.bsattn.block_sparse_flash_attention(
                q, k, v, window=window, block_q=blk, block_kv=blk)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            counts = port.counts()
            log(f"bsattn {shape} {name}: entry point {wall:.3f} ms (first "
                f"call), launches {counts}")
            if counts != expected(port, {"K9": 1}, 1):
                raise AssertionError(f"bsattn ({label}) {name}: launch "
                                     f"counts {counts}, expected K9 x1")
            qf, kf, vf = (t.float().transpose(0, 1)[None]
                          for t in (q, k, v))  # [1, S, H, D]
            if label == "i":
                oracle = port.lm_attention.local_block_attention(
                    qf, kf, vf, window=window, block=blk)
                oracle_name = "local_block_attention"
            else:
                oracle = port.lm_attention.flash_attention(
                    qf, kf, vf, causal=True, q_chunk=blk, kv_chunk=blk)
                oracle_name = "flash_attention(causal)"
            del qf, kf, vf
            oracle = oracle[0].transpose(0, 1)
            run = lambda: port.wrappers["K9"](ell, val, q, k, v, **kw)
            plain = lambda: port.bsattn_kernel.bsattn_ref(
                ell, val, q, k, v, scale=scale, **kw)
            err = hold_attention(torch, f"({label}) {name} vs plain version",
                                 out, plain(), name, same_rounding=True)
            hold_attention(torch, f"({label}) {name} vs f32 {oracle_name} "
                           "(independent oracle)", out, oracle, name,
                           same_rounding=False)
            del oracle
            row = dict(max_abs_err=err, ms=time_ms(torch, run),
                       plain_ms=time_ms(torch, plain), library_ms=None)
            row["library_ms"], lib = time_sdpa(torch, q, k, v, sdpa_kw, out,
                                               fused_sdpa)
            nbytes = (2 * h + 2 * hkv) * s * d * q.element_size() \
                + 2 * ell.numel() * 4
            # bf16: one tensor-core product per product; f32: three TF32
            # ones (hi hi, hi lo, lo hi), the least f32-accurate work on
            # the tensor cores
            peak, work = (PEAK_BF16_FLOP_PER_S, flops) \
                if dtype == torch.bfloat16 else (PEAK_TF32_FLOP_PER_S,
                                                 3 * flops)
            row["bound_ms"], row["bound_by"] = bound(nbytes, work, peak)
            entry = time_ms(torch, lambda: port.bsattn
                            .block_sparse_flash_attention(
                                q, k, v, window=window, block_q=blk,
                                block_kv=blk))
            log(f"K9 [{shape} {name}]: kernel {row['ms']:.4f} ms | entry "
                f"point {entry:.4f} ms | plain {row['plain_ms']:.4f} ms | "
                f"SDPA {lib} | bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']}: {nbytes / 1e9:.3f} GB, "
                f"{work / 1e9:.1f} GFLOP at {peak / 1e12:.0f} TFLOP/s; "
                f"{flops / PEAK_FP32_FLOP_PER_S * 1e3:.3f} ms at the FP32 "
                f"FFMA peak; kernel at "
                f"{flops / row['ms'] / 1e9:.2f} TFLOP/s)")
            how = "bf16" if dtype == torch.bfloat16 else "f32 (3xTF32)"
            log(f"  K9 ({label}) {how} on the tensor cores: "
                f"{flops / row['ms'] / 1e9:.1f} TFLOP/s, "
                f"{100 * row['bound_ms'] / row['ms']:.1f} % of its bound, "
                + ("" if row["library_ms"] is None else
                   f"{row['ms'] / row['library_ms']:.2f}x SDPA's time"))
            if label == "i" and dtype == torch.bfloat16:
                row["launches"] = counts["K9"]
                k9_row = row
            del q, k, v, out
        del x32, sdpa_kw
        torch.cuda.empty_cache()
    long_rows(torch, np, port, rng)
    log(f"bsattn peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return {"K9": k9_row}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    try:
        import numpy as np

        port = Port()
    except ImportError as exc:
        print(f"chip_smoke: cannot import the port ({exc}); run from the "
              "repository root", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, device {kind}, "
        f"count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    # built anew even where a library exists, so every ptxas log is here
    logs = port.build.build(force=True)
    log(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"({', '.join(port.build.SOURCES)})")
    for name, text in logs.items():
        usage = sorted({line.split(":", 1)[-1].strip()
                        for line in text.splitlines()
                        if "Used" in line or "spill" in line})
        log(f"  {name} (ptxas, distinct over its instances): "
            + " | ".join(usage))
    # K9 by instance; none may spill
    for inst, lines in sorted(port.ptxas_usage(logs["bsattn"]).items()):
        log(f"  K9 {inst}: " + "; ".join(lines))
        if port.spill_bytes(lines):
            raise AssertionError(f"K9 {inst} spills: {lines}")
    spills = []
    for name, text in logs.items():  # every instance that spills
        for inst, lines in ptxas_instances(text).items():
            if port.spill_bytes(lines):
                spills.append(name)
                log(f"  spill: {name} {inst}: " + "; ".join(lines))
    log(f"ptxas spills: {len(spills)} instance(s)")
    for inst, lines in sorted(ptxas_instances(
            logs["spmm_blockell"]).items()):  # K1/K5: none may spill
        log(f"  K1/K5 {inst}: " + "; ".join(lines))
    for source in ("spmm_blockell", "spmm_blockell_t"):
        if source in spills:
            raise AssertionError(f"a {source} instance spills")

    ragged_checks(torch, np, port)
    ragged_checks_blockell(torch, np, port)
    ragged_checks_transposed(torch, np, port)
    ragged_checks_sddmm_attention(torch, np, port)
    ragged_checks_pattern(torch, np, port)
    ragged_checks_bsattn(torch, np, port)

    n = N_NODES
    rng = np.random.default_rng(SEED)
    adj_a = (rng.random((n, n), dtype=np.float32) < 0.1).astype(np.float32)
    rows, backward_a = serve_graph(
        torch, np, port, "a: uniform density 0.1", adj_a, "ell",
        {"K1": 1, "K2": 0, "K5": 2, "K6": 0})
    del adj_a
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    adj_b = port.random_graph(n, 16, seed=1)
    rows_b, backward_b = serve_graph(
        torch, np, port, f"b: random_graph({n}, 16, seed=1)", adj_b, "sell",
        {"K1": 0, "K2": 1, "K5": 0, "K6": 2})
    rows.update(rows_b)
    del adj_b
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rows.update(bsattn_phase(torch, np, port))

    kernels = []
    for name in sorted(KERNELS):
        fn, source, replaces = KERNELS[name]
        row = rows[name]
        kernels.append({
            "name": f"{name} {fn}", "route": "cuda", "source": source,
            "replaces": replaces, "launches": row["launches"],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    print(json.dumps({"backward_shapes": {"a": backward_a,
                                          "b": backward_b}}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
