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
     D = 1, 2, 4, 8, 16, 128, 130 and 2048, f32, bf16 and f16, down each
     of its paths that takes the width (stream at D <= 8, tensor and
     sparse at every D), launched twice for equal bits, the rule's launch
     equal bit for bit to its path's, and K2 over Aᵀ's row view (the sell path's transposed SpMM)
     against the element route, launched twice for equal bits; K3/K4 at
     K = 2 and 48 (K3 with a weighted mask, with none and on bf16
     operands; K4 on its slot operands, held
     besides, exactly, to the tile kernel gathered to slots, with padding
     and edge-less rows' slots exactly 0); K3 at a pattern (K3p) at
     K = 2, 48 and 130, in f32 and bf16, over a Block-ELL form's Block-COO
     view and its occupancy bits, equal bit for bit to K3 without a mask
     at every set bit and exactly 0 elsewhere, launched twice for equal
     bits; at the SpMV backward's widths K3 (weighted and without a mask)
     and K4 at K = 1, N1 at D = 1 in f32 down every path (the same
     fills, padding block-row and empty block column) and K2 over Aᵀ's row view at D = 1,
     each launched twice for equal bits; K7/K8 at dk = 2 and 48,
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
     equal per ``torch.equal``.  On (a), GAT's first-step gradients
     through K7b must lie within the oracle's tolerance of the composed
     rule's (``PATTERN_MIN_K`` at 0: K3p x6 + K1 x3), each route equal to
     itself without and with deterministic mode.  Then the backward's
     kernels at their own shapes, each held to its plain version beside
     its bound and its library call: on (a) K7b at dk = 2 and D = 128 and
     16 (its bound the two stores of α and de; no library call; two
     launches equal); the SDDMM at K = 128
     (dα = ḡ Vᵀ) against ``sampled_addmm`` (on (a) K3 at the pattern, the
     step's launch with C a transposed view, its bound counted from the
     nonzeros, beside K3's staged kernel on every cell, the two equal at
     every nonzero; and the two routes at K = 2, 4, 8 and 16, the widths
     below 128 that set ``PATTERN_MIN_K`` (a step samples at 2 and 16);
     K4 on (b)), the
     SpMM (K1, K2) at D = 2 (GAT's dq) against ``torch.sparse.mm``, and
     the transposed SpMM at D = 128 (dH, dV) and D = 2 (dk), N1 on (a)
     and K2 over Aᵀ's row view on (b), beside its bound, ``torch.sparse.mm``
     on a CSR of Aᵀ and the plain route it replaced (N1's rows print the
     path its rule takes, the bound of the function whatever its path:
     its bytes against the nonzeros' products at the faster of FP32 and
     3xTF32, with the path's own operations beside it, and the copies
     around the kernel).
  6. Batched and continuous GNN serving and the DeltaGraph overlay, each
     run's launches counted between counts set to 0 and read, every
     output held to a dense f32 oracle, and failing if any
     ``resilience_*`` counter (retry, degrade, quarantine, shed, restart)
     moves:
       (6a) ``BatchServingEngine.for_gcn`` at bench_serve's full settings
            (12 graphs of 40-720 nodes, avg degree 4; 512 requests;
            max_batch 1, 8 and 32; a 4 ms window) with ``CONFIG``'s widths
            on 16 x 16 blocks, at ``form="auto"`` (its plans printed: csr
            on this traffic, no kernel) and ``form="ell"`` (K5 x2 + K1 per
            executed batch); per run a warm pass, a timed pass (req/s,
            p50 / p99, the padding ledger, steady compiles 0), a profiled
            pass (device busy) and one group run twice (equal bits
            required on both forms: the csr route's element SpMM sums each
            row in one fixed order); then K5 / K1 at 16 x 16 over
            a 32-graph composition with bucket padding and one
            ``batch_sddmm`` at K = 2 over it (K3 x1, also held to the
            per-graph samples);
       (6b) ``ContinuousBatchEngine.for_gcn`` at bench_serve_adaptive's
            full settings (in 128, hidden 64, 2 layers, 16 x 16 blocks;
            three drifting phases of 288 requests, seed 7; slots 4,
            adaptive, a 40 ms window, ``form="ell"``): warm passes until
            one compiles nothing, then a timed pass that must compile
            nothing (K5 + K1 per lane step);
       (6c) ``DeltaGraph(form="sell")`` (c 16, sigma 0, 8 x 8 tiles,
            width_slack 2) over graph (b)'s normalized adjacency: batches
            of seeded value updates, deletes and slack inserts into
            materialized tiles, the last with one insert outside the
            packing (exactly one repack); after each, ``matmul`` at
            D = 128 (K2), a 2-layer GCN (K6, K2), ``sddmm`` at K = 2 (K4)
            and a GAT layer (K8), then each kernel on the overlay's row
            view held to its plain version, and the final state to a
            rebuild from the final dense matrix.
  7. The dispatch remainder, on each graph of phase 3 right after its
     phase 5 (the same packing), every output held to the dense f32
     oracle (TF32 off) and every gradient to dense f32 autograd, each
     counted call's launches read between counts set to 0 and read:
       (7a) with its own ``AutotuneCache`` (the models' plans time into it
            too): ``matmul`` at D = 128 and 16, ``A.matmul(epilogue="relu",
            bias=b)`` at D = 128, ``sddmm`` at K = 2,
            ``fused_graph_attention`` at dk = 2, D = 128, ``gcn_forward``
            and ``gat_forward`` on ``CONFIG``'s seeded weights, each under
            ``policy="autotune"``: every candidate's time printed and
            finite, its peak memory printed; then each again on a fresh
            plan memo (``with_stats``), every plan "autotune: cached
            winner" and only the winners' kernels launched; the cache
            saved, loaded into a fresh one, the same winners;
       (7b) ``A @ v`` under auto and forced onto every candidate path (no
            kernel); then ``(A.with_data(w) @ x).square().sum()`` forced
            onto the graph's path, dx and dA held to dense f32 autograd,
            its launches asserted (N1 at D = 1 and K3 at K = 1 on (a), K2
            over Aᵀ's row view and K4 on (b)), run twice for equal bits;
       (7c) on (a): ``dispatch_spmm`` over a ``LazyForms`` of A's Block-ELL
            form at D = 128 (auto, ell, autotune) and over a 4096-node
            dense slice, ``dispatch_sddmm`` over A's Block-COO view at
            K = 2 (auto, ell), each call's launches its plan's, and
            ``obs.AUDIT``'s predicted-vs-measured summary;
     then the SpMV backward's kernels at those shapes (K3 / K4 at K = 1,
     N1 / K2 over Aᵀ at D = 1) held to their plain versions beside their
     bounds and library calls; and after phase 6, (7d) ``calibrate`` on
     the card at its defaults and at n = 4096, d = 128, the constants and
     the plans they would give (graphs (a), (b), their fused GAT and 6a's
     buckets) printed beside the shipped model's, nothing changed.
  8. The serving fleet (``repro_torch.serve.fleet``), after phase 7, at
     bench_serve_fleet's full settings: three drifting phases of 120
     requests (sizes 24-48, 96-256, 24-256; four a phase from
     ``default_rng(11)``), density 0.1, d = 8, hedging after 10 s, 2
     restarts a worker; every distinct (size, d) warmed with one
     ``infer``, then the storm with one live worker killed at request 180.
     Thread workers at 1, 2 and 4, each at ``form="auto"`` and
     ``form="ell"`` (K1 on 16 x 16 blocks over the continuous engine's
     block-diagonal lanes; its launches over the storm, counted between
     counts set to 0 and read, must be above 0), the planned route of every
     lane printed; the 2-worker ell storm served a second time (every
     request the same bits) with one profiled pass (device busy); then 2
     ``spawn`` process workers at ``form="ell"``, one SIGKILLed, each
     child's spawn-to-ready time printed.  Every result of every storm is
     held to the f64 dense oracle ``dense @ h``; none may fail or be lost,
     and no death, kill, restart or ``resilience_*`` counter may move but
     the one kill's.  Req/s, p50 / p99 and p99 before, during (2 s) and
     after the kill are printed, not gated.
  9. The LM models (``repro_torch.models.transformer``) and
     ``ServingEngine``, after phase 8, with gemma3-4b's ``CONFIG`` at full
     width and depth (34 layers, 3.88 B parameters, ``init_lm`` on the
     card from ``SEED``):
       (9a) dense.  f32 (TF32 off): B = 2 prompts of S = 4096 and 16
            decode steps fed the next tokens (the local layers' banded
            gather, the global layers' flash loop, a wrapped ring cache),
            every step's logits held to ``forward_hidden`` teacher-forced
            over the 4112 tokens (the plain masked-softmax route) with
            the tied head applied only at the 17 positions compared
            (``LM_RTOL``); the gate's power: faults planted at run time
            in the local layers (``LM_PLANTED``: the window one key
            short, the ring slot or RoPE position one ahead) must leave
            it, a sound reroute must stay in it; a 7-layer cut at full
            width held to the port's CPU path on the same weights (B = 1,
            S = 128, 4 decode steps).
            bf16 (the config's dtype): ``ServingEngine.generate`` at
            ``LM_BF16_RUNS`` (B = 4, S = 4096 and B = 8, S = 256, 32 new
            tokens): wall, tokens/s, peak memory; the prefill and the
            median decode step timed through the same entry points, one
            decode step profiled (device busy), and the greedy tokens'
            agreement with the bf16 teacher-forced argmax (printed);
       (9b) one ``wi`` pruned at ``sparsify_lm``'s defaults (8 x 8 tiles
            on 64 x 64 storage): its occupancy and plans, printed (dense
            expected); then ``sparsify_lm`` at ``LM_PRUNE`` (whole 64 x 64
            tiles) over the 34 layers, timed, its
            ``weight_sparsity_report``; every MLP weight must plan ell at
            every width the runs use; the f32 run of 9a with launch counts
            read around each decode step (N1 x3 a layer, nothing else)
            and every step's logits held to ``dense_reference`` through
            the same entry points; the bf16 runs of 9a, the engine owning
            the pruned tree (9a's dense runs keep the caller's f32 tree
            beside the engine's: ``sparsify_lm`` prunes it next), each
            run's device memory held and peak printed, and the pruned
            runs' prefill, decode and peak against the dense ones; N1 at
            D = 4, 8, 2048 and 16384 on layer 0's ``wi`` and ``wo``
            (``Wᵀ H``), held to its plain version beside its path, the
            function's bound, ``torch.sparse.mm`` on a CSR of Wᵀ,
            ``torch.matmul`` on the dense weight and the copies the LM
            makes around it for bf16 activations (xᵀ made contiguous,
            promoted to f32);
       (9c) every LM arch's ``SMOKE_CONFIG`` in f32: prefill and 8 decode
            steps held to the port's CPU run of the same weights and to
            the teacher-forced forward, ``lm_loss`` to the CPU's; MoE at
            capacity_factor = n_experts (no drops) and at its own
            capacity (drops; held to the CPU only).
     The main path's N1 launches join the kernel rows'.
 10. The LM training step (``repro_torch.train.loop``), after phase 9:
       (10a) gemma3-4b's ``CONFIG`` at full width and depth (34 layers,
            3,879,907,840 parameters) with f32 master params (TF32 off)
            and AdamW written in place, B = 1, S = 4096 from
            ``make_lm_batch``: run twice from the same init and batch
            (the first run's loss, gradients and updated params and
            moments kept on the host), every one equal per
            ``torch.equal``; then ``LM_TRAIN_STEPS`` steps through
            ``make_train_step`` (median on the host clock with a sync,
            tokens/s, peak memory), one profiled (device busy) and a
            ``cast_params_once`` bf16-compute step from the masters;
       (10b) ``remat_policy="dots"`` beside ``"nothing"`` on a
            ``LM_TRAIN_REMAT_LAYERS``-layer cut at full width (the saved
            products of 34 layers do not fit beside the 62 GB of state):
            the same loss and gradients, each step's time and peak;
       (10c) layers 0-5 (local and global) at full width, B = 1, S = 128:
            the loss and every gradient against the same cut on the CPU
            within ``LM_TRAIN_RTOL`` x max|want|;
       (10d) ``train_loop`` at gemma3's SMOKE_CONFIG with a chaos death
            and async checkpoints in a temporary directory (removed):
            one recovery, params and state equal per ``torch.equal`` to
            the undisturbed run.
     Its budget, ``PHASE10_BUDGET_S``, is printed beside its wall.
 11. The mesh at world size 1: a one-rank NCCL group on a ``FileStore``
     (destroyed after), ``make_mesh`` meshes of 1 x 1 (and 1 x 1 x 1, 1):
     ``spmm_1p5d`` / ``spmm_2d`` / ``spmm_2p5d`` on graph (a) at D =
     ``MESH_D``, each K1 x1 (counted; its main-path launches join K1's
     row), equal per ``torch.equal`` to ``spmm_blockell`` and held to the
     dense f32 oracle, timed beside K1 alone; ``allgather_matmul_overlap``
     against ``x @ w``; ``pipeline_apply`` with one stage, the MoE's
     expert-parallel branch on 1 x 1 (llama4-scout SMOKE_CONFIG, f32) and
     one sharded train step (gemma3 SMOKE_CONFIG), each equal per
     ``torch.equal`` to the unsharded computation.  Budget
     ``PHASE11_BUDGET_S``.
 12. The deprecated shims and the launchers, after phase 11:
       (12a) graph (a) again (the same seed), at the paper's width: with
            the counts set to 0 just before and read just after each
            call, ``core.spmm.spmm`` at D = ``SHIM_D`` with
            ``policy="ell"``, ``use_kernel=True`` (K1 x1 each) and
            ``use_kernel=False`` (the plain version: no launch), and over
            a ``SparseOperand`` (auto: its plan's launches), each held to
            the dense f32 oracle at phase 3's gate and each warning once
            (``DeprecationWarning``); ``core.sddmm.sddmm`` at K =
            ``SHIM_K`` with ``policy="ell"`` on A's Block-COO view with f32
            and bf16 weighted values and integer B, C (exact dots): K3 x1
            with the round-once epilogue, equal per ``torch.equal`` to its
            plain version, the cells where the round-the-dot-first
            epilogue would differ printed; K3's weighted bf16 launch timed
            beside its plain version and bound;
       (12b) ``launch.serve.main(["--arch", "gemma3-4b", "--full"])``:
            full width and depth, B = 4, a 64-token prompt, 32 new tokens;
            its tokens/s line;
       (12c) ``launch.train.main`` with ``--full`` at
            ``LAUNCH_TRAIN_FULL`` (f32 AdamW at full width and depth; the
            loss must be finite), then at SMOKE_CONFIG with a checkpoint
            directory (temporary) every 2 of 4 steps: the restored params
            and moments equal the saved ones per ``torch.equal``, and
            ``--resume`` starts its batches at the saved step.
     K1's and K3's launches join the kernel rows'; its budget,
     ``PHASE12_BUDGET_S``, is printed beside its wall.
 13. A JSON line of the backward shapes, one of the serving shapes (phase
     6's kernel rows and runs), one of phase 7, one of phase 8 (the
     fleet), one of phase 9 (``lm``), one of phase 10 (``lm_train``), one
     of phase 11 (``mesh``), one of phase 12 (``shims_launch``), a JSON
     line of the kernels, the script's wall time, the card line, and the
     final JSON line.

Without a CUDA device, or without the repository around it, the script
exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
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
# N1's widths in phase 2: every path's (the stream path's D <= 8, the
# tensor path's D-tile of 128 and a ragged second one, the LM's 2048)
N1_RAGGED_WIDTHS = (1, 2, 4, 8, 16, 128, 130, 2048)
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
# forward's (K5 x2 + K1, K6 x2 + K2, K7 / K8 x3); GAT's backward on (a)
# K7b once a layer (the score recompute at dk = 2, dα at D = 128, 128, 16,
# the softmax JVP and dq in one launch: dk < PATTERN_MIN_K), on (b) K4
# twice a layer (the score recompute and dα) and K2 once (dq); every
# transposed product runs N1 on (a) and K2 over Aᵀ's row view on (b):
# GCN's dH once a layer, GAT's dk and dV once a layer each; A's values
# take no gradient, so no dA is sampled
TRAIN_LAUNCHES = {
    ("ell", "gcn"): {"K5": 2, "K1": 1, "N1": 3},
    ("sell", "gcn"): {"K6": 2, "K2": 4},
    ("ell", "gat"): {"K7": 3, "K7b": 3, "N1": 6},
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
    # no Pallas kernel: the reference's jnp chain it takes the place of
    "K7b": ("fused_attn_blockell_bwd_kernel",
            "src/repro_torch/csrc/fused_attention_bwd.cu",
            "src/repro/sparse/autodiff.py:547"),
    "K9": ("bsattn_kernel", "src/repro_torch/csrc/bsattn.cu",
           "src/repro/kernels/bsattn/kernel.py:93"),
    # no Pallas kernel: the reference's jnp route it takes the place of
    "N1": ("spmm_blockell_t_kernel", "src/repro_torch/csrc/spmm_blockell_t.cu",
           "src/repro/sparse/paths.py:162"),
}
ACTS = ("identity", "relu", "leaky_relu")
# phase 6a: bench_serve's full settings (12 graphs of 40-720 nodes, 512
# requests, micro-batches of 1, 8 and 32, a 4 ms window), at both forms
SERVE_GRAPHS = 12
SERVE_REQUESTS = 512
SERVE_BATCHES = (1, 8, 32)
SERVE_DELAY_MS = 4.0
SERVE_FORMS = ("auto", "ell")
# phase 6b: bench_serve_adaptive's full settings (three drifting phases)
ADAPTIVE_PER_PHASE = 288
ADAPTIVE_PHASES = ((40, 160), (200, 900), (40, 900))
# warm passes at most before the timed one (the first that compiles
# nothing ends them; the timed pass must compile nothing)
ADAPTIVE_WARM_PASSES = 5
# phase 6c: batches of seeded deltas on graph (b)'s overlay; the last one
# also inserts once outside the packing, which forces one repack
DELTA_BATCHES = 3
DELTA_UPDATES, DELTA_DELETES, DELTA_INSERTS = 2000, 1000, 1000
# phase 8: bench_serve_fleet's full settings (three drifting phases of 120
# requests, four sizes a phase drawn from default_rng(11), density 0.1,
# d = 8; hedging after 10 s, 2 restarts a worker), one live worker killed
# at the storm's half-way request
FLEET_PER_PHASE = 120
FLEET_PHASES = ((24, 48), (96, 256), (24, 256))
FLEET_D = 8
FLEET_DENSITY = 0.1
FLEET_SEED = 11
FLEET_THREAD_WORKERS = (1, 2, 4)
FLEET_FORMS = ("auto", "ell")
FLEET_PROCESS_WORKERS = 2
FLEET_FAILOVER_S = 2.0  # submits this long after the kill are "during"
FLEET_TIMEOUT_S = 300.0
# phase 9: gemma3-4b (CONFIG, full width and depth) served through the
# port's LM entry points.  (batch, prompt, decode steps) of the f32 runs
# held to the teacher-forced forward (9a) and to dense_reference (9b); the
# full-width cut held to the port's CPU path (layers, batch, prompt, decode
# steps); (batch, prompt, new tokens) of the bf16 ServingEngine runs
LM_F32_RUN = (2, 4096, 16)
LM_CPU_CUT = (7, 1, 128, 4)
LM_BF16_RUNS = ((4, 4096, 32), (8, 256, 32))
# 9b: whole 64 x 64 storage tiles pruned, so the MLP products plan ell (N1)
LM_PRUNE = dict(sparsity=0.9, prune_block=(64, 64), block=(64, 64))
LM_N1_WIDTHS = (4, 8, 2048, 16384)
# f32 logits of the full model: |got - want| <= LM_RTOL * max|want|.  The
# same f32 sums over 34 layers taken in other orders (the banded gather,
# the flash loop and the ring cache against one masked softmax; N1 against
# cuBLAS), carried through the depth: 7.1e-6 of max|want| measured on an
# H100, so over 10x headroom
LM_RTOL = 1e-4
# the 9a gate's power: faults planted at run time in models/layers.py's
# source, each one key or one position off in the local layers, must leave
# it; a sound reroute of the local prefill must stay in it.  (what, [(text,
# replacement)], a fault?)
_LM_BANDED = ("return attn_lib.local_block_attention(q, k, v, window=cfg."
              "window,\n                                              "
              "block=lblk)")
LM_PLANTED = (
    ("decode window one key short",
     [("valid &= kpos > pos - cfg.window",
       "valid &= kpos > pos - cfg.window + 1")], True),
    ("decode ring slot one ahead",
     [("slot = pos % size if kind", "slot = (pos + 1) % size if kind")],
     True),
    ("decode RoPE position one ahead",
     [("positions = torch.full((b, 1), pos, dtype",
       "positions = torch.full((b, 1), pos + 1, dtype")], True),
    ("prefill local window one key short (masked softmax)",
     [(_LM_BANDED, "return attn_lib.mha_reference(q, k, v, causal=causal, "
                   "window=cfg.window - 1)")], True),
    ("prefill local through the masked softmax (sound)",
     [(_LM_BANDED, "return attn_lib.mha_reference(q, k, v, causal=causal, "
                   "window=cfg.window)")], False),
)
# 9c: smoke prompts of 32 positions (vision prefix included), 8 decode
# steps; rtol of max|want| (f32 sums over 2 to 7 narrow layers)
LM_SMOKE_PROMPT = 32
LM_SMOKE_DECODE = 8
LM_SMOKE_RTOL = 1e-4


# phase 10: gemma3-4b's AdamW step (f32 masters) at full width and depth:
# (batch, prompt), steps timed after the two held runs; the depth cut of the
# "dots" step beside "nothing" (the products it saves over 34 layers, about
# 0.7 GB a layer at S = 4096 in f32, do not fit beside the 62 GB of params,
# gradients and moments); the cut held to the CPU (layers 0-5: five local
# layers and the global one; batch, prompt); the train_loop chaos run at
# SMOKE_CONFIG (steps, the step a death hits, checkpoint interval, batch,
# prompt)
LM_TRAIN = (1, 4096)
LM_TRAIN_STEPS = 3
LM_TRAIN_REMAT_LAYERS = 12
LM_TRAIN_CPU_CUT = (6, 1, 128)
LM_TRAIN_CHAOS = (6, 5, 2, 2, 128)
# gradients on the card against the CPU: |got - want| <= 1e-4 * max|want|
# per leaf (f32 sums in other orders over six layers, TF32 off)
LM_TRAIN_RTOL = 1e-4
PHASE10_BUDGET_S = 150.0
# phase 11: the mesh at world size 1 (one NCCL rank), graph (a) at D = 128
MESH_D = 128
PHASE11_BUDGET_S = 30.0
# phase 12: the deprecated shims on graph (a): the SpMM width, the SDDMM's
# K and the range of B's and C's integer entries (the f32 dots exact, many
# of them no bf16 value, so the two epilogues of K3 differ in bf16); the
# launchers at gemma3-4b's full config (train: batch, prompt, steps) and
# at its SMOKE_CONFIG (checkpoint interval, steps, batch, prompt)
SHIM_D = 128
SHIM_K = 2
SHIM_INT = 40
LAUNCH_TRAIN_FULL = (1, 1024, 2)
LAUNCH_TRAIN_SMOKE = (2, 4, 2, 64)
PHASE12_BUDGET_S = 120.0


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
        from repro_torch import configs as lm_configs
        from repro_torch.configs import gemma3_4b, paper_gnn
        from repro_torch.models import layers as lm_layers
        from repro_torch.models import pruning
        from repro_torch.models import transformer as lm
        from repro_torch.core import attention as lm_attention
        from repro_torch.core.formats import (SELL_HEAVY_ROW_NNZ, BlockELL,
                                              SellCS)
        from repro_torch.data.pipeline import random_graph
        from repro_torch import dispatch
        from repro_torch.dispatch import _forms, autotune, dispatcher
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
        from repro_torch import batch
        from repro_torch.serve import fleet, runtime
        from repro_torch.core import distributed
        from repro_torch.data import pipeline as data
        from repro_torch.ft import checkpoint
        from repro_torch.kernels.spmm import ops as spmm_ops
        from repro_torch.resilience import chaos
        from repro_torch.sharding import ctx as shard_ctx
        from repro_torch.sharding import specs as shard_specs
        from repro_torch.sharding import step as shard_step
        from repro_torch.train import loop as lm_train
        from repro_torch.train import optimizer as lm_opt
        from repro_torch.train import pipeline as gpipe
        from repro_torch.core import sddmm as core_sddmm
        from repro_torch.core import spmm as core_spmm
        from repro_torch.dispatch import operand
        from repro_torch.launch import serve as launch_serve
        from repro_torch.launch import train as launch_train

        self.cfg = paper_gnn.CONFIG
        self.GNNConfig = paper_gnn.GNNConfig
        self.batch, self.runtime, self.fleet = batch, runtime, fleet
        self.lm_cfg = gemma3_4b.CONFIG
        self.lm, self.pruning, self.lm_configs = lm, pruning, lm_configs
        self.lm_attention, self.lm_layers = lm_attention, lm_layers
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
        self.dispatch, self.autotune, self.forms = dispatch, autotune, _forms
        self.autodiff, self.matrix = autodiff, matrix
        self.transposed, self.obs = transposed, obs
        self.distributed, self.data, self.checkpoint = distributed, data, \
            checkpoint
        self.spmm_blockell = spmm_ops.spmm_blockell
        self.chaos, self.gpipe = chaos, gpipe
        self.shard_ctx, self.shard_specs, self.shard_step = \
            shard_ctx, shard_specs, shard_step
        self.lm_train, self.lm_opt = lm_train, lm_opt
        self.core_spmm, self.core_sddmm = core_spmm, core_sddmm
        self.SparseOperand = operand.SparseOperand
        self.launch_serve, self.launch_train = launch_serve, launch_train
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
            "K7b": attention.fused_attn_blockell_bwd_kernel,
            "K9": bsattn_kernel.bsattn_kernel,
            "N1": transposed.spmm_blockell_t_kernel,
        }

    def reset_counts(self):
        for w in self.wrappers.values():
            w.launches = 0

    def counts(self):
        return {k: w.launches for k, w in self.wrappers.items()}


def ptxas_instances(log_text: str) -> dict:
    """Kernel instance (its mangled name from the kernel's own identifier
    on, ``<name>_kernel<template arguments>``, whole: the instances of
    every kernel of one source stay apart) -> its spill and register lines
    in an ``nvcc -Xptxas -v`` log."""
    usage, inst = {}, None
    for line in log_text.splitlines():
        if "Function properties for" in line:
            inst = line.split("Function properties for", 1)[1].strip()
            # the identifier after its length prefix (letters and _ only)
            found = re.search(r"\d([A-Za-z_]+_kernel)(.*)$", inst)
            if found:
                inst = found.group(1) + found.group(2)
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


def n1_paths_at(port, d, block):
    """N1's paths that take width ``d`` on ``block`` (the stream path only
    D <= 8, the tensor path only 64-column blocks of 16k rows)."""
    tr = port.transposed
    out = ["sparse"]
    if d <= tr.STREAM_MAX_D:
        out.append("stream")
    if block[1] == tr.TENSOR_BN and block[0] % tr.TENSOR_BM_STEP == 0:
        out.append("tensor")
    return out


def n1_every_path(torch, port, what, ops, block, empty_rows=None):
    """N1 on ``ops`` down every path that takes them, each launched twice
    (equal bits), held to the plain version (``transposed_sums_close``),
    the rule's launch equal bit for bit to its path's; ``empty_rows`` (a
    slice of Y) must come out 0.  Returns the largest error by path."""
    n1, d = port.wrappers["N1"], ops[3].shape[1]
    want = port.ref.spmm_blockell_t_ref(*ops)
    nbr, nbc = ops[2].shape[0], ops[0].shape[0] - 1
    rule = port.transposed.n1_plan(d, ops[2].dtype, block, nbr, nbc)[0]
    errs, outs = {}, {}
    for path in n1_paths_at(port, d, block):
        name = f"{what} {path}"
        got = n1(*ops, path=path)
        if not torch.equal(got, n1(*ops, path=path)):
            raise AssertionError(f"{name}: two launches gave different bits")
        if empty_rows is not None and bool((got[empty_rows] != 0).any()):
            raise AssertionError(f"{name}: the empty block column is not 0")
        errs[path] = transposed_sums_close(torch, port, name, got, want, ops)
        outs[path] = got
    if not torch.equal(n1(*ops), outs[rule]):
        raise AssertionError(f"{what}: the rule's launch ({rule}) differs "
                             "from the same path forced")
    return errs


def ragged_checks_transposed(torch, np, port):
    """Phase 2 for N1 (the transposed SpMM): block fills 0, 1 %, 10 % and
    100 % with a padding block-row (padded slots) and an empty block
    column, D = 1, 2, 4, 8, 16, 128, 130 and 2048, f32, bf16 and f16, down
    every path that takes the width (``n1_every_path``: the stream path at
    D <= 8, the tensor and sparse paths at every D), every launch twice for
    equal bits; and K2 over Aᵀ's row view (the sell path's transposed
    SpMM) against the element route, heavy rows of Aᵀ included."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED + 6)
    m, n, bm = 1000, 700, 64
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
            for d in N1_RAGGED_WIDTHS:
                ops = (col_ptr, col_slots, ell.blocks.to(dtype),
                       torch.randn(ell.shape[0], d, device=dev).to(dtype))
                errs = n1_every_path(torch, port, f"N1 fill={fill} {dtype} "
                                     f"d={d}", ops, (bm, bm),
                                     slice(bm, 2 * bm))
                for path, err in errs.items():
                    key = f"{str(dtype).split('.')[-1]} {path}"
                    worst[key] = max(worst.get(key, 0.0), err)
        log(f"ragged N1 {m}x{n} fill={fill} (W={ell.ell_width}, a padding "
            f"block-row, an empty block column; D = {N1_RAGGED_WIDTHS}, "
            "every path that takes D; two launches equal bit for bit, the "
            "rule's equal to its path's): max_abs_err "
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


def ragged_checks_width_one(torch, np, port):
    """Phase 2 at the SpMV backward's widths: K3 (weighted and without a
    mask) and K4 at K = 1, N1 at D = 1 in f32 (block fills 0, 1 %, 10 % and
    100 %, a padding block-row, an empty block column) and K2 over Aᵀ's row
    view at D = 1; each held to its plain version and launched twice for
    equal bits."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED + 7)
    m, n, bm = 1000, 700, 64
    a = np.where(rng.random((m, n)) < 0.05, rng.standard_normal((m, n)),
                 0).astype(np.float32)
    a[[3, 500, 999]] = 0.0  # edge-less rows
    coo = port.BlockCOO.from_dense(a, bm, bm, device=dev)
    b = torch.randn(coo.shape[0], 1, device=dev)
    c = torch.randn(1, coo.shape[1], device=dev)
    errs = {}
    k3, k3_plain = port.wrappers["K3"], port.sddmm_ref.sddmm_blockcoo_ref
    for what, mask in (("K3 k=1", coo.blocks), ("K3 no mask k=1", None)):
        ops = (coo.rows, coo.cols, mask, b, c)
        kw = dict(block=(bm, bm), out_dtype=torch.float32)
        got = k3(*ops, **kw)
        errs[what] = check_close(torch, what, got, k3_plain(*ops, **kw))
        if not torch.equal(got, k3(*ops, **kw)):
            raise AssertionError(f"{what}: two launches gave different bits")
    sell = port.SellCS.from_dense(np.where(rng.random((m, n)) < 0.003, 1.0,
                                           0).astype(np.float32),
                                  block=(bm, bm), device=dev)
    ops = (*port.sddmm_sell.sddmm_sell_operands(sell),
           torch.randn(m, 1, device=dev), torch.randn(1, n, device=dev))
    got = port.wrappers["K4"](*ops)
    errs["K4 k=1"] = check_close(torch, "K4 k=1", got,
                                 port.sddmm_sell.sddmm_sell_slots_ref(*ops))
    if not torch.equal(got, port.wrappers["K4"](*ops)):
        raise AssertionError("K4 k=1: two launches gave different bits")
    for fill in BLOCKELL_FILLS:
        a = np.where(rng.random((m, n)) < fill, rng.standard_normal((m, n)),
                     0).astype(np.float32)
        if fill == 1.0:
            a[a == 0] = 1.0
        a[bm:2 * bm] = 0.0  # block-row 1: padding slots only
        a[:, bm:2 * bm] = 0.0  # block column 1: in no list
        ell = port.BlockELL.from_dense(a, bm, bm, device=dev)
        ops = (*port.transposed.blockell_columns(ell), ell.blocks,
               torch.randn(ell.shape[0], 1, device=dev))
        what = f"N1 d=1 fill={fill}"
        for path, err in n1_every_path(torch, port, what, ops, (bm, bm),
                                       slice(bm, 2 * bm)).items():
            errs[f"{what} {path}"] = err
    x = torch.randn(m, 1, device=dev)
    got = port.transposed.spmm_sell_t(sell, x)
    if not torch.equal(got, port.transposed.spmm_sell_t(sell, x)):
        raise AssertionError("K2 over Aᵀ's row view d=1: two launches gave "
                             "different bits")
    errs["K2 Aᵀ d=1"] = check_close(
        torch, "K2 over Aᵀ's row view d=1", got, port.paths.spmm_elements(
            sell.slot_cols, sell.slot_rows, sell.slot_vals, x, n))
    log(f"ragged {m}x{n} at width one (K3 weighted and without a mask, K4 "
        "at K = 1; N1 at D = 1 down every path, with a padding block-row "
        "and an empty block column; K2 over Aᵀ's row view at D = 1; two launches equal bit for "
        "bit): max_abs_err " + " ".join(f"{k} {v:.3e}"
                                        for k, v in errs.items()))


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


def n1_nbytes(ell, ops, out_bytes) -> int:
    """The bytes N1 must move: its column lists, H and Y once each, and
    only the real blocks of ``ell`` (slots past ``nblocks`` are in no
    list and are never read)."""
    col_ptr, col_slots, _, h = ops
    return nbytes_of(col_ptr, col_slots, h) + out_bytes \
        + int(ell.nblocks.sum()) * ell.bm * ell.bn * ell.blocks.element_size()


def n1_work(port, ell, ops, nnz):
    """N1's path (by its rule) on ``ops`` and the operations the function
    needs, whatever path runs it: one product per nonzero and column of H,
    at the faster of FP32 FFMA and three TF32 products a product in f32
    (the bf16 / f16 mma rate in bf16 / f16).  The path's own count (the
    tensor and stream paths multiply the whole live blocks, stored zeros
    included) is only printed beside it.  Returns (path, chunks, flops,
    peak, what)."""
    col_ptr, col_slots, blocks, h = ops
    d, live = h.shape[1], col_slots.shape[0]
    path, chunks = port.transposed.n1_plan(
        d, blocks.dtype, (ell.bm, ell.bn), blocks.shape[0],
        col_ptr.shape[0] - 1)
    need = 2 * nnz * d
    if blocks.element_size() == 4:
        flops, peak, how = min(
            (need, PEAK_FP32_FLOP_PER_S, "FP32"),
            (3 * need, PEAK_TF32_FLOP_PER_S, "3xTF32"),
            key=lambda w: w[0] / w[1])
    else:
        flops, peak, how = need, PEAK_BF16_FLOP_PER_S, "bf16 / f16 mma"
    dense = 2 * live * ell.bm * ell.bn * d
    done = {"tensor": 3 * dense if blocks.element_size() == 4 else dense,
            "stream": dense, "sparse": need}[path]
    return path, chunks, flops, peak, (
        f"{how} over the {nnz} nonzeros; the {path} path does "
        f"{done / 1e9:.3f} GFLOP")


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
    a ``torch.profiler`` run; returns the busy ms (None: not measured)."""
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
        return None
    busy = sum(dev_ms.values())
    top = sorted(dev_ms.items(), key=lambda kv: -kv[1])[:8]
    log(f"{what}: wall {wall:.3f} ms under the profiler, device busy "
        f"{busy:.3f} ms ({100 * busy / wall:.1f} %); by device time: "
        + "; ".join(f"{k[:70]} {v:.3f} ms" for k, v in top))
    return busy


def expected(port, per_call, calls):
    """Launch counts over every wrapper: ``per_call`` times ``calls``."""
    return {k: per_call.get(k, 0) * calls for k in port.wrappers}


def measure(torch, name, run, plain, library, nbytes, flops, what,
            close=None, peak=PEAK_FP32_FLOP_PER_S):
    """One kernel row: held to its plain version (by ``close(name, got,
    want)``, else ``check_close``), timed beside it and beside the library
    call (``library`` None: there is none), with the bound from ``nbytes``
    and ``flops`` at ``peak`` FLOP/s."""
    close = close or (lambda *a: check_close(torch, *a))
    err = close(name, run(), plain())
    row = dict(max_abs_err=err, ms=time_ms(torch, run),
               plain_ms=time_ms(torch, plain),
               library_ms=None if library is None else time_ms(torch, library))
    row["bound_ms"], row["bound_by"] = bound(nbytes, flops, peak)
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
            k7b_grads_close(torch, port, params, graph, x, labels, what)
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


def k7b_grads_close(torch, port, params, graph, x, labels, what):
    """The first step's gradients through K7b and through the composed
    rule (``PATTERN_MIN_K`` at 0 turns K7b off: the score recompute and dα
    on K3p, dq on K1), each parameter's within ``ORACLE_RTOL`` x its
    max|composed| + ``GRAD_ATOL`` (the dense oracle's tolerance: dq and
    the row sums l are summed in another order); each route run without
    and with ``torch.use_deterministic_algorithms`` (warnings only), equal
    per ``torch.equal``.  Their launches are checked, not counted."""
    autodiff = port.autodiff
    min_k = autodiff.PATTERN_MIN_K
    expect = {"K7b": expected(port, TRAIN_LAUNCHES["ell", "gat"], 1),
              "composed": expected(port, {"K7": 3, "K3p": 6, "K1": 3,
                                          "N1": 6}, 1)}
    was = torch.are_deterministic_algorithms_enabled()
    grads = {}
    try:
        for mode in (False, True):
            torch.use_deterministic_algorithms(mode, warn_only=True)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                for route, k in (("K7b", min_k), ("composed", 0)):
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
    bad = [(route, name) for route in ("K7b", "composed")
           for (name, g), (_, w) in zip(named(grads[route, True]),
                                        named(grads[route, False]))
           if not torch.equal(g, w)]
    if bad:
        raise AssertionError(f"{what}: a route's gradients moved under "
                             f"deterministic mode: {bad}")
    errs = []
    for (name, g), (_, w) in zip(named(grads["K7b", False]),
                                 named(grads["composed", False])):
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        errs.append(f"{name} {err:.2e} (max|want| {scale:.3e})")
        if not err <= ORACLE_RTOL * scale + GRAD_ATOL:
            bad.append(name)
    log(f"{what}: first-step gradients through K7b (K7b x3) against the "
        "composed rule (K3p x6 + K1 x3), each route equal to itself under "
        "deterministic mode: " + ", ".join(errs))
    if bad:
        raise AssertionError(f"{what}: K7b's gradients off the composed "
                             f"rule's: {bad}")


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


def k7b_rows(torch, port, graph, gen):
    """On (a): K7b at the step's shapes (dk = 2; D = 128, then 16: q, k,
    V, ḡ and rowdot drawn, kᵀ a view of k, the matrix's memoized
    occupancy), launched twice for equal bits, held to its plain version
    and timed beside it and its bound: the two stores of α and de (every
    cell of every slot, f32) with the pattern's bits, the operands and dq
    once, or the nonzeros' 2 (D + 2 dk) FLOP.  Returns the D = 128 row,
    D = 16's under ``"D=16"``."""
    dev = torch.device(DEVICE)
    n, dk = graph.n_nodes, 2
    ell = graph.adj.form("ell")
    occ = graph.adj.tile_occupancy()
    nnz = int((ell.blocks != 0).sum())
    att = port.attention

    def close(name, got, want):
        """α and de to ``KERNEL_TOL``; dq, a sum of a row's de k terms in
        another order than the plain version's ``spmm_blockell_ref``, as
        ``ell_sums_close`` holds K1."""
        errs = [check_close(torch, f"{name} {part}", x, y)
                for part, x, y in zip(("alpha", "de"), got, want)]
        return max(errs + [ell_sums_close(
            torch, port, f"{name} dq", got[2], want[2],
            (ell.indices, want[1], port.paths.pad_rows(k, ell.shape[1])))])

    row = None
    for d in (port.cfg.hidden, port.cfg.n_classes):
        q, k = (torch.randn(n, dk, device=dev, generator=gen)
                for _ in range(2))
        v, g = (torch.randn(n, d, device=dev, generator=gen)
                for _ in range(2))
        ops = (occ, q, k.T, v, g, torch.randn(n, device=dev, generator=gen))
        run = lambda: att.fused_attn_blockell_bwd(ell, *ops)  # noqa: E731
        first, again = run(), run()
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            raise AssertionError(f"K7b at D={d}: two launches differ")
        del first, again
        got = measure(
            torch, f"K7b at D={d}, dk={dk} (the attention backward's chain)",
            run, lambda: att.fused_attn_blockell_bwd_ref(  # noqa: E731
                ell.indices, *ops, block=(ell.bm, ell.bn)), None,
            nbytes_of(ell.indices, *ops) + 2 * ell.blocks.numel() * 4
            + n * dk * 4, 2 * nnz * (d + 2 * dk),
            f"nbr={ell.n_block_rows} W={ell.ell_width} D={d}; {nnz} "
            "nonzeros; two launches equal; no library call", close=close)
        if row is None:
            row = got
        else:
            row[f"D={d}"] = got
    return {"K7b": row}


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
        rows.update(k7b_rows(torch, port, graph, gen))
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


def transposed_rows(torch, port, graph, want_path, gen, widths=None):
    """The transposed SpMM at the step's widths, D = 128 (dH, dV) and
    D = 2 (dk), or at ``widths``: on (a) N1, held to its plain version; on
    (b) K2 over Aᵀ's row view (with the per-call gather of the values),
    held to K2's plain version; each beside its bound, ``torch.sparse.mm``
    on a CSR of Aᵀ and the plain route it replaced (``einsum`` +
    a fixed-order segmented sum on the transposed Block-COO, or the element
    route).
    Returns the rows: "N1" at D = 128 on (a), "N1 D=2", "K2 Aᵀ D=128",
    "K2 Aᵀ D=2"."""
    dev = torch.device(DEVICE)
    n, nnz = graph.n_nodes, graph.stats.nnz
    paths, tr = port.paths, port.transposed
    lib_t = transposed_csr(torch, graph)
    rows, at = {}, graph.adj.T
    for d in widths or (port.cfg.hidden, 2):
        g = torch.randn(n, d, device=dev, generator=gen)
        out_bytes = n * d * 4
        library = lambda: torch.sparse.mm(lib_t, g)  # noqa: E731
        if want_path == "ell":
            ell = graph.adj.form("ell")
            t0 = time.perf_counter()
            h_in = paths.pad_rows(g, ell.shape[0])
            ops = (*tr.blockell_columns(ell), ell.blocks, h_in)
            copy_ms = 0.0 if h_in is g else time_ms(
                torch, lambda: paths.pad_rows(g, ell.shape[0]))
            name = "N1" if d == port.cfg.hidden else f"N1 D={d}"
            path, chunks, flops, peak, how = n1_work(port, ell, ops, nnz)
            row = measure(
                torch, f"N1 at D={d} (Aᵀ ḡ on A's Block-ELL blocks)",
                lambda: port.wrappers["N1"](*ops),
                lambda: port.ref.spmm_blockell_t_ref(*ops), library,
                n1_nbytes(ell, ops, out_bytes), flops,
                f"path {path} ({chunks} chunk(s) a column), operations "
                f"{how}; nbc={ops[0].shape[0] - 1} list entries "
                f"{ops[1].shape[0]} blocks {ell.bm}x{ell.bn} D={d}; {nnz} "
                "nonzeros; library: torch.sparse.mm on a CSR of Aᵀ",
                close=lambda *a: transposed_sums_close(torch, port, *a,
                                                       ops), peak=peak)
            row.update(path=path, copy_ms=copy_ms)
            log(f"  {name}: path {path}; copies around the kernel (H padded "
                f"to A's rows): {copy_ms:.4f} ms ({time.perf_counter() - t0:.1f}"
                " s for the row)")
            coo = at.form("coo")
            replaced = lambda: paths.spmm_coo(  # noqa: E731
                coo, paths.pad_rows(g, coo.shape[1]))
            old = ("einsum on the transposed Block-COO and a fixed-order "
                   "segmented sum")
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
            old = ("the element route on the transposed slot triplet: a "
                   "gather and a fixed-order segmented sum")
        row["replaced_ms"] = time_ms(torch, replaced)
        rows[name] = row
        log(f"  {name}: {row['replaced_ms'] / row['ms']:.2f}x faster than "
            f"the plain route it replaced ({old}, {row['replaced_ms']:.4f} "
            f"ms); torch.sparse.mm takes "
            f"{row['library_ms'] / row['ms']:.2f}x its time; "
            f"{row['ms'] / row['bound_ms']:.2f}x its bound")
        del g, ops
    return rows


# ---------------------------------------------------------------------------
# Phase 7: the dispatch remainder (autotune, the SpMV lane, the legacy entry
# points, calibrate)
# ---------------------------------------------------------------------------


# the kernel one forward call of a plan launches on the card (csr and
# dense: none)
PLAN_KERNELS = {("spmm", "ell"): "K1", ("spmm", "sell"): "K2",
                ("spmm+epilogue", "ell"): "K5",
                ("spmm+epilogue", "sell"): "K6",
                ("sddmm", "ell"): "K3", ("sddmm", "sell"): "K4",
                ("fused_attn", "ell"): "K7", ("fused_attn", "sell"): "K8"}


def plan_launches(port, plans) -> dict:
    """The launches ``plans``, each run once forward, make on the card."""
    want = dict.fromkeys(port.wrappers, 0)
    for p in plans:
        op = "spmm+epilogue" if p.op == "spmm" and p.fused else p.op
        name = PLAN_KERNELS.get((op, p.path))
        if name:
            want[name] += 1
    return want


def run_counted(torch, port, fn):
    """``fn()`` with the plan log emptied and the launch counts set to 0
    just before and read just after; returns (its result, the counts, the
    plans it logged)."""
    port.dispatcher.clear_log()
    torch.cuda.synchronize()
    port.reset_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, port.counts(), port.dispatcher.dispatch_log()


def add_counts(total, counts):
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n


def nonzero(counts) -> dict:
    return {k: n for k, n in counts.items() if n}


def hold_output(torch, what, got, want):
    """``got`` finite, of ``want``'s shape, within ``oracle_tol``; returns
    the error."""
    err = float((got.float() - want).abs().max())
    tol = oracle_tol(want)
    if tuple(got.shape) != tuple(want.shape) \
            or not bool(torch.isfinite(got).all()) or err > tol:
        raise AssertionError(f"{what}: off the dense f32 oracle, max_abs_err "
                             f"{err:.3e} > {tol:.3e}")
    return err


def attention_oracle(torch, pattern, q, k, v, chunk=2048):
    """Dense f32 ``fused_graph_attention``: leaky relu 0.2 of q kᵀ, a
    softmax over each row's pattern (exactly 0 off it), times V; row chunk
    by row chunk."""
    out = torch.empty(q.shape[0], v.shape[1], device=v.device)
    for r0 in range(0, q.shape[0], chunk):
        mask = pattern[r0:r0 + chunk]
        e = torch.nn.functional.leaky_relu(q[r0:r0 + chunk] @ k.T, 0.2)
        e = torch.where(mask, e, -1e30)
        p = torch.where(mask, torch.exp(e - e.amax(1, keepdim=True)), 0.0)
        out[r0:r0 + chunk] = (p / p.sum(1, keepdim=True).clamp_min(
            1e-12)) @ v
    return out


@contextlib.contextmanager
def own_global_cache(port, cache):
    """The models' ``autotune`` plans (``gcn_forward`` and ``gat_forward``
    take no cache) time into ``cache`` while the block runs, not into the
    process's ``GLOBAL_CACHE``."""
    saved = port.autotune.GLOBAL_CACHE
    port.autotune.GLOBAL_CACHE = cache
    try:
        yield
    finally:
        port.autotune.GLOBAL_CACHE = saved


def timings_text(plans) -> str:
    """Each autotune plan's candidates, in µs (a cached winner's as they
    were timed)."""
    return "; ".join(
        f"{p.op}{'+' + p.fused if p.fused and p.op == 'spmm' else ''} -> "
        f"{p.path} (" + ", ".join(f"{k} {t:.1f}"
                                  for k, t in sorted(p.timings_us.items()))
        + f" µs{', cached' if 'cached' in p.reason else ''})"
        for p in plans if p.policy == "autotune" and p.timings_us)


def autotune_phase(torch, np, port, graph, a_dense, x_np, label):
    """7a: the planned entry points under ``policy="autotune"`` at full
    width, with their own ``AutotuneCache``: each call once (every
    candidate timed and finite; its peak memory printed), held to the dense
    f32 oracle; then once more on a fresh plan memo (``with_stats``), which
    must plan "autotune: cached winner" and launch only the winners'
    kernels; then the cache through a file and back.  Returns (the
    launches, the winners)."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    n, cfg, ops = graph.n_nodes, port.cfg, port.ops
    cache = port.autotune.AutotuneCache()
    kw = dict(policy="autotune", autotune_cache=cache)
    h128, h16 = (torch.randn(n, d, device=dev, generator=gen)
                 for d in (cfg.hidden, cfg.n_classes))
    bias = torch.randn(cfg.hidden, device=dev, generator=gen)
    b, c = (torch.randn(shape, device=dev, generator=gen)
            for shape in ((n, 2), (2, n)))
    q, k = (torch.randn(n, 2, device=dev, generator=gen) for _ in range(2))
    v = torch.randn(n, cfg.hidden, device=dev, generator=gen)
    x = torch.from_numpy(x_np).to(dev)
    gcn = port.gnn.init_gcn(cfg, seed=SEED, device=DEVICE)
    gat = port.gnn.init_gat(cfg, seed=SEED, device=DEVICE)
    pattern = a_dense != 0
    calls = {
        "matmul D=128": (lambda a, g: ops.matmul(a, h128, **kw),
                         lambda: a_dense @ h128),
        "matmul D=16": (lambda a, g: ops.matmul(a, h16, **kw),
                        lambda: a_dense @ h16),
        "matmul relu+bias D=128": (
            lambda a, g: a.matmul(h128, epilogue="relu", bias=bias, **kw),
            lambda: torch.relu(a_dense @ h128 + bias)),
        "sddmm K=2": (lambda a, g: ops.sddmm(a, b, c, **kw).densify(),
                      lambda: a_dense * (b @ c)),
        "fused_graph_attention dk=2 D=128": (
            lambda a, g: ops.fused_graph_attention(a, q, k, v, **kw),
            lambda: attention_oracle(torch, pattern, q, k, v)),
        "gcn_forward": (
            lambda a, g: port.gnn.gcn_forward(gcn, g, x, policy="autotune"),
            lambda: oracle_logits(torch, a_dense, gcn, x)),
        "gat_forward": (
            lambda a, g: port.gnn.gat_forward(gat, g, x, policy="autotune"),
            lambda: gat_oracle(torch, pattern, gat, x)),
    }
    launches, winners = {}, {}
    with own_global_cache(port, cache):
        for what, (run, oracle) in calls.items():
            want = oracle()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            out, counts, plans = run_counted(
                torch, port, lambda: run(graph.adj, graph))
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - base
            add_counts(launches, counts)
            timed = [p for p in plans if p.policy == "autotune"]
            bad = [p.timings_us for p in timed if not p.timings_us
                   or not all(math.isfinite(t)
                              for t in p.timings_us.values())]
            if not timed or bad:
                raise AssertionError(f"7a ({label}) {what}: no timed plan, "
                                     f"or a candidate failed: {bad}")
            err = hold_output(torch, f"7a ({label}) {what}", out, want)
            log(f"7a ({label}) {what}: {wall:.2f} s, peak device memory "
                f"beyond the inputs {peak / 2**30:.2f} GiB, max_abs_err "
                f"{err:.3e}; plans: {timings_text(plans)}; "
                f"launches {nonzero(counts)}")
            del out
            # again on a fresh plan memo: the cached winners, and only
            # their kernels
            fresh = graph.adj.with_stats(graph.adj.stats)
            g2 = port.gnn.Graph(adj=fresh, n_nodes=n)
            out, counts, plans = run_counted(torch, port,
                                             lambda: run(fresh, g2))
            add_counts(launches, counts)
            reasons = {p.reason for p in plans}
            want_counts = plan_launches(port, plans)
            err = hold_output(torch, f"7a ({label}) {what} again", out, want)
            log(f"7a ({label}) {what} again: plans "
                f"{[(p.op, p.path) for p in plans]}, {sorted(reasons)}; "
                f"launches {nonzero(counts)}; max_abs_err {err:.3e}")
            if reasons != {"autotune: cached winner"} \
                    or counts != want_counts:
                raise AssertionError(
                    f"7a ({label}) {what} again: {reasons}, launches "
                    f"{counts}, the winners' {want_counts}")
            winners[what] = [dict(op=p.op, fused=p.fused, path=p.path,
                                  timings_us=p.timings_us) for p in plans]
            del out, want
    # the cache through a file and back: the same winners
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "autotune.json")
        cache.save(path)
        again = port.autotune.AutotuneCache()
        again.load(path)
    entries = json.loads(cache.to_json())["entries"]
    if len(again) != len(entries) or any(
            again.get(tuple(e["key"])).path != e["path"] for e in entries):
        raise AssertionError(f"7a ({label}): the cache did not round-trip")
    log(f"7a ({label}): {len(entries)} cached winners, the same after "
        "save and load: " + "; ".join(f"{e['key']} -> {e['path']}"
                                      for e in entries))
    return launches, winners


def spmv_phase(torch, np, port, graph, a_dense, label, want_path):
    """7b: ``A @ v`` under auto and forced onto every candidate path (no
    kernel), then ``loss = (A.with_data(w) @ x).square().sum()`` on
    ``want_path``'s form (``spmv`` forced onto that path: on ell dx is N1
    at D = 1 and dA K3 at K = 1, on sell K2 over Aᵀ's row view and K4),
    dx and dA held to dense f32 autograd, the step run twice for
    ``torch.equal`` gradients.  Returns (the launches, a summary)."""
    dev = torch.device(DEVICE)
    n, ops, a = graph.n_nodes, port.ops, graph.adj
    v = torch.from_numpy(np.random.default_rng(SEED + 8).standard_normal(
        n).astype(np.float32)).to(dev)
    want = a_dense @ v
    launches, summary = {}, {}
    for policy in ("auto",) + ops.available_paths(a):
        run = (lambda: a @ v) if policy == "auto" \
            else (lambda: ops.spmv(a, v, policy=policy))
        y, counts, plans = run_counted(torch, port, run)
        add_counts(launches, counts)
        err = hold_output(torch, f"7b ({label}) A @ v {policy}", y, want)
        plan = plans[-1]
        summary[policy] = plan.path
        log(f"7b ({label}) A @ v, policy {policy}: plan {plan.op} -> "
            f"{plan.path} ({plan.reason}); launches {nonzero(counts)}; "
            f"max_abs_err {err:.3e}")
        if plan.op != "spmv" or any(counts.values()):
            raise AssertionError(f"7b ({label}) A @ v {policy}: plan "
                                 f"{plan.op}, launches {counts}")
    ap = a.to(want_path)

    def step():
        w = ap.data.detach().clone().requires_grad_(True)
        x = v.clone().requires_grad_(True)
        ops.spmv(ap.with_data(w), x, policy=want_path).square().sum() \
            .backward()
        return w.grad, x.grad

    (gw, gx), counts, plans = run_counted(torch, port, step)
    add_counts(launches, counts)
    expect = {"ell": {"N1": 1, "K3": 1}, "sell": {"K2": 1, "K4": 1}}[
        want_path]
    vjp = [(p.op, p.path) for p in plans if p.policy == "vjp"]
    if counts != expected(port, expect, 1):
        raise AssertionError(f"7b ({label}) SpMV step launches {counts}, "
                             f"expected {expect}")
    again = step()
    same = torch.equal(gw, again[0]) and torch.equal(gx, again[1])
    del again
    ad = a_dense.clone().requires_grad_(True)
    xd = v.clone().requires_grad_(True)
    (ad @ xd).square().sum().backward()
    errs = {}
    for what, got, want_g in (
            ("dx", gx, xd.grad),
            ("dA", ap.with_data(gw).densify(),
             torch.where(a_dense != 0, ad.grad, 0.0))):
        err = float((got - want_g).abs().max())
        top = float(want_g.abs().max())
        tol = ORACLE_RTOL * top + GRAD_ATOL
        errs[what] = err
        log(f"7b ({label}) SpMV {what} vs dense f32 autograd: max_abs_err "
            f"{err:.3e}, max|want| {top:.3e}, tol {tol:.3e}")
        if err > tol or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"7b ({label}) SpMV {what} off the oracle")
        del got, want_g
    log(f"7b ({label}) SpMV step on {want_path}: launches "
        f"{nonzero(counts)}, vjp plans {vjp}; run twice: "
        f"{'the same bits' if same else 'different bits'}")
    if not same:
        raise AssertionError(f"7b ({label}) SpMV gradients differ between "
                             "two runs")
    del ad, xd, gw, gx
    summary.update(step_launches=nonzero(counts), vjp=vjp,
                   grad_errors=errs)
    return launches, summary


def legacy_phase(torch, np, port, graph, a_dense, label):
    """7c: ``dispatch_spmm`` over a ``LazyForms`` of A's Block-ELL form at
    D = 128 (auto, forced ell, autotune) and over a 4096-node dense slice
    of A (auto), and ``dispatch_sddmm`` over A's Block-COO view at K = 2
    (auto, forced ell); every output held to the oracle, each call's
    launches those of its plan; then ``obs.AUDIT``'s summary.  Returns the
    launches and the plans."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    n, disp = graph.n_nodes, port.dispatch
    h = torch.randn(n, port.cfg.hidden, device=dev, generator=gen)
    b, c = (torch.randn(shape, device=dev, generator=gen)
            for shape in ((n, 2), (2, n)))
    forms = port.forms.LazyForms.from_blockell(graph.adj.form("ell"))
    coo = port.paths.ell_to_coo(graph.adj.form("ell"))
    sub = a_dense[:4096, :4096]
    cache = port.autotune.AutotuneCache()
    port.obs.AUDIT.clear()
    sampled = lambda: a_dense * (b @ c)  # noqa: E731
    calls = [
        ("dispatch_spmm(ell form) D=128 auto",
         lambda: disp.dispatch_spmm(forms, h), lambda: a_dense @ h),
        ("dispatch_spmm(ell form) D=128 ell",
         lambda: disp.dispatch_spmm(forms, h, policy="ell"),
         lambda: a_dense @ h),
        ("dispatch_spmm(ell form) D=128 autotune",
         lambda: disp.dispatch_spmm(forms, h, policy="autotune",
                                    cache=cache), lambda: a_dense @ h),
        ("dispatch_spmm(4096-node dense slice) D=128 auto",
         lambda: disp.dispatch_spmm(sub.cpu().numpy(), h[:4096]),
         lambda: sub @ h[:4096]),
        ("dispatch_sddmm(Block-COO) K=2 auto",
         lambda: port.paths.densify_coo(disp.dispatch_sddmm(coo, b, c)),
         sampled),
        ("dispatch_sddmm(Block-COO) K=2 ell",
         lambda: port.paths.densify_coo(disp.dispatch_sddmm(
             coo, b, c, policy="ell")), sampled),
    ]
    launches, plans_out = {}, {}
    for what, run, oracle in calls:
        t0 = time.perf_counter()
        out, counts, plans = run_counted(torch, port, run)
        wall = time.perf_counter() - t0
        add_counts(launches, counts)
        plan = plans[-1]
        plans_out[what] = dict(path=plan.path, timings_us=plan.timings_us)
        err = hold_output(torch, f"7c {what}", out, oracle())
        log(f"7c ({label}) {what}: plan {plan.path} ({plan.reason}); "
            f"launches {nonzero(counts)}; max_abs_err {err:.3e}; "
            f"{wall:.2f} s with the host conversions")
        if plan.policy != "autotune" \
                and counts != plan_launches(port, [plan]):
            raise AssertionError(f"7c {what}: launches {counts}, its plan's "
                                 f"{plan_launches(port, [plan])}")
        if plan.policy == "autotune" and not all(
                math.isfinite(t) for t in plan.timings_us.values()):
            raise AssertionError(f"7c {what}: a candidate failed")
        del out
    log(f"7c ({label}) obs.AUDIT predicted vs measured: "
        f"{json.dumps(port.obs.AUDIT.summary())}; mispredictions "
        f"{json.dumps(port.obs.AUDIT.mispredictions())}")
    return launches, plans_out


def width_one_rows(torch, port, graph, want_path):
    """The SpMV backward's kernels at the shapes phase 7b gives them, each
    held to its plain version beside its bound and its library call: dA,
    K3 without a mask (every cell, as ``sample_exec`` launches it) on (a)
    or K4 on (b), at K = 1 against ``sampled_addmm``; dx, N1 on (a) or K2
    over Aᵀ's row view on (b), at D = 1 (``transposed_rows``)."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    n, paths = graph.n_nodes, port.paths
    a_lib = library_csr(torch, graph)
    b = torch.randn(n, 1, device=dev, generator=gen)
    c = torch.randn(1, n, device=dev, generator=gen)
    sampled = lambda: torch.sparse.sampled_addmm(  # noqa: E731
        a_lib, b, c, beta=0.0)
    rows = {}
    if want_path == "ell":
        coo = paths.ell_to_coo(graph.adj.form("ell"))
        bp, cp = paths.pad_rows(b, coo.shape[0]), paths.pad_cols(
            c, coo.shape[1]).contiguous()
        cells = coo.nnzb * coo.bm * coo.bn
        args = (coo.rows, coo.cols, None, bp, cp)
        kw = dict(block=(coo.bm, coo.bn), out_dtype=torch.float32)
        rows["K3 K=1"] = measure(
            torch, "K3 no mask at K=1 (the SpMV's dA)",
            lambda: port.wrappers["K3"](*args, **kw),
            lambda: port.sddmm_ref.sddmm_blockcoo_ref(*args, **kw), sampled,
            nbytes_of(coo.rows, coo.cols, bp, cp) + cells * 4, 2 * cells,
            f"nnzb={coo.nnzb} blocks {coo.bm}x{coo.bn} K=1; {cells} "
            "sampled cells; library: sampled_addmm")
    else:
        sell = graph.adj.form("sell")
        args = (*port.sddmm_sell.sddmm_sell_operands(sell), b, c)
        row_slot, row_nnz, perm, slot_cols = args[:4]
        nnz = int(row_nnz.sum())
        rows["K4 K=1"] = measure(
            torch, "K4 at K=1 (the SpMV's dA)",
            lambda: port.wrappers["K4"](*args),
            lambda: port.sddmm_sell.sddmm_sell_slots_ref(*args), sampled,
            nbytes_of(row_slot, row_nnz, perm, b, c)
            + nnz * slot_cols.element_size() + sell.n_slots * 4, 2 * nnz,
            f"rows={row_slot.shape[0]} nonzeros={nnz} K=1; library: "
            "sampled_addmm")
    del args
    rows.update(transposed_rows(torch, port, graph, want_path, gen,
                                widths=(1,)))
    return rows


def dispatch_phase(torch, np, port, graph, adj, x_np, label, want_path):
    """Phase 7 on one graph (7a, 7b; 7c on (a)) and the SpMV backward's
    kernel rows; returns (the launches, the rows, a summary)."""
    t0 = time.perf_counter()
    dev = torch.device(DEVICE)
    a_dense = torch.from_numpy(normalized_dense(np, adj)).to(dev)
    launches, winners = autotune_phase(torch, np, port, graph, a_dense,
                                       x_np, label)
    spmv_launches, spmv_summary = spmv_phase(torch, np, port, graph,
                                             a_dense, label, want_path)
    add_counts(launches, spmv_launches)
    summary = {"autotune": winners, "spmv": spmv_summary}
    if want_path == "ell":
        legacy_launches, summary["legacy"] = legacy_phase(
            torch, np, port, graph, a_dense, label)
        add_counts(launches, legacy_launches)
    del a_dense
    torch.cuda.empty_cache()
    rows = width_one_rows(torch, port, graph, want_path)
    summary["wall_s"] = time.perf_counter() - t0
    log(f"phase 7 ({label}): launches {nonzero(launches)}; wall "
        f"{summary['wall_s']:.1f} s")
    return launches, rows, summary


def serve_buckets(np, port):
    """The buckets of phase 6a's graphs (the same seeds and sizes), on
    16 x 16 blocks."""
    rng = np.random.default_rng(0)
    sizes = rng.integers(40, 720, size=SERVE_GRAPHS)
    cfg = dataclasses.replace(port.cfg, block_m=16, block_n=16)
    buckets = {}
    for i, n in enumerate(sizes):
        adj = port.random_graph(int(n), avg_degree=4, seed=i)
        stats = port.gnn.build_graph(adj, cfg, device="cpu").stats
        bucket = port.batch.bucket_for(stats)
        buckets[bucket.label] = bucket
    return [buckets[k] for k in sorted(buckets)]


def calibrate_phase(torch, np, port, graphs):
    """7d: ``calibrate`` on the card at its defaults and at n = 4096,
    d = 128; the constants beside the shipped (TPU) ones, and the plans
    the calibrated model would give beside the shipped model's: graphs (a)
    and (b) at D = 128 and 16, their fused GAT layers, and phase 6a's
    buckets at D = 128 and 16.  Prints only: ``DEFAULT_COST_MODEL`` is not
    changed."""
    disp = port.dispatch
    shipped = disp.DEFAULT_COST_MODEL
    models, out = {}, {}
    for what, kw in (("defaults", {}),
                     ("n=4096 d=128", dict(n=4096, d=128,
                                           densities=(0.1, 0.01, 0.001)))):
        t0 = time.perf_counter()
        cm = disp.calibrate(device=DEVICE, **kw)
        models[what] = cm
        out[what] = {k: getattr(cm, k) for k in ("c_ell", "c_sell", "c_csr")}
        log(f"7d calibrate ({what}, {time.perf_counter() - t0:.1f} s): "
            + ", ".join(f"{k} {getattr(cm, k):.4f} (shipped "
                        f"{getattr(shipped, k)})"
                        for k in ("c_ell", "c_sell", "c_csr")))
    cm = models["n=4096 d=128"]
    plans = {}
    for label, (stats, cand, graph_cand) in graphs.items():
        for d in (port.cfg.hidden, port.cfg.n_classes):
            plans[f"({label}) spmm D={d}"] = [
                disp.plan_spmm(stats, d, cost_model=m,
                               candidates=cand).path for m in (shipped, cm)]
        plans[f"({label}) fused GAT D={port.cfg.hidden}"] = [
            disp.plan_fused_attention(stats, 2, port.cfg.hidden,
                                      cost_model=m,
                                      candidates=graph_cand).path
            for m in (shipped, cm)]
    for bucket in serve_buckets(np, port):
        stats = port.batch.canonical_stats(bucket)
        for d in (port.cfg.hidden, port.cfg.n_classes):
            plans[f"6a {bucket.label} D={d}"] = [
                disp.plan_spmm(stats, d, cost_model=m,
                               candidates=("ell", "csr")).path
                for m in (shipped, cm)]
    log("7d plans, the shipped model's then the calibrated (n=4096 d=128) "
        "model's: " + "; ".join(f"{k}: {a} -> {b}"
                                for k, (a, b) in plans.items()))
    out["plans_shipped_then_calibrated"] = plans
    return out


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
    for name in ("K3p", "N1", "K7b"):  # rows at the backward's shapes
        if name in backward:
            rows[name] = dict(backward[name], launches=0)
    for name, count in launches.items():
        if count and name not in rows:
            raise AssertionError(f"training on ({label}) launched {name}, "
                                 "a kernel of the other path")
        if count:
            rows[name]["launches"] += count
    # phase 7 on the same packing; its launches (autotune times the other
    # path's kernels too) join the kernel rows once both graphs' are in
    dispatch_launches, width_one, dispatch = dispatch_phase(
        torch, np, port, graph, adj, xs[0], label, want_path)
    dispatch.update(launches=nonzero(dispatch_launches), rows=width_one,
                    plan_inputs=(graph.stats,
                                 port.ops.available_paths(graph.adj),
                                 port.gnn.graph_candidates(graph.adj)))
    return rows, backward, dispatch


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
    ell_np, val_np = port.bsattn.banded_ell(s, blk, blk, 0)
    ell, val = (torch.from_numpy(a).to(dev) for a in (ell_np, val_np))
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
    # the bound as phase 4's f32 rows count it: three TF32 products per
    # product over the live pairs, against the bytes of q, k, v, the
    # output and the ELL arrays
    flops = 4 * d * live_pairs(np, ell_np, val_np, blk, blk, 0) * h
    nbytes = (2 * h + 2 * hkv) * s * d * 4 + 2 * ell.numel() * 4
    bound_ms, bound_by = bound(nbytes, 3 * flops, PEAK_TF32_FLOP_PER_S)
    from torch.nn.attention import SDPBackend

    del want
    lib_ms, lib = time_sdpa(torch, q, k, v, dict(is_causal=True), out,
                            [SDPBackend.FLASH_ATTENTION,
                             SDPBackend.EFFICIENT_ATTENTION,
                             SDPBackend.CUDNN_ATTENTION])
    log(f"K9 [(iii) S={s} window=0 H={h} Hkv={hkv} D={d} float32]: kernel "
        f"{ms:.4f} ms, launches {counts} | SDPA {lib} | bound {bound_ms:.4f} "
        f"ms ({bound_by}: {nbytes / 1e9:.3f} GB, {3 * flops / 1e9:.1f} GFLOP "
        f"at {PEAK_TF32_FLOP_PER_S / 1e12:.0f} TFLOP/s)")
    del q, k, v, out
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


# ---------------------------------------------------------------------------
# Phase 6: batched and continuous GNN serving, and the DeltaGraph overlay
# ---------------------------------------------------------------------------


def resilience_counts(port) -> dict:
    """Every ``resilience_*`` counter series (retries, degrades,
    quarantines, sheds, worker restarts, recoveries)."""
    counters = port.obs.REGISTRY.snapshot()["counters"]
    return {k: dict(v) for k, v in counters.items()
            if k.startswith("resilience_")}


def lane_calls(port, ex, form: str) -> int:
    """Executed batches of ``ex`` on ``form`` (the sentry's lane calls)."""
    prefix = f"x{ex.uid}/"
    return sum(v["calls"] for lane, v in port.obs.SENTRY.lanes().items()
               if lane.startswith(prefix) and lane.endswith(f"/{form}"))


def csr_tensor(torch, rows, cols, vals, shape):
    """A torch CSR tensor of element triplets (zero entries kept)."""
    return torch.sparse_coo_tensor(torch.stack([rows.long(), cols.long()]),
                                   vals, shape).to_sparse_csr()


def hold_requests(np, label, outs, oracle):
    """Every request's logits (host arrays) finite, of the oracle's shape,
    within ``ORACLE_RTOL`` x max|want| + ``ORACLE_ATOL``; returns the worst
    error."""
    worst = 0.0
    for i, (got, want) in enumerate(zip(outs, oracle)):
        err = float(np.abs(got - want).max())
        tol = ORACLE_RTOL * float(np.abs(want).max()) + ORACLE_ATOL
        if got.shape != want.shape or not np.isfinite(got).all() \
                or err > tol:
            raise AssertionError(f"{label}: request {i} off the dense "
                                 f"oracle: max_abs_err {err:.3e} > {tol:.3e}")
        worst = max(worst, err)
    return worst


def serve_run(torch, np, port, params, graphs, reqs, oracle, form,
              max_batch):
    """One ``BatchServingEngine.for_gcn`` run at bench_serve's settings:
    a warm pass, a timed pass (launch counts set to 0 just before, read
    just after), a profiled pass, and the same group run twice through
    the executor for equal bits."""
    label = f"6a form={form} max_batch={max_batch}"
    scfg = port.engine.BatchServeConfig(max_batch=max_batch,
                                        max_delay_ms=SERVE_DELAY_MS,
                                        form=form, device=DEVICE)
    with port.engine.BatchServingEngine.for_gcn(params, scfg=scfg) as eng:
        ex = eng.executor
        for g, x in reqs:                      # warm every executor
            eng.submit(graphs[g], x)
        eng.drain(timeout=600.0)
        warm = ex.compiles
        eng.reset_metrics()
        ell0 = lane_calls(port, ex, "ell")
        torch.cuda.synchronize()
        port.reset_counts()
        t0 = time.perf_counter()
        futs = [eng.submit(graphs[g], x) for g, x in reqs]
        outs = [f.result(timeout=600.0) for f in futs]
        elapsed = time.perf_counter() - t0
        counts = port.counts()
        ell_batches = lane_calls(port, ex, "ell") - ell0
        rep = eng.report()
        steady = ex.compiles - warm
        busy = profiled_pass(torch, eng, graphs, reqs, label)
        group = reqs[:max_batch]
        first = ex.run([graphs[g].adj for g, _ in group],
                       [x for _, x in group])
        again = ex.run([graphs[g].adj for g, _ in group],
                       [x for _, x in group])
        same_bits = all(np.array_equal(a, b) for a, b in zip(first, again))
        plans = sorted({f"{b.label}: {p.path}"
                        for (b, _), p in ex._bucket_plans.items()}) \
            or ["every bucket: ell (form forced)"]
    worst = hold_requests(np, label, outs, oracle)
    want = expected(port, {"K5": 2, "K1": 1}, ell_batches)
    waste = rep["executor"]["waste"]
    log(f"{label}: {len(reqs) / elapsed:.1f} req/s (wall), p50 "
        f"{rep['p50_ms']:.3f} ms, p99 {rep['p99_ms']:.3f} ms; compiles warm "
        f"{warm}, steady {steady}; {rep['executor']['calls']} calls over "
        f"{rep['executor']['buckets']} buckets; flushes {rep['flushes']}; "
        f"padding {json.dumps({k: v for k, v in waste.items() if k != 'per_bucket'})}; "
        f"logits vs dense f32 oracle max_abs_err {worst:.3e}; launches "
        f"{counts} for {ell_batches} ell batches; one group run twice: "
        f"{'the same bits' if same_bits else 'different bits'}")
    log(f"{label}: plans {plans}")
    if counts != want:
        raise AssertionError(f"{label}: launches {counts}, expected {want}")
    if rep["failed"] or steady:
        raise AssertionError(f"{label}: {rep['failed']} failed, {steady} "
                             "steady compiles")
    if not same_bits:
        raise AssertionError(f"{label}: one group run twice gave different "
                             "bits")
    return {"req_per_s": len(reqs) / elapsed, "p50_ms": rep["p50_ms"],
            "p99_ms": rep["p99_ms"], "warm_compiles": warm,
            "steady_compiles": steady, "waste": {
                k: v for k, v in waste.items() if k != "per_bucket"},
            "device_busy": busy, "ell_batches": ell_batches,
            "launches": {k: v for k, v in counts.items() if v},
            "same_bits_twice": same_bits, "plans": plans}


def profiled_pass(torch, eng, graphs, reqs, label):
    """One more pass under ``torch.profiler``: the device's busy share of
    its wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        futs = [eng.submit(graphs[g], x) for g, x in reqs]
        for f in futs:
            f.result(timeout=600.0)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = log_device_time(prof, wall, f"{label} profiled pass")
    return None if busy is None else {"busy_ms": busy, "wall_ms": wall}


def blockdiag_composition(torch, port, graphs, bucket, n_slots):
    """``n_slots`` of the graphs in ``bucket`` (in turn) padded into it
    and composed block-diagonally, in the ell and the csr form."""
    mats = [g.adj for g in graphs
            if port.batch.bucket_for(g.adj.stats) == bucket]
    mats = [mats[i % len(mats)] for i in range(n_slots)]
    forms = {f: port.batch.BatchedSparseMatrix.from_matrices(
        [port.batch.pad_to_bucket(m, bucket, form=f) for m in mats],
        formats=(f,)) for f in ("ell", "csr")}
    return mats, forms


def blockdiag_rows(torch, np, port, graphs, cfg):
    """K5 and K1 at 16 x 16 over a 32-graph block-diagonal composition of
    the largest bucket, and one ``batch_sddmm`` at K = 2 over it (K3),
    each held to its plain version (K3 also to the per-graph results)."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    bucket = max((port.batch.bucket_for(g.adj.stats) for g in graphs),
                 key=lambda b: (b.rows, b.nnz))
    mats, forms = blockdiag_composition(torch, port, graphs, bucket,
                                        SERVE_BATCHES[-1])
    B = forms["ell"]
    ell = B.matrix.form("ell")
    rows_, cols_, vals_ = forms["csr"].matrix.form("csr")
    a_lib = csr_tensor(torch, rows_, cols_, vals_, B.shape)
    nnz = int((ell.blocks != 0).sum())
    shape = (f"{B.n_graphs} graphs of bucket {bucket.label}; nbr="
             f"{ell.n_block_rows} W={ell.ell_width} block 16x16; {nnz} "
             "nonzeros")
    # the bound reads only the real blocks: the bucket's pad slots hold
    # zero blocks the product does not need
    real_bytes = int(ell.nblocks.sum()) * ell.bm * ell.bn \
        * ell.blocks.element_size()
    rows = {}
    for name, d, epi in (("K5", cfg.hidden, port.Epilogue(act="relu")),
                         ("K1", cfg.n_classes, None)):
        h = torch.randn(ell.shape[1], d, device=dev, generator=gen)
        args = (ell.indices, ell.blocks, h) if epi is None \
            else (ell.indices, ell.blocks, h, None, None)
        kw = {} if epi is None else dict(epi=epi)
        plain = port.ref.spmm_blockell_ref if epi is None \
            else port.fused.spmm_blockell_epilogue_ref
        rows[name] = measure(
            torch, f"{name} 16x16 block-diagonal",
            lambda: port.wrappers[name](*args, **kw),
            lambda: plain(*args, **kw), lambda: torch.sparse.mm(a_lib, h),
            nbytes_of(ell.indices, h) + real_bytes + ell.shape[0] * d * 4,
            2 * nnz * d + (0 if epi is None else ell.shape[0] * d),
            f"{shape}; D={d}; library: torch.sparse.mm")
        full = nbytes_of(ell.indices, ell.blocks, h) + ell.shape[0] * d * 4
        log(f"  {name} bytes with every slot's block (a diagnostic, not "
            f"the bound): {full / 1e9:.4f} GB")
        # a diagnostic: the same launch with every block-row cut to the
        # widest real one (the bucket's pad slots sit past each graph's
        # blocks), and its share of the slots
        width = int(ell.nblocks.max())
        cut = (ell.indices[:, :width].contiguous(),
               ell.blocks[:, :width].contiguous(), *args[2:])
        cut_ms = time_ms(torch, lambda: port.wrappers[name](*cut, **kw))
        log(f"  {name} with the pad slots cut to W={width} "
            f"({int(ell.nblocks.sum())} real blocks of "
            f"{ell.n_block_rows * ell.ell_width} slots): {cut_ms:.4f} ms")
    # K3: one batch_sddmm at K = 2 over the composition (the entry point)
    k = 2
    bs = [torch.randn(s.rows_logical, k, device=dev, generator=gen)
          for s in B.segments]
    cs = [torch.randn(k, s.cols_logical, device=dev, generator=gen)
          for s in B.segments]
    torch.cuda.synchronize()
    port.reset_counts()
    got = port.batch.batch_sddmm(B, bs, cs, policy="ell")
    torch.cuda.synchronize()
    counts = port.counts()
    if counts != expected(port, {"K3": 1}, 1):
        raise AssertionError(f"6a batch_sddmm launches {counts}")
    err = 0.0
    for part, m, b, c, seg in zip(got, mats, bs, cs, B.segments):
        padded = port.batch.pad_to_bucket(m, bucket, form="ell")
        want = padded.sddmm(port.paths.pad_rows(b, seg.rows),
                            port.paths.pad_cols(c, seg.cols),
                            policy="ell").data
        err = max(err, check_close(torch, "6a batch_sddmm vs per graph",
                                   part, want))
    coo = port.paths.ell_to_coo(ell)
    bp = torch.cat([port.paths.pad_rows(b, s.rows)
                    for b, s in zip(bs, B.segments)])
    cp = torch.cat([port.paths.pad_cols(c, s.cols)
                    for c, s in zip(cs, B.segments)], dim=1).contiguous()
    args = (coo.rows, coo.cols, coo.blocks, bp, cp)
    cells = coo.nnzb * coo.bm * coo.bn
    rows["K3"] = measure(
        torch, "K3 16x16 block-diagonal (batch_sddmm's launch)",
        lambda: port.wrappers["K3"](*args),
        lambda: port.sddmm_ref.sddmm_blockcoo_ref(*args),
        lambda: torch.sparse.sampled_addmm(a_lib, bp, cp, beta=0.0),
        nbytes_of(coo.rows, coo.cols, coo.blocks, bp, cp) + cells * 4,
        2 * k * cells + cells,
        f"{shape}; K={k}; A's values as the mask; library: sampled_addmm "
        "(unweighted)")
    log(f"6a batch_sddmm: K3 x{counts['K3']}, {B.n_graphs} graphs held to "
        f"their per-graph samples (max_abs_err {err:.3e})")
    for name in ("K5", "K1", "K3"):
        rows[name]["launches"] = counts[name] if name == "K3" else 0
    return rows


def batched_serving_phase(torch, np, port):
    """Phase 6a: ``BatchServingEngine.for_gcn`` at bench_serve's full
    settings (12 graphs of 40-720 nodes, 512 requests, max_batch 1 / 8 /
    32, 4 ms window) with ``CONFIG``'s widths on 16 x 16 blocks, at
    ``form="auto"`` and ``form="ell"``; then K5 / K1 / K3 at the
    composition's shapes."""
    dev = torch.device(DEVICE)
    cfg = dataclasses.replace(port.cfg, block_m=16, block_n=16)
    params = port.gnn.init_gcn(cfg, seed=SEED, device=DEVICE)
    rng = np.random.default_rng(0)
    sizes = rng.integers(40, 720, size=SERVE_GRAPHS)
    adjs = [port.random_graph(int(n), avg_degree=4, seed=i)
            for i, n in enumerate(sizes)]
    graphs = [port.gnn.build_graph(a, cfg, device=DEVICE) for a in adjs]
    dense = [torch.from_numpy(normalized_dense(np, a)).to(dev) for a in adjs]
    reqs, oracle = [], []
    for i in range(SERVE_REQUESTS):
        g = i % len(graphs)
        x = torch.from_numpy(rng.normal(
            size=(graphs[g].n_nodes, cfg.in_features)).astype(np.float32)) \
            .to(dev)
        reqs.append((g, x))
        oracle.append(oracle_logits(torch, dense[g], params, x).cpu().numpy())
    log(f"6a: graphs of {sorted(int(n) for n in sizes)} nodes (avg degree "
        f"4), {SERVE_REQUESTS} requests, widths {cfg.in_features} -> "
        f"{cfg.hidden} -> {cfg.hidden} -> {cfg.n_classes}, blocks 16x16")
    runs = {}
    totals = dict.fromkeys(port.wrappers, 0)
    for form in SERVE_FORMS:
        for mb in SERVE_BATCHES:
            run = serve_run(torch, np, port, params, graphs, reqs, oracle,
                            form, mb)
            runs[f"{form}/b{mb}"] = run
            for name, n in run["launches"].items():
                totals[name] += n
    rows = blockdiag_rows(torch, np, port, graphs, cfg)
    for name in ("K5", "K1"):
        rows[name]["launches"] = totals[name]
    return rows, runs


def adaptive_workload(torch, np, port, cfg, params):
    """bench_serve_adaptive's drifting mix at its full settings: three
    phases of ``ADAPTIVE_PER_PHASE`` requests (seed 7), each with 3 hot
    sizes taking ~75 % of the requests and 8 tail sizes."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(7)
    reqs = []
    for p, (lo, hi) in enumerate(ADAPTIVE_PHASES):
        hot = rng.integers(lo, hi, size=3)
        tail = rng.integers(lo, hi, size=8)
        graphs = {}
        for i, n in enumerate(np.concatenate([hot, tail])):
            adj = port.random_graph(int(n), avg_degree=4, seed=100 * p + i)
            graphs[int(n)] = (port.gnn.build_graph(adj, cfg, device=DEVICE),
                              torch.from_numpy(normalized_dense(np, adj))
                              .to(dev))
        for _ in range(ADAPTIVE_PER_PHASE):
            pool = hot if rng.random() < 0.75 else tail
            g, a = graphs[int(pool[rng.integers(len(pool))])]
            x = torch.from_numpy(rng.normal(
                size=(g.n_nodes, cfg.in_features)).astype(np.float32)).to(dev)
            reqs.append((g, x, oracle_logits(torch, a, params, x)
                         .cpu().numpy()))
    return reqs


def continuous_phase(torch, np, port):
    """Phase 6b: ``ContinuousBatchEngine.for_gcn`` at bench_serve_adaptive's
    full settings (in 128, hidden 64, 2 layers, 16 x 16 blocks; slots 4,
    adaptive, 40 ms window, ``form="ell"``): a warm pass, then a timed
    pass with its launches counted; steady compiles must be 0."""
    cfg = port.GNNConfig(name="serve-adaptive", in_features=128, hidden=64,
                         n_classes=4, n_layers=2, block_m=16, block_n=16)
    params = port.gnn.init_gcn(cfg, seed=SEED, device=DEVICE)
    reqs = adaptive_workload(torch, np, port, cfg, params)
    ccfg = port.runtime.ContinuousConfig(slots=4, adaptive=True,
                                         max_wait_ms=40.0, form="ell",
                                         device=DEVICE)
    with port.runtime.ContinuousBatchEngine.for_gcn(params, cfg=ccfg) as eng:
        # warm passes (bench_serve_adaptive's: submit all, drain) until one
        # compiles nothing: the ladder refits as the mix drifts within a
        # pass, and its rungs settle only after a few passes
        warm_passes = []
        while len(warm_passes) < ADAPTIVE_WARM_PASSES:
            c0 = eng.executor.compiles
            for g, x, _ in reqs:
                eng.submit(g, x)
            eng.drain(timeout=600.0)
            warm_passes.append(eng.executor.compiles - c0)
            if not warm_passes[-1]:
                break
        warm = eng.executor.compiles
        refits = eng.ladder.refits
        eng.reset_metrics()
        torch.cuda.synchronize()
        port.reset_counts()
        t0 = time.perf_counter()
        futs = []
        backlog = 8 * ccfg.slots
        for g, x, _ in reqs:
            futs.append(eng.submit(g, x))
            while eng.pending() > backlog:
                eng.step()
        eng.drain(timeout=600.0)
        outs = [f.result(timeout=600.0) for f in futs]
        elapsed = time.perf_counter() - t0
        counts = port.counts()
        rep = eng.report()
        steady = eng.executor.compiles - warm
        lane_errs = lane_kernel_checks(torch, port, eng, reqs, cfg)
    calls = rep["executor"]["calls"]
    worst = hold_requests(np, "6b", outs, [o for _, _, o in reqs])
    want = expected(port, {"K5": 1, "K1": 1}, calls)
    waste = rep["executor"]["waste"]
    ladder = rep["executor"]["ladder"]
    occ = [v["occupancy"] for v in rep["lanes"].values()]
    log(f"6b continuous: {len(reqs)} requests, {len(reqs) / elapsed:.1f} "
        f"req/s (wall), p50 {rep['p50_ms']:.3f} ms, p99 {rep['p99_ms']:.3f} "
        f"ms; compiles over the warm passes {warm_passes} ({warm} in all, "
        f"ladder refits {refits}), steady {steady}; {calls} lane steps over "
        f"{len(rep['lanes'])} lanes (occupancy mean "
        f"{sum(occ) / max(len(occ), 1):.3f}); waste fraction "
        f"{waste['waste_fraction']}; ladder refits {ladder['refits']}, "
        f"fallbacks {ladder['fallbacks']}, snapped {ladder['snapped_rungs']};"
        f" logits vs dense f32 oracle max_abs_err {worst:.3e}; launches "
        f"{counts}")
    if counts != want:
        raise AssertionError(f"6b launches {counts}, expected {want}")
    if steady or rep["failed"]:
        raise AssertionError(f"6b: {steady} steady compiles, "
                             f"{rep['failed']} failed")
    return {"req_per_s": len(reqs) / elapsed, "p50_ms": rep["p50_ms"],
            "p99_ms": rep["p99_ms"], "warm_compiles": warm,
            "warm_passes": warm_passes, "steady_compiles": steady,
            "lane_steps": calls,
            "lanes": len(rep["lanes"]),
            "lane_kernel_errs": lane_errs,
            "waste_fraction": waste["waste_fraction"],
            "launches": {k: v for k, v in counts.items() if v}}


def lane_kernel_checks(torch, port, eng, reqs, cfg):
    """K5 at D = ``cfg.hidden`` (bias, relu) and K1 at D = ``cfg.n_classes``
    through their wrappers on one composition of 6b's busiest lane (graphs
    of its bucket padded in, the last slot an all-zero dummy), each held to
    its plain version; returns their errors."""
    dev = torch.device(DEVICE)
    lane = max(eng._lanes.values(), key=lambda l: l.steps)
    mats, seen = [], set()
    for g, _, _ in reqs:
        if len(mats) == len(lane.slots) - 1:
            break
        if id(g) not in seen and \
                eng.executor.ladder.bucket_for(g.adj.stats) == lane.bucket:
            seen.add(id(g))
            mats.append(port.batch.pad_to_bucket(g.adj, lane.bucket,
                                                 form=lane.form))
    if not mats:
        raise AssertionError(f"6b: no graph of the workload maps to lane "
                             f"{lane.bucket.label}")
    mats += [lane.dummy] * (len(lane.slots) - len(mats))
    ell = port.batch.BatchedSparseMatrix.from_matrices(
        mats, formats=("ell",), stats=lane.stats).matrix.form("ell")
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    h = torch.randn(ell.shape[1], cfg.hidden, device=dev, generator=gen)
    bias = torch.randn(cfg.hidden, device=dev, generator=gen)
    epi = port.Epilogue(act="relu", has_bias=True)
    ops5 = (ell.indices, ell.blocks, h, bias, None)
    errs = {"K5": check_close(
        torch, f"6b K5 D={cfg.hidden}", port.wrappers["K5"](*ops5, epi=epi),
        port.fused.spmm_blockell_epilogue_ref(*ops5, epi=epi))}
    h1 = torch.randn(ell.shape[1], cfg.n_classes, device=dev, generator=gen)
    ops1 = (ell.indices, ell.blocks, h1)
    errs["K1"] = check_close(torch, f"6b K1 D={cfg.n_classes}",
                             port.wrappers["K1"](*ops1),
                             port.ref.spmm_blockell_ref(*ops1))
    log(f"6b lane {lane.bucket.label} ({len(seen)} graphs and "
        f"{len(lane.slots) - len(seen)} dummy of {len(lane.slots)} slots; "
        f"nbr={ell.n_block_rows} W={ell.ell_width}): K5 D={cfg.hidden} "
        f"max_abs_err {errs['K5']:.3e}, K1 D={cfg.n_classes} max_abs_err "
        f"{errs['K1']:.3e} against their plain versions")
    return errs


def delta_stream(np, rng, dg, cur, force_repack: bool):
    """One batch of seeded deltas against the overlay's current packing:
    value updates and deletes of live edges, inserts into materialized
    tiles of rows with free slack (one a row), and with ``force_repack``
    one insert into a tile the packing never materialized, last.
    ``cur`` (the live dense matrix) is updated to match."""
    ov = dg._overlay
    edges = list(ov.edge_map)
    pick = rng.permutation(len(edges))[:DELTA_UPDATES + DELTA_DELETES]
    deltas = []
    for j, e in enumerate(pick):
        r, c = edges[e]
        if j < DELTA_UPDATES:
            v = float(cur[r, c]) * 1.5
            deltas.append(("insert", r, c, v))
            cur[r, c] = v
        else:
            deltas.append(("delete", r, c, 0.0))
            cur[r, c] = 0.0
    tiles_of = {}
    for (cbr, bc) in ov.tiles_index:
        tiles_of.setdefault(cbr, []).append(bc)
    slack_rows = [p for p, free in ov.row_free.items() if free]
    n = cur.shape[1]
    for p in rng.permutation(len(slack_rows)):
        if len(deltas) >= DELTA_UPDATES + DELTA_DELETES + DELTA_INSERTS:
            break
        p = slack_rows[p]
        r = ov.packed_to_orig.get(p)
        cols = tiles_of.get(ov.compact_of_pbr.get(p // ov.bm, -1))
        if r is None or not cols:
            continue
        c = int(cols[rng.integers(len(cols))] * ov.bn + rng.integers(ov.bn))
        if c < n and cur[r, c] == 0:
            deltas.append(("insert", r, c, 0.05))
            cur[r, c] = 0.05
    if force_repack:
        r = int(rng.integers(cur.shape[0]))
        cbr = ov.compact_of_pbr.get(int(ov.out_gather_h[r]) // ov.bm, -1)
        while True:
            c = int(rng.integers(n))
            if (cbr, c // ov.bn) not in ov.tiles_index and cur[r, c] == 0:
                break
        deltas.append(("insert", r, c, 0.05))
        cur[r, c] = 0.05
    return deltas


def overlay_rows(torch, port, sell, a_lib, h, b, c, q_perm, kt, timed):
    """K2, K6, K4 and K8 on the overlay's row view, each held to its plain
    version (timed beside it, the library call and the bound, when
    ``timed``)."""
    heavy = sell.tile_heavy_rows
    row_slot, row_nnz, slot_cols, slot_vals = \
        port.sell.sell_row_operands(sell)
    nnz = int(row_nnz.sum())  # the slots the row view reads
    d = h.shape[1]
    n_rows = row_slot.shape[0]
    row_bytes = nbytes_of(row_slot, row_nnz, heavy) + nnz * 8
    relu = port.Epilogue(act="relu")
    kw_attn = dict(act="leaky_relu", slope=0.2)
    aops = port.attention.fused_attn_sell_operands(sell)
    sops = port.sddmm_sell.sddmm_sell_operands(sell)
    specs = {
        "K2": (lambda: port.wrappers["K2"](row_slot, row_nnz, slot_cols,
                                           slot_vals, h, heavy_rows=heavy),
               lambda: port.sell.spmm_sell_slots_ref(
                   row_slot, row_nnz, slot_cols, slot_vals, h),
               lambda: torch.sparse.mm(a_lib, h),
               row_bytes + nbytes_of(h) + n_rows * d * 4, 2 * nnz * d,
               "torch.sparse.mm"),
        "K6": (lambda: port.wrappers["K6"](row_slot, row_nnz, slot_cols,
                                           slot_vals, h, None, None,
                                           epi=relu, heavy_rows=heavy),
               lambda: port.fused.spmm_sell_epilogue_slots_ref(
                   row_slot, row_nnz, slot_cols, slot_vals, h, None, None,
                   epi=relu),
               lambda: torch.sparse.mm(a_lib, h),
               row_bytes + nbytes_of(h) + n_rows * d * 4,
               2 * nnz * d + n_rows * d, "torch.sparse.mm"),
        "K4": (lambda: port.wrappers["K4"](*sops, b, c),
               lambda: port.sddmm_sell.sddmm_sell_slots_ref(*sops, b, c),
               lambda: torch.sparse.sampled_addmm(a_lib, b, c, beta=0.0),
               nbytes_of(row_slot, row_nnz, sops[2], b, c) + nnz * 4
               + sell.n_slots * 4, 2 * b.shape[1] * nnz, "sampled_addmm"),
        "K8": (lambda: port.wrappers["K8"](*aops, q_perm, kt, h,
                                           heavy_rows=heavy, **kw_attn),
               lambda: port.attention.fused_attn_sell_rows_ref(
                   *aops, q_perm, kt, h, **kw_attn),
               None,
               row_bytes + nbytes_of(q_perm, kt, h) + n_rows * d * 4,
               nnz * (2 * kt.shape[0] + 2 * d + 4), "none"),
    }
    rows = {}
    for name, (run, plain, lib, nbytes, flops, lib_name) in specs.items():
        width = f"K={b.shape[1]}" if name == "K4" else f"D={d}"
        if timed:
            rows[name] = measure(
                torch, f"{name} on the DeltaGraph overlay", run, plain, lib,
                nbytes, flops, f"rows={n_rows} slots={sell.n_slots} "
                f"row-view slots={nnz} {width}; library: {lib_name}")
        else:
            rows[name] = {"max_abs_err": check_close(
                torch, f"{name} on the DeltaGraph overlay", run(), plain())}
    return rows


def delta_phase(torch, np, port):
    """Phase 6c: ``DeltaGraph(form="sell")`` with the reference's defaults
    over graph (b); after each batch of seeded deltas, K2 (``matmul``,
    D = 128), K6 and K2 (a 2-layer GCN), K4 (``sddmm``, K = 2) and K8 (a
    GAT layer) through the entry points, counted, each held to a dense f32
    oracle of the live matrix, then each kernel on the overlay's operands
    held to its plain version; the final state held to a rebuild."""
    dev = torch.device(DEVICE)
    n = N_NODES
    cur = normalized_dense(np, port.random_graph(n, 16, seed=1))
    t0 = time.perf_counter()
    dg = port.runtime.DeltaGraph(cur, form="sell", device=DEVICE)
    log(f"6c DeltaGraph(form='sell', c=16, sigma=0, block=(8, 8), "
        f"width_slack=2) over graph (b): capacity {dg.capacity} slots, "
        f"{dg.live_nnz} live, {dg.free_slots()} free; built in "
        f"{time.perf_counter() - t0:.2f} s")
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    d = port.cfg.hidden
    h = torch.randn(n, d, device=dev, generator=gen)
    b = torch.randn(n, 2, device=dev, generator=gen)
    c = torch.randn(2, n, device=dev, generator=gen)
    q = torch.randn(n, 2, device=dev, generator=gen)
    k = torch.randn(n, 2, device=dev, generator=gen)
    gcn = port.gnn.init_gcn(port.GNNConfig(n_layers=2, in_features=d,
                                           hidden=d), seed=SEED,
                            device=DEVICE)
    gat = port.gnn.init_gat(port.GNNConfig(n_layers=1, in_features=d,
                                           n_classes=d), seed=SEED,
                            device=DEVICE)
    rng = np.random.default_rng(SEED + 6)
    totals = dict.fromkeys(port.wrappers, 0)
    rows = {}
    for batch in range(DELTA_BATCHES):
        last = batch == DELTA_BATCHES - 1
        deltas = delta_stream(np, rng, dg, cur, force_repack=last)
        t0 = time.perf_counter()
        dg.apply(deltas)
        apply_s = time.perf_counter() - t0
        if dg.repacks != int(last):
            raise AssertionError(f"6c batch {batch}: {dg.repacks} repacks")
        a = dg.matrix
        torch.cuda.synchronize()
        port.reset_counts()
        y_spmm = port.ops.matmul(a, h, policy="sell")
        g = port.gnn.Graph(adj=a, n_nodes=n)
        y_gcn = port.gnn.gcn_forward(gcn, g, h)
        s = port.ops.sddmm(a, b, c, policy="sell")
        y_gat = port.gnn.gat_forward(gat, g, h)
        torch.cuda.synchronize()
        counts = port.counts()
        want = expected(port, {"K2": 2, "K6": 1, "K4": 1, "K8": 1}, 1)
        if counts != want:
            raise AssertionError(f"6c batch {batch}: launches {counts}, "
                                 f"expected {want}")
        for name, count in counts.items():
            totals[name] += count
        a_dev = torch.from_numpy(cur).to(dev)
        errs = {}
        for what, got, oracle in (
                ("spmm", y_spmm, lambda: a_dev @ h),
                ("gcn", y_gcn, lambda: oracle_logits(torch, a_dev, gcn, h)),
                ("sddmm", s.densify(),
                 lambda: torch.where(a_dev != 0, a_dev * (b @ c), 0.0)),
                ("gat", y_gat, lambda: gat_oracle(torch, a_dev != 0, gat,
                                                  h))):
            want_y = oracle()
            errs[what] = float((got - want_y).abs().max())
            if got.shape != want_y.shape or errs[what] > oracle_tol(want_y) \
                    or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"6c batch {batch} {what} off the "
                                     f"dense oracle: {errs[what]:.3e}")
            del want_y
        sell = a.form("sell")
        q_perm = torch.cat([q, q.new_zeros((1, 2))])[sell.perm.long()]
        # timed on the last patched overlay, before the repack packs the
        # inserts back to the front of their rows
        timed = batch == DELTA_BATCHES - 2
        a_lib = a_dev.to_sparse_csr() if timed else None
        del a_dev
        kernel = overlay_rows(torch, port, sell, a_lib, h, b, c, q_perm,
                              k.T, timed=timed)
        if timed:
            rows = kernel
        launched = {k_: v for k_, v in counts.items() if v}
        oracle_errs = {k_: f"{v:.3e}" for k_, v in errs.items()}
        kernel_errs = {k_: f"{v['max_abs_err']:.3e}"
                       for k_, v in kernel.items()}
        log(f"6c batch {batch}: {len(deltas)} deltas applied in "
            f"{apply_s:.2f} s ({dg.deltas_applied} in all, {dg.repacks} "
            f"repack(s)); {dg.live_nnz} live of {dg.capacity} slots, the "
            f"row view {int(sell.tile_row_nnz.sum())} slots, "
            f"{int(sell.tile_heavy_rows.numel())} heavy rows; launches "
            f"{launched}; vs the dense oracle {oracle_errs}; kernels vs "
            f"their plain versions {kernel_errs}")
        del a_lib
        torch.cuda.empty_cache()
    if not np.array_equal(dg.matrix.to_dense(), cur):
        raise AssertionError("6c: the overlay's final state is not the "
                             "live dense matrix")
    rebuild = port.SellCS.from_dense(cur, c=16, sigma=0, block=(8, 8),
                                     device=DEVICE)
    err = check_close(torch, "6c overlay vs rebuild",
                      port.ops.matmul(dg.matrix, h, policy="sell"),
                      port.sell.spmm_sell_blocked(rebuild, h))
    log(f"6c final state: equal to the live dense matrix; SpMM against a "
        f"rebuild from it max_abs_err {err:.3e}; report {dg.report()}")
    for name in rows:
        rows[name]["launches"] = totals[name]
    return rows


def serving_phase(torch, np, port):
    """Phase 6 (6a, 6b, 6c); fails if any ``resilience_*`` counter moves.
    Returns the kernel rows at the new shapes and the run summaries."""
    t0 = time.perf_counter()
    before = resilience_counts(port)
    rows, runs = batched_serving_phase(torch, np, port)
    log(f"6a done at {time.perf_counter() - t0:.1f} s")
    runs["continuous"] = continuous_phase(torch, np, port)
    for name, count in runs["continuous"]["launches"].items():
        rows[name]["launches"] += count
    log(f"6b done at {time.perf_counter() - t0:.1f} s")
    delta = delta_phase(torch, np, port)
    after = resilience_counts(port)
    if after != before:
        raise AssertionError(f"phase 6: resilience counters moved: "
                             f"{before} -> {after}")
    log(f"phase 6: resilience counters unchanged ({after or 'none'}); "
        f"wall {time.perf_counter() - t0:.1f} s")
    return rows, delta, runs


def fleet_workload(np):
    """bench_serve_fleet's request mix at its full settings: three drifting
    phases (small, large, both), four sizes drawn a phase; each request
    with its f64 dense oracle ``dense @ h``, computed on the host."""
    rng = np.random.default_rng(FLEET_SEED)
    reqs = []
    for lo, hi in FLEET_PHASES:
        sizes = [int(s) for s in rng.integers(lo, hi, size=4)]
        for _ in range(FLEET_PER_PHASE):
            n = sizes[int(rng.integers(len(sizes)))]
            dense = (rng.random((n, n)) < FLEET_DENSITY).astype(np.float32)
            h = rng.standard_normal((n, FLEET_D)).astype(np.float32)
            reqs.append((dense, h,
                         dense.astype(np.float64) @ h.astype(np.float64)))
    return reqs


def fleet_counters(port) -> dict:
    """Every ``fleet_*`` and ``resilience_*`` counter series, keyed by
    (name, labels)."""
    counters = port.obs.REGISTRY.snapshot()["counters"]
    return {(name, labels): v for name, series in counters.items()
            if name.startswith(("fleet_", "resilience_"))
            for labels, v in series.items()}


def counter_moves(before, after) -> dict:
    return {f"{name}{{{labels}}}": after[(name, labels)]
            - before.get((name, labels), 0)
            for name, labels in after
            if after[(name, labels)] != before.get((name, labels), 0)}


def wait_ready(fleet, n, t0) -> dict:
    """Seconds from ``t0`` until each worker is first live (``n`` of them)."""
    ready = {}
    deadline = time.perf_counter() + FLEET_TIMEOUT_S
    while len(ready) < n:
        for ws in fleet.sup.states():
            if ws.status == "live" and ws.name not in ready:
                ready[ws.name] = time.perf_counter() - t0
        if time.perf_counter() > deadline:
            raise AssertionError(f"phase 8: {len(ready)} of {n} workers live "
                                 f"after {FLEET_TIMEOUT_S} s")
        time.sleep(0.002)
    return ready


def p99(np, xs):
    return float(np.percentile(np.asarray(xs), 99)) if xs else None


def fleet_storm(torch, np, port, reqs, *, backend, workers, form,
                profile=False):
    """One fleet at bench_serve_fleet's settings: every distinct (size, d)
    warmed with one ``infer``, then the storm of every request, one live
    worker killed (``_kill_worker``: SIGKILL for a process) at the half-way
    request; launch counts set to 0 just before the storm and read just
    after (in-process: thread workers only).  Latency is submit to the
    future's resolution (a done callback).  Gates, over the fleet's life
    up to ``close()``: every result within the oracle's tolerance, none
    failed or lost, one death, one kill and one restart (the kill's) and
    no ``resilience_*`` counter move but that restart's recovery.  Returns
    the summary and the results."""
    label = f"8 {backend} x{workers} form={form}"
    fl = port.fleet
    cfg = fl.FleetConfig(backend=backend, workers=workers,
                         hedge_after_ms=10_000.0, max_restarts_per_worker=2,
                         worker=fl.WorkerConfig(form=form, device=DEVICE))
    before = fleet_counters(port)
    t0 = time.perf_counter()
    fleet = fl.ServingFleet(cfg)
    try:
        ready = wait_ready(fleet, workers, t0)
        seen = set()
        for dense, h, _ in reqs:
            if (len(dense), h.shape[1]) not in seen:
                seen.add((len(dense), h.shape[1]))
                fleet.infer(dense, h, timeout=FLEET_TIMEOUT_S)
        torch.cuda.synchronize()
        port.reset_counts()
        kill_at = len(reqs) // 2
        futs, t_sub, t_done = [], [], [None] * len(reqs)
        t_start = time.perf_counter()
        for i, (dense, h, _) in enumerate(reqs):
            if i == kill_at:
                if not fleet.sup.live():
                    raise AssertionError(f"{label}: no live worker to kill")
                victim = fleet.sup.live()[0]
                gen = fleet.sup.get(victim).generation
                t_kill = time.perf_counter()
                fleet._kill_worker(victim)
            t_sub.append(time.perf_counter())
            fut = fleet.submit(dense, h)
            fut.add_done_callback(
                lambda _, i=i: t_done.__setitem__(i, time.perf_counter()))
            futs.append(fut)
        back = None  # kill to the victim's slot live again
        deadline = time.perf_counter() + FLEET_TIMEOUT_S
        while back is None or not all(f.done() for f in futs):
            ws = fleet.sup.get(victim)
            if back is None and ws.generation > gen and ws.status == "live":
                back = time.perf_counter() - t_kill
            if time.perf_counter() > deadline:
                raise AssertionError(
                    f"{label}: {sum(not f.done() for f in futs)} requests "
                    f"pending, victim back {back}, after {FLEET_TIMEOUT_S} s")
            time.sleep(0.002)
        errors = [(i, f.exception()) for i, f in enumerate(futs)
                  if f.exception() is not None]
        outs = [f.result() for f in futs] if not errors else None
        elapsed = max(t_done) - t_start
        torch.cuda.synchronize()
        counts = port.counts()
        rep = fleet.report()
        busy = profiled_pass(torch, fleet, [d for d, _, _ in reqs],
                             [(i, h) for i, (_, h, _) in enumerate(reqs)],
                             label) if profile else None
        # read before close(): a worker whose thread or process exits on
        # the "stop" of close() can still be seen dead by a monitor tick
        # already under way (the reference's behaviour)
        moves = counter_moves(before, fleet_counters(port))
    finally:
        fleet.close()
    exits = {ws.name: ws.handle._proc.exitcode
             for ws in fleet.sup.states()} if backend == "process" else None
    if errors:
        raise AssertionError(f"{label}: {len(errors)} requests failed, the "
                             f"first {errors[0][0]}: {errors[0][1]!r}")
    worst = hold_requests(np, label, outs, [o for *_, o in reqs])
    lat = [(d - s) * 1e3 for s, d in zip(t_sub, t_done)]
    before_k = [ms for s, ms in zip(t_sub, lat) if s < t_kill]
    during = [ms for s, ms in zip(t_sub, lat)
              if t_kill <= s < t_kill + FLEET_FAILOVER_S]
    after_k = [ms for s, ms in zip(t_sub, lat)
               if s >= t_kill + FLEET_FAILOVER_S]
    lanes = {}
    for wrep in rep["worker_reports"].values():
        for lane, v in wrep.get("lanes", {}).items():
            lanes.setdefault(lane, set()).add(v["form"])
    lanes = {k: "/".join(sorted(v)) for k, v in sorted(lanes.items())}
    fleet_moves = {k: v for k, v in moves.items() if k.startswith("fleet_")}
    res_moves = {k: v for k, v in moves.items()
                 if k.startswith("resilience_")}
    out = {"backend": backend, "workers": workers, "form": form,
           "n_requests": len(reqs), "req_per_s": len(reqs) / elapsed,
           "p50_ms": float(np.percentile(lat, 50)), "p99_ms": p99(np, lat),
           "p99_before_ms": p99(np, before_k),
           "p99_during_failover_ms": p99(np, during),
           "p99_after_ms": p99(np, after_k),
           "ready_s": ready, "victim": victim, "victim_back_s": back,
           "requests_lost": rep["fleet"]["requests_lost"],
           "completed": rep["completed"], "failed": rep["failed"],
           "oracle_max_abs_err": worst, "lanes": lanes,
           "launches": {k: v for k, v in counts.items() if v},
           "fleet_counters": fleet_moves, "resilience_counters": res_moves,
           "device_busy": busy}
    if exits is not None:
        out["exit_codes"] = exits
    log(f"{label}: {out['req_per_s']:.1f} req/s, p50 {out['p50_ms']:.3f} ms,"
        f" p99 {out['p99_ms']:.3f} ms (before the kill {out['p99_before_ms']}"
        f", during {out['p99_during_failover_ms']}, after "
        f"{out['p99_after_ms']}); ready after {ready} s; killed {victim} at "
        f"request {kill_at}, its slot live again after {back:.3f} s; lost "
        f"{out['requests_lost']}, failed {out['failed']}; results vs the "
        f"f64 oracle max_abs_err {worst:.3e}; launches {out['launches']}")
    log(f"{label}: lanes (planned route) {lanes}"
        + (f"; the children's exit codes after close() {exits}"
           if exits is not None else ""))
    log(f"{label}: counters moved {moves}")
    if rep["fleet"]["requests_lost"] or rep["failed"]:
        raise AssertionError(f"{label}: {rep['fleet']['requests_lost']} lost,"
                             f" {rep['failed']} failed")
    kill = {f"fleet_{what}{{{labels}worker={victim}}}": 1 for what, labels
            in (("worker_deaths_total", "reason=killed,"),
                ("kills_total", ""), ("restarts_total", ""))}
    if {k: v for k, v in fleet_moves.items() if k.startswith((
            "fleet_worker_deaths", "fleet_kills", "fleet_restarts"))} != kill:
        raise AssertionError(f"{label}: deaths or restarts beyond the one "
                             f"kill: {fleet_moves}")
    if res_moves != {"resilience_recoveries_total{site=fleet}": 1}:
        raise AssertionError(f"{label}: resilience counters moved beyond "
                             f"the kill's restart: {res_moves}")
    return out, outs


def fleet_phase(torch, np, port):
    """Phase 8: the serving fleet at bench_serve_fleet's full settings.
    Thread workers at 1, 2 and 4 on both forms (K1 at 16 x 16 on the ell
    runs, counted), the 2-worker ell storm served a second time for equal
    bits (and profiled), then 2 spawned process workers at ``form="ell"``,
    one SIGKILLed.  Returns the phase summary and K1's storm launches."""
    import multiprocessing

    t0 = time.perf_counter()
    reqs = fleet_workload(np)
    runs, k1 = {}, 0
    for workers in FLEET_THREAD_WORKERS:
        for form in FLEET_FORMS:
            run, outs = fleet_storm(torch, np, port, reqs, backend="thread",
                                    workers=workers, form=form)
            runs[f"thread_{workers}w_{form}"] = run
            k1 += run["launches"].get("K1", 0)
            if form == "ell" and not run["launches"].get("K1"):
                raise AssertionError(f"phase 8 thread x{workers} ell: K1 "
                                     "was not launched")
            if form == "ell" and workers == 2:
                first = outs
    run, again = fleet_storm(torch, np, port, reqs, backend="thread",
                             workers=2, form="ell", profile=True)
    k1 += run["launches"].get("K1", 0)
    same = all(np.array_equal(a, b) for a, b in zip(first, again))
    run["same_bits_as_first"] = same
    runs["thread_2w_ell_again"] = run
    log(f"8 thread x2 form=ell served twice: "
        f"{'the same bits' if same else 'different bits'}")
    if not same:
        raise AssertionError("phase 8: the 2-worker ell storm served twice "
                             "gave different bits")
    # what a spawned worker pays before it can beat at all
    probe = subprocess.run(
        [sys.executable, "-c", "import time; t = time.perf_counter(); "
         "import torch; print(time.perf_counter() - t)"],
        capture_output=True, text=True, check=True, timeout=120)
    import_s = float(probe.stdout.strip().splitlines()[-1])
    log(f"8: import torch in a fresh interpreter {import_s:.3f} s")
    run, _ = fleet_storm(torch, np, port, reqs, backend="process",
                         workers=FLEET_PROCESS_WORKERS, form="ell")
    run["torch_import_s"] = import_s
    runs[f"process_{FLEET_PROCESS_WORKERS}w_ell"] = run
    left = multiprocessing.active_children()
    if left:
        raise AssertionError(f"phase 8: worker processes left running: "
                             f"{left}")
    wall = time.perf_counter() - t0
    log(f"phase 8: wall {wall:.1f} s; K1 launches over the thread storms "
        f"{k1}")
    return {"n_requests": len(reqs), "runs": runs, "wall_s": wall}, k1


# ---------------------------------------------------------------------------
# Phase 9: the LM models and ServingEngine (gemma3-4b at full width, dense
# and with its MLP weights pruned onto N1; every smoke arch)
# ---------------------------------------------------------------------------


def lm_tokens(np, rng, vocab, b, s):
    return rng.integers(0, vocab, (b, s)).astype(np.int32)


def hold_logits(torch, what, got, want, rtol=LM_RTOL):
    """|got - want| <= rtol * max|want| over a step's logits; returns the
    error."""
    torch.cuda.synchronize()
    got, want = got.float(), want.float().to(got.device)
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    if got.shape != want.shape or not err <= rtol * scale:
        raise AssertionError(f"{what}: max_abs_err {err:.3e} above "
                             f"{rtol:g} x max|want| {scale:.3e}")
    return err


def head_logits(port, params, cfg, hidden, positions):
    """The LM head at ``positions`` of ``hidden`` only ([B, P, V] f32)."""
    return hidden[:, positions].float() @ port.lm._lm_head(params,
                                                           cfg).float()


def lm_serve(torch, port, params, cfg, toks, s, n_dec, side=None):
    """``prefill`` of ``toks[:, :s]`` and ``n_dec`` ``decode_step``s fed
    the next tokens of ``toks`` (teacher forcing).  Returns each step's
    logits (prefill's first) and each decode step's launch counts."""
    side = side or {}
    logits, cache = port.lm.prefill(params, cfg, toks[:, :s],
                                    cfg.vision_tokens + s + n_dec, **side)
    out, per_step = [logits], []
    for t in range(n_dec):
        before = port.counts()
        logits, cache = port.lm.decode_step(params, cfg,
                                            toks[:, s + t:s + t + 1], cache)
        torch.cuda.synchronize()
        after = port.counts()
        per_step.append({k: after[k] - before[k] for k in after})
        out.append(logits)
    return out, per_step


def teacher_forced(torch, port, params, cfg, toks, s, n_dec, side=None):
    """``forward_hidden`` over prompt plus fed tokens, the head applied at
    the ``n_dec + 1`` positions each serving step predicts from."""
    side = side or {}
    with torch.no_grad():
        hidden, _, _ = port.lm.forward_hidden(
            params, cfg, toks[:, :s + n_dec], mode="train", remat=False,
            **side)
    first = cfg.vision_tokens + s - 1
    logits = head_logits(port, params, cfg, hidden,
                         list(range(first, first + n_dec + 1)))
    return [logits[:, i] for i in range(n_dec + 1)]


def planted_faults(torch, port, params, cfg, toks, s, n_dec, want):
    """Each of ``LM_PLANTED`` patched into ``models/layers.py``'s source,
    re-executed in the module's namespace and restored after: the served
    logits must leave the ``LM_RTOL`` gate where a fault is planted and
    stay in it on the sound reroute.  Returns each one's max_abs_err over
    max|want|."""
    mod = port.lm_layers
    src, saved = Path(mod.__file__).read_text(), dict(mod.__dict__)
    scale = max(float(w.abs().max()) for w in want)
    out = {}
    for what, subs, fault in LM_PLANTED:
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise AssertionError(f"9a planted '{what}': its text is not "
                                     f"once in {mod.__file__}; update "
                                     "LM_PLANTED")
            text = text.replace(old, new)
        try:
            exec(compile(text, mod.__file__, "exec"), mod.__dict__)
            got, _ = lm_serve(torch, port, params, cfg, toks, s, n_dec)
        finally:
            mod.__dict__.clear()
            mod.__dict__.update(saved)
        rel = max(float((g - w.to(g.device)).abs().max())
                  for g, w in zip(got, want)) / scale
        log(f"9a planted {what}: max_abs_err {rel:.3e} x max|want| "
            f"({'a fault: must exceed' if fault else 'sound: must stay in'} "
            f"{LM_RTOL:g})")
        if (rel > LM_RTOL) != fault:
            raise AssertionError(f"9a planted {what}: {rel:.3e} x max|want| "
                                 f"against the gate {LM_RTOL:g}")
        out[what] = rel
        del got
    return out


def peak_gib(torch) -> float:
    return torch.cuda.max_memory_allocated() / 2**30


def lm_generate_run(torch, np, port, box, cfg, b, s, n_new, label, rng):
    """``ServingEngine.generate`` of ``n_new`` tokens after B prompts of S
    tokens (counted; wall, tokens/s and peak memory), then the same
    entry points it runs timed one by one (prefill, the median decode
    step with a sync, one decode step profiled) and the greedy agreement
    with the teacher-forced argmax in the same dtype (printed, not
    gated).  The engine takes the tree in ``box[0]`` and ``box[0]`` then
    holds the engine's own (cast) tree: where the caller keeps no other
    reference, the f32 leaves the engine cast are freed (F6), and a later
    run's engine casts nothing."""
    dev = torch.device(DEVICE)
    eng_mod = port.engine
    prompts = lm_tokens(np, rng, cfg.vocab_size, b, s)
    eng = eng_mod.ServingEngine(box[0], cfg,
                                eng_mod.ServeConfig(max_len=s + n_new + 1))
    box[0] = eng.params
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    before = port.counts()
    t0 = time.perf_counter()
    toks = eng.generate(prompts, n_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = port.counts()
    launches = {k: after[k] - before[k] for k in after if after[k] > before[k]}
    peak = peak_gib(torch)
    run_p, lm = eng.params, port.lm
    ptoks = torch.as_tensor(prompts, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    logits, cache = lm.prefill(run_p, cfg, ptoks, s + n_new + 1)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t1) * 1e3
    steps = []
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    for _ in range(n_new - 1):
        t1 = time.perf_counter()
        logits, cache = lm.decode_step(run_p, cfg, tok, cache)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t1) * 1e3)
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        lm.decode_step(run_p, cfg, tok, cache)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t1) * 1e3
    busy = log_device_time(prof, prof_wall, f"{label}: one decode step")
    del cache, logits
    full = torch.as_tensor(np.concatenate([prompts, toks[:, :-1]], 1),
                           device=dev)
    with torch.no_grad():
        hidden, _, _ = lm.forward_hidden(run_p, cfg, full, mode="train",
                                         remat=False)
    want = head_logits(port, run_p, cfg, hidden,
                       list(range(s - 1, s + n_new - 1))).argmax(-1)
    agree = float((want.cpu().numpy() == toks).mean())
    del hidden, want, eng
    row = {"batch": b, "prompt": s, "new_tokens": n_new,
           "generate_s": wall, "tokens_per_s": b * n_new / wall,
           "prefill_ms": prefill_ms,
           "decode_ms_median": statistics.median(steps),
           "decode_ms_min": min(steps), "peak_gib": peak,
           "held_gib": held,
           "decode_busy_pct": None if busy is None
           else 100 * busy / prof_wall,
           "greedy_agreement": agree, "launches": launches}
    log(f"{label}: B={b} S={s} n_new={n_new}: generate {wall:.3f} s, "
        f"{row['tokens_per_s']:.1f} tokens/s; prefill {prefill_ms:.2f} ms; "
        f"decode median {row['decode_ms_median']:.3f} ms a step (min "
        f"{row['decode_ms_min']:.3f}); device memory held once the engine "
        f"is built {held:.2f} GiB, peak {peak:.2f} GiB; greedy tokens "
        f"equal to the teacher-forced argmax: {100 * agree:.1f} %; "
        f"launches {launches}")
    torch.cuda.empty_cache()
    return row


def cut_layers(port, params, cfg, n_layers):
    """The first ``n_layers`` layers of a stacked params tree, fewer than
    its periods hold (whole periods, then a remainder from the next
    period's blocks), views; and its config."""
    tm = port.lm.tree_map
    n_per, rem = divmod(n_layers, cfg.period)
    out = {k: v for k, v in params.items()
           if k not in ("periods", "remainder")}
    out["periods"] = tm(lambda a: a[:n_per], params["periods"])
    out["remainder"] = tuple(tm(lambda a: a[n_per], params["periods"][j])
                             for j in range(rem))
    return out, dataclasses.replace(cfg, n_layers=n_layers)


def lm_dense_phase(torch, np, port, params, rng):
    """9a: gemma3-4b dense at full width and depth."""
    dev = torch.device(DEVICE)
    cfg = port.lm_cfg
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    out = {}
    b, s, n_dec = LM_F32_RUN
    toks = torch.as_tensor(lm_tokens(np, rng, cfg.vocab_size, b, s + n_dec),
                           device=dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got, _ = lm_serve(torch, port, params, cfg32, toks, s, n_dec)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    serve_peak = peak_gib(torch)
    torch.cuda.reset_peak_memory_stats()
    want = teacher_forced(torch, port, params, cfg32, toks, s, n_dec)
    errs = [hold_logits(torch, f"9a f32 step {t}", g, w)
            for t, (g, w) in enumerate(zip(got, want))]
    scale = max(float(w.abs().max()) for w in want)
    log(f"9a gemma3-4b f32 (TF32 off), B={b} S={s} + {n_dec} decode steps: "
        f"{serve_s:.2f} s, peak {serve_peak:.2f} GiB; logits held to the "
        f"teacher-forced forward at S={s + n_dec} (mha_reference route; "
        f"peak {peak_gib(torch):.2f} GiB): max_abs_err {max(errs):.3e}, "
        f"max|want| {scale:.3e} (tol {LM_RTOL:g} x max|want|)")
    out["f32"] = {"batch": b, "prompt": s, "decode_steps": n_dec,
                  "serve_s": serve_s, "peak_gib": serve_peak,
                  "max_abs_err": max(errs), "max_want": scale}
    del got
    out["f32"]["planted_rel_err"] = planted_faults(
        torch, port, params, cfg32, toks, s, n_dec, want)
    del want, toks
    torch.cuda.empty_cache()

    layers, b, s, n_dec = LM_CPU_CUT
    p_cut, cfg_cut = cut_layers(port, params, cfg32, layers)
    p_cpu = port.lm.tree_map(lambda a: a.cpu(), p_cut)
    toks = torch.as_tensor(lm_tokens(np, rng, cfg.vocab_size, b, s + n_dec))
    t0 = time.perf_counter()
    got, _ = lm_serve(torch, port, p_cut, cfg_cut, toks.to(dev), s, n_dec)
    want, _ = lm_serve(torch, port, p_cpu, cfg_cut, toks, s, n_dec)
    errs = [hold_logits(torch, f"9a {layers}-layer cut step {t}", g, w)
            for t, (g, w) in enumerate(zip(got, want))]
    log(f"9a {layers}-layer cut at full width, B={b} S={s} + {n_dec} decode "
        f"steps, card vs the port's CPU path on the same weights: max_abs_err "
        f"{max(errs):.3e} ({time.perf_counter() - t0:.1f} s)")
    out["cut_vs_cpu"] = {"layers": layers, "batch": b, "prompt": s,
                         "decode_steps": n_dec, "max_abs_err": max(errs)}
    del p_cpu, p_cut, got, want

    out["bf16"] = {}
    # the caller keeps the f32 tree (sparsify_lm prunes it next), so the
    # engine's cast copy sits beside it
    for b, s, n_new in LM_BF16_RUNS:
        label = f"9a dense bf16 B={b} S={s} (the f32 tree kept beside)"
        out["bf16"][f"B{b}_S{s}"] = lm_generate_run(
            torch, np, port, [params], cfg, b, s, n_new, label, rng)
    return out


def sparse_weights(port, sp):
    """Every pruned MLP weight (``SparseMatrix``) of ``sp``."""
    is_sparse = port.pruning._is_sparse
    return [w for w in port.lm.tree_leaves(sp, is_leaf=is_sparse)
            if is_sparse(w)]


def weight_plan(port, w, d):
    """The plan of ``x @ W`` (``Wᵀ xᵀ``) at width ``d``."""
    wt = w.T
    return port.dispatcher.plan_spmm(wt.stats, d,
                                     candidates=port.ops.available_paths(wt))


def n1_lm_rows(torch, port, sp):
    """N1 at the LM's widths on layer 0's ``wi`` and ``wo`` (``Wᵀ H`` on W's
    Block-ELL blocks): held to its plain version, timed beside its bound,
    ``torch.sparse.mm`` on a CSR of Wᵀ and ``torch.matmul`` on the dense
    weight (the route a dense plan runs), f32."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    tr, rows = port.transposed, {}
    blk = sp["periods"][0][0]["mlp"]
    for key in ("wi", "wo"):
        w = blk[key]
        ell = w.form("ell")
        r, c, v = w.form("csr")
        m, n = w.shape
        lib_t = torch.sparse_coo_tensor(
            torch.stack([c.long(), r.long()]), v, (n, m)
        ).coalesce().to_sparse_csr()
        dense_t = w.to_dense()
        dense_t = torch.as_tensor(dense_t.T.copy(), device=dev)
        nnz = w.stats.nnz
        for d in LM_N1_WIDTHS:
            h = torch.randn(ell.shape[0], d, device=dev, generator=gen)
            ops = (*tr.blockell_columns(ell), ell.blocks, h)
            path, chunks, flops, peak, how = n1_work(port, ell, ops, nnz)
            row = measure(
                torch, f"N1 LM {key}ᵀ at D={d}",
                lambda: port.wrappers["N1"](*ops),
                lambda: port.ref.spmm_blockell_t_ref(*ops),
                lambda: torch.sparse.mm(lib_t, h[:m]),
                n1_nbytes(ell, ops, ell.shape[1] * d * 4), flops,
                f"path {path} ({chunks} chunk(s) a column), operations "
                f"{how}; W {m}x{n}, blocks {ell.bm}x{ell.bn}, width "
                f"{ell.indices.shape[1]}, {int(ell.nblocks.sum())} real "
                f"blocks, {nnz} nonzeros, D={d}; library: "
                "torch.sparse.mm on a CSR of Wᵀ",
                close=lambda *a: transposed_sums_close(torch, port, *a, ops),
                peak=peak)
            row["dense_ms"] = time_ms(torch, lambda: dense_t @ h[:m])
            # the copies ops.matmul makes around N1 for x @ W with bf16
            # activations x [D, m]: xᵀ made contiguous, promoted to f32
            x = torch.randn(d, m, device=dev, generator=gen).bfloat16()
            xt = x.T.contiguous()
            row.update(path=path, chunks=chunks,
                       transpose_ms=time_ms(torch, lambda: x.T.contiguous()),
                       promote_ms=time_ms(torch, lambda: xt.float()))
            log(f"  N1 LM {key}ᵀ D={d}: path {path}; dense torch.matmul "
                f"(TF32 off) {row['dense_ms']:.4f} ms, "
                f"{row['dense_ms'] / row['ms']:.2f}x N1's time; "
                f"{row['ms'] / row['bound_ms']:.2f}x its bound; copies around "
                f"the kernel for bf16 activations: xᵀ contiguous "
                f"{row['transpose_ms']:.4f} ms, bf16 -> f32 "
                f"{row['promote_ms']:.4f} ms")
            del x, xt
            rows[f"N1 LM {key} D={d}"] = row
            del h, ops
        del lib_t, dense_t
    torch.cuda.empty_cache()
    return rows


def default_prune_finding(torch, port, w):
    """One MLP weight pruned at ``sparsify_lm``'s defaults (8 x 8 pruning
    tiles on 64 x 64 storage): its stats and plans (printed; dense
    expected, nearly every storage tile keeps a pruning tile)."""
    t0 = time.perf_counter()
    m = port.pruning._to_sparse(w, sparsity=0.9, prune_block=(8, 8),
                                formats=("ell", "csr"), format="auto",
                                block=(64, 64))
    st = m.stats
    plans = {d: weight_plan(port, m, d) for d in (8, 16384)}
    log(f"9b default pruning (8x8 tiles, 64x64 storage, sparsity 0.9) of one "
        f"wi {tuple(w.shape)}: occupancy {st.occupancy:.4f}, ell width "
        f"{st.ell_width}, nnz {st.nnz}; plans "
        + "; ".join(f"D={d} {p.path} ({p.reason})" for d, p in plans.items())
        + f" ({time.perf_counter() - t0:.2f} s)")
    return {"occupancy": st.occupancy, "ell_width": st.ell_width,
            "plans": {d: p.path for d, p in plans.items()}}


def lm_pruned_phase(torch, np, port, owned, rng):
    """9b after sparsify: plans, N1 per decode step, logits held to
    ``dense_reference``, bf16 generation, N1's rows.  ``owned`` holds the
    only reference to the pruned tree: the first bf16 engine takes it, so
    its f32 dense leaves go once cast (F6)."""
    dev = torch.device(DEVICE)
    sp = owned[0]
    cfg = port.lm_cfg
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    out = {"report": port.pruning.weight_sparsity_report(sp)}
    weights = sparse_weights(port, sp)
    b, s, n_dec = LM_F32_RUN
    widths = sorted({b, b * s} | {bb for bb, _, _ in LM_BF16_RUNS}
                    | {bb * ss for bb, ss, _ in LM_BF16_RUNS})
    off = [(i, d, weight_plan(port, w, d).path)
           for i, w in enumerate(weights) for d in widths
           if weight_plan(port, w, d).path != "ell"]
    if off:
        raise AssertionError("9b: MLP weights (index, D, plan) not planned "
                             f"ell: {off[:6]}")
    st = weights[0].stats
    log(f"9b: all {len(weights)} MLP weights plan ell at D = {widths} "
        f"(the first: {weights[0].shape}, occupancy {st.occupancy:.4f}, ell "
        f"width {st.ell_width}; {weight_plan(port, weights[0], 2).reason})")
    out["plan_widths"] = widths

    toks = torch.as_tensor(lm_tokens(np, rng, cfg.vocab_size, b, s + n_dec),
                           device=dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got, per_step = lm_serve(torch, port, sp, cfg32, toks, s, n_dec)
    serve_s = time.perf_counter() - t0
    serve_peak = peak_gib(torch)
    want_n1 = 3 * cfg.n_layers
    for t, c in enumerate(per_step):
        if nonzero(c) != {"N1": want_n1}:
            raise AssertionError(f"9b decode step {t}: launches "
                                 f"{nonzero(c)}, want N1 x{want_n1}")
    dense = port.pruning.dense_reference(sp)
    want, _ = lm_serve(torch, port, dense, cfg32, toks, s, n_dec)
    errs = [hold_logits(torch, f"9b f32 step {t}", g, w)
            for t, (g, w) in enumerate(zip(got, want))]
    scale = max(float(w.abs().max()) for w in want)
    log(f"9b pruned f32, B={b} S={s} + {n_dec} decode steps: {serve_s:.2f} "
        f"s, peak {serve_peak:.2f} GiB; N1 x{want_n1} a decode step; logits "
        f"held to dense_reference through the same entry points: max_abs_err "
        f"{max(errs):.3e}, max|want| {scale:.3e}")
    out["f32"] = {"batch": b, "prompt": s, "decode_steps": n_dec,
                  "serve_s": serve_s, "peak_gib": serve_peak,
                  "n1_per_decode_step": want_n1, "max_abs_err": max(errs),
                  "max_want": scale}
    del dense, got, want, toks, sp
    torch.cuda.empty_cache()
    out["bf16"] = {}
    for b, s, n_new in LM_BF16_RUNS:
        label = f"9b pruned bf16 B={b} S={s} (the engine owns the tree)"
        out["bf16"][f"B{b}_S{s}"] = lm_generate_run(
            torch, np, port, owned, cfg, b, s, n_new, label, rng)
    before = port.counts()["N1"]
    out["n1_rows"] = n1_lm_rows(torch, port, owned[0])
    out["n1_timing_launches"] = port.counts()["N1"] - before
    return out


def lm_smoke_phase(torch, np, port, rng):
    """9c: every LM arch's ``SMOKE_CONFIG`` on the card in f32, held to the
    teacher-forced forward and to the port's CPU run of the same weights;
    ``lm_loss`` against the CPU's; MoE at capacity_factor = n_experts (no
    drops; teacher-forced too) and at its own capacity (drops: the CPU
    only)."""
    dev = torch.device(DEVICE)
    cpu = torch.device("cpu")
    lm, out = port.lm, {}
    for arch in port.lm_configs.ARCHS:
        if arch == "paper-gnn":
            continue
        base = dataclasses.replace(port.lm_configs.get_smoke_config(arch),
                                   dtype="float32")
        variants = [("", base)]
        if base.n_experts:
            variants = [("no drops", dataclasses.replace(
                base, capacity_factor=float(base.n_experts))),
                ("own capacity", base)]
        for tag, cfg in variants:
            p_cpu = lm.init_lm(cfg, seed=SEED, device="cpu")
            p_dev = lm.tree_map(lambda a: a.to(dev), p_cpu)
            s = LM_SMOKE_PROMPT - cfg.vision_tokens
            toks = torch.as_tensor(lm_tokens(np, rng, cfg.vocab_size, 2,
                                             s + LM_SMOKE_DECODE + 1))
            side = {}
            if cfg.vision_tokens:
                side["vision_embeds"] = torch.as_tensor(rng.normal(
                    size=(2, cfg.vision_tokens, cfg.d_model)).astype(
                        np.float32))
            if cfg.encoder_layers:
                side["enc_embeds"] = torch.as_tensor(rng.normal(
                    size=(2, cfg.encoder_seq, cfg.d_model)).astype(
                        np.float32))
            on = {k: v.to(dev) for k, v in side.items()}
            got, _ = lm_serve(torch, port, p_dev, cfg, toks.to(dev), s,
                              LM_SMOKE_DECODE, on)
            want, _ = lm_serve(torch, port, p_cpu, cfg, toks, s,
                               LM_SMOKE_DECODE, side)
            e_cpu = max(hold_logits(torch, f"9c {arch} {tag} step {t} vs CPU",
                                    g, w, LM_SMOKE_RTOL)
                        for t, (g, w) in enumerate(zip(got, want)))
            e_tf = None
            if tag != "own capacity":
                tf = teacher_forced(torch, port, p_dev, cfg, toks.to(dev), s,
                                    LM_SMOKE_DECODE, on)
                e_tf = max(hold_logits(
                    torch, f"9c {arch} {tag} step {t} vs teacher-forced", g,
                    w, LM_SMOKE_RTOL) for t, (g, w) in enumerate(zip(got, tf)))
            batch = {"tokens": toks[:, :s], "targets": toks[:, 1:s + 1],
                     "mask": torch.ones(2, s)}
            batch.update(side)
            with torch.no_grad():
                loss_dev = float(lm.lm_loss(
                    p_dev, cfg, {k: v.to(dev) for k, v in batch.items()}))
                loss_cpu = float(lm.lm_loss(p_cpu, cfg, batch))
            if not (math.isfinite(loss_dev)
                    and abs(loss_dev - loss_cpu) <= 1e-4 * abs(loss_cpu)):
                raise AssertionError(f"9c {arch} {tag}: lm_loss {loss_dev} on "
                                     f"the card, {loss_cpu} on the CPU")
            name = f"{arch} {tag}".strip()
            out[name] = {"vs_cpu": e_cpu, "vs_teacher_forced": e_tf,
                         "loss": loss_dev, "loss_cpu": loss_cpu}
            log(f"9c {name}: prefill + {LM_SMOKE_DECODE} decode steps, "
                f"max_abs_err vs CPU {e_cpu:.3e}, vs teacher-forced "
                + ("not held (capacity drops differ)" if e_tf is None
                   else f"{e_tf:.3e}")
                + f"; lm_loss {loss_dev:.6f} (CPU {loss_cpu:.6f})")
    return out


def lm_phase(torch, np, port):
    """Phase 9: 9a, 9b and 9c; returns the ``lm`` summary and N1's main-path
    launches (the serving runs', not the timing rows')."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    params = port.lm.init_lm(port.lm_cfg, seed=SEED, device=DEVICE)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in port.lm.tree_leaves(params))
    log(f"phase 9: gemma3-4b CONFIG, {port.lm_cfg.n_layers} layers, "
        f"{n_params} parameters (param_count {port.lm_cfg.param_count()}), "
        f"init_lm on the card in {time.perf_counter() - t1:.2f} s, "
        f"{peak_gib(torch):.2f} GiB")
    if n_params != port.lm_cfg.param_count():
        raise AssertionError("init_lm's count differs from param_count")
    summary = {"params": n_params}
    before = port.counts()
    summary["dense"] = lm_dense_phase(torch, np, port, params, rng)
    summary["dense"]["wall_s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    summary["default_prune"] = default_prune_finding(
        torch, port, params["periods"][0]["mlp"]["wi"][0])
    t2 = time.perf_counter()
    # a list holding the only reference, so that the engine can own it
    owned = [port.pruning.sparsify_lm(params, port.lm_cfg, **LM_PRUNE)]
    torch.cuda.synchronize()
    sparsify_s = time.perf_counter() - t2
    del params  # the dense MLP weights go; sp keeps views of the rest
    torch.cuda.empty_cache()
    log(f"9b sparsify_lm({LM_PRUNE}) over {port.lm_cfg.n_layers} layers: "
        f"{sparsify_s:.1f} s; weight_sparsity_report "
        f"{port.pruning.weight_sparsity_report(owned[0])}; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    summary["pruned"] = lm_pruned_phase(torch, np, port, owned, rng)
    summary["pruned"].update(sparsify_s=sparsify_s,
                             wall_s=time.perf_counter() - t1)
    del owned
    torch.cuda.empty_cache()
    for run, dense in summary["dense"]["bf16"].items():
        pruned = summary["pruned"]["bf16"][run]
        log(f"9b pruned against dense bf16, {run}: prefill "
            f"{pruned['prefill_ms']:.2f} ms against {dense['prefill_ms']:.2f}"
            f" ({pruned['prefill_ms'] / dense['prefill_ms']:.2f}x); decode "
            f"median {pruned['decode_ms_median']:.3f} ms a step against "
            f"{dense['decode_ms_median']:.3f}; peak {pruned['peak_gib']:.2f} "
            f"GiB against {dense['peak_gib']:.2f}")
    t1 = time.perf_counter()
    summary["smoke"] = lm_smoke_phase(torch, np, port, rng)
    after = port.counts()
    summary["smoke_wall_s"] = time.perf_counter() - t1
    summary["wall_s"] = time.perf_counter() - t0
    n1 = after["N1"] - before["N1"] \
        - summary["pruned"].pop("n1_timing_launches")
    log(f"phase 9: wall {summary['wall_s']:.1f} s; N1 launches on the main "
        f"path {n1}")
    return summary, n1


def lm_train_tcfg(port, **kw):
    return port.lm_train.TrainConfig(opt=port.lm_opt.OptConfig(
        lr=1e-4, warmup_steps=0, total_steps=100), **kw)


def lm_train_run(torch, port, cfg, tcfg, params, state, batch):
    """One train step as ``make_train_step`` composes it (the gradients,
    then the compression and AdamW in place), returning the gradients
    too: (loss, grads, params, state)."""
    loss, grads = port.lm_train.make_grad_fn(cfg, tcfg)(params, batch)
    params, state, _ = port.lm_train.apply_gradients(params, state, grads,
                                                     tcfg)
    torch.cuda.synchronize()
    return loss, grads, params, state


def same_bits_leafwise(torch, port, what, got, host):
    """Each device leaf equal, per ``torch.equal``, to its host copy
    (brought back to the leaf's device, one leaf at a time)."""
    leaves = port.lm.tree_leaves(got)
    if len(leaves) != len(host):
        raise AssertionError(f"{what}: {len(leaves)} leaves against "
                             f"{len(host)}")
    for i, (g, h) in enumerate(zip(leaves, host)):
        g = port.shard_specs.whole(g)  # a DTensor: gathered whole
        if not torch.equal(g, h.to(g.device)):
            raise AssertionError(f"{what}: leaf {i} differs between two "
                                 "runs from the same init and batch")


def timed_steps(torch, step, params, state, batches):
    """Host-clock seconds of each step (ending in a sync)."""
    times = []
    for batch in batches:
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if not math.isfinite(loss):
            raise AssertionError(f"a train step's loss is {loss}")
    return params, state, times


def lm_train_full(torch, np, port, out):
    """10a: the full model, run twice from one init (equal bits), then
    timed, profiled and stepped in bf16 compute from f32 masters."""
    cfg = dataclasses.replace(port.lm_cfg, dtype="float32")
    b, s = LM_TRAIN
    tcfg = lm_train_tcfg(port)
    dcfg = port.data.DataConfig(seed=SEED)
    batches = [port.data.make_lm_batch(cfg, s, b, i, dcfg, device=DEVICE)
               for i in range(LM_TRAIN_STEPS + 4)]

    def fresh():
        params = port.lm.init_lm(cfg, seed=SEED, device=DEVICE)
        return params, port.lm_train.init_train_state(params, tcfg)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, state = fresh()
    n_params = sum(x.numel() for x in port.lm.tree_leaves(params))
    t0 = time.perf_counter()
    loss, grads, params, state = lm_train_run(torch, port, cfg, tcfg, params,
                                              state, batches[0])
    first_s = time.perf_counter() - t0
    first_peak = peak_gib(torch)
    log(f"10a gemma3-4b CONFIG f32 masters, {cfg.n_layers} layers (no depth "
        f"cut), {n_params} parameters, AdamW, B={b} S={s}: first step "
        f"{first_s:.2f} s, loss {float(loss):.6f}, peak {first_peak:.2f} GiB "
        f"(params, gradients and two moments {16 * n_params / 2**30:.2f} GiB)")
    host_loss = loss.cpu()
    host_grads = [g.cpu() for g in port.lm.tree_leaves(grads)]
    del grads
    host_leaves = [x.cpu() for x in port.lm.tree_leaves((params, state))]
    del params, state, loss
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params, state = fresh()
    loss, grads, params, state = lm_train_run(torch, port, cfg, tcfg, params,
                                              state, batches[0])
    if not torch.equal(loss.cpu(), host_loss):
        raise AssertionError(f"10a: loss {float(loss)} on the second run, "
                             f"{float(host_loss)} on the first")
    same_bits_leafwise(torch, port, "10a gradients", grads, host_grads)
    del grads, host_grads
    same_bits_leafwise(torch, port, "10a updated params and moments",
                       (params, state), host_leaves)
    del host_leaves
    log(f"10a the same init and batch twice: the loss, all "
        f"{len(port.lm.tree_leaves(params))} gradients and every updated "
        "param and "
        f"moment equal per torch.equal ({time.perf_counter() - t0:.1f} s "
        "with the host copies)")

    step = port.lm_train.make_train_step(cfg, tcfg)
    torch.cuda.reset_peak_memory_stats()
    params, state, times = timed_steps(torch, step, params, state,
                                       batches[1:1 + LM_TRAIN_STEPS])
    peak = peak_gib(torch)
    med = statistics.median(times)
    tokens = b * s
    log(f"10a step (make_train_step, host clock with a sync): median "
        f"{med * 1e3:.1f} ms of {LM_TRAIN_STEPS} "
        f"({', '.join(f'{t * 1e3:.1f}' for t in times)}), {tokens / med:.0f} "
        f"tokens/s, peak {peak:.2f} GiB")
    from torch.profiler import ProfilerActivity, profile

    batch = batches[1 + LM_TRAIN_STEPS]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        params, state, _ = step(params, state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = log_device_time(prof, wall, "10a one step")
    del prof
    out["full"] = {"layers": cfg.n_layers, "params": n_params, "batch": b,
                   "prompt": s, "first_step_s": first_s,
                   "step_ms": [t * 1e3 for t in times],
                   "step_ms_median": med * 1e3, "tokens_per_s": tokens / med,
                   "peak_gib": peak, "first_peak_gib": first_peak,
                   "profiled_wall_ms": wall, "device_busy_ms": busy,
                   "busy_share": None if busy is None else busy / wall}

    # bf16 compute from the f32 masters (the config's dtype), cast once
    tcfg16 = lm_train_tcfg(port, cast_params_once=True,
                           compute_dtype="bfloat16")
    step16 = port.lm_train.make_train_step(port.lm_cfg, tcfg16)
    torch.cuda.reset_peak_memory_stats()
    params, state, times16 = timed_steps(
        torch, step16, params, state, batches[2 + LM_TRAIN_STEPS:])
    peak16 = peak_gib(torch)
    log(f"10a cast_params_once bf16-compute step from the f32 masters: "
        f"{', '.join(f'{t * 1e3:.1f}' for t in times16)} ms (the first "
        f"warms up), peak {peak16:.2f} GiB")
    out["bf16_cast_once"] = {"step_ms": [t * 1e3 for t in times16],
                             "peak_gib": peak16}
    del params, state, batches
    torch.cuda.empty_cache()


def lm_train_remat(torch, np, port, out):
    """10b: ``remat_policy="dots"`` beside ``"nothing"`` on a depth cut at
    full width: the same loss and gradients, each policy's step time and
    peak memory."""
    layers = LM_TRAIN_REMAT_LAYERS
    cfg = dataclasses.replace(port.lm_cfg, dtype="float32", n_layers=layers)
    b, s = LM_TRAIN
    batches = [port.data.make_lm_batch(cfg, s, b, i, port.data.DataConfig(
        seed=SEED), device=DEVICE) for i in range(3)]  # the first warms up
    params = port.lm.init_lm(cfg, seed=SEED, device=DEVICE)
    grads = {}
    for policy in ("nothing", "dots"):
        tcfg = lm_train_tcfg(port, remat_policy=policy)
        grads[policy] = port.lm_train.make_grad_fn(cfg, tcfg)(params,
                                                              batches[0])
    (l0, g0), (l1, g1) = grads["nothing"], grads["dots"]
    equal = torch.equal(l0, l1) and all(
        torch.equal(a, c) for a, c in zip(port.lm.tree_leaves(g0),
                                          port.lm.tree_leaves(g1)))
    worst = max(float((a - c).abs().max()) / max(float(c.abs().max()), 1e-30)
                for a, c in zip(port.lm.tree_leaves(g1),
                                port.lm.tree_leaves(g0)))
    if worst > LM_TRAIN_RTOL:
        raise AssertionError(f"10b: dots' gradients {worst:.3e} x max|want| "
                             "from nothing's")
    del grads, g0, g1, params
    torch.cuda.empty_cache()
    rows = {}
    for policy in ("nothing", "dots"):
        tcfg = lm_train_tcfg(port, remat_policy=policy)
        params = port.lm.init_lm(cfg, seed=SEED, device=DEVICE)
        state = port.lm_train.init_train_state(params, tcfg)
        step = port.lm_train.make_train_step(cfg, tcfg)
        torch.cuda.reset_peak_memory_stats()
        params, state, times = timed_steps(torch, step, params, state,
                                           batches)
        rows[policy] = {"step_ms": [t * 1e3 for t in times],
                        "step_ms_median": statistics.median(times[1:]) * 1e3,
                        "peak_gib": peak_gib(torch)}
        del params, state, step
        torch.cuda.empty_cache()
    log(f"10b remat on a {layers}-layer cut at full width (B={b} S={s}, f32): "
        f"nothing {rows['nothing']['step_ms_median']:.1f} ms, peak "
        f"{rows['nothing']['peak_gib']:.2f} GiB; dots "
        f"{rows['dots']['step_ms_median']:.1f} ms, peak "
        f"{rows['dots']['peak_gib']:.2f} GiB; loss and gradients equal per "
        f"torch.equal: {equal} (worst {worst:.3e} x max|want|)")
    out["remat"] = {"layers": layers, "equal_bits": equal,
                    "worst_rel": worst, **rows}


def lm_train_vs_cpu(torch, np, port, out):
    """10c: layers 0-5 at full width, the loss and every gradient on the
    card against the same cut on the CPU (TF32 off)."""
    layers, b, s = LM_TRAIN_CPU_CUT
    cfg = dataclasses.replace(port.lm_cfg, dtype="float32", n_layers=layers)
    tcfg = lm_train_tcfg(port)
    batch = port.data.make_lm_batch(cfg, s, b, 0, port.data.DataConfig(
        seed=SEED + 1), device="cpu")
    p_dev = port.lm.init_lm(cfg, seed=SEED, device=DEVICE)
    p_cpu = port.lm.tree_map(lambda a: a.cpu(), p_dev)
    t0 = time.perf_counter()
    loss, grads = port.lm_train.make_grad_fn(cfg, tcfg)(
        p_dev, {k: v.to(DEVICE) for k, v in batch.items()})
    want_loss, want = port.lm_train.make_grad_fn(cfg, tcfg)(p_cpu, batch)
    worst = 0.0
    for i, (g, w) in enumerate(zip(port.lm.tree_leaves(grads),
                                   port.lm.tree_leaves(want))):
        err = float((g.cpu() - w).abs().max())
        tol = LM_TRAIN_RTOL * float(w.abs().max())
        if err > tol:
            raise AssertionError(f"10c gradient leaf {i}: {err:.3e} from the "
                                 f"CPU's (tol {tol:.3e})")
        worst = max(worst, err / max(float(w.abs().max()), 1e-30))
    lerr = abs(float(loss) - float(want_loss))
    if not lerr <= LM_TRAIN_RTOL * abs(float(want_loss)):
        raise AssertionError(f"10c loss {float(loss)} on the card, "
                             f"{float(want_loss)} on the CPU")
    log(f"10c layers 0-{layers - 1} (local and global) at full width, B={b} "
        f"S={s}: loss {float(loss):.6f} (CPU {float(want_loss):.6f}), every "
        f"gradient within {worst:.3e} x max|want| of the CPU's (tol "
        f"{LM_TRAIN_RTOL:g}; {time.perf_counter() - t0:.1f} s)")
    out["vs_cpu"] = {"layers": layers, "batch": b, "prompt": s,
                     "loss_abs_err": lerr, "grad_worst_rel": worst}


def lm_train_chaos(torch, np, port, out):
    """10d: ``train_loop`` at gemma3's SMOKE_CONFIG with a chaos death at a
    step and async checkpoints in a temporary directory: the recovered run
    equal, per ``torch.equal``, to the undisturbed one."""
    n_steps, die_at, every, b, s = LM_TRAIN_CHAOS
    cfg = dataclasses.replace(port.lm_configs.get_smoke_config("gemma3-4b"),
                              dtype="float32")
    tcfg = lm_train_tcfg(port)
    shape = port.lm_configs.ShapeConfig("t", s, b, "train")

    def setup():
        params = port.lm.init_lm(cfg, seed=SEED, device=DEVICE)
        return (params, port.lm_train.init_train_state(params, tcfg),
                port.lm_train.make_train_step(cfg, tcfg))

    def it(start):
        return port.data.lm_data_iter(cfg, shape, port.data.DataConfig(
            seed=9), start_step=start, device=DEVICE)

    base = port.lm_train.train_loop(*setup(), it(0), n_steps, log_every=1)
    plan = port.chaos.FaultPlan([port.chaos.FaultSpec(
        site="train.step", kind="die", at=die_at)])
    with tempfile.TemporaryDirectory() as d:
        ck = port.checkpoint.Checkpointer(d, keep=2, async_save=True)
        with port.chaos.active(plan):
            got = port.lm_train.train_loop(
                *setup(), it(0), n_steps, log_every=1, checkpointer=ck,
                ckpt_every=every, data_factory=it, max_recoveries=2)
        ck.wait()
        saved = ck.all_steps()
    if got["recoveries"] != 1 or ck.failed_saves:
        raise AssertionError(f"10d: {got['recoveries']} recoveries, "
                             f"{ck.failed_saves} failed saves")
    for what in ("params", "state"):
        same_bits_leafwise(torch, port, f"10d recovered {what}", got[what],
                           [x.cpu() for x in
                            port.lm.tree_leaves(base[what])])
    log(f"10d train_loop at SMOKE_CONFIG ({n_steps} steps, B={b} S={s}), a "
        f"chaos death at step {die_at}, async checkpoints every {every} "
        f"(kept {saved}, the directory removed): 1 recovery, params and "
        f"state equal per torch.equal to the undisturbed run")
    out["chaos"] = {"steps": n_steps, "die_at": die_at, "recoveries": 1,
                    "checkpoints_kept": saved}


def lm_train_phase(torch, np, port):
    """Phase 10: the LM training step at full width."""
    t0 = time.perf_counter()
    out = {}
    lm_train_full(torch, np, port, out)
    lm_train_remat(torch, np, port, out)
    lm_train_vs_cpu(torch, np, port, out)
    lm_train_chaos(torch, np, port, out)
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 10: wall {out['wall_s']:.1f} s (budget "
        f"{PHASE10_BUDGET_S:.0f} s)")
    return out


def mesh_checks(torch, np, port, out):
    """Phase 11's checks on a one-rank mesh; returns K1's launches."""
    specs, dist_mod = port.shard_specs, port.distributed
    dev = torch.device(DEVICE)
    mesh = specs.make_mesh((1, 1), ("data", "model"), device=DEVICE)
    mesh3 = specs.make_mesh((1, 1, 1), ("pod", "data", "model"),
                            device=DEVICE)
    n = N_NODES
    rng = np.random.default_rng(SEED)
    adj = (rng.random((n, n), dtype=np.float32) < 0.1).astype(np.float32)
    a = normalized_dense(np, adj)
    del adj
    ell = port.BlockELL.from_dense(a, 64, 64, device=DEVICE)
    h = torch.as_tensor(rng.standard_normal((n, MESH_D)).astype(np.float32),
                        device=dev)
    a_dev = torch.as_tensor(a, device=dev)
    del a
    oracle = a_dev @ h
    del a_dev
    want = port.spmm_blockell(ell, h)
    k1_ms = time_ms(torch, lambda: port.spmm_blockell(ell, h))
    k1 = 0
    rows = {}
    for name, fn, m in (("spmm_1p5d", dist_mod.spmm_1p5d, mesh),
                        ("spmm_2d", dist_mod.spmm_2d, mesh),
                        ("spmm_2p5d", dist_mod.spmm_2p5d, mesh3)):
        port.reset_counts()
        got = fn(ell, h, m).full_tensor()
        torch.cuda.synchronize()
        counts = port.counts()
        if counts != expected(port, {"K1": 1}, 1):
            raise AssertionError(f"11 {name} launched {counts}")
        k1 += 1
        if not torch.equal(got, want):
            raise AssertionError(f"11 {name}: not spmm_blockell's bits")
        err = float((got - oracle).abs().max())
        if err > oracle_tol(oracle):
            raise AssertionError(f"11 {name}: {err:.3e} from the dense "
                                 "oracle")
        ms = time_ms(torch, lambda: fn(ell, h, m))
        rows[name] = {"ms": ms, "k1_ms": k1_ms, "overhead_ms": ms - k1_ms,
                      "oracle_err": err}
        log(f"11 {name} on a one-rank NCCL mesh, graph (a) D={MESH_D}: "
            f"K1 x1, equal to spmm_blockell per torch.equal, {err:.3e} from "
            f"the dense f32 oracle (tol {oracle_tol(oracle):.3e}); "
            f"{ms:.4f} ms against K1 alone {k1_ms:.4f} ms (the collective "
            f"and the DTensor: {ms - k1_ms:+.4f} ms)")
    del oracle, want, h, ell
    torch.cuda.empty_cache()

    x = torch.as_tensor(rng.standard_normal((2048, 4096)).astype(np.float32),
                        device=dev)
    w = torch.as_tensor(rng.standard_normal((4096, 2048)).astype(np.float32),
                        device=dev)
    got = dist_mod.allgather_matmul_overlap(x, w, mesh,
                                            axis="model").full_tensor()
    ref = x @ w
    err = float((got - ref).abs().max())
    if err > oracle_tol(ref):
        raise AssertionError(f"11 allgather_matmul_overlap: {err:.3e}")
    rows["allgather_matmul_overlap"] = {"equal_bits": torch.equal(got, ref),
                                        "max_abs_err": err}
    del x, w, got, ref

    pmesh = specs.make_mesh((1,), ("pod",), device=DEVICE)
    ws = torch.as_tensor(rng.standard_normal((1, 256, 256)).astype(
        np.float32) / 16, device=dev)
    xs = torch.as_tensor(rng.standard_normal((8, 64, 256)).astype(
        np.float32), device=dev)

    def stage(wt, xt):
        return torch.tanh(xt @ wt)

    got = port.gpipe.pipeline_apply(stage, ws, xs, pmesh, axis="pod")
    ref = torch.stack([stage(ws[0], xs[t]) for t in range(xs.shape[0])])
    if not torch.equal(got, ref):
        raise AssertionError("11 pipeline_apply with one stage differs from "
                             "the stage applied to each microbatch")

    cfg = dataclasses.replace(port.lm_configs.get_smoke_config(
        "llama4-scout-17b-a16e"), dtype="float32")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    from repro_torch.models.moe import init_moe, moe_ffn

    p = init_moe(gen, cfg)
    xm = torch.as_tensor(rng.standard_normal((2, 64, cfg.d_model)).astype(
        np.float32), device=dev)
    with port.shard_ctx.use_mesh(mesh):
        y_ep, aux_ep = moe_ffn(p, xm, cfg)
    y, aux = moe_ffn(p, xm, cfg)
    if not (torch.equal(y_ep, y) and torch.equal(aux_ep, aux)):
        raise AssertionError("11 the MoE's expert-parallel branch on 1 x 1 "
                             "differs from its local branch")

    scfg = dataclasses.replace(port.lm_configs.get_smoke_config("gemma3-4b"),
                               dtype="float32")
    tcfg = lm_train_tcfg(port)
    batch = port.data.make_lm_batch(scfg, 128, 2, 0, port.data.DataConfig(
        seed=SEED), device=DEVICE)
    params = port.lm.init_lm(scfg, seed=SEED, device=DEVICE)
    state = port.lm_train.init_train_state(params, tcfg)
    place = port.shard_step.place_tree
    p_sh, s_sh = place(params, mesh), place(state, mesh)
    p_sh, s_sh, m_sh = port.shard_step.make_sharded_train_step(
        scfg, tcfg, mesh)(p_sh, s_sh, batch)
    params, state, m = port.lm_train.make_train_step(scfg, tcfg)(
        params, state, batch)
    torch.cuda.synchronize()
    if not torch.equal(m_sh["loss"], m["loss"]):
        raise AssertionError("11 the sharded step's loss differs")
    same_bits_leafwise(torch, port, "11 the sharded step", (p_sh, s_sh),
                       [x.cpu() for x in
                        port.lm.tree_leaves((params, state))])
    log("11 allgather_matmul_overlap against x @ w "
        f"({rows['allgather_matmul_overlap']['max_abs_err']:.3e}, equal "
        f"bits {rows['allgather_matmul_overlap']['equal_bits']}); "
        "pipeline_apply with one stage, the MoE's expert-parallel branch on "
        "1 x 1 (llama4-scout SMOKE_CONFIG, f32) and one sharded train step "
        "(gemma3 SMOKE_CONFIG) each equal per torch.equal to the unsharded "
        "computation")
    out.update(rows)
    return k1


def mesh_phase(torch, np, port):
    """Phase 11: the mesh at world size 1, a one-rank NCCL group on a
    ``FileStore``, destroyed before the next phase."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl", store=dist.FileStore(
            str(Path(d) / "store"), 1), rank=0, world_size=1)
        try:
            k1 = mesh_checks(torch, np, port, out)
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    out["k1_launches"] = k1
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 11: wall {out['wall_s']:.1f} s (budget "
        f"{PHASE11_BUDGET_S:.0f} s); K1 launches on its main path {k1}")
    return out, k1


def deprecations(fn):
    """``fn()`` and the number of DeprecationWarnings it raised."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn()
    return out, sum(issubclass(w.category, DeprecationWarning)
                    for w in caught)


def printed(fn):
    """``fn()`` and the lines it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue().splitlines()


def shim_calls(torch, port, what, fn, want_counts, n_warnings=1):
    """One deprecated call between counts set to 0 and read: its launches
    must be ``want_counts`` and it must warn ``n_warnings`` times."""
    port.reset_counts()
    got, warned = deprecations(fn)
    torch.cuda.synchronize()
    counts = port.counts()
    if counts != expected(port, want_counts, 1):
        raise AssertionError(f"12a {what} launched {counts}, not "
                             f"{want_counts}")
    if warned != n_warnings:
        raise AssertionError(f"12a {what}: {warned} DeprecationWarnings, "
                             f"not {n_warnings}")
    return got, counts


def shim_checks(torch, np, port, out):
    """12a: the deprecated shims at graph (a)'s full width; returns their
    K1 and K3 launches."""
    dev = torch.device(DEVICE)
    n = N_NODES
    rng = np.random.default_rng(SEED)
    adj = (rng.random((n, n), dtype=np.float32) < 0.1).astype(np.float32)
    a = normalized_dense(np, adj)
    del adj
    ell = port.BlockELL.from_dense(a, 64, 64, device=DEVICE)
    h = torch.as_tensor(rng.standard_normal((n, SHIM_D)).astype(np.float32),
                        device=dev)
    a_dev = torch.as_tensor(a, device=dev)
    del a
    oracle = a_dev @ h
    del a_dev
    tol = oracle_tol(oracle)
    spmm = port.core_spmm.spmm
    launched = {"K1": 0, "K3": 0}
    rows = {}
    op, counts = shim_calls(torch, port, "SparseOperand(ell=...)",
                            lambda: port.SparseOperand(ell=ell), {})
    for what, call, uses_k1 in (
            ("policy=ell", lambda: spmm(ell, h, policy="ell"), True),
            ("use_kernel=True", lambda: spmm(ell, h, use_kernel=True), True),
            ("use_kernel=False", lambda: spmm(ell, h, use_kernel=False),
             False),
            ("SparseOperand, auto", lambda: spmm(op, h), None)):
        if uses_k1 is None:  # auto: the plan's path
            plan = port.dispatch.plan_spmm(op.stats(), SHIM_D,
                                           device=dev,
                                           candidates=("ell", "csr", "dense"))
            uses_k1 = plan.path == "ell"
        got, counts = shim_calls(torch, port, what, call,
                                 {"K1": 1} if uses_k1 else {})
        path = port.dispatch.last_plan("spmm").path
        err = float((got - oracle).abs().max())
        if err > tol:
            raise AssertionError(f"12a spmm {what}: {err:.3e} from the "
                                 f"dense oracle (tol {tol:.3e})")
        launched["K1"] += counts["K1"]
        rows[what] = {"path": path, "K1": counts["K1"], "oracle_err": err}
        log(f"12a core.spmm.spmm {what} on graph (a), D={SHIM_D}: path "
            f"{path}, K1 x{counts['K1']}, one DeprecationWarning, {err:.3e} "
            f"from the dense f32 oracle (tol {tol:.3e})")
    del oracle, h, op
    torch.cuda.empty_cache()

    coo = port.paths.ell_to_coo(ell)
    b = torch.as_tensor(rng.integers(-SHIM_INT, SHIM_INT + 1, (n, SHIM_K))
                        .astype(np.float32), device=dev)
    c = torch.as_tensor(rng.integers(-SHIM_INT, SHIM_INT + 1, (SHIM_K, n))
                        .astype(np.float32), device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        mask = coo.blocks.to(dtype)
        coo_d = dataclasses.replace(coo, blocks=mask)
        bd, cd = b.to(dtype), c.to(dtype)
        got, counts = shim_calls(
            torch, port, f"sddmm {name}",
            lambda: port.core_sddmm.sddmm(coo_d, bd, cd, policy="ell"),
            {"K3": 1})
        launched["K3"] += counts["K3"]
        plain = port.sddmm_ref.sddmm_blockcoo_ref(coo.rows, coo.cols, mask,
                                                  bd, cd)
        if not torch.equal(got.blocks, plain):
            raise AssertionError(f"12a sddmm {name}: K3 (round once) is not "
                                 "its plain version's bits")
        first = port.sddmm_ref.sddmm_blockcoo_ref(coo.rows, coo.cols, mask,
                                                  bd, cd, round_dot=True)
        differ = int((first != got.blocks).sum())
        del first, plain, got
        row = {"K3": counts["K3"], "equal_bits_plain": True,
               "cells_round_dot_first_differs": differ,
               "cells": mask.numel()}
        if dtype == torch.bfloat16:
            k3, ops = port.wrappers["K3"], (coo.rows, coo.cols, mask, bd, cd)
            cells = mask.numel()
            nbytes = nbytes_of(coo.rows, coo.cols, mask, bd, cd) + cells * 2
            row.update(measure(
                torch, "K3 weighted bf16, round once", lambda: k3(*ops),
                lambda: port.sddmm_ref.sddmm_blockcoo_ref(*ops), None,
                nbytes, 2 * SHIM_K * cells + cells,
                f"graph (a) Block-COO, K={SHIM_K}, the shims' epilogue"))
        rows[f"sddmm {name}"] = row
        log(f"12a core.sddmm.sddmm policy=ell, {name} weighted values, "
            f"K={SHIM_K} (integer B, C: exact dots): K3 x{counts['K3']} "
            "round once, "
            f"one DeprecationWarning, equal to its plain version per "
            f"torch.equal; the round-the-dot-first epilogue would differ in "
            f"{differ} of {mask.numel()} cells")
        del mask, coo_d, bd, cd
    del coo, ell, b, c
    torch.cuda.empty_cache()
    out["shims"] = rows
    return launched


def launcher_checks(torch, np, port, out):
    """12b and 12c: the serve and train launchers on the card."""
    toks, lines = printed(lambda: port.launch_serve.main(
        ["--arch", "gemma3-4b", "--full", "--device", DEVICE]))
    if toks.shape != (4, 32) or not (
            (toks >= 0) & (toks < port.lm_cfg.vocab_size)).all():
        raise AssertionError(f"12b launch.serve: tokens {toks.shape}")
    out["serve"] = lines
    log(f"12b launch.serve --arch gemma3-4b --full (34 layers, B = 4, a "
        f"64-token prompt, 32 new tokens): {lines[0]}; {lines[1]}")
    torch.cuda.empty_cache()

    batch, seq, steps = LAUNCH_TRAIN_FULL
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res, lines = printed(lambda: port.launch_train.main(
        ["--arch", "gemma3-4b", "--full", "--batch", str(batch), "--seq",
         str(seq), "--steps", str(steps), "--device", DEVICE]))
    wall = time.perf_counter() - t0
    losses = [row["loss"] for row in res["history"]]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"12c launch.train --full: losses {losses}")
    del res
    torch.cuda.empty_cache()
    out["train_full"] = {"lines": lines, "wall_s": wall,
                         "peak_gib": peak_gib(torch)}
    log(f"12c launch.train --arch gemma3-4b --full --batch {batch} --seq "
        f"{seq} --steps {steps} (f32 AdamW, 34 layers): {lines[-1]} "
        f"(finite); wall {wall:.1f} s, peak {peak_gib(torch):.2f} GiB")

    every, steps, batch, seq = LAUNCH_TRAIN_SMOKE
    with tempfile.TemporaryDirectory() as d:
        args = ["--arch", "gemma3-4b", "--batch", str(batch), "--seq",
                str(seq), "--steps", str(steps), "--ckpt-dir", d,
                "--ckpt-every", str(every), "--device", DEVICE]
        first, _ = printed(lambda: port.launch_train.main(args))
        saved = port.checkpoint.Checkpointer(d).restore(
            {"params": first["params"], "state": first["state"]})
        same_bits_leafwise(
            torch, port, "12c the restored checkpoint",
            (saved["params"], saved["state"]),
            [x.cpu() for x in port.lm.tree_leaves(
                (first["params"], first["state"]))])
        _, lines = printed(lambda: port.launch_train.main(
            args + ["--resume"]))
    if lines[0] != f"resumed from step {steps}" \
            or not lines[1].startswith(f"step {steps:5d}  loss "):
        raise AssertionError(f"12c launch.train --resume printed {lines[:2]}")
    out["train_resume"] = lines
    log(f"12c launch.train at SMOKE_CONFIG, --ckpt-every {every} --steps "
        f"{steps}: the restored params and moments equal the saved ones "
        f"per torch.equal; --resume: {lines[0]}, first step {lines[1]}")


def shims_launch_phase(torch, np, port):
    """Phase 12: the deprecated shims on K1 and K3, and the launchers."""
    t0 = time.perf_counter()
    out = {}
    launched = shim_checks(torch, np, port, out)
    launcher_checks(torch, np, port, out)
    out["launches"] = launched
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 12: wall {out['wall_s']:.1f} s (budget "
        f"{PHASE12_BUDGET_S:.0f} s); launches on its main path {launched}")
    return out, launched


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

    t0 = t_start = time.perf_counter()
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
    for name, tag in (("spmm_blockell", "K1/K5"), ("spmm_blockell_t", "N1")):
        for inst, lines in sorted(ptxas_instances(logs[name]).items()):
            log(f"  {tag} {inst}: " + "; ".join(lines))  # none may spill
    for source in ("spmm_blockell", "spmm_blockell_t"):
        if source in spills:
            raise AssertionError(f"a {source} instance spills")

    ragged_checks(torch, np, port)
    ragged_checks_blockell(torch, np, port)
    ragged_checks_transposed(torch, np, port)
    ragged_checks_sddmm_attention(torch, np, port)
    ragged_checks_width_one(torch, np, port)
    ragged_checks_pattern(torch, np, port)
    ragged_checks_bsattn(torch, np, port)

    n = N_NODES
    rng = np.random.default_rng(SEED)
    adj_a = (rng.random((n, n), dtype=np.float32) < 0.1).astype(np.float32)
    t_main = time.perf_counter() - t0
    rows, backward_a, dispatch_a = serve_graph(
        torch, np, port, "a: uniform density 0.1", adj_a, "ell",
        {"K1": 1, "K2": 0, "K5": 2, "K6": 0})
    del adj_a
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    adj_b = port.random_graph(n, 16, seed=1)
    rows_b, backward_b, dispatch_b = serve_graph(
        torch, np, port, f"b: random_graph({n}, 16, seed=1)", adj_b, "sell",
        {"K1": 0, "K2": 1, "K5": 0, "K6": 2})
    rows.update(rows_b)
    for name, count in itertools.chain(dispatch_a["launches"].items(),
                                       dispatch_b["launches"].items()):
        rows[name]["launches"] += count
    del adj_b
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rows.update(bsattn_phase(torch, np, port))
    torch.cuda.empty_cache()
    serve_rows, delta_rows, runs6 = serving_phase(torch, np, port)
    for name, row in list(serve_rows.items()) + list(delta_rows.items()):
        rows[name]["launches"] += row["launches"]
    calibration = calibrate_phase(torch, np, port, {
        "a": dispatch_a.pop("plan_inputs"),
        "b": dispatch_b.pop("plan_inputs")})
    fleet, fleet_k1 = fleet_phase(torch, np, port)
    rows["K1"]["launches"] += fleet_k1
    lm_summary, lm_n1 = lm_phase(torch, np, port)
    rows["N1"]["launches"] += lm_n1
    lm_train_summary = lm_train_phase(torch, np, port)
    mesh_summary, mesh_k1 = mesh_phase(torch, np, port)
    rows["K1"]["launches"] += mesh_k1
    shims_summary, shims_launched = shims_launch_phase(torch, np, port)
    for name, count in shims_launched.items():
        rows[name]["launches"] += count

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
    print(json.dumps({"serving_shapes": {"blockdiag_16x16": serve_rows,
                                         "delta_overlay": delta_rows,
                                         "runs": runs6}}))
    print(json.dumps({"dispatch": {"a": dispatch_a, "b": dispatch_b,
                                   "calibrate": calibration}},
                     default=str))
    print(json.dumps({"fleet": fleet}))
    print(json.dumps({"lm": lm_summary}))
    print(json.dumps({"lm_train": lm_train_summary}))
    print(json.dumps({"mesh": mesh_summary}))
    print(json.dumps({"shims_launch": shims_summary}))
    print(json.dumps({"kernels": kernels}))
    log(f"chip_smoke wall {time.perf_counter() - t_start:.1f} s (phases 1 "
        f"and 2, the kernel build included, {t_main:.1f} s of it)")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
