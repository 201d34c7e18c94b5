#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one card

Phases, each of which must pass or the script exits non-zero:

  1. Device and build: the card's name and power limit, torch and CUDA
     versions, and the build of every CUDA kernel from ``csrc/``.
  2. Kernels against their plain PyTorch versions on the card, at ragged
     small shapes (m not a multiple of bm): K1/K2/K5/K6 at D = 16 and 48
     with bias and residual (K2/K6 on their slot operands, held besides
     to the tile-granular plain versions of the same matrix); K3/K4 at K = 2 and 48 (K3 with a weighted
     mask); K7/K8 at dk = 2 and 48, D = 16 and 48, with edge-less rows
     and all three edge activations; K9 in f32 and bf16 at S = 256, GQA
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
     SpMM kernels, ``torch.sparse.sampled_addmm`` for the SDDMM ones;
     printed here, never called by the port) and beside its bound from
     bytes and the FP32 operations its nonzeros need (K2/K6: the two row
     arrays, each nonzero's column and value, H and Y; K2/K6 also with
     every row cut to the p99 count, to show what the heaviest rows
     cost).  Then, with the kernel launch counts set to 0 just before and
     read just after:
       GCN: 8 requests through ``GNNServingEngine``, logits held to a
            dense f32 oracle (TF32 off), and one request with
            ``fuse=False``; one more request profiled, which must call
            neither ``sell_tile_blocks`` nor ``sell_row_ptr``;
       SDDMM: one ``repro_torch.sparse.ops.sddmm`` call at K = 2, its
            plan and values held to a dense f32 oracle of A ⊙ (B C);
       GAT: 8 requests through ``GNNServingEngine(model="gat")``, logits
            held to a dense f32 masked-softmax oracle, and one request
            with ``fuse=False`` (no kernel: it samples on the csr
            pattern) held to the fused logits.
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
     each in bf16 and then in f32.  Every output row is held to its own
     norm; f32 besides to 1e-4 x max|want|, and bf16 element by element
     to the plain version (rtol 1e-2, atol 2e-3).
     Each timed beside its bound (the live query-key pairs at the
     dtype's peak), the plain version and
     ``scaled_dot_product_attention`` (the dense ELL mask at (i),
     ``is_causal`` at (ii); printed here, never called by the port).
  5. A JSON line of the kernels, the card line, and the final JSON line.

Without a CUDA device, or without the repository around it, the script
exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import math
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and FP32 FLOP/s
# outside the tensor cores.  Bounds are stated against these, at 700 W.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12  # tensor cores, dense
# logits (and SDDMM values) vs the dense oracle, relative to their own
# scale: |got - want| <= ORACLE_RTOL * max|want| + ORACLE_ATOL (f32 sums
# over up to 16384 terms, and for GAT the softmax's exp, taken in
# another order)
ORACLE_RTOL = 1e-4
ORACLE_ATOL = 1e-7
KERNEL_TOL = dict(rtol=1e-4, atol=1e-5)  # kernel vs its plain version
BF16_TOL = dict(rtol=2e-2, atol=2e-2)  # K9 in bf16 vs its plain version
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
SEED = 0
N_NODES = 16384
S_LOCAL = 32768   # phase 4 (i): the prefill_32k length, local-layer window
S_GLOBAL = 8192   # phase 4 (ii): the global-layer mask (full causal)
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
    "K4": ("sddmm_sell_kernel", "src/repro_torch/csrc/sddmm.cu",
           "src/repro/kernels/sddmm/sell.py:58"),
    "K7": ("fused_attn_blockell_kernel",
           "src/repro_torch/csrc/fused_attention.cu",
           "src/repro/kernels/fused/attention.py:99"),
    "K8": ("fused_attn_sell_kernel", "src/repro_torch/csrc/fused_attention.cu",
           "src/repro/kernels/fused/attention.py:281"),
    "K9": ("bsattn_kernel", "src/repro_torch/csrc/bsattn.cu",
           "src/repro/kernels/bsattn/kernel.py:93"),
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
        from repro_torch.kernels.fused import attention
        from repro_torch.kernels.fused import spmm as fused
        from repro_torch.kernels.fused.epilogue import Epilogue
        from repro_torch.kernels.sddmm import kernel as sddmm_kernel
        from repro_torch.kernels.sddmm import ref as sddmm_ref
        from repro_torch.kernels.sddmm import sell as sddmm_sell
        from repro_torch.kernels.spmm import kernel, ref, sell
        from repro_torch.models import gnn
        from repro_torch.serve import engine
        from repro_torch.sparse import ops, paths

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
        self.Epilogue = Epilogue
        self.gnn, self.engine = gnn, engine
        self.ops, self.paths, self.dispatcher = ops, paths, dispatcher
        self.wrappers = {
            "K1": kernel.spmm_blockell_kernel,
            "K2": sell.spmm_sell_kernel,
            "K5": fused.spmm_blockell_epilogue_kernel,
            "K6": fused.spmm_sell_epilogue_kernel,
            "K3": sddmm_kernel.sddmm_blockcoo_kernel,
            "K4": sddmm_sell.sddmm_sell_kernel,
            "K7": attention.fused_attn_blockell_kernel,
            "K8": attention.fused_attn_sell_kernel,
            "K9": bsattn_kernel.bsattn_kernel,
        }

    def reset_counts(self):
        for w in self.wrappers.values():
            w.launches = 0

    def counts(self):
        return {k: w.launches for k, w in self.wrappers.items()}


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


def ragged_checks_sddmm_attention(torch, np, port):
    """Phase 2 for K3/K4 (K = 2 and 48) and K7/K8 (dk = 2 and 48, D = 16
    and 48, edge-less rows, every edge activation) at m = 1000."""
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
    for k in (2, 48):
        ops = (coo.rows, coo.cols, coo.blocks,
               torch.randn(n_pad, k, device=dev),
               torch.randn(k, n_pad, device=dev))
        errs = {"K3": check_close(torch, f"K3 ragged k={k}",
                                  port.wrappers["K3"](*ops),
                                  port.sddmm_ref.sddmm_blockcoo_ref(*ops))}
        ops = (sell.tile_rows, sell.tile_cols, pattern,
               torch.randn(live * bm, k, device=dev),
               torch.randn(k, n_pad, device=dev))
        errs["K4"] = check_close(
            torch, f"K4 ragged k={k}", port.wrappers["K4"](*ops),
            port.sddmm_sell.sddmm_sell_tiles_ref(*ops))
        log(f"ragged m={m} k={k} (COO blocks {coo.nnzb}, SELL tiles "
            f"{sell.n_tiles}): max_abs_err "
            + " ".join(f"{n} {e:.3e}" for n, e in errs.items()))
    att = port.attention
    for dk in (2, 48):
        for d in (16, 48):
            errs = {"K7": 0.0, "K8": 0.0}
            for act in ACTS:
                kw = dict(act=act, slope=0.2)
                ops = (ell.indices, ell.blocks,
                       torch.randn(n_pad, dk, device=dev),
                       torch.randn(dk, n_pad, device=dev),
                       torch.randn(n_pad, d, device=dev))
                got = port.wrappers["K7"](*ops, **kw)
                err = check_close(torch, f"K7 ragged dk={dk} d={d} {act}",
                                  got, att.fused_attn_blockell_ref(*ops, **kw))
                if bool(got[[3, 500, 999]].any()):
                    raise AssertionError("K7: edge-less rows are not 0")
                errs["K7"] = max(errs["K7"], err)
                ops = (sell.tile_rows, sell.tile_cols, pattern,
                       torch.randn(live * bm, dk, device=dev),
                       torch.randn(dk, n_pad, device=dev),
                       torch.randn(n_pad, d, device=dev))
                kw["n_live_block_rows"] = live
                errs["K8"] = max(errs["K8"], check_close(
                    torch, f"K8 ragged dk={dk} d={d} {act}",
                    port.wrappers["K8"](*ops, **kw),
                    att.fused_attn_sell_tiles_ref(*ops, **kw)))
            log(f"ragged m={m} dk={dk} d={d} ({', '.join(ACTS)}; edge-less "
                "rows exactly 0): max_abs_err "
                + " ".join(f"{n} {e:.3e}" for n, e in errs.items()))


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
    dev_ms = {}
    for ev in prof.key_averages():
        if str(ev.device_type).endswith("CUDA"):
            t = getattr(ev, "self_device_time_total", None)
            if t is None:
                t = getattr(ev, "self_cuda_time_total", 0)
            if t > 0:
                dev_ms[ev.key] = t / 1e3
    if not dev_ms:
        log(f"graph ({label}) profile: the profiler saw no device time "
            "(device busy share not measured)")
        return calls
    busy = sum(dev_ms.values())
    top = sorted(dev_ms.items(), key=lambda kv: -kv[1])[:8]
    log(f"graph ({label}) profile of one request: wall {wall:.3f} ms under "
        f"the profiler, device busy {busy:.3f} ms ({100 * busy / wall:.1f} "
        "%); by device time: "
        + "; ".join(f"{k[:70]} {v:.3f} ms" for k, v in top))
    return calls


def expected(port, per_call, calls):
    """Launch counts over every wrapper: ``per_call`` times ``calls``."""
    return {k: per_call.get(k, 0) * calls for k in port.wrappers}


def measure(torch, name, run, plain, library, nbytes, flops, what):
    """One kernel row: held to its plain version, timed beside it and
    beside the library call (``library`` None: there is none), with the
    bound from ``nbytes`` and ``flops``."""
    err = check_close(torch, name, run(), plain())
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
    # the kernel at the operands the path hands it (autodiff.sample_exec)
    if want_path == "ell":
        name, plain = "K3", port.sddmm_ref.sddmm_blockcoo_ref
        coo = paths.ell_to_coo(graph.adj.form("ell"))
        args = (coo.rows, coo.cols, torch.ones_like(coo.blocks),
                paths.pad_rows(b, coo.shape[0]),
                paths.pad_cols(c, coo.shape[1]).contiguous())
        what = f"nnzb={coo.nnzb} all-ones blocks {coo.bm}x{coo.bn} K={k}"
    else:
        name, plain = "K4", port.sddmm_sell.sddmm_sell_tiles_ref
        sell = graph.adj.form("sell")
        n_pad = -(-n // sell.bn) * sell.bn
        args = (sell.tile_rows, sell.tile_cols,
                (sell.tile_slot_map < sell.n_slots).float(),
                torch.cat([b, b.new_zeros((1, k))])[sell.perm].contiguous(),
                paths.pad_cols(c, n_pad).contiguous())
        what = (f"T={sell.n_tiles} live_block_rows={sell.n_live_block_rows} "
                f"block={sell.bm}x{sell.bn} K={k}")
    nnz = int((args[2] != 0).sum())
    nbytes = sum(t.numel() * t.element_size() for t in args) \
        + args[2].numel() * 4  # the output tiles
    a_lib = library_csr(torch, graph)
    row = measure(
        torch, name, lambda: port.wrappers[name](*args), lambda: plain(*args),
        lambda: torch.sparse.sampled_addmm(a_lib, b, c, beta=0.0), nbytes,
        2 * k * nnz + nnz, f"{what}; sampled entries {nnz}")
    del args

    cand = port.gnn.graph_candidates(graph.adj)
    torch.cuda.synchronize()
    port.reset_counts()
    s = port.ops.sddmm(graph.adj, b, c, candidates=cand)
    torch.cuda.synchronize()
    counts = port.counts()
    plan = port.dispatcher.last_plan("sddmm")
    log(f"graph ({label}) SDDMM K={k}: plan {plan.path} ({plan.reason}); "
        f"launches {counts}")
    if plan.path != want_path or s.formats != (want_path,) \
            or counts != expected(port, {name: 1}, 1):
        raise AssertionError(f"graph ({label}) SDDMM ran {plan.path!r} with "
                             f"{counts}, expected {want_path!r} and {name} x1")
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
    return {name: row}


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
        topo, n_rows, n_pad = (ell.indices, ell.blocks), ell.shape[0], \
            ell.shape[1]
        what = f"nbr={ell.n_block_rows} W={ell.ell_width} block=" \
            f"{ell.bm}x{ell.bn} dk={dk} D={d}"
    else:
        name, plain = "K8", att.fused_attn_sell_tiles_ref
        sell = graph.adj.form("sell")
        kw["n_live_block_rows"] = sell.n_live_block_rows
        topo = (sell.tile_rows, sell.tile_cols,
                (port.sell.sell_tile_blocks(sell) != 0).float())
        n_rows = sell.n_live_block_rows * sell.bm
        n_pad = -(-n // sell.bn) * sell.bn
        what = (f"T={sell.n_tiles} live_block_rows={sell.n_live_block_rows} "
                f"block={sell.bm}x{sell.bn} dk={dk} D={d}")
    args = topo + (torch.randn(n_rows, dk, device=dev, generator=gen),
                   torch.randn(dk, n_pad, device=dev, generator=gen),
                   torch.randn(n_pad, d, device=dev, generator=gen))
    nnz = int((topo[-1] != 0).sum())
    nbytes = sum(t.numel() * t.element_size() for t in args) \
        + n_rows * d * 4  # the output
    # per nonzero: dk + D multiply-adds, and the act, max, exp and sum
    flops = nnz * (2 * dk + 2 * d + 4)
    row = measure(torch, name, lambda: port.wrappers[name](*args, **kw),
                  lambda: plain(*args, **kw), None, nbytes, flops,
                  f"{what}; nonzeros {nnz}")
    del args, topo

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

    unfused = port.engine.GNNServingEngine(
        params, graph, port.engine.GNNServeConfig(model="gat", fuse=False))
    port.reset_counts()
    t0 = time.perf_counter()
    got = unfused.infer(xs[0])
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    ucounts = port.counts()
    err = float((got - outs[0]).abs().max())
    log(f"graph ({label}) GAT fuse=False ({wall:.3f} ms; paths "
        f"{sorted({p.path for p in port.dispatcher.dispatch_log()[-6:]})}): "
        f"launches {ucounts}, max_abs_err vs fused {err:.3e}")
    if ucounts != expected(port, {}, 1) or err > oracle_tol(outs[0]):
        raise AssertionError(f"graph ({label}) GAT fuse=False run off: "
                             f"{ucounts}, err {err:.3e}")
    profile_request(torch, eng, xs[0], f"{label}, GAT")
    row["launches"] = counts[name]
    return {name: row}


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
    rows.update(sddmm_phase(torch, port, graph, a_dense, label, want_path))
    pattern = a_dense != 0
    del a_dense
    rows.update(gat_phase(torch, port, graph, pattern, label, want_path, xs))
    log(f"graph ({label}) peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return rows


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


def bsattn_phase(torch, np, port):
    """Phase 4: block-sparse attention at gemma3-4b width through the
    entry point; returns K9's row at (i) in bf16, with launches."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

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
            if dtype == torch.bfloat16:
                with sdpa_kernel(fused_sdpa), warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    library = lambda: \
                        torch.nn.functional.scaled_dot_product_attention(
                            q[None], k[None], v[None], enable_gqa=True,
                            **sdpa_kw)
                    lib_err = float((library()[0].float() - out.float())
                                    .abs().max())
                    row["library_ms"] = time_ms(torch, library)
                lib = (f"{row['library_ms']:.4f} ms (max_abs_err vs K9 "
                       f"{lib_err:.3e})")
            else:
                lib = "not timed (no fused SDPA backend takes f32 with GQA)"
            nbytes = (2 * h + 2 * hkv) * s * d * q.element_size() \
                + 2 * ell.numel() * 4
            peak = PEAK_BF16_FLOP_PER_S if dtype == torch.bfloat16 \
                else PEAK_FP32_FLOP_PER_S
            row["bound_ms"], row["bound_by"] = bound(nbytes, flops, peak)
            entry = time_ms(torch, lambda: port.bsattn
                            .block_sparse_flash_attention(
                                q, k, v, window=window, block_q=blk,
                                block_kv=blk))
            log(f"K9 [{shape} {name}]: kernel {row['ms']:.4f} ms | entry "
                f"point {entry:.4f} ms | plain {row['plain_ms']:.4f} ms | "
                f"SDPA {lib} | bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']}: {nbytes / 1e9:.3f} GB, "
                f"{flops / 1e9:.1f} GFLOP at {peak / 1e12:.0f} TFLOP/s; "
                f"{flops / PEAK_FP32_FLOP_PER_S * 1e3:.3f} ms at the FP32 "
                f"FFMA peak; kernel at "
                f"{flops / row['ms'] / 1e9:.2f} TFLOP/s)")
            if label == "i" and dtype == torch.bfloat16:
                row["launches"] = counts["K9"]
                k9_row = row
            del q, k, v, out
        del x32, sdpa_kw
        torch.cuda.empty_cache()
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
    logs = port.build.build()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"({', '.join(port.build.SOURCES)})")
    for name, text in logs.items():
        usage = sorted({line.split(":", 1)[-1].strip()
                        for line in text.splitlines()
                        if "Used" in line or "spill" in line})
        log(f"  {name} (ptxas, distinct over its instances): "
            + " | ".join(usage))

    ragged_checks(torch, np, port)
    ragged_checks_sddmm_attention(torch, np, port)
    ragged_checks_bsattn(torch, np, port)

    n = N_NODES
    rng = np.random.default_rng(SEED)
    adj_a = (rng.random((n, n), dtype=np.float32) < 0.1).astype(np.float32)
    rows = serve_graph(torch, np, port, "a: uniform density 0.1", adj_a,
                       "ell", {"K1": 1, "K2": 0, "K5": 2, "K6": 0})
    del adj_a
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    adj_b = port.random_graph(n, 16, seed=1)
    rows.update(serve_graph(torch, np, port,
                            f"b: random_graph({n}, 16, seed=1)", adj_b,
                            "sell", {"K1": 0, "K2": 1, "K5": 0, "K6": 2}))
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
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
