#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one card

Phases, each of which must pass or the script exits non-zero:

  1. Device and build: the card's name and power limit, torch and CUDA
     versions, and the build of every CUDA kernel from ``csrc/``.
  2. Kernels against their plain PyTorch versions on the card, at one
     ragged small shape (m not a multiple of bm, D = 16 and 48, bias and
     residual on).
  3. GCN node-classification serving at the paper's full width
     (``CONFIG``: 256 -> 128 -> 128 -> 16, 64 x 64 blocks, numpy-seeded He
     weights) on two graphs of N = 16384 nodes:
       (a) uniform density 0.1, planned onto the Block-ELL path (K5, K1);
       (b) ``random_graph(16384, 16, seed=1)``, > 99 % sparse, planned
           onto the SELL-C-σ path (K6, K2).
     Per graph: each kernel at the serving shapes against its plain
     version, timed beside it, beside ``torch.sparse.mm`` on the same A
     and H (a yardstick printed here, never called by the port) and
     beside its bound from bytes and the FP32 operations its nonzeros
     need; then 8 requests
     through ``GNNServingEngine(device="cuda")`` with the kernel launch
     counts set to 0 just before and read just after; the logits held to
     a dense f32 oracle (TF32 off); and one request with ``fuse=False``.
  4. A JSON line of the kernels, the card line, and the final JSON line.

Without a CUDA device, or without the repository around it, the script
exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and FP32 FLOP/s
# outside the tensor cores.  Bounds are stated against these, at 700 W.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
# logits vs the dense oracle, relative to the logits' own scale:
# |got - want| <= ORACLE_RTOL * max|want| + ORACLE_ATOL
# (f32 sums over up to 16384 terms, taken in another order)
ORACLE_RTOL = 1e-4
ORACLE_ATOL = 1e-7
KERNEL_TOL = dict(rtol=1e-4, atol=1e-5)  # kernel vs its plain version
REQUESTS = 8
SEED = 0
N_NODES = 16384
DEVICE = "cuda"

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
}


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
        from repro_torch.configs import paper_gnn
        from repro_torch.core.formats import BlockELL, SellCS
        from repro_torch.data.pipeline import random_graph
        from repro_torch.kernels import _build
        from repro_torch.kernels.fused import spmm as fused
        from repro_torch.kernels.fused.epilogue import Epilogue
        from repro_torch.kernels.spmm import kernel, ref, sell
        from repro_torch.models import gnn
        from repro_torch.serve import engine

        self.cfg = paper_gnn.CONFIG
        self.random_graph = random_graph
        self.BlockELL, self.SellCS = BlockELL, SellCS
        self.build = _build
        self.fused, self.ref, self.sell = fused, ref, sell
        self.Epilogue = Epilogue
        self.gnn, self.engine = gnn, engine
        self.wrappers = {
            "K1": kernel.spmm_blockell_kernel,
            "K2": sell.spmm_sell_kernel,
            "K5": fused.spmm_blockell_epilogue_kernel,
            "K6": fused.spmm_sell_epilogue_kernel,
        }

    def reset_counts(self):
        for w in self.wrappers.values():
            w.launches = 0

    def counts(self):
        return {k: w.launches for k, w in self.wrappers.items()}


def time_ms(torch, fn, iters=20, warmup=3) -> float:
    """Median device time of one call, from CUDA events around each."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: int, flops: int):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOP_PER_S * 1e3
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
        # SELL: K2, and K6 with leaky_relu + bias + residual
        a = np.where(rng.random((m, m)) < 0.003, rng.standard_normal((m, m)),
                     0).astype(np.float32)
        sell = port.SellCS.from_dense(a, block=(bm, bm), device=dev)
        kw = dict(n_live_block_rows=sell.n_live_block_rows)
        ops = (sell.tile_rows, sell.tile_cols,
               port.sell.sell_tile_blocks(sell),
               torch.randn(-(-m // bm) * bm, d, device=dev))
        epi = port.Epilogue(act="leaky_relu", negative_slope=0.2,
                            has_bias=True, has_residual=True)
        tail = (torch.randn(d, device=dev),
                torch.randn(sell.n_live_block_rows * bm, d, device=dev))
        errs["K2"] = check_close(torch, f"K2 ragged d={d}",
                                 port.wrappers["K2"](*ops, **kw),
                                 port.sell.spmm_sell_tiles_ref(*ops, **kw))
        errs["K6"] = check_close(
            torch, f"K6 ragged d={d}",
            port.wrappers["K6"](*ops, *tail, epi=epi, **kw),
            port.fused.spmm_sell_epilogue_ref(*ops, *tail, epi=epi, **kw))
        log(f"ragged m={m} d={d} (SELL tiles {sell.n_tiles}, live "
            f"block-rows {sell.n_live_block_rows}): max_abs_err "
            + " ".join(f"{k} {v:.3e}" for k, v in errs.items()))


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


def kernel_rows(torch, port, graph, path):
    """Each kernel of this graph's path at the serving shapes: held to its
    plain version, timed beside it, ``torch.sparse.mm`` and its bound."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cfg = port.cfg
    relu = port.Epilogue(act="relu")
    if path == "ell":
        ell = graph.adj.form("ell")
        n_pad, slots, (bm, bn) = ell.shape[1], int(ell.nblocks.sum()), \
            (ell.bm, ell.bn)
        fixed, kw = (ell.indices, ell.blocks), {}
        shape = f"nbr={ell.n_block_rows} W={ell.ell_width} block={bm}x{bn}"
        plain = {"K1": port.ref.spmm_blockell_ref,
                 "K5": port.fused.spmm_blockell_epilogue_ref}
        specs = [("K5", cfg.hidden, relu), ("K1", cfg.n_classes, None)]
    else:
        sell = graph.adj.form("sell")
        n_pad, slots, (bm, bn) = -(-sell.shape[1] // sell.bn) * sell.bn, \
            sell.n_tiles, sell.block
        fixed = (sell.tile_rows, sell.tile_cols,
                 port.sell.sell_tile_blocks(sell))
        kw = dict(n_live_block_rows=sell.n_live_block_rows)
        shape = (f"T={sell.n_tiles} live_block_rows="
                 f"{sell.n_live_block_rows} block={bm}x{bn}")
        plain = {"K2": port.sell.spmm_sell_tiles_ref,
                 "K6": port.fused.spmm_sell_epilogue_ref}
        specs = [("K6", cfg.hidden, relu), ("K2", cfg.n_classes, None)]
    a_lib = library_csr(torch, graph)
    # the work this data needs: one multiply-add per nonzero of the
    # blocks / tiles and column of H (the dense tile work is printed apart)
    nnz = int((fixed[-1] != 0).sum())
    rows = {}
    for name, d, epi in specs:
        h = torch.randn(n_pad, d, device=dev, generator=gen)
        args = (*fixed, h) if epi is None else (*fixed, h, None, None)
        kwargs = dict(kw) if epi is None else dict(kw, epi=epi)
        y = port.wrappers[name](*args, **kwargs)
        err = check_close(torch, name, y, plain[name](*args, **kwargs))
        nbytes = sum(t.numel() * t.element_size() for t in (*fixed, h, y))
        flops = 2 * nnz * d + (0 if epi is None else y.numel())
        tile_flops = 2 * slots * bm * bn * d
        row = dict(
            max_abs_err=err,
            ms=time_ms(torch, lambda: port.wrappers[name](*args, **kwargs)),
            plain_ms=time_ms(torch, lambda: plain[name](*args, **kwargs)),
            library_ms=time_ms(
                torch, lambda: torch.sparse.mm(a_lib, h[: graph.n_nodes])))
        row["bound_ms"], row["bound_by"] = bound(nbytes, flops)
        log(f"{name} [{shape} D={d}]: max_abs_err {err:.3e} | kernel "
            f"{row['ms']:.4f} ms | plain {row['plain_ms']:.4f} ms | "
            f"torch.sparse.mm {row['library_ms']:.4f} ms | bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}: "
            f"{nbytes / 1e9:.3f} GB, {flops / 1e9:.3f} GFLOP for "
            f"{nnz} nonzeros) | dense tile work {tile_flops / 1e9:.2f} "
            f"GFLOP, {tile_flops / PEAK_FP32_FLOP_PER_S * 1e3:.4f} ms at "
            "the FP32 peak")
        rows[name] = row
    return rows


def profile_request(torch, eng, x, label):
    """One more request under ``torch.profiler``: device time by kernel
    and the device's busy share of the request's wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.infer(x)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
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
        return
    busy = sum(dev_ms.values())
    top = sorted(dev_ms.items(), key=lambda kv: -kv[1])[:8]
    log(f"graph ({label}) profile of one request: wall {wall:.3f} ms under "
        f"the profiler, device busy {busy:.3f} ms ({100 * busy / wall:.1f} "
        "%); by device time: "
        + "; ".join(f"{k[:70]} {v:.3f} ms" for k, v in top))


def serve_graph(torch, np, port, label, adj, want_path, expect):
    """Phase 3 for one graph; returns this graph's kernel rows and the
    launch counts of its 8 served requests."""
    dev = torch.device(DEVICE)
    n = adj.shape[0]
    t0 = time.perf_counter()
    graph = port.gnn.build_graph(adj, port.cfg, device=DEVICE)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    params = port.gnn.init_gcn(port.cfg, seed=SEED, device=DEVICE)
    eng = port.engine.GNNServingEngine(params, graph)
    report = eng.dispatch_report()
    log(f"graph ({label}): N={n} nnz={graph.stats.nnz} sparsity "
        f"{graph.stats.sparsity:.5f} forms={graph.adj.formats} host packing "
        f"{pack_s:.2f} s; plan {report['path']} ({report['reason']})")
    if eng.plan.path != want_path:
        raise AssertionError(f"graph ({label}) planned {eng.plan.path!r}, "
                             f"expected {want_path!r}")
    rows = kernel_rows(torch, port, graph, want_path)

    a_dense = torch.from_numpy(normalized_dense(np, adj)).to(dev)
    xs = [np.random.default_rng(SEED + i).standard_normal(
        (n, port.cfg.in_features)).astype(np.float32)
        for i in range(REQUESTS)]
    torch.cuda.synchronize()
    port.reset_counts()
    lat, outs = [], []
    for x in xs:
        t0 = time.perf_counter()
        outs.append(eng.infer(x))
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    counts = port.counts()
    log(f"graph ({label}) launches over {REQUESTS} requests: {counts}")
    want_counts = {k: v * REQUESTS for k, v in expect.items()}
    if counts != want_counts:
        raise AssertionError(f"graph ({label}) launch counts {counts}, "
                             f"expected {want_counts}")
    worst, worst_tol, max_logit = 0.0, float("inf"), 0.0
    for x, got in zip(xs, outs):
        want = oracle_logits(torch, a_dense, params,
                             torch.from_numpy(x).to(dev))
        err = float((got - want).abs().max())
        tol = oracle_tol(want)
        if got.shape != (n, port.cfg.n_classes) \
                or not bool(torch.isfinite(got).all()) or err > tol:
            raise AssertionError(f"graph ({label}) logits off the dense "
                                 f"oracle: max_abs_err {err:.3e} > {tol:.3e}")
        worst, worst_tol = max(worst, err), min(worst_tol, tol)
        max_logit = max(max_logit, float(want.abs().max()))
    lat_sorted = sorted(lat)
    med = statistics.median(lat)
    p90 = lat_sorted[min(len(lat) - 1, int(0.9 * len(lat)))]
    log(f"graph ({label}) serving: logits vs dense f32 oracle (TF32 off) "
        f"max_abs_err {worst:.3e}, max|logit| {max_logit:.3e}, tightest "
        f"tol {worst_tol:.3e} ({ORACLE_RTOL} x max|logit| + {ORACLE_ATOL}); "
        f"latency median {med:.3f} ms p90 {p90:.3f} ms "
        f"(all: {', '.join(f'{t:.3f}' for t in lat)}); "
        f"{n / med * 1e3:.0f} nodes/s")

    unfused = port.engine.GNNServingEngine(
        params, graph, port.engine.GNNServeConfig(fuse=False))
    port.reset_counts()
    got = unfused.infer(xs[0])
    torch.cuda.synchronize()
    ucounts = port.counts()
    plain_kernel = "K1" if want_path == "ell" else "K2"
    want_u = {k: (3 if k == plain_kernel else 0) for k in ucounts}
    err = float((got - outs[0]).abs().max())
    log(f"graph ({label}) fuse=False: launches {ucounts}, max_abs_err vs "
        f"fused {err:.3e}")
    if ucounts != want_u or err > oracle_tol(outs[0]):
        raise AssertionError(f"graph ({label}) fuse=False run off: "
                             f"{ucounts}, err {err:.3e}")
    profile_request(torch, eng, xs[0], label)
    log(f"graph ({label}) peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for name in rows:
        rows[name]["launches"] = counts[name]
    return rows


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

    kernels = []
    for name in ("K1", "K2", "K5", "K6"):
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
