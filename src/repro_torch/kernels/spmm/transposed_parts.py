"""Time N1 (the transposed SpMM) on one card: each of its three paths at
the shapes that reach it, copies of it with parts taken out, and K1 on the
same blocks.

    PYTHONPATH=src python -m repro_torch.kernels.spmm.transposed_parts

Builds, with ``_build``'s flags, under ``build/repro_torch/n1_parts/``:
``csrc/spmm_blockell_t.cu`` as it stands; a copy whose tensor path takes
no product (its ring, waits and stores left: "tensor ring only"); a copy
whose sparse path sums nothing (the ring, the row bits, the barrier and
the column compaction left: "sparse no sums"); and a copy whose sparse
path only stages each block ("sparse ring only").  Only the build as it
stands computes the function: every path of it is held to its plain
version (``spmm_blockell_t_ref``; twice √n · eps · Σ|term| over the dtype's
tolerance, as ``chip_smoke.py`` holds N1) and launched twice for equal
bits; the copies are timed only.  The stream path is also timed unsplit
(one CTA a block column: "stream 1 chunk").

Shapes:
  * graph (a) of ``chip_smoke.py``: N = 16384 at density 0.1, 64 x 64
    blocks, f32, at D = 1, 2, 8 (every path), 16, 32, 64, 128 (tensor and
    sparse; the stream path takes D <= 8), and K1 at D = 128 and 2;
  * the pruned gemma3-4b MLP weights' shape: W 2560 x 10240 (``wi``) and
    10240 x 2560 (``wo``) with 10 % of the 64 x 64 tiles kept whole, as
    ``sparsify_lm`` keeps them, f32 at D = 4, 8 (stream, sparse), 2048,
    16384 (tensor, sparse), the tensor path also on bf16 operands.
Times are CUDA events after a device spin, median of 20 after 3 warm-ups.
Ends with one JSON line of every time (ms) by shape, D and build.  Exits 2
without a card.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

from repro_torch.core.formats import BlockELL
from repro_torch.kernels import _build
from repro_torch.kernels.spmm.kernel import (KERNEL_DTYPES,
                                             spmm_blockell_kernel)
from repro_torch.kernels.spmm.ref import spmm_blockell_t_ref
from repro_torch.kernels.spmm.transposed import (N1_PATHS, blockell_columns,
                                                 n1_plan)

SUMS = "      for (int j = 0; j < len; j += E) {"
SPLIT_SUMS = "      for (int e = lane % SPLIT; e < mine; e += SPLIT) {"
BITS = "    row_bits<T>(as, bits, p, warp, lane);\n"
BARRIER = "    consumer_sync();\n"
CONSUME = ("    consume<T, R, LG, SPLIT, NW>(\n"
           "        as, reinterpret_cast<const T*>(base + p.a_bytes), "
           "zero_row, bits, p,\n"
           "        warp, lane, col < dt ? col : 0, lists, acc);\n")
PRODUCT = "      if constexpr (kF32)\n        slot_product("
NO_PRODUCT = ("      for (auto& x : sum) for (auto& y : x) for (auto& z : y) "
              "z = 0.f;\n      if constexpr (false)\n        slot_product(")
N, DENSITY, BLOCK = 16384, 0.1, 64
GRAPH_WIDTHS = (1, 2, 8, 16, 32, 64, 128)
LM_SHAPES = {"wi": (2560, 10240), "wo": (10240, 2560)}
LM_KEEP = 0.1  # the pruned MLP weights keep 10 % of their 64 x 64 tiles
LM_WIDTHS = (4, 8, 2048, 16384)
TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (1e-2, 1e-3)}
# ≈ 0.5 ms of the card's clock: a call's launch queues behind it
SPIN_CYCLES = 1_000_000


def variants(src: str) -> dict:
    """Name -> the source text of each build."""
    texts = {
        "as built": src,
        "tensor ring only": src.replace(PRODUCT, NO_PRODUCT),
        "sparse no sums": src.replace(SUMS, SUMS.replace("j < len", "j < 0"))
        .replace(SPLIT_SUMS, SPLIT_SUMS.replace("e < mine", "e < 0")),
        "sparse ring only": src.replace(BITS + BARRIER + CONSUME, ""),
    }
    for name, text in texts.items():
        if name != "as built" and text == src:
            raise RuntimeError(f"csrc/spmm_blockell_t.cu no longer holds "
                               f"what the {name!r} copy replaces")
    return texts


def build(texts: dict) -> dict:
    """Compile every text at once; returns name -> the C entry point."""
    out_dir = _build.BUILD_DIR / "n1_parts"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(texts.items()):
        cu, lib = out_dir / f"v{i}.cu", out_dir / f"libv{i}.so"
        cu.write_text(text)
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fn_name, argtypes = _build._SIGNATURES["spmm_blockell_t"]
    built = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = getattr(ctypes.CDLL(str(lib)), fn_name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        built[name] = fn
    return built


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def launcher(fn, ell, lists, h, path, chunks):
    """A call of one build's entry point on one path; its output tensor."""
    col_ptr, col_slots = lists
    nbr, w, bm, bn = ell.blocks.shape
    nbc, d = col_ptr.shape[0] - 1, h.shape[1]
    blocks = ell.blocks.to(h.dtype)
    y = torch.empty(nbc * bn, d, dtype=h.dtype, device=h.device)
    part = torch.empty(nbc * chunks, bn, d, device=h.device) \
        if chunks > 1 else None
    stream = torch.cuda.current_stream(h.device).cuda_stream

    def call():
        _build.check(fn(
            KERNEL_DTYPES[h.dtype], N1_PATHS.index(path), col_ptr.data_ptr(),
            col_slots.data_ptr(), blocks.data_ptr(), h.data_ptr(),
            y.data_ptr(), None if part is None else part.data_ptr(), nbr,
            nbc, w, bm, bn, d, chunks, stream), f"N1 {path}")
        return y
    return call


def hold(name, got, ell, lists, h) -> float:
    """``got`` against the plain version, as chip_smoke.py holds N1."""
    blocks = ell.blocks.to(h.dtype)
    want = spmm_blockell_t_ref(*lists, blocks, h).float()
    mag = spmm_blockell_t_ref(*lists, blocks.abs(), h.abs()).float()
    rtol, atol = TOL[h.dtype]
    diff = (got.float() - want).abs()
    bound = atol + rtol * want.abs() \
        + 2 * torch.finfo(torch.float32).eps * h.shape[0] ** 0.5 * mag
    worst = float((diff / bound).max())
    if worst > 1:
        raise AssertionError(f"{name}: off its plain version, an element "
                             f"{worst:.2f}x its tolerance")
    return float(diff.max())


def paths_at(d: int):
    """(path, chunks or None for the rule's) pairs timed at width d."""
    if d <= 8:
        return [("stream", None), ("stream", 1), ("sparse", 1),
                ("tensor", 1)]
    return [("tensor", 1), ("sparse", 1)]


def run_shape(label, built, ell, widths, out, gen, k1=False,
              bf16_tensor=False):
    dev = ell.blocks.device
    lists = blockell_columns(ell)
    nbr, _, bm, bn = ell.blocks.shape
    nbc = lists[0].shape[0] - 1
    rows = out.setdefault(label, {})
    for d in widths:
        h = torch.randn(ell.shape[0], d, device=dev, generator=gen)
        cells, row = [], rows.setdefault(str(d), {})
        dtypes = [torch.float32] + ([torch.bfloat16] if bf16_tensor
                                    and d > 8 else [])
        for dtype in dtypes:
            hd = h.to(dtype)
            tag = "" if dtype == torch.float32 else " bf16"
            for path, chunks in paths_at(d):
                if tag and path != "tensor":
                    continue
                rule_chunks = n1_plan(d, dtype, (bm, bn), nbr, nbc)[1]
                ch = rule_chunks if chunks is None else chunks
                ch = ch if path == "stream" else 1
                name = f"{path}{tag}" + (" 1 chunk" if path == "stream"
                                         and chunks == 1 else "")
                call = launcher(built["as built"], ell, lists, hd, path, ch)
                got = call().clone()
                if not torch.equal(got, call()):
                    raise AssertionError(f"{label} D={d} {name}: two "
                                         "launches gave different bits")
                err = hold(f"{label} D={d} {name}", got, ell, lists, hd)
                row[name] = time_ms(call)
                cells.append(f"{name} {row[name]:.4f} ms (err {err:.2e})")
                parts = {"tensor": ("tensor ring only",),
                         "sparse": ("sparse no sums", "sparse ring only")}
                if chunks is not None and not tag:
                    for part in parts.get(path, ()):
                        row[part] = time_ms(launcher(built[part], ell,
                                                     lists, hd, path, 1))
                        cells.append(f"{part} {row[part]:.4f} ms")
        if k1:
            row["K1"] = time_ms(lambda: spmm_blockell_kernel(
                ell.indices, ell.blocks, h))
            cells.append(f"K1 {row['K1']:.4f} ms")
        rule = n1_plan(d, torch.float32, (bm, bn), nbr, nbc)
        print(f"{label} D={d} (rule: {rule[0]}, {rule[1]} chunk(s)): "
              + " | ".join(cells), flush=True)
        del h


def lm_weight(rng, m, n):
    """A pruned-MLP-like Block-ELL of W [m, n]: 10 % of its 64 x 64 tiles
    kept whole, the rest 0."""
    keep = rng.random((m // BLOCK, n // BLOCK)) < LM_KEEP
    w = rng.standard_normal((m, n)).astype(np.float32) * 0.02
    w *= np.kron(keep, np.ones((BLOCK, BLOCK), np.float32))
    return w


def main() -> int:
    if not torch.cuda.is_available():
        print("transposed_parts: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())
    built = build(variants((_build.CSRC / "spmm_blockell_t.cu").read_text()))
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for key, (m, n) in LM_SHAPES.items():
        # W's Block-ELL; x @ W runs N1 on it at D = the rows of x
        ell = BlockELL.from_dense(lm_weight(rng, m, n), BLOCK, BLOCK,
                                  device=dev)
        run_shape(f"LM {key} {m}x{n}", built, ell, LM_WIDTHS, out, gen,
                  bf16_tensor=True)
        del ell
        torch.cuda.empty_cache()
    adj = (rng.random((N, N), dtype=np.float32) < DENSITY).astype(np.float32)
    ell = BlockELL.from_dense(adj, BLOCK, BLOCK, device=dev)
    del adj
    run_shape("graph (a)", built, ell, GRAPH_WIDTHS, out, gen, k1=True)
    print(json.dumps({"n1_parts": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
