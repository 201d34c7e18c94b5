"""Time N1 (the transposed SpMM) on one card: the kernel as built against
copies of it with parts taken out, beside K1 on the same blocks.

    PYTHONPATH=src python -m repro_torch.kernels.spmm.transposed_parts

Builds, with ``_build``'s flags, under ``build/repro_torch/n1_parts/``:
``csrc/spmm_blockell_t.cu`` as it stands; a copy that sums nothing (the
ring, the row bits, the barrier and the column compaction left); a copy
without the consumer warps' barrier (its results are wrong: a warp may
read row bits not yet written); a copy that only stages and marks each
block (the ring, the row bits and the barrier); and a copy that only
stages each block (the ring).  Only the build as it stands computes the
function: it is held to its plain version; the copies are timed only.
The shape is ``chip_smoke.py``'s graph (a): N = 16384 at density 0.1,
64 x 64 blocks, f32, at D = 128 (a step's dH and dV) and D = 2 (GAT's
dk), each build and K1 at the same D timed with CUDA events after a
device spin (median of 20 after 3 warm-ups).  Exits 2 without a card.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys

import numpy as np
import torch

from repro_torch.core.formats import BlockELL
from repro_torch.kernels import _build
from repro_torch.kernels.spmm.kernel import spmm_blockell_kernel
from repro_torch.kernels.spmm.ref import spmm_blockell_t_ref
from repro_torch.kernels.spmm.transposed import blockell_columns

SUMS = "      for (int j = 0; j < len; j += E) {"
SPLIT_SUMS = "      for (int e = lane % SPLIT; e < mine; e += SPLIT) {"
BARRIER = "    consumer_sync();\n"
BITS = "    row_bits<T>(as, bits, p, warp, lane);\n"
CONSUME = ("    consume<T, R, LG, SPLIT, NW>(\n"
           "        as, reinterpret_cast<const T*>(base + p.a_bytes), "
           "zero_row, bits, p,\n"
           "        warp, lane, col < dt ? col : 0, lists, acc);\n")
N, DENSITY, BLOCK = 16384, 0.1, 64
WIDTHS = (128, 2)
# ≈ 0.5 ms of the card's clock: a call's launch queues behind it
SPIN_CYCLES = 1_000_000


def variants(src: str) -> dict:
    """Name -> the source text of each build."""
    texts = {
        "as built": src,
        "no sums": src.replace(SUMS, SUMS.replace("j < len", "j < 0"))
        .replace(SPLIT_SUMS, SPLIT_SUMS.replace("e < mine", "e < 0")),
        "no barrier": src.replace(BARRIER, ""),
        "ring, bits, barrier": src.replace(CONSUME, ""),
        "ring only": src.replace(BITS + BARRIER + CONSUME, ""),
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


def main() -> int:
    if not torch.cuda.is_available():
        print("transposed_parts: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())
    built = build(variants((_build.CSRC / "spmm_blockell_t.cu").read_text()))
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    adj = (rng.random((N, N), dtype=np.float32) < DENSITY).astype(np.float32)
    ell = BlockELL.from_dense(adj, BLOCK, BLOCK, device=dev)
    del adj
    col_ptr, col_slots = blockell_columns(ell)
    nbc = col_ptr.shape[0] - 1
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for d in WIDTHS:
        h = torch.randn(N, d, device=dev, generator=gen)
        y = torch.empty(N, d, device=dev)
        want = spmm_blockell_t_ref(col_ptr, col_slots, ell.blocks, h)
        k1 = lambda: spmm_blockell_kernel(  # noqa: E731
            ell.indices, ell.blocks, h)
        cells = [f"K1 {time_ms(k1):.4f} ms"]
        for name, fn in built.items():
            call = lambda: fn(  # noqa: E731
                0, col_ptr.data_ptr(), col_slots.data_ptr(),
                ell.blocks.data_ptr(), h.data_ptr(), y.data_ptr(), nbc,
                ell.ell_width, BLOCK, BLOCK, d, stream)
            _build.check(call(), f"N1 {name}")
            torch.cuda.synchronize()
            if name == "as built" and not torch.allclose(y, want, rtol=1e-4,
                                                         atol=1e-3):
                raise AssertionError(f"N1 as built, D={d}: off its plain "
                                     "version")
            cells.append(f"{name} {time_ms(call):.4f} ms")
        print(f"D={d}: " + " | ".join(cells), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
