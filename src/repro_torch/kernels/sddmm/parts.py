"""Time K3 at a pattern on one card: the kernel as built against copies
of it with a part taken out or changed, beside K3 on every cell.

    PYTHONPATH=src python -m repro_torch.kernels.sddmm.parts

Builds, with ``_build``'s flags, under ``build/repro_torch/sddmm_parts/``:
``csrc/sddmm.cu`` as it stands; a copy that sums no dot (the C staging,
the lists, the barriers and the tile store left: the overhead a tile
carries); a copy whose dots read C only (B's reads taken out); a copy
whose lanes all read B's first row (what B would cost if every read were
a broadcast); a copy that always stages C two tiles deep (one block an
SM at K = 128 f32); and a copy with 512 threads a block.  Only the build
as it stands computes the function: it is held, at every set bit, to K3
without a mask, bit for bit; the copies are timed only.  The shape is
``chip_smoke.py``'s graph (a): N = 16384 at density 0.1, 64 x 64 tiles
(65,536 of them), f32, at K = 128, 16 and 2 (a GAT step's widths), each
build and K3 without a mask timed with CUDA events after a device spin
(median of 20 after 3 warm-ups).  Exits 2 without a card.
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
from repro_torch.kernels.sddmm.kernel import sddmm_blockcoo_kernel
from repro_torch.kernels.sddmm.ref import pack_occupancy
from repro_torch.sparse.paths import ell_to_coo

LOADS = "        const uint4 braw = bp[v], craw = cp[v];"
B_ROW = ("      const uint4* bp = reinterpret_cast<const uint4*>"
         "(bs + r * L.rs);")
DOTS = "      for (int v = 0; v < nv; ++v) {"
STAGES = "  const int stages = per_sm[2] >= per_sm[1] ? 2 : 1;"
THREADS = "constexpr int kPatThreads = 256;"
N, DENSITY, BLOCK = 16384, 0.1, 64
WIDTHS = (128, 16, 2)
# ≈ 0.5 ms of the card's clock: a call's launch queues behind it
SPIN_CYCLES = 1_000_000


def variants(src: str) -> dict:
    """Name -> the source text of each build."""
    texts = {
        "as built": src,
        "no dots": src.replace(DOTS, DOTS.replace("v < nv", "v < 0")),
        "C only": src.replace(LOADS, "        const uint4 craw = cp[v], "
                              "braw = craw;"),
        "B from one row": src.replace(B_ROW, B_ROW.replace(" + r * L.rs",
                                                           "")),
        "two stages": src.replace(STAGES, "  const int stages = 2;"),
        "512 threads": src.replace(THREADS, THREADS.replace("256", "512")),
    }
    for name, text in texts.items():
        if name != "as built" and text == src:
            raise RuntimeError(f"csrc/sddmm.cu no longer holds what the "
                               f"{name!r} copy replaces")
    return texts


def build(texts: dict) -> dict:
    """Compile every text at once; returns name -> the C entry point."""
    out_dir = _build.BUILD_DIR / "sddmm_parts"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(texts.items()):
        cu, lib = out_dir / f"v{i}.cu", out_dir / f"libv{i}.so"
        cu.write_text(text)
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fn_name, argtypes = _build._SIGNATURES["sddmm_pattern"]
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
        print("parts: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())
    built = build(variants((_build.CSRC / "sddmm.cu").read_text()))
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    adj = (rng.random((N, N), dtype=np.float32) < DENSITY).astype(np.float32)
    ell = BlockELL.from_dense(adj, BLOCK, BLOCK, device=dev)
    del adj
    coo = ell_to_coo(ell)
    occ = pack_occupancy(ell.blocks)
    keep = coo.blocks != 0
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    y = torch.empty(coo.blocks.shape, device=dev)
    for k in WIDTHS:
        b = torch.randn(coo.shape[0], k, device=dev, generator=gen)
        ct = torch.randn(coo.shape[1], k, device=dev, generator=gen)
        kw = dict(block=(BLOCK, BLOCK), out_dtype=torch.float32)
        c = ct.T.contiguous()
        every = lambda: sddmm_blockcoo_kernel(  # noqa: E731
            coo.rows, coo.cols, None, b, c, **kw)
        want = every()
        cells = [f"K3 every cell {time_ms(every):.4f} ms"]
        for name, fn in built.items():
            call = lambda: fn(  # noqa: E731
                coo.rows.data_ptr(), coo.cols.data_ptr(), occ.data_ptr(),
                b.data_ptr(), ct.data_ptr(), y.data_ptr(), coo.nnzb, BLOCK,
                BLOCK, k, 0, 0, stream)
            _build.check(call(), f"K3p {name}")
            torch.cuda.synchronize()
            if name == "as built" and not (
                    torch.equal(y[keep], want[keep])
                    and not bool(y[~keep].any())):
                raise AssertionError(f"K3p as built, K={k}: not K3's dots "
                                     "at the set bits and 0 elsewhere")
            cells.append(f"{name} {time_ms(call):.4f} ms")
        del want
        print(f"K={k}: " + " | ".join(cells), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
