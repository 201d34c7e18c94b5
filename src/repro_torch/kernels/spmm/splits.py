"""Time K1's cluster split on one card: the kernel as built, which splits
a block-row's slots over a cluster of 2 or 4 CTAs where that takes fewer
waves of CTAs for the same work, against copies of it capped at 2 and at
1 CTA per block-row.

    PYTHONPATH=src python -m repro_torch.kernels.spmm.splits

Builds, with ``_build``'s flags, under ``build/repro_torch/splits/``:
``csrc/spmm_blockell.cu`` as it stands (``kMaxSplit = 4``) and with
``kMaxSplit`` = 2 and 1.  The matrices have the rows of ``chip_smoke.py``'s
graph (a): 64 x 64 blocks at density 0.1, every one of the 256
block-columns live (W = 256), H of 16384 rows; only the number of
block-rows varies, from 16 to 256 (on an H100 at one CTA per SM the
kernel as built takes 4 CTAs a block-row at 16, 150 and 200 block-rows,
2 at 32 and 66, 1 at 100, 132 and 256).
For each, in f32 at D = 16 and 128, every build is held to the plain
version, launched twice for equal bits, and timed (CUDA events after a
device spin, median of 20 after 3 warm-ups), with the host time of one
call beside.  Exits 2 without a card.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
import time

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.spmm.ref import spmm_blockell_ref

MAX_SPLIT = "constexpr int kMaxSplit = 4;"
CAPS = (4, 2, 1)
BLOCK, W, DENSITY = 64, 256, 0.1
BLOCK_ROWS = (16, 32, 66, 100, 132, 150, 200, 256)
WIDTHS = (16, 128)


def build_caps(src: str) -> dict:
    """Compile the source with each cap, all at once; returns cap -> the
    C entry point ``spmm_blockell``."""
    out_dir = _build.BUILD_DIR / "splits"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for cap in CAPS:
        cu, lib = out_dir / f"cap{cap}.cu", out_dir / f"libcap{cap}.so"
        cu.write_text(src.replace(MAX_SPLIT,
                                  f"constexpr int kMaxSplit = {cap};"))
        procs[cap] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fn_name, argtypes = _build._SIGNATURES["spmm_blockell"]
    built = {}
    for cap, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for kMaxSplit = {cap}:\n{log}")
        fn = getattr(ctypes.CDLL(str(lib)), fn_name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        built[cap] = fn
    return built


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of one call; the card spins first, so a short
    kernel is not timed at the host's pace."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(fn, calls: int = 50) -> float:
    """Host time of one call (the split's occupancy queries and the
    launch) while the card is busy, so the launch queue never blocks."""
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def check_sums(got, want, idx, blocks, h, what: str) -> None:
    """f32 sums of up to W * 64 terms in two orders: rtol 1e-4, atol 1e-5
    plus 2 eps √n Σ|term| (the bound ``chip_smoke.py`` holds K1 to)."""
    mag = spmm_blockell_ref(idx, blocks.abs(), h.abs())
    n = blocks.shape[1] * blocks.shape[3]
    bound = 1e-5 + 1e-4 * want.abs() \
        + 2 * torch.finfo(torch.float32).eps * n ** 0.5 * mag
    worst = float(((got - want).abs() / bound).max())
    if worst > 1:
        raise AssertionError(f"{what}: an element is {worst:.2f}x its "
                             "tolerance")


def run(built: dict) -> None:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    n = W * BLOCK
    for nbr in BLOCK_ROWS:
        blocks = torch.randn(nbr, W, BLOCK, BLOCK, device=dev, generator=gen)
        blocks *= torch.rand(blocks.shape, device=dev,
                             generator=gen) < DENSITY
        idx = torch.arange(W, dtype=torch.int32, device=dev).repeat(nbr, 1)
        for d in WIDTHS:
            h = torch.randn(n, d, device=dev, generator=gen)
            want = spmm_blockell_ref(idx, blocks, h)
            cells = []
            for cap, fn in built.items():
                y = torch.empty(nbr * BLOCK, d, device=dev)
                call = lambda: fn(  # noqa: E731
                    0, idx.data_ptr(), blocks.data_ptr(), h.data_ptr(),
                    None, None, y.data_ptr(), nbr, W, BLOCK, BLOCK, d, 0,
                    0.0, stream)
                what = f"kMaxSplit={cap} block-rows={nbr} D={d}"
                _build.check(call(), what)
                first = y.clone()
                _build.check(call(), what)
                torch.cuda.synchronize()
                if not torch.equal(first, y):
                    raise AssertionError(f"{what}: two launches gave "
                                         "different bits")
                check_sums(y, want, idx, blocks, h, what)
                cells.append(f"cap {cap} {time_ms(call):.4f} ms "
                             f"(host {host_us(call):.1f} µs)")
            print(f"block-rows={nbr} D={d} f32: " + " | ".join(cells),
                  flush=True)
        del blocks


def main() -> int:
    if not torch.cuda.is_available():
        print("splits: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())
    src = (_build.CSRC / "spmm_blockell.cu").read_text()
    if MAX_SPLIT not in src:
        raise RuntimeError(f"csrc/spmm_blockell.cu no longer holds "
                           f"{MAX_SPLIT!r}")
    print(f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    run(build_caps(src))
    return 0


if __name__ == "__main__":
    sys.exit(main())
