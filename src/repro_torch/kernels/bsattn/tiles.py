"""Time K9's bf16 tensor-core instances on one card, as built and in the
tile choices its design was weighed against.

    PYTHONPATH=src python -m repro_torch.kernels.bsattn.tiles

Builds, with ``_build``'s flags, under ``build/repro_torch/tiles/``:
``csrc/bsattn.cu`` as it stands (32-key chunks and two CTAs per SM at
D = 256, 64-key chunks below); copies with 32-key and with 64-key chunks
at every width (64 keys halve the Q fragment reads and barriers per key,
double the score registers, and at D = 256 leave shared memory for one
CTA per SM); and a copy that asks shared memory for one CTA per SM.
Prints each build's ptxas usage by instance, then for each shape holds
every build to K9's plain version and prints their times (CUDA events,
median of 20 after 3 warm-ups).  The shapes are gemma3-4b's attention
widths (8 q heads on 4 kv heads, 512 x 512 blocks, causal) at head dims
64, 128 and 256, with the 256 ones at both of ``chip_smoke.py``'s
phase 4 shapes.  Exits 2 without a card.
"""
from __future__ import annotations

import ctypes
import math
import re
import statistics
import subprocess
import sys

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bsattn.kernel import DTYPES, bsattn_ref
from repro_torch.kernels.bsattn.ops import banded_ell

KEYS = "template <int DT>\nconstexpr int kKeys = DT == 256 ? 32 : 64;"
KEYS_32 = (KEYS, "template <int DT>\nconstexpr int kKeys = 32;")
KEYS_64 = (KEYS, "template <int DT>\nconstexpr int kKeys = 64;")
ONE_CTA = ("constexpr size_t kSmemFloor = 0;",
           "constexpr size_t kSmemFloor = 116 * 1024;")
H, HKV, BLOCK = 8, 4, 512
# (head dim, S, window), all bf16
CASES = ((64, 8192, 0), (128, 8192, 0), (256, 32768, 1024), (256, 8192, 0))
TOL = dict(rtol=1e-2, atol=2e-3)


def ptxas_usage(log: str) -> dict:
    """Instance ("f32 DT=64", "bf16 DT=256", ...) of ``csrc/bsattn.cu`` ->
    its spill and register lines in an ``nvcc -Xptxas -v`` log."""
    usage, inst = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for \S*?"
                      r"(bsattn_tc_kernelILi|bsattn_kernelIfLi)(\d+)E", line)
        if m:
            dtype = "bf16" if m.group(1).startswith("bsattn_tc") else "f32"
            inst = f"{dtype} DT={m.group(2)}"
            usage[inst] = []
        elif "Function properties" in line:
            inst = None
        elif inst and ("spill" in line or "Used" in line):
            usage[inst].append(line.split(":", 1)[-1].strip())
    return usage


def spill_bytes(lines) -> int:
    """Bytes of spill stores and loads in an instance's ptxas lines."""
    return sum(int(a) + int(b) for line in lines for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", line))


def build_variants(texts: dict) -> dict:
    """Compile each source text (name -> text), all at once; returns name
    -> (C entry point, ptxas usage by instance)."""
    out_dir = _build.BUILD_DIR / "tiles"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(texts.items()):
        cu, lib = out_dir / f"v{i}.cu", out_dir / f"libv{i}.so"
        cu.write_text(text)
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fn_name, argtypes = _build._SIGNATURES["bsattn"]
    built = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = getattr(ctypes.CDLL(str(lib)), fn_name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        built[name] = (fn, ptxas_usage(log))
    return built


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
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


def run(texts: dict) -> None:
    """Build every text, print its ptxas usage, and time it on CASES."""
    built = build_variants(texts)
    for name, (_, usage) in built.items():
        print(f"== {name}")
        for inst, lines in sorted(usage.items()):
            print(f"   {inst}: " + "; ".join(lines))
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for d, s, window in CASES:
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (n, s, d), dtype=np.float32)).to(dev, torch.bfloat16)
            for n in (H, HKV, HKV))
        ell, val = (torch.from_numpy(a).to(dev)
                    for a in banded_ell(s, BLOCK, BLOCK, window))
        scale = 1 / math.sqrt(d)
        want = bsattn_ref(ell, val, q, k, v, block_q=BLOCK, block_kv=BLOCK,
                          causal=True, window=window, scale=scale)
        cells = []
        for name, (fn, _) in built.items():
            out = torch.empty_like(q)
            call = lambda: fn(  # noqa: E731
                ell.data_ptr(), val.data_ptr(), q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), H, HKV, s, d, ell.shape[1],
                BLOCK, BLOCK, 1, window, scale, DTYPES[torch.bfloat16],
                stream)
            _build.check(call(), f"K9 {name}")
            torch.cuda.synchronize()
            if not torch.allclose(out.float(), want.float(), **TOL):
                raise AssertionError(f"{name} D={d} S={s}: disagrees with "
                                     "the plain version")
            cells.append(f"{name} {time_ms(call):.3f} ms")
        print(f"D={d} bf16 S={s} window={window}: " + " | ".join(cells),
              flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("tiles: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())
    src = (_build.CSRC / "bsattn.cu").read_text()
    for line in (KEYS, ONE_CTA[0]):
        if line not in src:
            raise RuntimeError(f"csrc/bsattn.cu no longer holds {line!r}")
    run({"as built": src, "32-key chunks": src.replace(*KEYS_32),
         "64-key chunks": src.replace(*KEYS_64),
         "one CTA per SM": src.replace(*ONE_CTA)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
