"""Time K9's tensor-core instances on one card, as built and in the
designs and tile choices they were weighed against.

    PYTHONPATH=src python -m repro_torch.kernels.bsattn.tiles

Builds, with ``_build``'s flags, under ``build/repro_torch/tiles/``:
``csrc/bsattn.cu`` as it stands; for bf16, copies with 32-key and with
64-key chunks at every width (64 keys halve the Q fragment reads and
barriers per key, double the score registers, and at D = 256 leave shared
memory for one CTA per SM) and a copy that asks shared memory for one CTA
per SM; for f32, a copy that runs f32 on the earlier FFMA design
(``csrc/bsattn_ffma.cuh`` spliced in) instead of the error-compensated
TF32 one, a copy that sums O on the tensor cores across chunks instead of
folding each chunk's P V into it with ``fmaf``, a copy that splits each
operand with ``cvt.rna`` instead of integer rounding, and a copy that
leaves the low TF32 part unrounded (the tensor core then reads its top
bits).  Prints each build's ptxas usage by instance, then for each shape
holds every build to K9's plain version and prints their times (CUDA
events, median of 20 after 3 warm-ups) and their worst output row's
distance from the plain version's, as a share of that row's norm.  The
shapes are gemma3-4b's attention widths (8 q heads on 4 kv heads,
512 x 512 blocks, causal) at head dims 64, 128 and 256, with the 256 ones
at ``chip_smoke.py``'s three phase 4 shapes (S = 32768 with window 1024,
S = 8192 and S = 32768 under the full causal mask: the longest rows), in
bf16 and in f32.  Exits 2 without a card.
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

# Each variant is a list of (text in csrc/bsattn.cu, what replaces every
# occurrence of it).
KEYS = "template <int DT>\nconstexpr int kKeys = DT == 256 ? 32 : 64;"
KEYS_32 = [(KEYS, "template <int DT>\nconstexpr int kKeys = 32;")]
KEYS_64 = [(KEYS, "template <int DT>\nconstexpr int kKeys = 64;")]
ONE_CTA = [("constexpr size_t kSmemFloor = 0;",
            "constexpr size_t kSmemFloor = 116 * 1024;")]
# with csrc/bsattn_ffma.cuh put in before namespace tc (in main: nothing
# is read at import)
FFMA = [("run(tf32::launch<", "run(ffma::launch<float, ")]
NO_FOLD = [("          for (int e = 0; e < 4; ++e) po[i][e] = 0.f;",
            "          for (int e = 0; e < 4; ++e)\n"
            "            po[i][e] = o[G][i][e] * alpha[e >> 1];"),
           ("            o[G][i][e] = fmaf(o[G][i][e], alpha[e >> 1], "
            "po[i][e]);", "            o[G][i][e] = po[i][e];")]
SPLIT = ("  hi = round_tf32(__float_as_uint(x));\n"
         "  lo = round_tf32(__float_as_uint(x - __uint_as_float(hi)));\n")
CVT_SPLIT = [(SPLIT, '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));'
              '\n  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - '
              '__uint_as_float(hi)));\n')]
LO_UNROUNDED = [
    ("  lo = round_tf32(__float_as_uint(x - __uint_as_float(hi)));",
     "  lo = __float_as_uint(x - __uint_as_float(hi));")]
BF16_VARIANTS = {"32-key chunks": KEYS_32, "64-key chunks": KEYS_64,
                 "one CTA per SM": ONE_CTA}
F32_VARIANTS = {"FFMA (earlier design)": FFMA,
                "O summed on the tensor cores": NO_FOLD,
                "cvt.rna split": CVT_SPLIT,
                "lo left to the tensor core": LO_UNROUNDED}
H, HKV, BLOCK = 8, 4, 512
# (head dim, S, window)
CASES = ((64, 8192, 0), (128, 8192, 0), (256, 32768, 1024), (256, 8192, 0),
         (256, 32768, 0))
TOL = {torch.bfloat16: dict(rtol=1e-2, atol=2e-3),
       torch.float32: dict(rtol=1e-4, atol=1e-5)}


def ptxas_usage(log: str) -> dict:
    """Instance ("bf16 DT=256", "f32 DT=64", "f32 FFMA DT=64", ...) of
    ``csrc/bsattn.cu`` -> its spill and register lines in an ``nvcc
    -Xptxas -v`` log."""
    names = {"bsattn_tc_kernelILi": "bf16", "bsattn_tf32_kernelILi": "f32",
             "bsattn_kernelIfLi": "f32 FFMA"}
    usage, inst = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for \S*?(" + "|".join(names)
                      + r")(\d+)E", line)
        if m:
            inst = f"{names[m.group(1)]} DT={m.group(2)}"
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


def run(built: dict, dtype: torch.dtype) -> None:
    """Time every build in ``built`` (name -> (entry point, usage)) on
    CASES in ``dtype``, each held to the plain version first."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    dtype_name = str(dtype).split(".")[-1]
    for d, s, window in CASES:
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (n, s, d), dtype=np.float32)).to(dev, dtype)
            for n in (H, HKV, HKV))
        ell, val = (torch.from_numpy(a).to(dev)
                    for a in banded_ell(s, BLOCK, BLOCK, window))
        scale = 1 / math.sqrt(d)
        want = bsattn_ref(ell, val, q, k, v, block_q=BLOCK, block_kv=BLOCK,
                          causal=True, window=window, scale=scale)
        want_norm = torch.linalg.vector_norm(want.float(), dim=-1)
        cells = []
        for name, (fn, _) in built.items():
            out = torch.empty_like(q)
            call = lambda: fn(  # noqa: E731
                ell.data_ptr(), val.data_ptr(), q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), H, HKV, s, d, ell.shape[1],
                BLOCK, BLOCK, 1, window, scale, DTYPES[dtype], stream)
            _build.check(call(), f"K9 {name}")
            torch.cuda.synchronize()
            if not torch.allclose(out.float(), want.float(), **TOL[dtype]):
                err = float((out.float() - want.float()).abs().max())
                raise AssertionError(f"{name} {dtype_name} D={d} S={s}: "
                                     "disagrees with the plain version "
                                     f"(max_abs_err {err:.3e})")
            row = float((torch.linalg.vector_norm(
                out.float() - want.float(), dim=-1)
                / want_norm.clamp_min(1e-30)).max())
            cells.append(f"{name} {time_ms(call):.3f} ms, row {row:.2e}")
        print(f"D={d} {dtype_name} S={s} window={window}: "
              + " | ".join(cells), flush=True)
        del q, k, v, want, out


def main() -> int:
    if not torch.cuda.is_available():
        print("tiles: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())
    src = (_build.CSRC / "bsattn.cu").read_text()
    ffma = (_build.CSRC / "bsattn_ffma.cuh").read_text()
    variants = {**BF16_VARIANTS, **F32_VARIANTS}
    variants["FFMA (earlier design)"] = [
        ("namespace tc {", ffma + "\nnamespace tc {"), *FFMA]
    texts = {"as built": src}
    for name, swaps in variants.items():
        text = src
        for old, new in swaps:
            if old not in text:
                raise RuntimeError(f"csrc/bsattn.cu no longer holds {old!r}")
            text = text.replace(old, new)
        texts[name] = text
    built = build_variants(texts)
    for name, (_, usage) in built.items():
        print(f"== {name}")
        for inst, lines in sorted(usage.items()):
            print(f"   {inst}: " + "; ".join(lines))
    for dtype, names in ((torch.bfloat16, BF16_VARIANTS),
                         (torch.float32, F32_VARIANTS)):
        run({name: built[name] for name in ("as built", *names)}, dtype)
    return 0


if __name__ == "__main__":
    sys.exit(main())
