"""Time K7's parts on one card: the kernel as built against copies of it
with a part taken out, and K1 on the same blocks and V.

    PYTHONPATH=src python -m repro_torch.kernels.fused.parts

Builds, with ``_build``'s flags, under ``build/repro_torch/parts/``:
``csrc/fused_attention.cu`` as it stands; a copy with ``__expf`` for
``expf`` in the softmax pass; a copy that scores every entry without
reading kT (a constant in its place); a copy without the softmax pass
(every p is 1 and no max is kept); and a copy without the softmax pass,
its two warp syncs and the staged kT ("bare": K1's stream and compaction
with K7's bookkeeping).  Only the build as it stands computes K7's
function: it is held to the plain version, the copies are timed only.
The shape is ``chip_smoke.py``'s graph (a): N = 16384 at density 0.1,
64 x 64 blocks (W = 256), dk = 2, f32, at D = 128 and 16 (the widths of
a GAT request), each build and K1 (``spmm_blockell_kernel``, no
epilogue) timed with CUDA events after a device spin (median of 20 after
3 warm-ups).  Exits 2 without a card.
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
from repro_torch.kernels.fused.attention import fused_attn_blockell_ref
from repro_torch.kernels.spmm.kernel import ACT_CODES, spmm_blockell_kernel

SOFTMAX_A = "    {  // the softmax lanes: list li = lane / kSL"
SOFTMAX_B = "    __syncwarp();  // the p are read by the summing lanes"
LISTS_SYNC = "    __syncwarp();  // the lists are read by other lanes below\n"
NO_SOFTMAX = """    {
      const int li = lane / kSL;
      int n = 0;
#pragma unroll
      for (int k = 0; k < kLists; ++k)
        if (k == li) n = cnt[k];
      int2* list = lists + li * p.list_len;
      for (int e = lane % kSL; e < n; e += kSL)
        list[e].y = __float_as_int(1.f);
      scale = 1.f;
      any_grew = false;
      ls[c] += n;
    }
"""
BARE = """    {
      scale = 1.f;
      any_grew = false;
    }
"""
KT_STAGED = "  p.stages = plan_ell<T>(p);\n  if (p.stages < 2) {"
KT_FROM_L2 = "  p.k_bytes = 0;\n" + KT_STAGED
N, DENSITY, BLOCK, DK = 16384, 0.1, 64, 2
WIDTHS = (128, 16)
# ≈ 0.5 ms of the card's clock: a call's launch queues behind it
SPIN_CYCLES = 1_000_000


def variants(src: str) -> dict:
    """Name -> the source text of each build."""
    soft = src[src.index(SOFTMAX_A):src.index(SOFTMAX_B)]
    no_kt = soft
    for j in ("j0", "j1"):
        no_kt = no_kt.replace(f"Elem<T>::to_f(kb[kk * ks + {j}])", "0.5f")
    texts = {
        "as built": src,
        "__expf": src.replace(soft, soft.replace("expf(", "__expf(")),
        "no kT loads": src.replace(soft, no_kt),
        "no softmax pass": src.replace(soft, NO_SOFTMAX),
        "bare": src.replace(soft, BARE).replace(LISTS_SYNC, "")
        .replace(SOFTMAX_B + "\n", "").replace(KT_STAGED, KT_FROM_L2),
    }
    for name, text in texts.items():
        if name != "as built" and text == src:
            raise RuntimeError(f"csrc/fused_attention.cu no longer holds "
                               f"what the {name!r} copy replaces")
    return texts


def build(texts: dict) -> dict:
    """Compile every text at once; returns name -> the C entry point."""
    out_dir = _build.BUILD_DIR / "parts"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(texts.items()):
        cu, lib = out_dir / f"v{i}.cu", out_dir / f"libv{i}.so"
        cu.write_text(text)
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fn_name, argtypes = _build._SIGNATURES["fused_attention"]
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
    built = build(variants((_build.CSRC / "fused_attention.cu").read_text()))
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    adj = (rng.random((N, N), dtype=np.float32) < DENSITY).astype(np.float32)
    ell = BlockELL.from_dense(adj, BLOCK, BLOCK, device=dev)
    del adj
    nbr, w, bm, bn = ell.blocks.shape
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(nbr * bm, DK, device=dev, generator=gen)
    kt = torch.randn(DK, ell.shape[1], device=dev, generator=gen)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for d in WIDTHS:
        v = torch.randn(ell.shape[1], d, device=dev, generator=gen)
        want = fused_attn_blockell_ref(ell.indices, ell.blocks, q, kt, v)
        y = torch.empty_like(want)
        k1 = time_ms(lambda: spmm_blockell_kernel(ell.indices, ell.blocks, v))
        cells = [f"K1 {k1:.4f} ms"]
        for name, fn in built.items():
            call = lambda: fn(  # noqa: E731
                0, 4, ell.indices.data_ptr(), ell.blocks.data_ptr(),
                q.data_ptr(), kt.data_ptr(), v.data_ptr(), y.data_ptr(),
                nbr, w, bm, bn, DK, ell.shape[1], d, ACT_CODES["leaky_relu"],
                0.2, stream)
            _build.check(call(), f"K7 {name}")
            torch.cuda.synchronize()
            if name == "as built" and not torch.allclose(y, want, rtol=1e-4,
                                                         atol=1e-5):
                err = float((y - want).abs().max())
                raise AssertionError(f"K7 as built, D={d}: disagrees with "
                                     f"the plain version ({err:.3e})")
            cells.append(f"{name} {time_ms(call):.4f} ms")
        print(f"D={d}: " + " | ".join(cells), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
