"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into a shared library, at first use, under
``build/repro_torch/`` at the repository root.  The file name carries a
hash of every source in ``csrc/`` and of the flags, so an edited kernel
is rebuilt and a stale library is never loaded.  Libraries are loaded
with ``ctypes``: every pointer and the stream pass as ``c_void_p``.
Nothing here runs at import time: the CPU tests import every module.
A failed build, load or launch raises ``KernelError``, which the serving
engines never retry and never route around.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable

from repro_torch.resilience.errors import KernelError

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("spmm_blockell", "spmm_blockell_t", "spmm_sell", "sddmm",
           "fused_attention", "bsattn")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point and argument types by the name ``entry`` takes: a source's
# own name, or another entry point of a source named in ``_SOURCE`` (see
# the .cu files)
_SIGNATURES = {
    "spmm_blockell": ("spmm_blockell",
                      [_I] + [_P] * 6 + [_I] * 6 + [_F, _P]),
    "spmm_blockell_t": ("spmm_blockell_t", [_I] + [_P] * 5 + [_I] * 5 + [_P]),
    "spmm_sell": ("spmm_sell_f32", [_P] * 9 + [_I] * 5 + [_F, _P]),
    "sddmm": ("sddmm_tiles", [_P] * 6 + [_I] * 7 + [_P]),
    "sddmm_pattern": ("sddmm_pattern", [_P] * 6 + [_I] * 6 + [_P]),
    "sddmm_sell_slots": ("sddmm_sell_slots_f32", [_P] * 7 + [_I] * 3 + [_P]),
    "fused_attention": ("fused_attn_blockell",
                        [_I, _I] + [_P] * 6 + [_I] * 8 + [_F, _P]),
    "fused_attn_sell": ("fused_attn_sell",
                        [_I, _I] + [_P] * 7 + [_I, _I, _P, _P] + [_I] * 7
                        + [_F, _P]),
    "bsattn": ("bsattn_fwd", [_P] * 6 + [_I] * 9 + [_F, _I, _P]),
}
_SOURCE = {"sddmm_sell_slots": "sddmm", "sddmm_pattern": "sddmm",
           "fused_attn_sell": "fused_attention"}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[str, Callable[..., int]] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise KernelError(
            "nvcc not found (on PATH or at /usr/local/cuda/bin); the CUDA "
            "kernels are built from src/repro_torch/csrc at first use")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest()}.so"


def build(names: Iterable[str] = SOURCES,
          force: bool = False) -> Dict[str, str]:
    """Compile the named sources that are not built yet (every one with
    ``force``), all at once (one ``nvcc`` process each).  Returns each
    compiled source's ``nvcc`` output (``-Xptxas -v``: registers, shared
    memory, spills); raises with that output if any compile fails."""
    todo = [n for n in names if force or not lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = BUILD_DIR / f".{name}-{os.getpid()}-{time.monotonic_ns()}.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib_path(name))  # atomic: readers see whole files
    if failed:
        raise KernelError("nvcc failed for " + ", ".join(failed) + ":\n"
                          + "\n".join(logs[n] for n in failed))
    return logs


def entry(name: str):
    """The C entry point ``name`` (see ``_SIGNATURES``), its library built
    on first use."""
    with _LOCK:
        fn = _FNS.get(name)
        if fn is None:
            source = _SOURCE.get(name, name)
            lib = _LIBS.get(source)
            if lib is None:
                build([source])
                try:
                    lib = ctypes.CDLL(str(lib_path(source)))
                except OSError as exc:
                    raise KernelError(f"cannot load {source}: {exc}") \
                        from exc
                _LIBS[source] = lib
            fn_name, argtypes = _SIGNATURES[name]
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _FNS[name] = fn
        return fn


def check(err: int, what: str) -> None:
    if err != 0:
        raise KernelError(f"{what}: CUDA launch failed with cudaError_t "
                          f"{err}")
