"""Atomic, async checkpointing for trees of tensors (the port of
``repro.ft.checkpoint``, with its on-disk layout byte for byte).

Layout:  <dir>/step_<N>/  with one .npy per leaf (path-encoded filename:
``d:<key>`` / ``s:<index>`` joined by ``__``) plus metadata.json.  Writes
go to a temp directory renamed into place, so a crash mid-write never
corrupts the latest checkpoint; a background thread makes saves
non-blocking (training continues while the previous step serializes).

Restore is mesh-independent: leaves are saved whole (a ``DTensor`` leaf
is gathered), so a checkpoint from one mesh restores onto another or onto
one device; ``ft/resharding.py`` re-places the leaves.  A checkpoint
written by the reference's ``Checkpointer`` restores here and the
reverse: bf16 leaves are written as the reference's ``np.save`` writes
``ml_dtypes.bfloat16`` arrays (raw bits, descr ``'<V2'``) and read back
through ``uint16`` views, without ``ml_dtypes``.

Resilience: a crash mid-write (chaos site ``checkpoint.write``) only
ever loses the *in-flight* save — the previous published step survives
the atomic-rename protocol.  An async save that fails records the error
(``last_error``/``failed_saves``) instead of silently dying with its
thread, and :meth:`restore` skips corrupt ``step_<N>`` directories
(truncated metadata, partial ``.npy``, shape drift) falling back to the
newest intact step, counting each skip in
``resilience_ckpt_corrupt_total``.

With a process group of more than one rank, every rank calls
:meth:`save` (gathering a ``DTensor`` leaf is a collective) and rank 0
writes; every rank reads on :meth:`restore`.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import threading
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.resilience import chaos
from repro_torch.sharding.specs import whole
from repro_torch.tree import (DictKey, SequenceKey, tree_flatten_with_path,
                              tree_map_with_path)

_SEP = "__"
_BF16_DESCR = "<V2"  # what np.save writes for an ml_dtypes.bfloat16 array


def _path_str(p) -> str:
    if isinstance(p, DictKey):
        return f"d:{p.key}"
    if isinstance(p, SequenceKey):
        return f"s:{p.idx}"
    return f"x:{p}"


def _key(path) -> str:
    return _SEP.join(_path_str(p) for p in path)


class _Bf16Bits:
    """A bf16 leaf on the host: its bits as ``uint16``."""

    def __init__(self, bits: np.ndarray):
        self.bits = bits


def _to_host(x):
    x = whole(x)  # a DTensor: gathered whole
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return _Bf16Bits(x.contiguous().view(torch.int16).numpy()
                             .view(np.uint16).copy())
        return x.numpy().copy()
    return np.asarray(x)


def _save_leaf(path: str, arr):
    if isinstance(arr, _Bf16Bits):
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": _BF16_DESCR, "fortran_order": False,
                    "shape": arr.bits.shape})
            f.write(np.ascontiguousarray(arr.bits, dtype="<u2").tobytes())
    else:
        np.save(path, arr)


def _from_file(arr: np.ndarray, ref) -> torch.Tensor:
    """The loaded array as a tensor of the target leaf's dtype (on the
    host)."""
    dtype = ref.dtype if isinstance(ref, torch.Tensor) else None
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:  # bf16 bits
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))  # a copy, 0-d kept
    return t if dtype is None else t.to(dtype)


def _writes() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None
        self.failed_saves = 0
        os.makedirs(directory, exist_ok=True)

    # -- save ----------------------------------------------------------------
    def save(self, step: int, tree, *, meta: Optional[Dict] = None,
             block: bool = False):
        # gather to host BEFORE handing off to the writer thread
        host_leaves = {_key(path): _to_host(leaf)
                       for path, leaf in tree_flatten_with_path(tree)}
        if not _writes():
            return
        self.wait()  # one in-flight save at a time
        if self.async_save and not block:
            self._thread = threading.Thread(
                target=self._write_guarded,
                args=(step, host_leaves, meta or {}), daemon=True)
            self._thread.start()
        else:
            self._write(step, host_leaves, meta or {})

    def _write_guarded(self, step: int, host_leaves, meta: Dict):
        """Async writer body: a failed save must not die silently with
        its thread — the error is recorded and the previously published
        step keeps serving restores."""
        try:
            self._write(step, host_leaves, meta)
        except BaseException as exc:  # noqa: BLE001 — recorded, not lost
            self.last_error = exc
            self.failed_saves += 1
            obs.counter("resilience_ckpt_save_failures_total").inc()

    def _write(self, step: int, host_leaves: Dict, meta: Dict):
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = tempfile.mkdtemp(dir=self.directory, prefix=".tmp_")
        try:
            for key, arr in host_leaves.items():
                _save_leaf(os.path.join(tmp, key + ".npy"), arr)
            with open(os.path.join(tmp, "metadata.json"), "w") as f:
                json.dump({"step": step, **meta}, f)
            # chaos: a crash here loses only this in-flight save — the
            # temp dir is swept and the previous step stays published
            chaos.hook("checkpoint.write", step=step)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)  # atomic publish
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore -------------------------------------------------------------
    def all_steps(self):
        out = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.directory, name,
                                                 "metadata.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, target_tree, step: Optional[int] = None,
                sharding_tree=None):
        """Restore into the structure of ``target_tree``: each leaf a
        tensor of the target leaf's dtype on its device.

        ``sharding_tree``: optional tree of
        ``repro_torch.sharding.specs.NamedSharding`` — leaves are placed
        with it as ``DTensor``s (the elastic re-placement hook).

        With ``step=None`` (the default), corrupt step directories —
        truncated metadata, partial/unreadable ``.npy`` leaves, shape
        drift — are skipped, falling back to the newest *intact* step.
        An explicit ``step=`` loads exactly that step and raises on
        corruption.
        """
        if step is not None:
            return self._load_step(step, target_tree, sharding_tree)
        steps = self.all_steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        last_exc: Optional[BaseException] = None
        for s in reversed(steps):
            try:
                tree = self._load_step(s, target_tree, sharding_tree)
            except Exception as exc:  # noqa: BLE001 — corrupt: try older
                last_exc = exc
                obs.counter("resilience_ckpt_corrupt_total").inc()
                continue
            if s != steps[-1]:
                obs.counter("resilience_recoveries_total",
                            site="checkpoint").inc()
            return tree
        raise FileNotFoundError(
            f"no intact checkpoint in {self.directory}: all of "
            f"{steps} are corrupt (last error: {last_exc!r})")

    def _load_step(self, step: int, target_tree, sharding_tree=None):
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "metadata.json")) as f:
            json.load(f)  # truncated metadata = incomplete publish
        shardings = None
        if sharding_tree is not None:
            shardings = dict((_key(p), s) for p, s in
                             tree_flatten_with_path(sharding_tree))
        # every file is read (and its shape checked) before any is placed
        loaded = {}
        for path, ref in tree_flatten_with_path(target_tree):
            key = _key(path)
            arr = np.load(os.path.join(d, key + ".npy"))
            if arr.shape != tuple(ref.shape):
                raise ValueError(
                    f"checkpoint leaf {key}: shape {arr.shape} != "
                    f"expected {tuple(ref.shape)}")
            loaded[key] = _from_file(arr, ref)

        def place(path, ref):
            t = loaded[_key(path)]
            if shardings is not None:
                sh = shardings[_key(path)]
                return sh.place(t.to(sh.mesh.device_type))
            dev = getattr(ref, "device", None)
            return t if dev is None else t.to(dev)

        return tree_map_with_path(place, target_tree)

    def metadata(self, step: Optional[int] = None) -> Dict:
        step = step if step is not None else self.latest_step()
        with open(os.path.join(self.directory, f"step_{step:08d}",
                               "metadata.json")) as f:
            return json.load(f)
