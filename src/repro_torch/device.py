"""Device selection: the port runs on the card unless the caller asks for
the CPU, and never falls back silently."""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; raises if it names CUDA and there is none.
    A CUDA device without an index is pinned to the calling thread's
    current card, so it equals the device of the tensors placed there and
    names the same card in any other thread."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available()"
            " is False; pass device='cpu' to run on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def device_scope(device: torch.device):
    """Make ``device`` the current CUDA device of the calling thread (the
    current device is per thread); a no-op context on the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
