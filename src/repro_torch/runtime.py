"""Execution-mode flags for the cost-counting runs (the port of
``repro.runtime``).

The reference flips its ``lax.scan`` loops (layer periods, flash-attention
chunks, the SSD chunk scan, the encoder stack) to straight-line code under
``cost_mode()``, because XLA's cost analysis counts a loop body once.  The
port runs eagerly, and those loops are already Python loops that run every
iteration (``models/transformer.py``'s period loop and encoder stack,
``models/ssm.py``'s chunk scan): ``unrolled()`` changes nothing there, and
no branch reads it.  What the flags still choose is the attention's work:
under ``cost_mode`` ``core.attention.flash_attention`` takes the chunk
size ``attn_chunk`` (when given) and, with ``causal_skip``, visits only kv
chunks ``0..i`` for q chunk ``i`` (the causal FLOPs exactly), as the
reference's unrolled attention does.  ``launch.dryrun`` counts a step's
FLOPs, bytes and collectives under it.

The flags are thread-local; ``cost_mode`` nests and restores the previous
values on exit.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

_state = threading.local()


def unrolled() -> bool:
    return getattr(_state, "unroll", False)


def causal_skip() -> bool:
    return getattr(_state, "causal_skip", False)


def attn_chunk_override() -> Optional[int]:
    return getattr(_state, "attn_chunk", None)


@contextlib.contextmanager
def cost_mode(*, causal_skip: bool = False,
              attn_chunk: Optional[int] = None):
    prev = (getattr(_state, "unroll", False),
            getattr(_state, "causal_skip", False),
            getattr(_state, "attn_chunk", None))
    _state.unroll, _state.causal_skip, _state.attn_chunk = \
        True, causal_skip, attn_chunk
    try:
        yield
    finally:
        _state.unroll, _state.causal_skip, _state.attn_chunk = prev
