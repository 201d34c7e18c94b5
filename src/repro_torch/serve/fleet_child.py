"""Entry point of a spawned fleet worker process.

A ``spawn`` child imports its target's module, and every package above
it, before it runs anything.  ``repro_torch.serve.fleet`` imports torch,
which can take longer than the process backend's 5 s heartbeat deadline
(``chip_smoke.py`` phase 8 prints the time), so a child whose target
lived there would be declared dead by heartbeat, and restarted, before
its first beat.  This module imports only the standard library: the child beats
from the moment its interpreter is up, imports the worker, and hands the
beats over to the worker loop, whose own heartbeat thread starts before
its engine is built (the reference's rule: a worker does not read as
dead while it is warming up).
"""
from __future__ import annotations

import threading
from typing import Any, Dict


def main(name: str, cfg_dict: Dict[str, Any], in_q, out_q) -> None:
    """Beat while the worker module imports, then run the worker loop
    (``repro_torch.serve.fleet.worker._process_main``)."""
    importing = threading.Event()
    interval = float(cfg_dict.get("heartbeat_interval_s", 0.02))

    def beat() -> None:
        while not importing.wait(interval):
            out_q.put(("hb", 0, 0))

    beats = threading.Thread(target=beat, daemon=True,
                             name=f"fleet-{name}-import-hb")
    beats.start()
    try:
        from repro_torch.serve.fleet.worker import _process_main
    finally:
        importing.set()
        beats.join()
    _process_main(name, cfg_dict, in_q, out_q)


__all__ = ["main"]
