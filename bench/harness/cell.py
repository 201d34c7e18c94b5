"""One run of one cell: set-up, the window, the trace, the check and the
result line."""
from __future__ import annotations

import dataclasses
import gc
import math
import statistics
import subprocess
import sys
import time
from types import ModuleType
from typing import List, Optional, Tuple

import torch

from bench.harness import trace as tracing
from bench.harness.check import verdict
from bench.harness.device import Device
from bench.harness.loop import Context, Window
from bench.harness.spec import Cell, Spec
from bench.reference.precision import strict_float32

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    cell: Cell
    work: ModuleType          # the configuration's operation counts
    shape: dict               # the run's size, as ``work`` takes it
    setup_s: float
    window: Window
    peak_window_bytes: int
    trace: Optional[tracing.Trace] = None


def finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True)
        return float(out.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, device: str = "cuda",
             spec: Optional[Spec] = None,
             overrides: Optional[dict] = None) -> Tuple[dict, List[str]]:
    """Run ``name`` once; returns the result object and the lines for
    standard error (the numbers compared, each beside its limit, last)."""
    spec = spec or Spec.load()
    cell = spec.cell(name, overrides)
    dev = Device(torch.device(device, 0) if device == "cuda"
                 else torch.device(device))
    strict_float32()
    model = cell.model()
    program = model.program.Program()
    if dev.cuda:
        program.build_kernels()
    ctx = Context(cell, seed, dev, model, program)
    loop = cell.driver().Loop(ctx)
    loop.warm_up()
    dev.sync()
    setup_peak = dev.peak_bytes()
    dev.reset_peak()

    tracer = tracing.Tracer(trace, dev.cuda)
    gc_before = [g["collections"] for g in gc.get_stats()]
    setup_s = time.perf_counter() - t_start
    with tracer:
        win = loop.window(seconds, tracer)
    peak = dev.peak_bytes()
    gc_runs = [g["collections"] - b
               for g, b in zip(gc.get_stats(), gc_before)]
    tr = tracer.reduce() if trace else None

    loop.free_program()
    dev.free()
    readings = loop.readings()
    ok, checks = verdict(readings, cell.limits["limits"])

    run = Run(cell=cell, work=model.work, shape=loop.shape,
              setup_s=setup_s, window=win, peak_window_bytes=peak, trace=tr)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = m.reader().read(run)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    dev_info = {"platform": "gpu" if dev.cuda else dev.device.type,
                "kind": torch.cuda.get_device_name(dev.device)
                if dev.cuda else "cpu",
                "count": cell.chips if dev.cuda else 0,
                "memory_peak_bytes": max(setup_peak, peak)}
    if tr is not None:
        dev_info["busy_s"] = tr.busy_s()
        dev_info["window_s"] = tr.window_s
    if dev.cuda:
        dev_info["power_limit_w"] = power_limit_w()
    result = {"correct": ok, "attempted": win.units, "failed": 0,
              "metrics": metrics, "device": dev_info}
    if tr is not None:
        result["breakdown"] = tracing.breakdown(tr)
    result["checks"] = {k: {"value": finite(c["value"]),
                            "limit": c["limit"]}
                        for k, c in checks.items()}
    unit = "requests" if win.op == "infer" else "steps"
    lines = [f"{name} seed {seed}: {win.units} {unit} in "
             f"{win.window_s:.3f} s, set-up {setup_s:.3f} s, "
             f"{'traced' if trace else 'untraced'}; garbage collections "
             f"in the window by generation {gc_runs}"]
    if len(win.latencies_ms) >= 2:
        lat = sorted(win.latencies_ms)
        q = statistics.quantiles(lat, n=100, method="inclusive")
        lines.append(
            f"request ms over {len(lat)}: mean {statistics.fmean(lat):.4f}"
            f" p50 {q[49]:.4f} p95 {q[94]:.4f} p99 {q[98]:.4f} max "
            f"{lat[-1]:.4f}; requests over 2x the median "
            f"{sum(x > 2 * q[49] for x in lat)}, their ms "
            f"{sum(x for x in lat if x > 2 * q[49]):.3f}; the window less "
            f"the requests {win.window_s * 1e3 - sum(lat):.3f} ms")
    lines += [f"{k} {c['value']:.6e} limit {c['limit']:.6e}"
              for k, c in checks.items()]
    return result, lines
