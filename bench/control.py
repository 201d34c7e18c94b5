"""The readings that a cell's correctness limits are set from (not run by
the benchmark's own runs).

    python3 bench/control.py --workload <cell> --seeds 1 2 3 [--program 4 5 ...]

For each ``--seeds`` seed, at the cell's own size and on its own inputs,
each of the driver's ``VARIANTS`` (``bench/drivers/<driver>.py``):

- ``control``: the reference in TF32 (the nearest precision below the
  configurations' float32 with TF32 off) put in the program's place,
  against the reference in float32;
- training also: ``half_batch`` (the loss's mean over half the nodes) and
  ``leaf_doubled`` (the first layer's gradient doubled where it is
  produced), each planted in the reference put in the program's place.  A
  step that leaves its state unchanged reads 1 by the measure and needs no
  run.

For each ``--program`` seed, one sound run of the program through the
harness (a window of ``--seconds``), all in this one process: its
readings are the lower ones.  One JSON line per reading.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_readings(name: str, seed: int, variant: str, *,
                     device: str = "cuda", overrides=None) -> dict:
    """One variant's readings against the float32 reference."""
    import torch

    from bench.harness.device import Device
    from bench.harness.loop import Context
    from bench.harness.spec import Spec
    from bench.reference.precision import strict_float32

    strict_float32()
    cell = Spec.load().cell(name, overrides)
    dev = Device(torch.device(device, 0) if device == "cuda"
                 else torch.device(device))
    ctx = Context(cell, seed, dev, cell.model())
    return cell.driver().control(ctx, variant)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--program", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    sys.path[:] = [str(ROOT / "src"), str(ROOT)] + sys.path[1:]
    import torch

    from bench.harness.spec import Spec

    if not torch.cuda.is_available():
        print("bench/control.py: no card", file=sys.stderr)
        return 2
    variants = Spec.load().cell(args.workload).driver().VARIANTS
    for seed in args.seeds:
        for v in variants:
            t0 = time.perf_counter()
            r = control_readings(args.workload, seed, v)
            print(json.dumps({"cell": args.workload, "seed": seed,
                              "side": v, "readings": r,
                              "s": time.perf_counter() - t0}), flush=True)
            torch.cuda.empty_cache()
    if args.program:
        from bench.harness.cell import run_cell

        for seed in args.program:
            t0 = time.perf_counter()
            res, _ = run_cell(args.workload, seed, args.seconds, False,
                              t_start=t0)
            print(json.dumps({"cell": args.workload, "seed": seed,
                              "side": "program",
                              "readings": {k: c["value"] for k, c in
                                           res["checks"].items()},
                              "metrics": res["metrics"],
                              "s": time.perf_counter() - t0}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
