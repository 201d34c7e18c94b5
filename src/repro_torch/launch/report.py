"""Build the dry-run / roofline tables from artifacts (the port of
``repro.launch.report``).

Usage:  PYTHONPATH=src python -m repro_torch.launch.report [--dir experiments/dryrun]
Writes markdown to stdout: the reference's four tables over the port's
``ARCHS`` and ``SHAPES``, from ``launch.dryrun``'s JSON artifacts (or the
reference's: the keys are the same).
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.configs import ARCHS, SHAPES

ARTIFACT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))), "experiments", "dryrun")


def load(dirname):
    cells = {}
    for path in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        name = os.path.basename(path)[:-5]
        with open(path) as f:
            d = json.load(f)
        key = (d.get("arch"), d.get("shape"), d.get("mesh"))
        tag = name.split(d.get("mesh") or "", 1)[-1] if d.get("mesh") else ""
        if tag:  # tagged experiment variants don't overwrite the baseline
            cells.setdefault("variants", {})[name] = d
            continue
        cells[key] = d
    return cells


def fmt_bytes(b):
    if b is None:
        return "—"
    return f"{b / 2**30:.2f}"


def dryrun_table(cells, mesh):
    rows = ["| arch | shape | status | args GiB/dev | temps GiB/dev | "
            "compile s |",
            "|---|---|---|---|---|---|"]
    for arch in [a for a in ARCHS if a != "paper-gnn"]:
        for shape in SHAPES:
            d = cells.get((arch, shape, mesh))
            if d is None:
                rows.append(f"| {arch} | {shape} | MISSING | | | |")
                continue
            if d["status"] == "skipped":
                rows.append(f"| {arch} | {shape} | skipped¹ | — | — | — |")
                continue
            mem = d.get("memory", {})
            rows.append(
                f"| {arch} | {shape} | {d['status']} | "
                f"{fmt_bytes(mem.get('argument_bytes_per_device'))} | "
                f"{fmt_bytes(mem.get('temp_bytes_per_device'))} | "
                f"{d.get('compile_s', '—')} |")
    return "\n".join(rows)


def roofline_table(cells, mesh="16x16"):
    rows = ["| arch | shape | t_comp s | t_mem s | t_coll s | bottleneck | "
            "MODEL_FLOPS | useful frac | roofline frac |",
            "|---|---|---|---|---|---|---|---|---|"]
    for arch in [a for a in ARCHS if a != "paper-gnn"]:
        for shape in SHAPES:
            d = cells.get((arch, shape, mesh))
            if d is None or d.get("status") != "ok" or "roofline" not in d:
                continue
            r = d["roofline"]
            rows.append(
                f"| {arch} | {shape} | {r['t_compute_s']:.4f} | "
                f"{r['t_memory_s']:.4f} | {r['t_collective_s']:.4f} | "
                f"**{r['bottleneck']}** | {r['model_flops']:.2e} | "
                f"{r['useful_flop_fraction']:.3f} | "
                f"{r['roofline_fraction']:.3f} |")
    return "\n".join(rows)


def collectives_table(cells, mesh="16x16"):
    rows = ["| arch | shape | all-reduce GiB | all-gather GiB | "
            "reduce-scatter GiB | all-to-all GiB | permute GiB |",
            "|---|---|---|---|---|---|---|"]
    for arch in [a for a in ARCHS if a != "paper-gnn"]:
        for shape in SHAPES:
            d = cells.get((arch, shape, mesh))
            if d is None or d.get("status") != "ok" or "roofline" not in d:
                continue
            c = d["roofline"]["per_op_collectives"]
            g = lambda k: c.get(k, 0) / 2**30  # noqa: E731
            rows.append(
                f"| {arch} | {shape} | {g('all-reduce'):.2f} | "
                f"{g('all-gather'):.2f} | {g('reduce-scatter'):.2f} | "
                f"{g('all-to-all'):.2f} | {g('collective-permute'):.2f} |")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=ARTIFACT_DIR)
    args = ap.parse_args(argv)
    cells = load(args.dir)
    print("### Dry-run — single-pod 16x16 (256 chips)\n")
    print(dryrun_table(cells, "16x16"))
    print("\n### Dry-run — multi-pod 2x16x16 (512 chips)\n")
    print(dryrun_table(cells, "2x16x16"))
    print("\n### Roofline — single-pod, per chip\n")
    print(roofline_table(cells))
    print("\n### Collective breakdown (bytes/chip/step)\n")
    print(collectives_table(cells))


if __name__ == "__main__":
    main()
