"""A whole run of each cell on the CPU at a small size (the look for a
card skipped), sound and with the timed path broken underneath; the
control; the command's refusals; and no JAX anywhere.

The limits are the cells' own (``bench/limits/``); a sound run must meet
them and every planted fault must fail one of them.
"""
import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from bench.harness.spec import ROOT, load_json

SMALL = {"traffic": {"graph": {"n": 512}}}
CELLS = [w["name"] for w in load_json(ROOT / "BENCHMARK.json")["workloads"]]
SEED = 3_000_000_019  # above 2**31, as the driver's are


def run(cell, trace=False):
    from bench.harness.cell import run_cell

    torch.set_num_threads(2)
    return run_cell(cell, SEED, 0.3, trace, t_start=time.perf_counter(),
                    device="cpu", overrides=SMALL)


def driver(cell):
    from bench.harness.spec import Spec

    return Spec.load().cell(cell).traffic["driver"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    result, lines = run(cell)
    assert result["correct"] is True, lines
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert lines[-len(result["checks"]):] == [
        f"{k} {c['value']:.6e} limit {c['limit']:.6e}"
        for k, c in result["checks"].items()]
    assert "setup_s" in result["metrics"]


def test_features_from_the_host_are_served_correctly():
    from bench.harness.cell import run_cell

    torch.set_num_threads(2)
    over = {"traffic": dict(SMALL["traffic"], features="host")}
    result, lines = run_cell("gcn-infer-s90", SEED, 0.3, False,
                             t_start=time.perf_counter(), device="cpu",
                             overrides=over)
    assert result["correct"] is True, lines
    assert result["metrics"]["infer_nodes_per_s"]["value"] > 0


def test_a_traced_run_reports_per_layer_metrics_and_a_breakdown():
    result, _ = run("gat-train-s90", trace=True)
    assert result["correct"] is True
    assert "host_ms.train" in result["metrics"]
    assert "setup_s" not in result["metrics"]
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def _alter_answer(monkeypatch):
    from repro_torch.serve import engine

    for name in ("gcn_forward", "gat_forward"):
        orig = getattr(engine, name)

        def altered(*a, _orig=orig, **kw):
            out = _orig(*a, **kw).clone()
            out[0, 0] += out.abs().max()
            return out
        monkeypatch.setattr(engine, name, altered)


def _state_unchanged(monkeypatch):
    from repro_torch.train import gnn

    monkeypatch.setattr(gnn, "sgd_update", lambda params, grads, lr: None)


def _half_batch(monkeypatch):
    from repro_torch.train import gnn

    orig = gnn.nll_and_accuracy

    def half(logits, labels):
        h = logits.shape[0] // 2
        return orig(logits[:h], labels[:h])
    monkeypatch.setattr(gnn, "nll_and_accuracy", half)


def _leaf_doubled(monkeypatch):
    from repro_torch.train import gnn

    orig = gnn.sgd_update

    def doubled(params, grads, lr):
        grads = dict(grads, w=[2 * grads["w"][0]] + list(grads["w"][1:]))
        orig(params, grads, lr)
    monkeypatch.setattr(gnn, "sgd_update", doubled)


FAULTS = {"closed_loop": {"answer altered": _alter_answer},
          "full_batch": {"state unchanged": _state_unchanged,
                         "half the batch": _half_batch,
                         "answer altered": _leaf_doubled}}


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in CELLS for f in FAULTS[driver(c)]])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    FAULTS[driver(cell)][fault](monkeypatch)
    result, lines = run(cell)
    assert result["correct"] is False, lines


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_limits(cell):
    from bench.control import control_readings
    from bench.harness.check import verdict
    from bench.harness.spec import Spec

    torch.set_num_threads(2)
    readings = control_readings(cell, SEED, "control", device="cpu",
                                overrides=SMALL)
    ok, checks = verdict(readings, Spec.load().cell(cell).limits["limits"])
    assert not ok, checks


def _command(cwd, *extra):
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "gcn-infer-s90",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def _printed_result(stdout: str) -> bool:
    lines = stdout.strip().splitlines()
    return bool(lines) and lines[-1].startswith("{")


def test_the_command_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _command(ROOT)
    assert out.returncode != 0 and not _printed_result(out.stdout)
    assert "no card" in out.stderr


def test_the_command_fails_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _command(tmp_path)
    assert out.returncode != 0 and not _printed_result(out.stdout)


def test_nothing_loads_jax_or_the_jax_package():
    """A whole small run in a fresh interpreter, then every loaded
    module's top-level name (``repro_torch`` is allowed; ``repro`` and
    ``jax`` are not)."""
    code = (
        "import sys, time, json; t = time.perf_counter()\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        "from bench.harness.cell import run_cell, forbidden_modules\n"
        "res, _ = run_cell('gat-train-s90', 7, 0.2, True, t_start=t, "
        f"device='cpu', overrides={SMALL!r})\n"
        "print(json.dumps({'bad': forbidden_modules(), 'top': sorted({m."
        "split('.')[0] for m in sys.modules}), 'ok': res['correct']}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["bad"] == [] and got["ok"] is True
    assert "repro_torch" in got["top"]
    assert not {"jax", "jaxlib", "flax", "repro"} & set(got["top"])


@pytest.mark.cuda
def test_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = _command(ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
