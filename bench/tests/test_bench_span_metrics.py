"""The readers of the port's own spans (``harness/spans.py``) on synthetic
profiler traces (Chrome trace JSON, times in µs), against numbers worked
out by hand; and a traced run of each cell on the CPU reading them."""
import time

import pytest
import torch

from bench.harness import trace as tracing
from bench.harness.loop import Window
from bench.harness.spec import ROOT, Spec, load_json

PORT = "void (anonymous namespace)::spmm_blockell_kernel<float, 4, 32>(int)"
SPANS = {"infer": "bench.infer", "train": "bench.train_step"}
CELLS = [w["name"] for w in load_json(ROOT / "BENCHMARK.json")["workloads"]]
NEW = ("dispatch_ms", "model_host_ms", "idle_in_program")


def ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": tid}


def span(name, ts, dur, tid=1):
    """A port span as the profiler records it: a host operation."""
    return ev("cpu_op", name, ts, dur, tid)


def serving() -> dict:
    """A 10 ms window (µs 1000 to 11000) of two requests.  Request 1: two
    layers, the first holding a dispatch with one nested in it; request
    2: one layer.  A dispatch on a second thread (µs 7000-7100) while
    the benchmark syncs.  Idle gaps begin at µs 1030 (inside a layer), 3000
    (at the sync), 7050 (inside the second thread's span) and 9000 (at
    the sync)."""
    return {"traceEvents": [
        ev("user_annotation", "bench.window", 1000, 10000),
        ev("user_annotation", "bench.request", 1000, 4500),
        ev("user_annotation", "bench.infer", 1000, 500),
        ev("user_annotation", "bench.sync", 1500, 4000),
        ev("user_annotation", "bench.request", 5500, 5500),
        ev("user_annotation", "bench.infer", 5500, 800),
        ev("user_annotation", "bench.sync", 6300, 4700),
        span("serve.infer", 1010, 480),
        span("gnn.layer", 1020, 180),
        span("sparse.dispatch", 1050, 50),
        span("sparse.dispatch", 1060, 20),
        span("gnn.layer", 1200, 280),
        span("sparse.dispatch", 1300, 100),
        span("serve.infer", 5510, 780),
        span("gnn.layer", 5520, 480),
        span("sparse.dispatch", 5600, 100),
        span("sparse.dispatch", 7000, 100, tid=2),
        ev("cpu_op", "aten::mm", 1030, 10),
        ev("cuda_runtime", "cudaDeviceSynchronize", 1500, 4000),
        ev("kernel", PORT, 1000, 30),
        ev("kernel", PORT, 1250, 1750),
        ev("kernel", PORT, 5600, 1450),
        ev("kernel", PORT, 7200, 1800),
    ]}


def training() -> dict:
    """A 5 ms window of one step: the forward's layer holds a dispatch,
    and autograd's thread records one during the backward.  Idle gaps
    begin at µs 1150 (inside the layer), 2550 (inside the backward, and
    autograd's dispatch) and 5200 (at the sync, after the step)."""
    return {"traceEvents": [
        ev("user_annotation", "bench.window", 1000, 5000),
        ev("user_annotation", "bench.train_step", 1000, 4000),
        ev("user_annotation", "bench.sync", 5000, 1000),
        span("train.step", 1000, 3950),
        span("train.forward", 1000, 1000),
        span("gnn.layer", 1100, 800),
        span("sparse.dispatch", 1200, 100),
        span("train.backward", 2000, 2500),
        span("sparse.dispatch", 2500, 100, tid=2),
        span("train.update", 4500, 400),
        ev("kernel", PORT, 1000, 150),
        ev("kernel", PORT, 1400, 1150),
        ev("kernel", PORT, 2700, 2500),
        ev("kernel", PORT, 5300, 700),
    ]}


class FakeRun:
    def __init__(self, data, op="infer", units=2):
        self.trace = tracing.from_chrome(data)
        self.window = Window(op, units, self.trace.window_s,
                             call_span=SPANS[op])


def reader(name):
    return next(m for m in Spec.load().per_layer if m.name == name).reader()


def test_the_span_metrics_are_read_in_their_cells():
    spec = Spec.load()
    for base in NEW:
        for op, cells in (("infer", ["gcn-infer-s90", "gat-infer-s90"]),
                          ("train", ["gat-train-s90", "gcn-train-s90"])):
            m = next(m for m in spec.per_layer if m.name == f"{base}.{op}")
            assert m.source == "program_span"
            assert m.reader().__file__.endswith(f"/metrics/{base}.py")
            assert all(m.name in {x.name for x in spec.cell_per_layer(c)}
                       for c in cells)


def test_dispatch_ms_counts_a_nested_span_once_and_every_thread():
    run = FakeRun(serving())
    # 50 (its nested 20 held) + 100 + 100 + 100 on the second thread
    assert reader("dispatch_ms.infer").read(run) == pytest.approx(0.175)
    run = FakeRun(training(), "train", units=1)
    assert reader("dispatch_ms.train").read(run) == pytest.approx(0.2)


def test_model_host_ms_is_the_layers_less_their_dispatch():
    run = FakeRun(serving())
    # (180 - 50) + (280 - 100) + (480 - 100) µs over 2 requests
    assert reader("model_host_ms.infer").read(run) == pytest.approx(0.345)
    run = FakeRun(training(), "train", units=1)
    assert reader("model_host_ms.train").read(run) == pytest.approx(0.7)


def test_the_port_spans_lie_inside_the_call():
    run = FakeRun(serving())
    inside = reader("dispatch_ms.infer").read(run) \
        + reader("model_host_ms.infer").read(run)
    assert inside <= reader("host_ms.infer").read(run)


def test_idle_in_program_tells_a_gap_in_a_span_from_one_at_the_sync():
    run = FakeRun(serving())
    # gaps of 220 (in a layer), 2600 (sync), 150 (in the second thread's
    # dispatch) and 2000 µs (sync)
    assert reader("idle_in_program.infer").read(run) == \
        pytest.approx(100 * 370 / 4970)
    run = FakeRun(training(), "train", units=1)
    # 250 (in the layer) and 150 (in the backward) of 250 + 150 + 100
    assert reader("idle_in_program.train").read(run) == \
        pytest.approx(100 * 400 / 500)


def test_idle_in_program_reads_zero_where_the_device_never_idles():
    data = serving()
    data["traceEvents"] = [e for e in data["traceEvents"]
                           if e["cat"] != "kernel"]
    data["traceEvents"].append(ev("kernel", PORT, 1000, 10000))
    assert reader("idle_in_program.infer").read(FakeRun(data)) == 0.0


@pytest.mark.parametrize("op", ["infer", "train"])
def test_no_port_span_reads_none(op):
    data = serving()
    data["traceEvents"] = [e for e in data["traceEvents"]
                           if e["cat"] != "cpu_op" or e["name"] == "aten::mm"]
    run = FakeRun(data, op)
    for base in NEW:
        assert reader(f"{base}.{op}").read(run) is None, base
    run.trace = None
    for base in NEW:
        assert reader(f"{base}.{op}").read(run) is None, base


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reads_the_port_spans(cell):
    """On the CPU the profiler records the port's spans (no device
    operation, so no idle share)."""
    from bench.harness.cell import run_cell

    torch.set_num_threads(2)
    result, _ = run_cell(cell, 3_000_000_019, 0.3, True,
                         t_start=time.perf_counter(), device="cpu",
                         overrides={"traffic": {"graph": {"n": 512}}})
    assert result["correct"] is True
    op = "infer" if "infer" in cell else "train"
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert got[f"dispatch_ms.{op}"] > 0 and got[f"model_host_ms.{op}"] > 0
    assert f"idle_in_program.{op}" not in got
    if op == "infer":
        assert got["dispatch_ms.infer"] + got["model_host_ms.infer"] \
            <= got["host_ms.infer"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_overlap_s_agrees_with_every_interval_visited(seed):
    """``overlap_s`` visits only the intervals near ``[a, b]``; it reads
    what a scan of all of them reads."""
    import random

    from bench.harness.spans import overlap_s, union
    from bench.harness.trace import Event

    rng = random.Random(seed)
    events = [Event("sparse.dispatch", t, rng.uniform(0.0, 3.0))
              for t in (rng.uniform(0.0, 100.0) for _ in range(300))]
    merged = union(events)
    starts = [lo for lo, _ in merged]
    for _ in range(200):
        a = rng.uniform(-5.0, 105.0)
        b = a + rng.uniform(0.0, 20.0)
        every = sum(max(0.0, min(b, hi) - max(a, lo)) for lo, hi in merged)
        assert overlap_s(merged, starts, a, b) == pytest.approx(every)
