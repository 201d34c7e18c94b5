"""Each metric reader on a synthetic profiler trace (Chrome trace JSON,
times in µs), against numbers worked out by hand."""
import pytest

from bench.harness import trace as tracing
from bench.harness.loop import Window
from bench.harness.spec import Spec
from bench.work import gnn as work
from bench.work.gnn import dense_ops, sparse_ops
from bench.work.ops import flops, least_s
from bench.work.peaks import PEAK_F32_FLOP_PER_S

PORT = "void (anonymous namespace)::spmm_blockell_kernel<float, 4, 32>(int)"
CFG = {"model": "gcn", "n_layers": 3, "in_features": 32, "hidden": 16,
       "n_classes": 4}
N, NNZ = 100, 1000
SHAPE = {"n": N, "nnz": NNZ}
SPANS = {"infer": "bench.infer", "train": "bench.train_step"}


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": 1}


def chrome() -> dict:
    """A 10 ms window (µs 1000 to 11000) of two requests."""
    return {"traceEvents": [
        ev("user_annotation", "bench.window", 1000, 10000),
        ev("user_annotation", "bench.request", 1000, 4000),
        ev("user_annotation", "bench.infer", 1000, 500),
        ev("user_annotation", "bench.sync", 1500, 3500),
        ev("user_annotation", "bench.request", 5500, 4500),
        ev("user_annotation", "bench.infer", 5500, 800),
        ev("user_annotation", "bench.sync", 6300, 3700),
        ev("user_annotation", "not.ours", 1000, 10),
        ev("gpu_user_annotation", "bench.window", 1000, 10000),
        ev("kernel", "sm80_xmma_gemm_straddling", 900, 200),
        ev("kernel", "sm80_xmma_gemm_f32f32", 1100, 100),
        ev("kernel", PORT, 1200, 2000),
        ev("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 3150, 100),
        ev("kernel", "void at::native::(anonymous namespace)::CatArray",
           3300, 200),
        ev("kernel", PORT, 5600, 3000),
        ev("kernel", "after_the_window", 11500, 100),
        ev("cpu_op", "aten::mm", 1050, 40),
        ev("cuda_runtime", "cudaStreamSynchronize", 1550, 3400),
        {"ph": "s", "cat": "ac2g", "name": "flow", "ts": 1100},
    ]}


class FakeRun:
    """A traced run of two units over the 10 ms window."""

    def __init__(self, tr, op="infer"):
        self.trace = tr
        self.window = Window(op, 2, 0.01, call_span=SPANS[op])
        self.cell = type("C", (), {"config": CFG})()
        self.work = work
        self.shape = SHAPE


def reduced() -> tracing.Trace:
    return tracing.from_chrome(chrome())


def reader(name):
    return next(m for m in Spec.load().per_layer if m.name == name).reader()


def test_reduction():
    tr = reduced()
    assert tr.window_s == pytest.approx(0.01)
    assert len(tr.device) == 6  # the one after the window is left out
    assert len(tr.spans) == 7  # bench.* only
    assert tr.busy() == [pytest.approx((0.0, 2.25e-3)),
                         pytest.approx((2.3e-3, 2.5e-3)),
                         pytest.approx((4.6e-3, 7.6e-3))]
    assert tr.busy_s() == pytest.approx(5.45e-3)
    assert [g[1] for g in tr.idle_gaps()] == [pytest.approx(5e-5),
                                             pytest.approx(2.1e-3),
                                             pytest.approx(2.4e-3)]
    idle = tracing.idle_by_host(tr)
    assert [n for n, _ in idle] == ["bench.sync",
                                    "bench.sync > cudaStreamSynchronize"]
    assert [s for _, s in idle] == [pytest.approx(2.4e-3),
                                    pytest.approx(2.15e-3)]
    ops = dict(tracing.device_ops(tr))
    assert ops[PORT] == pytest.approx(5e-3)
    b = tracing.breakdown(tr)
    assert b["device_ops"][0] == [PORT, pytest.approx(5e-3)]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_readers_by_hand():
    for kind in ("infer", "train"):
        run = FakeRun(reduced(), kind)
        assert reader(f"idle_share.{kind}").read(run) == \
            pytest.approx(45.5)
        # library kernels and the copy: 100 + 100 + 200 + 100 µs, 2 units
        assert reader(f"torch_ops_ms.{kind}").read(run) == \
            pytest.approx(0.25)
        least = least_s(sparse_ops(CFG, kind, SHAPE))
        assert reader(f"kernel_roofline.{kind}").read(run) == \
            pytest.approx(100 * least / 2.5e-3)
        need = flops(sparse_ops(CFG, kind, SHAPE)) \
            + flops(dense_ops(CFG, kind, SHAPE))
        assert reader(f"mfu.{kind}").read(run) == \
            pytest.approx(100 * need / (5e-3 * PEAK_F32_FLOP_PER_S))
    run = FakeRun(reduced())
    assert reader("host_ms.infer").read(run) == pytest.approx(0.65)
    run = FakeRun(reduced(), "train")
    assert reader("host_ms.train").read(run) is None  # no such span


def test_suffixed_metrics_share_their_base_reader():
    spec = Spec.load()
    for m in spec.per_layer:
        base = m.name.split(".")[0]
        assert m.reader().__file__.endswith(f"/metrics/{base}.py")


def test_readers_find_nothing_to_read():
    empty = tracing.from_chrome({"traceEvents": [
        ev("user_annotation", "bench.window", 0, 1000)]})
    for m in Spec.load().per_layer:
        assert m.reader().read(FakeRun(empty)) is None, m.name
    for m in Spec.load().per_layer:
        run = FakeRun(reduced())
        run.trace = None
        assert m.reader().read(run) is None, m.name


def test_a_trace_without_the_window_span_is_refused():
    with pytest.raises(ValueError):
        tracing.from_chrome({"traceEvents": [ev("kernel", PORT, 0, 1)]})


class E2ERun:
    def __init__(self, op, units, window_s, lat, peak):
        self.window = Window(op, units, window_s, items=N * units,
                             latencies_ms=lat)
        self.peak_window_bytes = peak
        self.setup_s = 12.5


def test_end_to_end_readers():
    spec = Spec.load()
    read = {m.name: m.reader().read for m in spec.end_to_end}
    lat = [float(i) for i in range(1, 101)]  # 1 .. 100 ms
    run = E2ERun("infer", 100, 2.0, lat, 3 * 2**30)
    assert read["infer_nodes_per_s"](run) == pytest.approx(N * 100 / 2.0)
    assert read["infer_p95_ms"](run) == pytest.approx(95.05)
    assert read["peak_mem_gib"](run) == pytest.approx(3.0)
    assert read["setup_s"](run) == 12.5
    assert read["train_step_ms"](run) is None
    run = E2ERun("train", 40, 2.0, [], 2**30)
    assert read["train_step_ms"](run) == pytest.approx(50.0)
    assert read["infer_p95_ms"](run) is None
