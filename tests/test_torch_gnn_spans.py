"""The port's spans on the GNN hot path (``repro_torch.obs.tracing``), on
the CPU at a tiny size, for GCN and GAT.

Off (the ring off, no profiler), ``obs.span`` is one shared no-op and
nothing is recorded.  With the ring on, ``serve.infer`` holds one
``gnn.layer`` a layer, each holding its ``sparse.dispatch``; ``train.step``
holds ``train.forward``, ``train.backward`` and ``train.update``, and the
backward's ``sparse.dispatch`` spans are the plan records of its rules
(on the CPU autograd runs the backward on the caller's thread, so they
sit under ``train.backward``).  Under the CPU profiler each span is a
``cpu_op`` event inside its call, whether the ring is on or off.
"""
import json
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.configs.paper_gnn import SMOKE_CONFIG
from repro_torch.models.gnn import build_graph, init_gat, init_gcn
from repro_torch.obs import tracing
from repro_torch.serve.engine import GNNServeConfig, GNNServingEngine
from repro_torch.train import gnn as trainer

N = 256
LAYERS = SMOKE_CONFIG.n_layers
CASES = [("gcn", True), ("gcn", False), ("gat", True), ("gat", False)]
STEP_PHASES = ("train.forward", "train.backward", "train.update")
# the autograd Functions of the sparse ops, as the profiler names them
APPLIES = ("SpMM", "SpMMEpilogue", "SDDMMValues", "FusedAttention")


@pytest.fixture(autouse=True)
def _fresh_obs():
    """Empty instruments and the ring off, as a process starts."""
    obs.TRACER.disable()
    obs.reset()
    yield
    obs.TRACER.disable()
    obs.reset()


def _graph():
    rng = np.random.default_rng(7)  # uniform density 0.1: plans ell
    adj = (rng.random((N, N)) < 0.1).astype(np.float32)
    return build_graph(adj, SMOKE_CONFIG, device="cpu")


def _engine(kind, fuse):
    init = init_gcn if kind == "gcn" else init_gat
    return GNNServingEngine(init(SMOKE_CONFIG, seed=0, device="cpu"),
                            _graph(), GNNServeConfig(model=kind, fuse=fuse))


def _trainer(kind):
    params = trainer.init_params(kind, SMOKE_CONFIG, seed=0, device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(N, SMOKE_CONFIG.in_features)).astype(np.float32))
    labels = torch.from_numpy(trainer.planted_labels(
        N, SMOKE_CONFIG.n_classes))
    graph = _graph()
    return lambda fuse: trainer.train_step(params, graph, x, labels,
                                           kind=kind, lr=0.05, fuse=fuse)


def _features():
    return torch.from_numpy(np.random.default_rng(3).normal(
        size=(N, SMOKE_CONFIG.in_features)).astype(np.float32))


def _dispatch_per_layer(kind, fuse):
    """An unfused GAT layer samples the scores and then multiplies."""
    return 2 if (kind, fuse) == ("gat", False) else 1


def _vjp_plans():
    counters = obs.snapshot()["metrics"]["counters"]
    return sum(v for k, v in counters.get("dispatch_plans_total", {}).items()
               if "policy=vjp" in k)


def _parent_names(spans):
    by_id = {s.span_id: s for s in spans}
    return Counter((s.name, by_id[s.parent_id].name if s.parent_id
                    else None) for s in spans)


def test_off_a_span_is_one_shared_no_op():
    assert not obs.TRACER.enabled
    first = obs.span("serve.infer")
    assert first is obs.span("gnn.layer", layer=0) is tracing.NO_SPAN
    with first as entered:
        assert entered is None


def test_off_a_span_reads_no_clock(monkeypatch):
    class NoClock:
        def __getattr__(self, name):
            raise AssertionError(f"time.{name} read")

    monkeypatch.setattr(tracing, "time", NoClock())
    with obs.span("sparse.dispatch"):
        pass
    obs.TRACER.enable()
    with pytest.raises(AssertionError, match="read"):
        with obs.span("sparse.dispatch"):
            pass


@pytest.mark.parametrize("kind,fuse", CASES)
def test_off_infer_and_a_step_record_nothing(kind, fuse):
    _engine(kind, fuse).infer(_features())
    _trainer(kind)(fuse)
    assert obs.TRACER.spans() == ()
    snap = obs.snapshot()
    assert snap["spans"] == {}
    assert "span_ms" not in snap["metrics"]["histograms"]


@pytest.mark.parametrize("kind,fuse", CASES)
def test_ring_on_infer_nests_layers_and_dispatch(kind, fuse):
    obs.TRACER.enable()
    eng = _engine(kind, fuse)
    x = _features()
    for _ in range(2):
        eng.infer(x)
    spans = obs.TRACER.spans()
    per = _dispatch_per_layer(kind, fuse)
    assert _parent_names(spans) == {
        ("serve.infer", None): 2,
        ("gnn.layer", "serve.infer"): 2 * LAYERS,
        ("sparse.dispatch", "gnn.layer"): 2 * LAYERS * per}
    for call in obs.TRACER.spans("serve.infer"):
        layers = [s for s in spans if s.parent_id == call.span_id]
        assert [dict(s.tags) for s in layers] == \
            [{"layer": str(i)} for i in range(LAYERS)]
        assert all(s.trace_id == call.span_id for s in spans
                   if s.parent_id in {x.span_id for x in layers})
    hists = obs.snapshot()["metrics"]["histograms"]["span_ms"]
    assert {k: v["count"] for k, v in hists.items()} == {
        "span=serve.infer": 2, "span=gnn.layer": 2 * LAYERS,
        "span=sparse.dispatch": 2 * LAYERS * per}


@pytest.mark.parametrize("kind,fuse", CASES)
def test_ring_on_a_step_holds_its_phases(kind, fuse):
    step = _trainer(kind)
    obs.TRACER.enable()
    for _ in range(2):
        step(fuse)
    spans = obs.TRACER.spans()
    forward = 2 * LAYERS * _dispatch_per_layer(kind, fuse)
    backward = _vjp_plans()
    assert backward > 0
    assert _parent_names(spans) == {
        ("train.step", None): 2,
        **{(phase, "train.step"): 2 for phase in STEP_PHASES},
        ("gnn.layer", "train.forward"): 2 * LAYERS,
        ("sparse.dispatch", "gnn.layer"): forward,
        ("sparse.dispatch", "train.backward"): backward}
    summary = obs.snapshot()["spans"]
    assert summary["train.step"]["count"] == 2
    assert summary["sparse.dispatch"]["count"] == forward + backward


def _chrome(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if e.get("ph") == "X"]


def _inside(inner, outer):
    return outer["ts"] <= inner["ts"] \
        and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("kind", ["gcn", "gat"])
def test_under_the_profiler_each_span_is_a_host_op_inside_its_call(
        kind, ring, tmp_path):
    eng, step = _engine(kind, True), _trainer(kind)
    x = _features()
    if ring:
        obs.TRACER.enable()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("call.infer"):
            eng.infer(x)
        with torch.profiler.record_function("call.step"):
            step(True)
    backward = _vjp_plans()
    events = _chrome(prof, tmp_path)
    calls = {e["name"]: e for e in events if e["name"].startswith("call.")}
    ours = [e for e in events if e["name"].startswith(
        ("serve.", "gnn.", "sparse.", "train."))]
    assert {e["cat"] for e in ours} == {"cpu_op"}
    assert all("args" not in e or "layer" not in e["args"] for e in ours)
    in_infer = Counter(e["name"] for e in ours
                       if _inside(e, calls["call.infer"]))
    in_step = Counter(e["name"] for e in ours
                      if _inside(e, calls["call.step"]))
    assert in_infer == {"serve.infer": 1, "gnn.layer": LAYERS,
                        "sparse.dispatch": LAYERS}
    assert in_step == {"train.step": 1, "train.forward": 1,
                       "train.backward": 1, "train.update": 1,
                       "gnn.layer": LAYERS,
                       "sparse.dispatch": LAYERS + backward}
    assert len(ours) == sum(in_infer.values()) + sum(in_step.values())
    by_name = {e["name"]: e for e in ours}  # one of each name suffices
    assert _inside(by_name["train.update"], by_name["train.step"])
    layer = next(e for e in ours if e["name"] == "gnn.layer"
                 and _inside(e, calls["call.infer"]))
    assert _inside(layer, by_name["serve.infer"])
    assert any(_inside(e, layer) for e in ours
               if e["name"] == "sparse.dispatch")
    # the front end ends before the op's autograd Function runs
    applies = [e for e in events if e["name"] in APPLIES]
    assert applies
    assert not any(_inside(f, e) for e in ours
                   if e["name"] == "sparse.dispatch" for f in applies)
    n_ring = len(obs.TRACER.spans())
    assert n_ring == (len(ours) if ring else 0)
