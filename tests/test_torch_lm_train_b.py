"""Port parity, continued from ``tests/test_torch_lm_train.py`` (its
tolerances and its reference steps): microbatches 2 and 4 and both
compressions in a train step against the reference's jitted step, the
train state crossed from the reference, and ``tests/test_resilience.py``'s
two ``train_loop`` crash cases on the port, ``torch.equal`` to the
undisturbed run; ``cast_params_once`` against the reference's bf16
step."""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import DataConfig, lm_data_iter
from repro_torch.models import transformer as T
from repro_torch.resilience import FaultPlan, FaultSpec, KernelError, chaos
from repro_torch.train import loop as L
from repro_torch.train.loop import (TrainConfig, init_train_state,
                                    make_train_step)
from repro_torch.train.optimizer import OptConfig
from test_torch_lm_train import (CPU, STEP_ARCHS, _hold_grads, _hold_params,
                                 _opt, _port_inputs, reference_step)


def _rel_l2(got, want):
    """‖got − want‖ / ‖want‖ over every leaf together, in f64."""
    d = sum(float(np.sum((np.asarray(g, np.float64) - w) ** 2))
            for g, w in zip(got, want))
    n = sum(float(np.sum(np.asarray(w, np.float64) ** 2)) for w in want)
    return math.sqrt(d / n)


CAST_LEAF = 1e-2  # x max|want| per leaf: bf16 products in another order
CAST_L2 = 3e-3  # relative L2 over the tree: below the cast's own effect


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_cast_params_once_reaches_f32_masters(arch):
    """bf16 compute from f32 masters: the gradients are f32, one per
    master, and hold to the reference's ``cast_params_once`` step (loss
    within 1e-5 relative, each leaf within 1e-2 x max|want|, the whole
    tree within 3e-3 relative L2; measured 1e-7, 6e-3 and 1e-3), while
    the port's f32 run lies beyond both the loss and the tree's limits
    (measured 3e-5 and 1e-2 to 2e-2): a cast that does nothing fails."""
    ref = reference_step(arch, cast_params_once=True)
    cfg, params, batch = _port_inputs(arch, ref)
    tcfg = TrainConfig(opt=_opt(), cast_params_once=True)
    loss, grads = L.make_grad_fn(cfg, tcfg)(params, batch)
    loss32, grads32 = L.make_grad_fn(cfg, TrainConfig(opt=_opt()))(params,
                                                                   batch)
    got = [g.numpy() for g in T.tree_leaves(grads)]
    assert all(g.dtype == torch.float32 and g.shape == p.shape
               for g, p in zip(T.tree_leaves(grads), T.tree_leaves(params)))
    assert abs(float(loss) - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    assert abs(float(loss) - float(loss32)) > 1e-5 * abs(float(loss32))
    want = jax.tree_util.tree_leaves(ref["grads"])
    for i, (g, w) in enumerate(zip(got, want)):
        err = float(np.abs(g - w).max())
        assert err <= CAST_LEAF * float(np.abs(w).max()), f"leaf {i}: {err}"
    assert _rel_l2(got, want) <= CAST_L2
    assert _rel_l2(got, [g.numpy() for g in T.tree_leaves(grads32)]) \
        > CAST_L2
    new_p, _, m = make_train_step(cfg, tcfg)(
        params, init_train_state(params, tcfg), batch)
    assert abs(float(m["loss"]) - ref["step_loss"]) \
        <= 1e-5 * abs(ref["step_loss"])
    assert all(p.dtype == torch.float32 for p in T.tree_leaves(new_p))


@pytest.mark.parametrize("nm", [2, 4])
def test_microbatched_step_matches_reference(nm):
    ref = reference_step("granite-20b", microbatches=nm)
    cfg, params, batch = _port_inputs("granite-20b", ref)
    tcfg = TrainConfig(opt=_opt(), microbatches=nm)
    loss, grads = L.make_grad_fn(cfg, tcfg)(params, batch)
    assert abs(float(loss) - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    _hold_grads(grads, ref["grads"], f"nm={nm}")
    new_p, _, m = make_train_step(cfg, tcfg)(
        params, init_train_state(params, tcfg), batch)
    assert abs(float(m["loss"]) - ref["step_loss"]) \
        <= 1e-5 * abs(ref["step_loss"])
    _hold_params(new_p, ref["new_params"], f"nm={nm}")


@pytest.mark.parametrize("compression", ["int8", "topk_ef"])
def test_compressed_step_matches_reference(compression):
    ref = reference_step("granite-20b", compression=compression)
    cfg, params, batch = _port_inputs("granite-20b", ref)
    tcfg = TrainConfig(opt=_opt(), compression=compression)
    state = init_train_state(params, tcfg)
    new_p, new_s, m = make_train_step(cfg, tcfg)(params, state, batch)
    assert abs(float(m["grad_norm"]) - ref["grad_norm"]) \
        <= 1e-4 * ref["grad_norm"]
    _hold_params(new_p, ref["new_params"], compression)
    if compression == "topk_ef":
        for g, w in zip(T.tree_leaves(new_s["residual"]),
                        jax.tree_util.tree_leaves(
                            ref["new_state"]["residual"])):
            assert float(np.abs(g.numpy() - w).max()) \
                <= 1e-4 * max(float(np.abs(w).max()), 1e-30)


def test_train_state_from_numpy_round_trip():
    ref = reference_step("granite-20b", compression="topk_ef")
    state = L.train_state_from_numpy(ref["new_state"], device=CPU)
    assert state["opt"]["step"].dtype == torch.int32
    assert int(state["opt"]["step"]) == 1
    for g, w in zip(T.tree_leaves(state),
                    jax.tree_util.tree_leaves(ref["new_state"])):
        np.testing.assert_array_equal(g.numpy(), w)


# ---------------------------------------------------------------------------
# tests/test_resilience.py's train_loop crash cases, on the port
# ---------------------------------------------------------------------------


@pytest.fixture
def _clean():
    obs.reset()
    chaos.uninstall()
    yield
    obs.reset()
    chaos.uninstall()


def _train_setup():
    cfg = dataclasses.replace(get_smoke_config("nemotron-4-15b"),
                              dtype="float32")
    tcfg = TrainConfig(opt=OptConfig(lr=5e-3, warmup_steps=0,
                                     total_steps=100))
    params = T.init_lm(cfg, seed=0, device=CPU)
    state = init_train_state(params, tcfg)
    step = make_train_step(cfg, tcfg)
    it = lambda start: lm_data_iter(  # noqa: E731
        cfg, ShapeConfig("t", 32, 4, "train"), DataConfig(seed=9),
        start_step=start, device=CPU)
    return params, state, step, it


def _same_bits(a, b):
    return all(torch.equal(x, y) for x, y in
               zip(T.tree_leaves(a), T.tree_leaves(b)))


def _counter_total(name: str) -> float:
    return sum(obs.snapshot()["metrics"]["counters"].get(name, {}).values())


def test_train_crash_recovery_reconverges(tmp_path, _clean):
    """A chaos-killed step restores from the newest atomic checkpoint,
    replays the data stream, and lands on the same params, bit for bit,
    as the undisturbed run."""
    from repro_torch.ft.checkpoint import Checkpointer

    n_steps = 6
    params, state, step, it = _train_setup()
    base = L.train_loop(params, state, step, it(0), n_steps, log_every=1)
    assert base["recoveries"] == 0

    params, state, step2, it = _train_setup()
    ck = Checkpointer(str(tmp_path), keep=2, async_save=False)
    plan = FaultPlan([FaultSpec(site="train.step", kind="die", at=5)])
    with chaos.active(plan):
        out = L.train_loop(params, state, step2, it(0), n_steps,
                           log_every=1, checkpointer=ck, ckpt_every=2,
                           data_factory=it, max_recoveries=2)
    assert out["recoveries"] == 1
    assert ("train.step", "die", 5) in plan.events
    assert _same_bits(base["params"], out["params"])
    assert _same_bits(base["state"], out["state"])
    assert base["history"][-1]["loss"] == out["history"][-1]["loss"]
    assert _counter_total("resilience_recoveries_total") >= 1


def test_train_crash_before_first_checkpoint_restarts_from_init(
        tmp_path, _clean):
    from repro_torch.ft.checkpoint import Checkpointer

    n_steps = 3
    params, state, step, it = _train_setup()
    base = L.train_loop(params, state, step, it(0), n_steps, log_every=1)

    params, state, step2, it = _train_setup()
    ck = Checkpointer(str(tmp_path), async_save=False)
    plan = FaultPlan([FaultSpec(site="train.step", kind="raise", at=2)])
    with chaos.active(plan):
        out = L.train_loop(params, state, step2, it(0), n_steps,
                           log_every=1, checkpointer=ck, ckpt_every=0,
                           data_factory=it, max_recoveries=1)
    assert out["recoveries"] == 1
    assert _same_bits(base["params"], out["params"])
    assert base["history"][-1]["loss"] == out["history"][-1]["loss"]


def test_train_loop_never_retries_a_kernel_error(tmp_path, _clean):
    """A ``KernelError`` is FATAL: it escapes the loop unretried."""
    from repro_torch.ft.checkpoint import Checkpointer

    params, state, step, it = _train_setup()
    ck = Checkpointer(str(tmp_path), async_save=False)
    plan = FaultPlan([FaultSpec(site="train.step", kind="raise", at=1,
                                payload=KernelError("K1 launch failed"))])
    with chaos.active(plan), pytest.raises(KernelError):
        L.train_loop(params, state, step, it(0), 3, checkpointer=ck,
                     ckpt_every=1, data_factory=it, max_recoveries=3)
    assert _counter_total("resilience_recoveries_total") == 0


def test_train_loop_records_its_metrics(_clean):
    params, state, step, it = _train_setup()
    L.train_loop(params, state, step, it(0), 2, log_every=1)
    snap = obs.snapshot()
    assert snap["spans"]["train.step"]["count"] == 2
    assert snap["metrics"]["histograms"]["train_step_ms"]
    assert "train_loss" in snap["metrics"]["gauges"]
