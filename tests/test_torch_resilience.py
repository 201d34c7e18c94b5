"""Port parity: ``repro_torch.resilience`` against ``repro.resilience``.

The same error taxonomy (``classify`` of every error class), the same
retry delays and fault schedules for the same seeds (both draw from numpy
generators), the same worker restarts, and the same ``obs`` counters for
each."""
import threading

import numpy as np
import pytest
import torch

from repro import obs as j_obs
from repro import resilience as j_res
from repro.resilience import chaos as j_chaos
from repro_torch import obs, resilience
from repro_torch.resilience import chaos


@pytest.fixture(autouse=True)
def _clean():
    for o, c in ((obs, chaos), (j_obs, j_chaos)):
        o.reset()
        c.uninstall()
    yield
    for o, c in ((obs, chaos), (j_obs, j_chaos)):
        o.reset()
        c.uninstall()


def _counters(o):
    return o.snapshot()["metrics"]["counters"]


# every error class, built the same way in both packages
ERRORS = [
    ("PoisonRequestError", ()), ("NaNOutputError", ()),
    ("TransientExecutorError", ()), ("WorkerLostError", ()),
    ("RequestShedError", ()), ("DeadlineExceededError", ()),
    ("EngineClosedError", ()), ("ResilienceError", ()),
]
CHAOS_ERRORS = [("WorkerKilled", ("x",)), ("ProcessKillRequested", ("x",)),
                ("WorkerHangRequested", ("x", 1.0))]
BUILTINS = [ValueError("v"), TypeError("t"), KeyboardInterrupt(),
            SystemExit(1), RuntimeError("r"), TimeoutError("t"),
            ZeroDivisionError(), MemoryError()]


@pytest.mark.parametrize("name,args", ERRORS + CHAOS_ERRORS,
                         ids=[n for n, _ in ERRORS + CHAOS_ERRORS])
def test_classify_matches_reference(name, args):
    mod, jmod = (chaos, j_chaos) if (name, args) in CHAOS_ERRORS \
        else (resilience.errors, j_res.errors)
    got = resilience.classify(getattr(mod, name)(*args))
    assert got == j_res.classify(getattr(jmod, name)(*args))
    assert [c.__name__ for c in getattr(mod, name).__mro__] \
        == [c.__name__ for c in getattr(jmod, name).__mro__]


@pytest.mark.parametrize("exc", BUILTINS, ids=lambda e: type(e).__name__)
def test_classify_builtins_matches_reference(exc):
    assert resilience.classify(exc) == j_res.classify(exc)


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("kw", [{}, dict(base_ms=2.0, jitter=0.0),
                                dict(max_attempts=6, multiplier=3.0,
                                     max_ms=20.0, jitter=0.9)],
                         ids=["default", "no-jitter", "steep"])
def test_retry_policy_delays_match_reference(seed, kw):
    pol, jpol = resilience.RetryPolicy(**kw), j_res.RetryPolicy(**kw)
    rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
    got = [pol.backoff_s(a, rng) for a in range(1, 10)]
    assert got == [jpol.backoff_s(a, jrng) for a in range(1, 10)]
    assert [pol.allows(a) for a in range(8)] \
        == [jpol.allows(a) for a in range(8)]


@pytest.mark.parametrize("failures", [0, 2, 5])
def test_call_with_retry_matches_reference(failures):
    def run(res, errors, o):
        left = [failures]
        sleeps = []

        def fn():
            if left[0]:
                left[0] -= 1
                raise errors.TransientExecutorError("flaky")
            return "ok"

        try:
            out = res.call_with_retry(
                fn, policy=res.RetryPolicy(max_attempts=4), site="s",
                rng=np.random.default_rng(3), sleep=sleeps.append,
                budget=res.RetryBudget(capacity=10, refill_per_s=0.0))
        except errors.TransientExecutorError:
            out = "raised"
        return out, sleeps, _counters(o)

    assert run(resilience, resilience.errors, obs) \
        == run(j_res, j_res.errors, j_obs)


def test_poison_is_not_retried_and_budget_fails_fast():
    for res in (resilience, j_res):
        calls = []

        def poison():
            calls.append(1)
            raise res.PoisonRequestError("bad")

        with pytest.raises(res.PoisonRequestError):
            res.call_with_retry(poison, sleep=lambda s: None)
        assert len(calls) == 1
        budget = res.RetryBudget(capacity=1, refill_per_s=0.0)
        assert budget.spend() and not budget.spend()
        assert budget.remaining() == 0.0


def _plan(c):
    return c.FaultPlan([
        c.FaultSpec(site="executor.execute", kind=c.RAISE, at=2, times=2),
        c.FaultSpec(site="serve.flush", kind=c.POISON, match={"tags": "t1"}),
        c.FaultSpec(site="train.step", kind=c.DELAY, p=0.4, payload=0.0),
        c.FaultSpec(site="executor.output", kind=c.NAN, at=1, times=None,
                    payload=(1, 0)),
    ], seed=11)


def _fire(c, plan, out_value):
    outcome = []
    with c.active(plan):
        for i in range(6):
            for site, ctx in (("executor.execute", {}),
                              ("serve.flush", {"tags": ["t0", f"t{i % 3}"]}),
                              ("train.step", {"step": i})):
                try:
                    c.hook(site, **ctx)
                    outcome.append((site, "ok"))
                except Exception as exc:  # the injected faults
                    outcome.append((site, type(exc).__name__))
        value = c.corrupt("executor.output", out_value)
    return outcome, list(plan.events), value


def test_fault_plan_fires_as_reference():
    got, events, value = _fire(chaos, _plan(chaos), torch.ones(3, 2))
    want, jevents, jvalue = _fire(j_chaos, _plan(j_chaos), np.ones((3, 2)))
    assert got == want and events == jevents
    np.testing.assert_array_equal(value.numpy(), np.asarray(jvalue))
    assert torch.isnan(value[1, 0]) and not torch.isnan(value[0, 0])
    assert _counters(obs) == _counters(j_obs)
    assert chaos.active_plan() is None  # disarmed after the block


def test_corrupt_does_not_touch_the_input_and_disarmed_is_identity():
    x = torch.ones(2, 2)
    assert chaos.corrupt("executor.output", x) is x
    plan = chaos.FaultPlan([chaos.FaultSpec(site="s", kind=chaos.NAN,
                                            payload="all")])
    with chaos.active(plan):
        y = chaos.corrupt("s", x)
    assert torch.isnan(y).all() and not torch.isnan(x).any()
    with pytest.raises(ValueError):
        chaos.FaultSpec(site="s", kind="nope")


@pytest.mark.parametrize("max_restarts", [0, 2])
def test_worker_supervisor_restarts_as_reference(max_restarts):
    def run(res, o):
        sup = res.WorkerSupervisor("w", lambda: None,
                                   max_restarts=max_restarts)
        assert sup.ensure() is False  # not started: foreground mode
        sup.start()
        seen = []
        for _ in range(max_restarts + 2):
            sup.join(timeout=10)
            assert not sup.alive()
            seen.append((sup.ensure(), sup.restarts, sup.generation))
        stale = sup.ensure(observed_generation=0)
        sup.join(timeout=10)
        return seen, stale, _counters(o)

    assert run(resilience, obs) == run(j_res, j_obs)


def test_worker_supervisor_restarts_once_under_a_race():
    release = threading.Event()
    sup = resilience.WorkerSupervisor("race", release.wait, max_restarts=5)
    sup.start()
    release.set()
    sup.join(timeout=10)
    gen = sup.generation
    threads = [threading.Thread(target=sup.ensure, args=(gen,))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert sup.restarts == 1 and sup.generation == gen + 1
    sup.join(timeout=10)
