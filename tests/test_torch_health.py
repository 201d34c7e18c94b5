"""Port parity: ``repro_torch.ft.health`` against ``repro.ft.health``.

Both are pure Python, so the port is held to the reference exactly: the
same straggler flags and medians on the same seeded step times, the same
dead hosts for the same scripted beats, the same hot-spare decisions, and
the same per-instance default configs (mirrors the health cases of
``tests/test_fault_tolerance.py`` and ``tests/test_fleet.py``)."""
import dataclasses

import numpy as np
import pytest

from repro.ft import health as jh
from repro_torch.ft import health as th

PKGS = (th, jh)


def test_health_config_defaults_match():
    assert dataclasses.asdict(th.HealthConfig()) \
        == dataclasses.asdict(jh.HealthConfig())


def test_straggler_detector_flags_a_slow_step():
    det = th.StragglerDetector(th.HealthConfig(window=20))
    for i in range(15):
        det.record(i, 0.100 + 0.001 * (i % 3))
    assert det.record(15, 0.5) is True  # 5x median
    assert det.record(16, 0.101) is False
    assert det.flags == [15]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("window", [8, 20, 50])
def test_straggler_decisions_match_reference(seed, window):
    """Seeded step times with planted spikes: every decision, the flags
    and the running median equal the reference's step by step."""
    rng = np.random.default_rng(seed)
    times = 0.05 + 0.01 * rng.random(120)
    times[rng.integers(0, 120, size=10)] *= rng.uniform(1.2, 6.0, size=10)
    dets = [p.StragglerDetector(p.HealthConfig(window=window))
            for p in PKGS]
    for step, dt in enumerate(times.tolist()):
        got = [d.record(step, dt) for d in dets]
        assert got[0] == got[1], step
        assert dets[0].median == dets[1].median
    assert dets[0].flags == dets[1].flags
    assert dets[0].flags  # the planted spikes were seen


def test_heartbeat_timeout():
    hb = th.Heartbeat(th.HealthConfig(heartbeat_timeout_s=10))
    hb.beat(0, now=100.0)
    hb.beat(1, now=105.0)
    assert hb.dead_hosts(now=112.0) == [0]
    assert set(hb.dead_hosts(now=120.0)) == {0, 1}


def test_heartbeat_script_matches_reference():
    """Beats from int ranks and fleet worker names, a forgotten host and
    a late beat: the same dead hosts at every check."""
    script = [("beat", 0, 0.0), ("beat", "w1", 0.1), ("beat", 1, 0.3),
              ("dead", None, 0.4), ("dead", None, 0.65),
              ("beat", "w1", 0.7), ("forget", 1, None), ("dead", None, 1.0),
              ("beat", "w2", 1.1), ("dead", None, 1.25), ("dead", None, 9.0)]
    hbs = [p.Heartbeat(p.HealthConfig(heartbeat_timeout_s=0.5))
           for p in PKGS]
    for op, host, t in script:
        if op == "beat":
            for hb in hbs:
                hb.beat(host, now=t)
        elif op == "forget":
            for hb in hbs:
                hb.forget(host)
        else:
            got = [hb.dead_hosts(now=t) for hb in hbs]
            assert got[0] == got[1], (op, t)
    assert hbs[0].last == hbs[1].last


def test_simulated_cluster_hot_spare_then_shrink():
    c = th.SimulatedCluster(n_hosts=4, n_spares=1)
    assert c.fail(2) == "swap"
    assert c.world_size == 4
    assert c.fail(0) == "shrink"  # spares exhausted -> elastic shrink
    assert c.world_size == 3


@pytest.mark.parametrize("spares", [0, 1, 3])
def test_simulated_cluster_matches_reference(spares):
    clusters = [p.SimulatedCluster(n_hosts=6, n_spares=spares)
                for p in PKGS]
    for host in (5, 0, 3, 6, 1):
        if host not in clusters[0].active:
            continue
        got = [c.fail(host) for c in clusters]
        assert got[0] == got[1]
        assert clusters[0].active == clusters[1].active
        assert clusters[0].world_size == clusters[1].world_size
    assert clusters[0].events == clusters[1].events


def test_detectors_get_private_configs():
    d1, d2 = th.StragglerDetector(), th.StragglerDetector()
    assert d1.cfg is not d2.cfg
    d1.cfg.straggler_ratio = 99.0
    assert d2.cfg.straggler_ratio != 99.0
    h1, h2 = th.Heartbeat(), th.Heartbeat()
    assert h1.cfg is not h2.cfg
