"""Port parity: the timed ``autotune`` policy, its cache and ``calibrate``
(``repro_torch.dispatch.autotune``) against ``repro.dispatch.autotune``.

Keys are spelled as the reference spells them, so a cache file saved by
either package loads in the other and hits; ``measure`` records an
unavailable candidate as +inf but lets a kernel failure propagate; one
measurement serves a sparsity bucket (as ``tests/test_dispatch.py`` pins
for the reference); ``calibrate`` returns positive constants and rides in
the cache file; and a cache pre-filled from one JSON file makes both
packages plan the same path, "autotune: cached winner", for every op.
Outputs are held to the dense product at ``tests/test_dispatch.py``'s
2e-4.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dispatch import AutotuneCache as JAutotuneCache
from repro.dispatch import CostModel as JCostModel
from repro.dispatch import dispatch_spmm as j_dispatch_spmm
from repro.dispatch import make_key as j_make_key
from repro.dispatch import last_plan as j_last_plan
from repro.dispatch._forms import LazyForms as JLazyForms
from repro.kernels.fused.epilogue import Epilogue as JEpilogue
from repro.sparse import SparseMatrix as JSparseMatrix
from repro.sparse import fused_graph_attention as j_fused_attention
from repro.sparse import matmul as j_matmul
from repro.sparse import sddmm as j_sddmm
from repro.sparse import spmv as j_spmv
from repro_torch.dispatch import (AutotuneCache, CostModel, calibrate,
                                  dispatch_spmm, last_plan, make_key,
                                  measure)
from repro_torch.dispatch._forms import LazyForms
from repro_torch.dispatch.autotune import Measurement
from repro_torch.resilience.errors import KernelError
from repro_torch.sparse import (SparseMatrix, fused_graph_attention, matmul,
                                sddmm, spmv)

TOL = dict(rtol=2e-4, atol=2e-4)
N, D, K = 64, 8, 2
BLOCK = (16, 16)


def _dense(seed, sparsity, n=N):
    rng = np.random.default_rng(seed)
    return np.where(rng.random((n, n)) < 1.0 - sparsity,
                    rng.normal(size=(n, n)), 0.0).astype(np.float32)


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# keys and the cache file
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("jdtype,tdtype", [
    (jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16),
    (jnp.float16, torch.float16)])
@pytest.mark.parametrize("density", [0.5, 0.01, 0.0])
def test_make_key_matches_reference(jdtype, tdtype, density):
    want = j_make_key("spmm", (64, 48), 16, jnp.dtype(jdtype), density)
    assert make_key("spmm", (64, 48), 16, tdtype, density) == want
    assert make_key("spmm", (64, 48), 16, tdtype, density,
                    buckets_per_decade=3) == j_make_key(
        "spmm", (64, 48), 16, jnp.dtype(jdtype), density,
        buckets_per_decade=3)


def test_reference_cache_loads_in_the_port_and_hits(tmp_path):
    dense = _dense(1, 0.99, 128)
    h = _normal(2, 128, D)
    jcache = JAutotuneCache()
    jcache.cost_model = JCostModel(c_ell=2.5, c_csr=31.0, c_sell=7.5)
    j_dispatch_spmm(JLazyForms.from_dense(dense, block_m=16, block_n=16),
                    jnp.asarray(h), policy="autotune", cache=jcache)
    jpath = j_last_plan("spmm").path
    p = tmp_path / "ref.json"
    jcache.save(str(p))

    cache = AutotuneCache()
    cache.load(str(p))
    assert len(cache) == 1
    assert dataclass_dict(cache.cost_model) == dataclass_dict(
        jcache.cost_model)
    op = LazyForms.from_dense(dense, block_m=16, block_n=16, device="cpu")
    y = dispatch_spmm(op, torch.from_numpy(h), policy="autotune",
                      cache=cache)
    plan = last_plan("spmm")
    assert plan.path == jpath and plan.reason == "autotune: cached winner"
    assert cache.hits == 1 and cache.misses == 0
    np.testing.assert_allclose(y.numpy(), dense @ h, **TOL)


def test_port_cache_loads_in_the_reference_and_hits(tmp_path):
    dense = _dense(3, 0.9, 128)
    h = _normal(4, 128, D)
    cache = AutotuneCache()
    cache.cost_model = CostModel(c_ell=2.0, c_csr=20.0, c_sell=5.0)
    op = LazyForms.from_dense(dense, block_m=16, block_n=16, device="cpu")
    dispatch_spmm(op, torch.from_numpy(h), policy="autotune", cache=cache)
    path = last_plan("spmm").path
    assert set(last_plan("spmm").timings_us) == {"ell", "csr", "dense"}
    p = tmp_path / "port.json"
    cache.save(str(p))
    assert json.loads(p.read_text())["entries"][0]["key"][4] == "float32"

    jcache = JAutotuneCache()
    jcache.load(str(p))
    assert dataclass_dict(jcache.cost_model) == dataclass_dict(
        cache.cost_model)
    j_dispatch_spmm(JLazyForms.from_dense(dense, block_m=16, block_n=16),
                    jnp.asarray(h), policy="autotune", cache=jcache)
    jplan = j_last_plan("spmm")
    assert jplan.path == path and jplan.reason == "autotune: cached winner"


def dataclass_dict(cm):
    return dataclasses.asdict(cm)


def test_legacy_bare_list_payload_loads(tmp_path):
    p = tmp_path / "legacy.json"
    p.write_text(json.dumps([
        {"key": ["spmm", 8, 8, 4, "float32", 0], "path": "csr",
         "timings_us": {"csr": 5.0}}]))
    cache = AutotuneCache()
    cache.load(str(p))
    assert cache.cost_model is None
    assert cache.get(("spmm", 8, 8, 4, "float32", 0)).path == "csr"


# ---------------------------------------------------------------------------
# measure
# ---------------------------------------------------------------------------


def _raise(exc):
    def thunk():
        raise exc
    return thunk


@pytest.mark.parametrize("exc", [ValueError("no such form"),
                                 TypeError("bad dtype"),
                                 torch.cuda.OutOfMemoryError("oom")])
def test_measure_records_an_unavailable_path_as_inf(exc):
    m = measure({"ell": _raise(exc), "csr": lambda: torch.ones(3)},
                warmup=0, iters=1)
    assert m.path == "csr"
    assert m.timings_us["ell"] == float("inf")
    assert 0 <= m.timings_us["csr"] < float("inf")


def test_measure_raises_when_every_path_fails():
    with pytest.raises(RuntimeError, match="every candidate path failed"):
        measure({"ell": _raise(ValueError("x")),
                 "csr": _raise(TypeError("y"))}, warmup=0, iters=1)


@pytest.mark.parametrize("exc", [KernelError("K1: launch failed"),
                                 RuntimeError("CUDA error: an illegal "
                                              "memory access")])
def test_measure_lets_a_kernel_failure_propagate(exc):
    calls = []

    def fine():
        calls.append(1)
        return torch.ones(2)

    with pytest.raises(type(exc)):
        measure({"ell": _raise(exc), "csr": fine}, warmup=0, iters=1)
    assert not calls  # nothing after the failure was timed


def test_measure_takes_the_min_of_iters():
    import time

    naps = [0.05, 0.03, 0.002, 0.03]  # the warm-up call's, then 3 timed

    def thunk():
        time.sleep(naps.pop(0))
        return torch.zeros(1)

    m = measure({"a": thunk}, warmup=1, iters=3)
    assert m == Measurement(path="a", timings_us=m.timings_us)
    assert 2000 <= m.timings_us["a"] < 20000 and not naps


def test_autotune_under_matmul_lets_kernel_errors_propagate(monkeypatch):
    from repro_torch.sparse import autodiff

    dense = _dense(5, 0.9)
    a = SparseMatrix.from_dense(dense, formats=("ell", "csr"), block=BLOCK,
                                device="cpu")
    real = autodiff.spmm_exec

    def failing(path, a, h):
        if path == "ell":
            raise KernelError("K1 spmm_blockell: CUDA launch failed")
        return real(path, a, h)

    monkeypatch.setattr(autodiff, "spmm_exec", failing)
    with pytest.raises(KernelError):
        matmul(a, torch.from_numpy(_normal(6, N, D)), policy="autotune",
               autotune_cache=AutotuneCache())


# ---------------------------------------------------------------------------
# one measurement per sparsity bucket (tests/test_dispatch.py:383-409)
# ---------------------------------------------------------------------------


def test_autotune_caches_per_sparsity_bucket(tmp_path):
    dense = _dense(29, 0.98, 256)
    op = LazyForms.from_dense(dense, block_m=4, block_n=4, device="cpu")
    h = torch.from_numpy(_normal(30, 256, D))
    cache = AutotuneCache()
    y = dispatch_spmm(op, h, policy="autotune", cache=cache)
    np.testing.assert_allclose(y.numpy(), dense @ h.numpy(), **TOL)
    assert len(cache) == 1
    first = last_plan("spmm")
    assert first.timings_us and len(first.timings_us) == 3
    assert first.reason.startswith("autotune: measured")

    # a matrix of another density in the same bucket: a hit, no timing
    dense2 = _dense(31, 0.985, 256)
    misses = cache.misses
    dispatch_spmm(LazyForms.from_dense(dense2, block_m=4, block_n=4,
                                       device="cpu"),
                  h, policy="autotune", cache=cache)
    assert cache.misses == misses and len(cache) == 1
    assert last_plan("spmm").reason == "autotune: cached winner"
    # another bucket: measured again
    dispatch_spmm(LazyForms.from_dense(_dense(32, 0.5, 256), block_m=4,
                                       block_n=4, device="cpu"),
                  h, policy="autotune", cache=cache)
    assert len(cache) == 2

    p = tmp_path / "autotune.json"
    cache.save(str(p))
    cache2 = AutotuneCache()
    cache2.load(str(p))
    assert len(cache2) == 2
    key = make_key("spmm", op.stats().shape, D, h.dtype,
                   op.stats().density)
    assert cache2.get(key).path == first.path


# ---------------------------------------------------------------------------
# calibrate
# ---------------------------------------------------------------------------


def test_calibrate_returns_positive_constants_and_round_trips(tmp_path):
    cache = AutotuneCache()
    cm = calibrate(n=128, d=16, densities=(0.3, 0.02), iters=1,
                   cache=cache, device="cpu")
    assert cm.c_ell > 0 and cm.c_sell > 0 and cm.c_csr > 0
    assert cm.c_dense == 1.0
    assert cache.cost_model is cm
    p = tmp_path / "calibrated.json"
    cache.save(str(p))
    fresh = AutotuneCache()
    fresh.load(str(p))
    assert fresh.cost_model == cm
    jcache = JAutotuneCache()
    jcache.load(str(p))
    assert dataclass_dict(jcache.cost_model) == dataclass_dict(cm)


# ---------------------------------------------------------------------------
# one pre-filled cache file, both packages, every op
# ---------------------------------------------------------------------------


def _pair(dense, formats):
    return (SparseMatrix.from_dense(dense, formats=formats, block=BLOCK,
                                    device="cpu"),
            JSparseMatrix.from_dense(dense, formats=formats, block=BLOCK))


def _prefilled(tmp_path, key, path):
    p = tmp_path / "prefilled.json"
    timings = {"ell": 3.0, "sell": 2.0, "csr": 1.0, "dense": 4.0}
    p.write_text(json.dumps({"entries": [
        {"key": list(key), "path": path, "timings_us": timings}],
        "cost_model": None}))
    cache, jcache = AutotuneCache(), JAutotuneCache()
    cache.load(str(p))
    jcache.load(str(p))
    return cache, jcache


def _run_op(op, port, ref, dense):
    """(the port's output, the reference's, the oracle) for ``op``."""
    a, ja = port, ref
    h, b, c = _normal(7, N, D), _normal(8, N, K), _normal(9, K, N)
    q, k, v = _normal(10, N, K), _normal(11, N, K), _normal(12, N, D)
    x, bias = _normal(13, N), _normal(14, D)
    t = torch.from_numpy
    if op == "spmm":
        return (lambda **kw: matmul(a, t(h), **kw),
                lambda **kw: j_matmul(ja, h, **kw), dense @ h)
    if op == "epilogue":
        return (lambda **kw: matmul(a, t(h), epilogue="relu", bias=t(bias),
                                    **kw),
                lambda **kw: j_matmul(ja, h, epilogue="relu", bias=bias,
                                      **kw),
                np.maximum(dense @ h + bias, 0))
    if op == "sddmm":
        return (lambda **kw: sddmm(a, t(b), t(c), **kw).to_dense(),
                lambda **kw: j_sddmm(ja, b, c, **kw).to_dense(),
                dense * (b @ c))
    if op == "fused_attn":
        e = np.where(dense != 0, q @ k.T, -np.inf)
        e = np.where(e > 0, e, 0.2 * e)
        p = np.exp(e - e.max(axis=1, keepdims=True))
        want = (p / p.sum(axis=1, keepdims=True)) @ v
        return (lambda **kw: fused_graph_attention(a, t(q), t(k), t(v),
                                                   **kw),
                lambda **kw: j_fused_attention(ja, q, k, v, **kw), want)
    return (lambda **kw: spmv(a, t(x), **kw),
            lambda **kw: j_spmv(ja, x, **kw), dense @ x)


# (op, its autotune key's op tag, width, the reference's key extras)
OPS = [("spmm", "spmm", D, ()),
       ("epilogue", "spmm", D,
        (str(JEpilogue(act="relu", has_bias=True)),)),
       ("sddmm", "sddmm", K, ()),
       ("fused_attn", "fused_attn", K + D, ("leaky_relu", "0.2")),
       ("spmv", "spmv", 1, ())]


@pytest.mark.parametrize("op,tag,width,extra", OPS,
                         ids=[o[0] for o in OPS])
@pytest.mark.parametrize("winner", ["csr", "sell"])
def test_prefilled_cache_plans_the_same_in_both_packages(
        tmp_path, op, tag, width, extra, winner):
    dense = _dense(15, 0.9)
    dense[np.arange(N), (np.arange(N) + 1) % N] = 1.0  # every row an edge
    formats = ("ell", "csr", "sell")
    a, ja = _pair(dense, formats)
    key = j_make_key(tag, ja.stats.shape, width, jnp.dtype(jnp.float32),
                     ja.stats.density) + extra
    assert make_key(tag, a.stats.shape, width, torch.float32,
                    a.stats.density) + extra == key
    cache, jcache = _prefilled(tmp_path, key, winner)
    run, jrun, want = _run_op(op, a, ja, dense)
    got = run(policy="autotune", autotune_cache=cache)
    jgot = jrun(policy="autotune", autotune_cache=jcache)
    from repro.dispatch import dispatch_log as j_dispatch_log
    from repro_torch.dispatch import dispatch_log

    plan, jplan = dispatch_log()[-1], j_dispatch_log()[-1]
    assert plan.path == jplan.path == winner
    assert plan.reason == jplan.reason == "autotune: cached winner"
    assert plan.op == jplan.op and plan.timings_us == jplan.timings_us
    assert cache.hits == jcache.hits == 1
    assert cache.misses == jcache.misses == 0
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(jgot), **TOL)
    np.testing.assert_allclose(got, want, **TOL)


def test_cached_winner_outside_the_candidates_falls_back(tmp_path):
    """A winner the matrix cannot run (a cache shared by matrices of other
    forms) gives way to the fastest timed candidate it can run."""
    dense = _dense(16, 0.9)
    a, ja = _pair(dense, ("ell", "csr"))
    key = j_make_key("spmm", ja.stats.shape, D, jnp.dtype(jnp.float32),
                     ja.stats.density)
    cache, jcache = _prefilled(tmp_path, key, "sell")
    h = _normal(17, N, D)
    matmul(a, torch.from_numpy(h), policy="autotune", autotune_cache=cache)
    j_matmul(ja, h, policy="autotune", autotune_cache=jcache)
    from repro.dispatch import last_plan as j_last

    assert last_plan("spmm").path == j_last("spmm").path == "csr"


def test_autotune_measures_each_candidate_once_and_memoizes():
    dense = _dense(18, 0.9)
    a = SparseMatrix.from_dense(dense, formats=("ell", "csr"), block=BLOCK,
                                device="cpu")
    cache = AutotuneCache()
    h = torch.from_numpy(_normal(19, N, D))
    y = matmul(a, h, policy="autotune", autotune_cache=cache)
    plan = last_plan("spmm")
    assert plan.policy == "autotune" and plan.reason.startswith(
        "autotune: measured")
    assert set(plan.timings_us) == {"ell", "csr", "dense"}
    np.testing.assert_allclose(y.numpy(), dense @ h.numpy(), **TOL)
    # the same matrix: the plan memo; a fresh memo: the autotune cache
    matmul(a, h, policy="autotune", autotune_cache=cache)
    assert last_plan("spmm") is plan and len(cache) == 1
    matmul(a.with_stats(a.stats), h, policy="autotune",
           autotune_cache=cache)
    assert last_plan("spmm").reason == "autotune: cached winner"
    assert last_plan("spmm").path == plan.path
