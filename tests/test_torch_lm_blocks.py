"""Port parity of the LM's non-attention blocks against the JAX package,
on the same numpy weights and inputs, f32:

* ``moe_ffn`` (``repro_torch.models.moe``, the single-device branch) at a
  capacity that drops tokens and at one that drops none, with the set of
  kept tokens equal to the reference's; top-k ties go to the lower index;
* ``ssd_chunked`` at two chunk sizes (and across them), ``ssm_forward``
  with and without a carried state and conv tail, and
  ``ssm_decode_step``;
* ``rglru_forward`` with and without a carried state and
  ``rglru_decode_step`` (the port scans in another order);
* the port's ``init_moe`` / ``init_ssm`` / ``init_rglru`` trees and shapes.

Tolerance rtol = atol = 5e-5 (f32 sums in another order; the SSD's
exponentials of cumulative decays), 1e-4 for the RG-LRU's scan.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import moe as JM
from repro.models import rglru as JR
from repro.models import ssm as JS
from repro_torch.configs import get_smoke_config
from repro_torch.models import moe as M
from repro_torch.models import rglru as R
from repro_torch.models import ssm as S

TOL = dict(rtol=5e-5, atol=5e-5)
SCAN_TOL = dict(rtol=1e-4, atol=1e-4)


def _cfgs(arch, **kw):
    kw.setdefault("dtype", "float32")
    return (dataclasses.replace(j_smoke(arch), **kw),
            dataclasses.replace(get_smoke_config(arch), **kw))


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


def _weights(init, jcfg, seed):
    """The reference's init (its shapes and its constants), as numpy."""
    return jax.tree_util.tree_map(np.array,
                                  init(jax.random.PRNGKey(seed), jcfg))


def _both(tree):
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            jax.tree_util.tree_map(torch.from_numpy, tree))


def _shapes(tree):
    return jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), tree)


@pytest.mark.parametrize("arch,init,jinit", [
    ("llama4-scout-17b-a16e", M.init_moe, JM.init_moe),
    ("mamba2-2.7b", S.init_ssm, JS.init_ssm),
    ("recurrentgemma-2b", R.init_rglru, JR.init_rglru)])
def test_block_inits(arch, init, jinit):
    jcfg, cfg = _cfgs(arch)
    got = init(torch.Generator().manual_seed(0), cfg)
    assert _shapes(got) == _shapes(jinit(jax.random.PRNGKey(0), jcfg))


# -- MoE ---------------------------------------------------------------------


def _kept(jcfg, xf, router, cap):
    """Tokens the reference's dispatch keeps (top-1), from its own
    routing."""
    probs = jax.nn.softmax(jnp.asarray(xf) @ jnp.asarray(router), axis=-1)
    eid = np.asarray(jax.lax.top_k(probs, jcfg.top_k)[1][:, 0])
    kept, seen = set(), {}
    for t, e in enumerate(eid):  # stable: lower token index first
        seen[e] = seen.get(e, 0) + 1
        if seen[e] <= cap:
            kept.add(t)
    return kept


@pytest.mark.parametrize("factor", ["own", "n_experts"])
@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e",
                                  "llama4-maverick-400b-a17b"])
def test_moe_ffn(arch, factor):
    """The config's own capacity factor (1.25; the router skewed toward
    expert 0, which overflows and drops tokens) and capacity_factor =
    n_experts (none dropped)."""
    kw = {} if factor == "own" else dict(
        capacity_factor=float(get_smoke_config(arch).n_experts))
    jcfg, cfg = _cfgs(arch, **kw)
    w = _weights(JM.init_moe, jcfg, 1)
    w["router"][:, 0] *= 4.0  # skew the routing toward expert 0
    jp, tp = _both(w)
    x = np.random.default_rng(2).normal(size=(4, 16, cfg.d_model)).astype(
        np.float32)
    got, aux = M.moe_ffn(tp, torch.from_numpy(x), cfg)
    want, jaux = JM.moe_ffn(jp, jnp.asarray(x), jcfg)
    _close(got, want)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    # the same tokens kept: a dropped token gets the shared expert only
    xf = x.reshape(-1, cfg.d_model)
    cap = M._capacity(xf.shape[0], cfg)
    assert cap == JM._capacity(xf.shape[0], jcfg)
    kept = _kept(jcfg, xf, w["router"], cap)
    shared = JM.mlp(jp["shared"], jnp.asarray(xf), jcfg)
    routed = np.abs(np.asarray(got).reshape(xf.shape) - np.asarray(shared))
    got_kept = {t for t in range(xf.shape[0]) if routed[t].max() > 1e-6}
    assert got_kept == kept
    if factor == "own":
        assert len(kept) < xf.shape[0]
    else:
        assert len(kept) == xf.shape[0]


def test_top_k_ties_go_low():
    probs = torch.tensor([[0.25, 0.5, 0.5, 0.25], [0.1, 0.1, 0.1, 0.7]])
    vals, idx = M.top_k(probs, 2)
    jvals, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    assert np.array_equal(vals.numpy(), np.asarray(jvals))


# -- SSM ---------------------------------------------------------------------


def _ssd_inputs(seed, b=2, s=64, h=4, p=8, n=16):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, p)).astype(np.float32),
            np.log1p(np.exp(rng.normal(size=(b, s, h)))).astype(np.float32)
            * 0.1,
            np.log(np.linspace(1.0, 16.0, h)).astype(np.float32),
            rng.normal(size=(b, s, n)).astype(np.float32),
            rng.normal(size=(b, s, n)).astype(np.float32))


@pytest.mark.parametrize("chunk", [16, 64])
def test_ssd_chunked(chunk):
    """Two chunk sizes, each against the reference, and against each
    other; a carried initial state."""
    xs = _ssd_inputs(3)
    init = np.random.default_rng(4).normal(size=(2, 4, 8, 16)).astype(
        np.float32)
    ys = []
    for state in (None, init):
        kw_t = {} if state is None else {"init_state": torch.from_numpy(state)}
        kw_j = {} if state is None else {"init_state": jnp.asarray(state)}
        y, st = S.ssd_chunked(*map(torch.from_numpy, xs), chunk=chunk, **kw_t)
        jy, jst = JS.ssd_chunked(*map(jnp.asarray, xs), chunk=chunk, **kw_j)
        _close(y, jy)
        _close(st, jst)
        ys.append(y)
    y8, _ = S.ssd_chunked(*map(torch.from_numpy, xs), chunk=8)
    _close(ys[0], y8)


def test_ssm_forward_and_decode():
    """Prefill over 24 tokens returning its state, a continuation of 8
    from that state and conv tail (the same as 32 tokens at once), then 6
    decode steps from it."""
    jcfg, cfg = _cfgs("mamba2-2.7b", ssm_chunk=8)
    jp, tp = _both(_weights(JS.init_ssm, jcfg, 5))
    x = np.random.default_rng(6).normal(size=(2, 38, cfg.d_model)).astype(
        np.float32)
    y, c = S.ssm_forward(tp, torch.from_numpy(x[:, :24]), cfg,
                         return_state=True)
    jy, jc = JS.ssm_forward(jp, jnp.asarray(x[:, :24]), jcfg,
                            return_state=True)
    _close(y, jy)
    _close(c["state"], jc["state"])
    _close(c["conv"], jc["conv"])
    y2 = S.ssm_forward(tp, torch.from_numpy(x[:, 24:32]), cfg,
                       init_state=c["state"], conv_tail=c["conv"])
    jy2 = JS.ssm_forward(jp, jnp.asarray(x[:, 24:32]), jcfg,
                         init_state=jc["state"], conv_tail=jc["conv"])
    _close(y2, jy2)
    whole = S.ssm_forward(tp, torch.from_numpy(x[:, :32]), cfg)
    _close(whole[:, 24:], y2)
    cache = S.init_ssm_cache(cfg, 2, torch.float32, "cpu")
    assert _shapes(cache) == _shapes(JS.init_ssm_cache(jcfg, 2, jnp.float32))
    cache, jcache = c, jc
    for t in range(24, 30):
        yd, cache = S.ssm_decode_step(tp, torch.from_numpy(x[:, t:t + 1]),
                                      cache, cfg)
        jyd, jcache = JS.ssm_decode_step(jp, jnp.asarray(x[:, t:t + 1]),
                                         jcache, jcfg)
        _close(yd, jyd)
        _close(cache["state"], jcache["state"])
        _close(cache["conv"], jcache["conv"])


# -- RG-LRU -----------------------------------------------------------------


def test_linear_scan():
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 37, 5)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(2, 37, 5)).astype(np.float32))
    h, want = torch.zeros(2, 5), []
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    _close(R.linear_scan(a, b), torch.stack(want, 1), SCAN_TOL)


def test_rglru_forward_and_decode():
    jcfg, cfg = _cfgs("recurrentgemma-2b")
    jp, tp = _both(_weights(JR.init_rglru, jcfg, 8))
    x = np.random.default_rng(9).normal(size=(2, 40, cfg.d_model)).astype(
        np.float32)
    y, c = R.rglru_forward(tp, torch.from_numpy(x[:, :33]), cfg,
                           return_state=True)
    jy, jc = JR.rglru_forward(jp, jnp.asarray(x[:, :33]), jcfg,
                              return_state=True)
    _close(y, jy, SCAN_TOL)
    _close(c["h"], jc["h"], SCAN_TOL)
    _close(c["conv"], jc["conv"])
    y2 = R.rglru_forward(tp, torch.from_numpy(x[:, 33:]), cfg, h0=c["h"],
                         conv_tail=c["conv"])
    jy2 = JR.rglru_forward(jp, jnp.asarray(x[:, 33:]), jcfg, h0=jc["h"],
                           conv_tail=jc["conv"])
    _close(y2, jy2, SCAN_TOL)
    cache = R.init_rglru_cache(cfg, 2, torch.float32, "cpu")
    assert _shapes(cache) == _shapes(JR.init_rglru_cache(jcfg, 2,
                                                         jnp.float32))
    cache, jcache = c, jc
    for t in range(33, 40):
        yd, cache = R.rglru_decode_step(tp, torch.from_numpy(x[:, t:t + 1]),
                                        cache, cfg)
        jyd, jcache = JR.rglru_decode_step(jp, jnp.asarray(x[:, t:t + 1]),
                                           jcache, jcfg)
        _close(yd, jyd, SCAN_TOL)
        _close(cache["h"], jcache["h"], SCAN_TOL)
    whole = R.rglru_forward(tp, torch.from_numpy(x), cfg)
    _close(whole[:, 33:], y2, SCAN_TOL)
