"""Port parity of MLP weight pruning (``repro_torch.models.pruning``)
against ``repro.models.pruning``.

* ``magnitude_prune`` returns the reference's array exactly at prune
  blocks (1, 1), (4, 4) and (8, 8), and its errors;
* ``sparsify_lm``'s plans equal the reference's at the widths an LM runs
  (D = 8 at decode, 512 at prefill) on 64 x 64 storage tiles: dense for
  (8, 8) pruning tiles (nearly every 64 x 64 tile keeps one: occupancy ≈
  0.999, as at gemma3-4b's full width), ell for (64, 64) pruning tiles
  (whole storage tiles dropped), on a 256 x 1024 weight, which keeps those
  occupancies;
* ``weight_sparsity_report`` and ``dense_reference`` equal the
  reference's on a pruned gemma3 smoke model (the kept weights exactly);
* that model's forward, prefill and decode logits against the
  reference's sparse model (rtol = atol = 5e-5, stated in
  ``tests/test_torch_lm_parity.py``) and against the port's own
  ``dense_reference`` of it;
* ``dense_reference``'s dense weights are not held by the densify memo.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dispatch.dispatcher import plan_spmm as j_plan_spmm
from repro.models import pruning as JP
from repro.models import transformer as JT
from repro.sparse.ops import available_paths as j_available_paths
from repro_torch.configs import get_smoke_config
from repro_torch.dispatch.dispatcher import plan_spmm
from repro_torch.models import pruning as P
from repro_torch.models import transformer as T
from repro_torch.sparse.ops import available_paths

import test_torch_lm_parity as LP


@pytest.mark.parametrize("block", [(1, 1), (4, 4), (8, 8)])
@pytest.mark.parametrize("sparsity", [0.0, 0.5, 0.9])
def test_magnitude_prune_equals_reference(block, sparsity):
    w = np.random.default_rng(0).normal(size=(64, 96)).astype(np.float32)
    got = P.magnitude_prune(torch.from_numpy(w), sparsity, block)
    want = np.asarray(JP.magnitude_prune(jnp.asarray(w), sparsity, block))
    assert got.dtype == np.float32
    assert np.array_equal(got, want)


def test_magnitude_prune_errors():
    w = np.ones((8, 8), np.float32)
    with pytest.raises(ValueError):
        P.magnitude_prune(w, 1.0)
    with pytest.raises(ValueError):
        P.magnitude_prune(w, 0.5, block=(3, 3))


def _weight_plans(sparse_of, plan, avail, w):
    """The plans of ``x @ W`` (``Wᵀ xᵀ``) at decode and prefill widths."""
    wt = sparse_of(w).T
    return {d: plan(wt.stats, d, candidates=avail(wt)).path
            for d in (8, 512)}


@pytest.mark.parametrize("prune_block,want", [((8, 8), "dense"),
                                              ((64, 64), "ell")])
def test_plans_equal_reference(prune_block, want):
    rng = np.random.default_rng(1)
    w = (rng.normal(size=(256, 1024)) / 16).astype(np.float32)
    kw = dict(sparsity=0.9, prune_block=prune_block, formats=("ell", "csr"),
              format="auto", block=(64, 64))
    got = _weight_plans(lambda a: P._to_sparse(torch.from_numpy(a), **kw),
                        plan_spmm, available_paths, w)
    ref = _weight_plans(lambda a: JP._to_sparse(jnp.asarray(a), **kw),
                        j_plan_spmm, j_available_paths, w)
    assert got == ref == {8: want, 512: want}


@pytest.mark.parametrize("d", [8, 512])
def test_dense_planned_weight_promotes_bf16_activations(d):
    """``x @ W`` with bf16 activations on an f32 weight pruned at (8, 8)
    tiles, which plans dense: the product is taken in f32, the common type,
    as ``jnp.matmul`` takes the reference's, and held to the reference."""
    rng = np.random.default_rng(2)
    w = (rng.normal(size=(256, 1024)) / 16).astype(np.float32)
    x = rng.normal(size=(d, 256)).astype(np.float32)
    kw = dict(sparsity=0.9, prune_block=(8, 8), formats=("ell", "csr"),
              format="auto", block=(64, 64))
    wp = P._to_sparse(torch.from_numpy(w), **kw)
    assert _weight_plans(lambda _: wp, plan_spmm, available_paths, w)[d] \
        == "dense"
    got = torch.from_numpy(x).bfloat16() @ wp
    want = np.asarray(jnp.asarray(x, jnp.bfloat16)
                      @ JP._to_sparse(jnp.asarray(w), **kw))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def _pruned_models(arch="gemma3-4b"):
    jcfg, cfg = LP.cfgs(arch)
    jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    params = T.lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    kw = dict(sparsity=0.8, prune_block=(4, 4), block=(8, 8))
    return (jcfg, cfg, JP.sparsify_lm(jparams, jcfg, **kw),
            P.sparsify_lm(params, cfg, **kw))


def test_report_and_dense_reference_equal():
    jcfg, cfg, jsp, sp = _pruned_models()
    assert P.weight_sparsity_report(sp) == JP.weight_sparsity_report(jsp)
    assert P.weight_sparsity_report(sp)["n_sparse"] == 3 * cfg.n_layers
    got, want = P.dense_reference(sp), JP.dense_reference(jsp)
    leaves = T.tree_leaves(got)
    wants = jax.tree_util.tree_leaves(want)
    assert len(leaves) == len(wants)
    for g, w in zip(leaves, wants):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_dense_reference_is_not_memoized():
    """The oracle's dense weights belong to its tree alone: the densify
    memo holds none of them, so dropping the tree frees them while the
    sparse model lives on."""
    from repro_torch.sparse import matrix as M

    _, _, _, sp = _pruned_models()
    weights = [w for w in T.tree_leaves(sp, is_leaf=P._is_sparse)
               if P._is_sparse(w)]
    before = set(M._DENSE_MEMO)
    dense = P.dense_reference(sp)
    assert set(M._DENSE_MEMO) == before
    leaves = T.tree_leaves(dense)
    assert all(not any(x is v[1] for v in M._DENSE_MEMO.values())
               for x in leaves)
    assert torch.equal(weights[0].densify(), weights[0].dense_copy())


def test_pruned_model_logits():
    jcfg, cfg, jsp, sp = _pruned_models()
    dense = P.dense_reference(sp)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (2, 28)).astype(np.int32)
    with torch.no_grad():
        h, _, _ = T.forward_hidden(sp, cfg, torch.from_numpy(toks[:, :24]),
                                   remat=False)
        hd, _, _ = T.forward_hidden(dense, cfg,
                                    torch.from_numpy(toks[:, :24]),
                                    remat=False)
    jh, _, _ = JT.forward_hidden(jsp, jcfg, jnp.asarray(toks[:, :24]),
                                 remat=False)
    LP.close(h, jh)
    LP.close(h, hd)
    logits, cache = T.prefill(sp, cfg, torch.from_numpy(toks[:, :24]), 28)
    jlogits, jcache = JT.prefill(jsp, jcfg, jnp.asarray(toks[:, :24]), 28)
    dlogits, dcache = T.prefill(dense, cfg, torch.from_numpy(toks[:, :24]),
                                28)
    for t in range(24, 29):
        LP.close(logits, jlogits, what=f"pos {t}")
        LP.close(logits, dlogits, what=f"pos {t}")
        if t == 28:
            break
        tok = toks[:, t:t + 1]
        logits, cache = T.decode_step(sp, cfg, torch.from_numpy(tok), cache)
        jlogits, jcache = JT.decode_step(jsp, jcfg, jnp.asarray(tok), jcache)
        dlogits, dcache = T.decode_step(dense, cfg, torch.from_numpy(tok),
                                        dcache)
