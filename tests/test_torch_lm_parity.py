"""Shared by the LM parity tests (no tests of its own): one arch's smoke
model run through the JAX package (under ``jax.jit``, as its own tests
run it) and through the port on the CPU, on the same weights and inputs.

Weights are the reference's ``init_lm`` draws crossed leaf by leaf with
``lm_params_from_numpy``; tokens and modality embeddings are numpy draws
from a seed.  The reference's outputs are computed once per arch
(``reference``) and kept as numpy arrays.

Tolerance (``MODEL_TOL``): rtol = atol = 5e-5 on f32 logits and hidden
states of magnitude ≈ 3: the same f32 sums over two to seven layers in
another order, and on the RG-LRU a scan that combines in another order.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import ARCHS, get_smoke_config as j_smoke
from repro.models import transformer as JT
from repro_torch.configs import get_smoke_config
from repro_torch.models import transformer as T

LM_ARCHS = [a for a in ARCHS if a != "paper-gnn"]
MODEL_TOL = dict(rtol=5e-5, atol=5e-5)
B, S, N_DECODE = 2, 32, 8


def cfgs(arch):
    return (dataclasses.replace(j_smoke(arch), dtype="float32"),
            dataclasses.replace(get_smoke_config(arch), dtype="float32"))


def close(got, want, tol=MODEL_TOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), err_msg=what,
                               **tol)


def leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    n_text = S - cfg.vision_tokens
    toks = rng.integers(0, cfg.vocab_size, (B, n_text + N_DECODE + 1)
                        ).astype(np.int32)
    side = {}
    if cfg.vision_tokens:
        side["vision_embeds"] = rng.normal(
            size=(B, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.encoder_layers:
        side["enc_embeds"] = rng.normal(
            size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    batch = {"tokens": toks[:, :n_text], "targets": toks[:, 1:n_text + 1],
             "mask": (rng.random((B, n_text)) < 0.9).astype(np.float32)}
    batch.update(side)
    return toks, side, batch


def torch_tree(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


@functools.lru_cache(maxsize=None)
def reference(arch):
    """The reference's params (numpy) and outputs for ``arch``."""
    jcfg, _ = cfgs(arch)
    params = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    toks, side, batch = inputs(jcfg)
    n_text = S - jcfg.vision_tokens
    jside = {k: jnp.asarray(v) for k, v in side.items()}
    fwd = jax.jit(lambda p, t, s: JT.forward_hidden(
        p, jcfg, t, mode="train", remat=False, **s))
    hidden, _, aux = fwd(params, jnp.asarray(toks[:, :n_text]), jside)
    max_len = S + N_DECODE
    pre = jax.jit(lambda p, t, s: JT.prefill(p, jcfg, t, max_len, **s))
    dec = jax.jit(lambda p, t, c: JT.decode_step(p, jcfg, t, c))
    logits, cache = pre(params, jnp.asarray(toks[:, :n_text]), jside)
    steps = [(np.asarray(logits), leaves(cache))]
    for t in range(N_DECODE):
        tok = jnp.asarray(toks[:, n_text + t:n_text + t + 1])
        logits, cache = dec(params, tok, cache)
        steps.append((np.asarray(logits), leaves(cache)))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss = jax.jit(lambda p, b: JT.lm_loss(p, jcfg, b))(params, jbatch)
    return {"params": jax.tree_util.tree_map(np.asarray, params),
            "toks": toks, "side": side, "batch": batch,
            "hidden": np.asarray(hidden), "aux": float(aux),
            "steps": steps, "loss": float(loss)}


def check_forward(arch):
    _, cfg = cfgs(arch)
    ref = reference(arch)
    params = T.lm_params_from_numpy(ref["params"], device="cpu")
    n_text = S - cfg.vision_tokens
    with torch.no_grad():
        hidden, cache, aux = T.forward_hidden(
            params, cfg, torch.from_numpy(ref["toks"][:, :n_text]),
            mode="train", remat=False, **torch_tree(ref["side"]))
    assert cache is None
    close(hidden, ref["hidden"], what="hidden")
    np.testing.assert_allclose(float(aux), ref["aux"], rtol=1e-5, atol=1e-6)


def check_prefill_decode(arch):
    """Prefill, then N_DECODE decode steps: the logits and every cache
    leaf (in the reference's flatten order) after each."""
    _, cfg = cfgs(arch)
    ref = reference(arch)
    params = T.lm_params_from_numpy(ref["params"], device="cpu")
    toks = ref["toks"]
    n_text = S - cfg.vision_tokens
    logits, cache = T.prefill(params, cfg, torch.from_numpy(toks[:, :n_text]),
                              S + N_DECODE, **torch_tree(ref["side"]))
    for t, (want_logits, want_cache) in enumerate(ref["steps"]):
        if t:
            tok = torch.from_numpy(toks[:, n_text + t - 1:n_text + t])
            logits, cache = T.decode_step(params, cfg, tok, cache)
        close(logits, want_logits, what=f"logits, step {t}")
        got_cache = T.tree_leaves(cache)
        assert len(got_cache) == len(want_cache)
        for i, (g, w) in enumerate(zip(got_cache, want_cache)):
            assert tuple(g.shape) == w.shape, (t, i)
            if w.dtype.kind in "iu":
                assert np.array_equal(g.numpy(), w), (t, i)
            else:
                close(g, w, what=f"cache leaf {i}, step {t}")


def check_loss(arch):
    _, cfg = cfgs(arch)
    ref = reference(arch)
    params = T.lm_params_from_numpy(ref["params"], device="cpu")
    with torch.no_grad():
        loss = T.lm_loss(params, cfg, torch_tree(ref["batch"]))
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-5)


def check_param_count(arch):
    """The port's ``init_lm`` gives the reference's tree and shapes, and
    its count equals the analytic ``param_count``."""
    jcfg, cfg = cfgs(arch)
    params = T.init_lm(cfg, seed=0, device="cpu")
    n = sum(x.numel() for x in T.tree_leaves(params))
    assert n == cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    want = jax.eval_shape(lambda: JT.init_lm(jax.random.PRNGKey(0), jcfg))
    assert [tuple(x.shape) for x in T.tree_leaves(params)] \
        == [tuple(x.shape) for x in jax.tree_util.tree_leaves(want)]


def check_grads(arch):
    """``lm_loss``'s gradient w.r.t. every parameter against
    ``jax.grad``, each leaf within 1e-4 x its max|want| + 1e-6 (f32 sums
    of the backward in another order)."""
    jcfg, cfg = cfgs(arch)
    ref = reference(arch)
    jbatch = {k: jnp.asarray(v) for k, v in ref["batch"].items()}
    want = jax.jit(jax.grad(lambda p: JT.lm_loss(p, jcfg, jbatch)))(
        jax.tree_util.tree_map(jnp.asarray, ref["params"]))
    params = T.lm_params_from_numpy(ref["params"], device="cpu")
    flat = T.tree_leaves(params)
    for x in flat:
        x.requires_grad_(True)
    loss = T.lm_loss(params, cfg, torch_tree(ref["batch"]))
    grads = torch.autograd.grad(loss, flat)
    wants = leaves(want)
    assert len(grads) == len(wants)
    for i, (g, w) in enumerate(zip(grads, wants)):
        tol = 1e-4 * float(np.abs(w).max()) + 1e-6
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol,
                                   err_msg=f"grad leaf {i}")
