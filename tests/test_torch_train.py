"""Port parity for the slice as a whole: GCN and GAT training.

On ``SMOKE_CONFIG`` the JAX package's models (``jax.value_and_grad`` of
the example's full-batch NLL, jitted as ``examples/gnn_train.py`` jits
it) and the port's trainer (``repro_torch.train.gnn`` on the CPU) take
the same numpy weights (JAX's He init through ``*_params_from_numpy``),
features and planted labels, fused and unfused, on graphs planned onto
the ell, csr and sell paths: the same loss and
the gradient of every parameter within rtol 1e-4, atol 1e-5 (the
reference's fused-gradient tolerance, ``tests/test_fused.py``: three
layers of f32 sums, and for GAT the softmax's exp, in another order).
Three SGD steps give the same parameters within 1e-4.  The trainer's
command line runs on the CPU when asked and raises without a card
otherwise.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_gnn import SMOKE_CONFIG as J_SMOKE
from repro.models.gnn import build_graph as j_build_graph
from repro.models.gnn import gat_forward as j_gat_forward
from repro.models.gnn import gcn_forward as j_gcn_forward
from repro.models.gnn import init_gat as j_init_gat
from repro.models.gnn import init_gcn as j_init_gcn
from repro_torch.configs.paper_gnn import SMOKE_CONFIG
from repro_torch.data.pipeline import random_graph
from repro_torch.dispatch.dispatcher import clear_log, dispatch_log
from repro_torch.models.gnn import (build_graph, gat_params_from_numpy,
                                    gcn_params_from_numpy)
from repro_torch.train import gnn as trainer

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-5)
N = 256
LR = 0.05
J_FORWARD = {"gcn": j_gcn_forward, "gat": j_gat_forward}


def _adjacency(kind):
    if kind == "ell":  # uniform density 0.1: plans ell
        rng = np.random.default_rng(7)
        return (rng.random((N, N)) < 0.1).astype(np.float32)
    if kind == "sell":  # skewed, > 99 % sparse: packs and plans sell
        return random_graph(N, 1.0, seed=1)
    rng = np.random.default_rng(7)
    return (rng.random((N, N)) < 0.01).astype(np.float32)  # plans csr


def _inputs(kind, adj):
    """Numpy weights (the JAX package's init), features and labels."""
    if kind == "gcn":
        jparams = j_init_gcn(jax.random.PRNGKey(0), J_SMOKE, bias=True)
    else:
        jparams = j_init_gat(jax.random.PRNGKey(0), J_SMOKE)
    nparams = {k: [np.asarray(x) for x in v] for k, v in jparams.items()}
    x = np.random.default_rng(2).normal(
        size=(adj.shape[0], SMOKE_CONFIG.in_features)).astype(np.float32)
    labels = trainer.planted_labels(adj.shape[0], SMOKE_CONFIG.n_classes)
    return nparams, x, labels


def _port(kind, adj, nparams, x, labels):
    from_numpy = gcn_params_from_numpy if kind == "gcn" \
        else gat_params_from_numpy
    params = trainer.trainable(from_numpy(nparams, "cpu"))
    graph = build_graph(adj, SMOKE_CONFIG, device="cpu")
    return params, graph, torch.from_numpy(x), torch.from_numpy(labels)


def _reference(kind, adj, x, labels, fuse):
    """The example's jitted value-and-grad and SGD step."""
    graph = j_build_graph(adj, J_SMOKE)
    fwd = J_FORWARD[kind]
    x, labels = jnp.asarray(x), jnp.asarray(labels.astype(np.int32))

    def loss_fn(params):
        logits = fwd(params, graph, x, policy="auto", fuse=fuse)
        logp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.take_along_axis(logp, labels[:, None], 1).mean()

    grad_fn = jax.jit(jax.value_and_grad(loss_fn))

    @jax.jit
    def step(params):
        _, g = jax.value_and_grad(loss_fn)(params)
        return jax.tree_util.tree_map(lambda p, gg: p - LR * gg, params, g)

    return grad_fn, step


def _jparams(nparams):
    return {k: [jnp.asarray(x) for x in v] for k, v in nparams.items()}


@pytest.mark.parametrize("graph_kind", ["ell", "csr", "sell"])
@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("kind", ["gcn", "gat"])
def test_loss_and_grads_match_reference(kind, fuse, graph_kind):
    adj = _adjacency(graph_kind)
    nparams, x, labels = _inputs(kind, adj)
    params, graph, tx, tlabels = _port(kind, adj, nparams, x, labels)
    clear_log()
    loss, acc, grads = trainer.loss_and_grads(params, graph, tx, tlabels,
                                              kind=kind, fuse=fuse)
    # the forward ran on the planned path, the backward on the same one
    # (the unfused GAT samples on the csr pattern: csr or dense)
    paths = {p.path for p in dispatch_log()}
    if kind == "gat" and not fuse:
        assert len(paths) == 1 and paths <= {"csr", "dense"}, paths
    else:
        assert paths == {graph_kind}, paths
    assert any(p.policy == "vjp" for p in dispatch_log())
    grad_fn, _ = _reference(kind, adj, x, labels, fuse)
    jloss, jgrads = grad_fn(_jparams(nparams))
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    assert 0.0 <= float(acc) <= 1.0
    assert sorted(grads) == sorted(jgrads)
    for key in grads:
        for i, (got, want) in enumerate(zip(grads[key], jgrads[key])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       err_msg=f"d{key}[{i}]", **TOL)


@pytest.mark.parametrize("kind", ["gcn", "gat"])
def test_three_sgd_steps_match_reference(kind):
    adj = _adjacency("sell")
    nparams, x, labels = _inputs(kind, adj)
    params, graph, tx, tlabels = _port(kind, adj, nparams, x, labels)
    _, step = _reference(kind, adj, x, labels, fuse=True)
    jparams = _jparams(nparams)
    losses = []
    for _ in range(3):
        loss, _ = trainer.train_step(params, graph, tx, tlabels, kind=kind,
                                     lr=LR)
        losses.append(float(loss))
        jparams = step(jparams)
    assert losses[-1] < losses[0]
    for key in params:
        for got, want in zip(params[key], jparams[key]):
            np.testing.assert_allclose(got.detach().numpy(),
                                       np.asarray(want), rtol=1e-4, atol=1e-4)


def test_command_line_trains_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.train.gnn", "--device", "cpu",
         "--n", "256", "--steps", "3"], capture_output=True, text=True,
        env=env, cwd=ROOT, timeout=300, check=True).stdout
    assert "step    0  loss" in out and "step    2  loss" in out
    assert "gcn trained 3 steps" in out
    assert "last spmm plan: spmm->" in out


def test_trainer_needs_a_card_unless_asked_for_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trainer.main(["--n", "64", "--steps", "1"])
    with pytest.raises(RuntimeError, match="is_available"):
        trainer.init_params("gcn", SMOKE_CONFIG)
    trainer.main(["--kind", "gat", "--n", "64", "--steps", "2",
                  "--device", "cpu"])
    assert "gat trained 2 steps" in capsys.readouterr().out


def test_precision_probe_needs_a_card(monkeypatch, capsys):
    """The gradient-precision probe runs only on a card: without one it
    exits 2 before it imports ``chip_smoke`` or builds anything."""
    from repro_torch.train import precision

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delitem(sys.modules, "chip_smoke", raising=False)
    assert precision.main() == 2
    assert "needs a CUDA card" in capsys.readouterr().err
    assert "chip_smoke" not in sys.modules
