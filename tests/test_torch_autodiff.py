"""Port parity: the SpMM <-> SDDMM backward rules (``torch.autograd``
Functions of ``repro_torch.sparse.autodiff``) against ``jax.grad`` of the
reference's ``custom_vjp`` rules, on the same numpy inputs.

Each rule on every path (ell over an ell and over a coo form, csr, sell,
dense) at sparsity 0.5, 0.9 and 0.99: SpMM ``dA`` (on the read form's
values) and ``dH``, SDDMM ``dA``, ``dB`` and ``dC`` (rtol = atol = 1e-5,
``tests/test_sparse_api.py``'s gradient tolerance); the fused epilogue's
``dh``, ``dbias`` and ``dresidual`` and the fused attention's ``dq``,
``dk`` and ``dv`` (rtol 1e-4, atol 1e-5, ``tests/test_fused.py``'s);
the reference's gradients are taken under ``jax.jit``, as its GNN tests
and example take them (its rules record their plans while they are
traced).
Structural zeros get zero gradient; ``A.T`` densifies as the reference's
does; and the ``policy="vjp"`` plans a backward records match the
reference's when every input, A's values included, needs a gradient (a
rule no input needs is skipped and not recorded).
"""
import dataclasses
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dispatch.dispatcher import clear_log as j_clear_log
from repro.dispatch.dispatcher import dispatch_log as j_dispatch_log
from repro.sparse import SparseMatrix as JSparseMatrix
from repro.sparse import autodiff as j_autodiff
from repro.sparse import fused_graph_attention as j_fused_attention
from repro.sparse import matmul as j_matmul
from repro.sparse import sddmm as j_sddmm
from repro_torch.dispatch.dispatcher import clear_log, dispatch_log
from repro_torch.sparse import autodiff
from repro_torch.sparse.matrix import SparseMatrix
from repro_torch.sparse.ops import fused_graph_attention, matmul, sddmm

SPARSITIES = (0.5, 0.9, 0.99)
# (dispatch path, the one form the matrix carries)
PATH_FORMS = [("ell", "ell"), ("ell", "coo"), ("csr", "csr"),
              ("sell", "sell"), ("dense", "ell")]
N, D, K = 48, 8, 4
BLOCK = (16, 16)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
FUSED_TOL = dict(rtol=1e-4, atol=1e-5)


def _dense(seed, sparsity, n=N):
    rng = np.random.default_rng(seed)
    a = np.where(rng.random((n, n)) < 1.0 - sparsity,
                 rng.normal(size=(n, n)), 0.0).astype(np.float32)
    a[0, 1] = 1.0  # at least one edge, so each row softmax has work
    return a


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _pair(dense, fmt):
    return (SparseMatrix.from_dense(dense, formats=(fmt,), block=BLOCK,
                                    device="cpu"),
            JSparseMatrix.from_dense(dense, formats=(fmt,), block=BLOCK))


def _leaf(x):
    return torch.tensor(np.asarray(x)).requires_grad_(True)


def _close(got, want, tol, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg=what, **tol)


def _dA_dense(a, grad_vals):
    """A cotangent on the primary form's values, densified."""
    return a.with_data(grad_vals.detach()).to_dense()


CASES = [(p, f, s) for p, f in PATH_FORMS for s in SPARSITIES]
IDS = [f"{p}-{f}-{s}" for p, f, s in CASES]


@pytest.mark.parametrize("path,fmt,sparsity", CASES, ids=IDS)
def test_spmm_grads_match_reference(path, fmt, sparsity):
    dense = _dense(1, sparsity)
    a, ja = _pair(dense, fmt)
    h, w = _normal(2, N, D), _normal(3, N, D)

    def j_loss(vals, hh):
        return jnp.sum(jnp.tanh(j_matmul(ja.with_data(vals), hh,
                                         policy=path)) * w)

    jdv, jdh = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(ja.data,
                                                      jnp.asarray(h))
    vals, th = _leaf(a.data.numpy()), _leaf(h)
    y = matmul(a.with_data(vals), th, policy=path)
    (torch.tanh(y) * torch.from_numpy(w)).sum().backward()
    _close(th.grad, jdh, GRAD_TOL, "dH")
    got = _dA_dense(a, vals.grad)
    _close(torch.from_numpy(got), ja.with_data(jdv).to_dense(), GRAD_TOL,
           "dA")
    assert (got[dense == 0] == 0).all(), "a structural zero got a gradient"
    assert (vals.grad[a.data == 0] == 0).all()


@pytest.mark.parametrize("path,fmt,sparsity", CASES, ids=IDS)
def test_sddmm_grads_match_reference(path, fmt, sparsity):
    dense = _dense(4, sparsity)
    a, ja = _pair(dense, fmt)
    b, c = _normal(5, N, K), _normal(6, K, N)

    def j_loss(vals, bb, cc):
        s = j_sddmm(ja.with_data(vals), bb, cc, policy=path)
        return jnp.sum(jnp.sin(s.densify()))

    jdv, jdb, jdc = jax.jit(jax.grad(j_loss, argnums=(0, 1, 2)))(
        ja.data, jnp.asarray(b), jnp.asarray(c))
    vals, tb, tc = _leaf(a.data.numpy()), _leaf(b), _leaf(c)
    s = sddmm(a.with_data(vals), tb, tc, policy=path)
    torch.sin(s.densify()).sum().backward()
    _close(tb.grad, jdb, GRAD_TOL, "dB")
    _close(tc.grad, jdc, GRAD_TOL, "dC")
    got = _dA_dense(a, vals.grad)
    _close(torch.from_numpy(got), ja.with_data(jdv).to_dense(), GRAD_TOL,
           "dA")
    assert (got[dense == 0] == 0).all(), "a structural zero got a gradient"


@pytest.mark.parametrize("path,fmt,sparsity", CASES, ids=IDS)
def test_epilogue_grads_match_reference(path, fmt, sparsity):
    dense = _dense(7, sparsity)
    a, ja = _pair(dense, fmt)
    h, bias, res, w = (_normal(8, N, D), _normal(9, D), _normal(10, N, D),
                       _normal(11, N, D))

    def j_loss(vals, hh, bb, rr):
        y = j_matmul(ja.with_data(vals), hh, policy=path, epilogue="relu",
                     bias=bb, residual=rr)
        return (y * w).sum()

    jgrads = jax.jit(jax.grad(j_loss, argnums=(0, 1, 2, 3)))(
        ja.data, jnp.asarray(h), jnp.asarray(bias), jnp.asarray(res))
    vals, th, tb, tr = (_leaf(a.data.numpy()), _leaf(h), _leaf(bias),
                        _leaf(res))
    y = matmul(a.with_data(vals), th, policy=path, epilogue="relu", bias=tb,
               residual=tr)
    (y * torch.from_numpy(w)).sum().backward()
    for name, got, want in zip(("dh", "dbias", "dresidual"),
                               (th.grad, tb.grad, tr.grad), jgrads[1:]):
        _close(got, want, FUSED_TOL, name)
    got = _dA_dense(a, vals.grad)
    _close(torch.from_numpy(got), ja.with_data(jgrads[0]).to_dense(),
           FUSED_TOL, "dA")
    assert (got[dense == 0] == 0).all(), "a structural zero got a gradient"


@pytest.mark.parametrize("path,fmt,sparsity", CASES, ids=IDS)
def test_fused_attention_grads_match_reference(path, fmt, sparsity):
    dense = _dense(12, sparsity)
    a, ja = _pair(dense, fmt)
    q, k, v, w = (_normal(13, N, 2), _normal(14, N, 2), _normal(15, N, D),
                  _normal(16, N, D))

    def j_loss(qq, kk, vv):
        return (j_fused_attention(ja, qq, kk, vv, policy=path) * w).sum()

    jgrads = jax.jit(jax.grad(j_loss, argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    vals, tq, tk, tv = _leaf(a.data.numpy()), _leaf(q), _leaf(k), _leaf(v)
    y = fused_graph_attention(a.with_data(vals), tq, tk, tv, policy=path)
    (y * torch.from_numpy(w)).sum().backward()
    for name, got, want in zip(("dq", "dk", "dv"),
                               (tq.grad, tk.grad, tv.grad), jgrads):
        _close(got, want, FUSED_TOL, name)
    # attention reads A's pattern only: its values get zeros
    assert torch.equal(vals.grad, torch.zeros_like(vals))


@pytest.mark.parametrize("fmt", ["ell", "coo", "csr", "sell"])
def test_transpose_matches_reference(fmt):
    dense = _dense(17, 0.9, n=40)[:, :35].copy()  # ragged, not square
    a, ja = _pair(dense, fmt)
    np.testing.assert_array_equal(a.T.to_dense(), np.asarray(ja.T.to_dense()))
    np.testing.assert_array_equal(a.T.to_dense(), dense.T)
    assert a.T.formats == ja.T.formats
    assert a.T.T is a and a.T is a.T  # memoized both ways
    assert dataclasses.asdict(a.T.stats) == dataclasses.asdict(ja.T.stats)
    # no reference cycle: a matrix is freed with its last reference, its
    # transpose's device memory with it
    ref = weakref.ref(a)
    del a
    assert ref() is None


def test_transposed_sell_operand_runs_as_elements():
    dense = _dense(18, 0.9)
    a, ja = _pair(dense, "sell")
    h = _normal(19, N, D)
    assert autodiff.form_read_by(a.T, "sell") == "csr" \
        == j_autodiff.form_read_by(ja.T, "sell")
    got = autodiff.spmm_exec("sell", a.T, torch.from_numpy(h))
    want = j_autodiff.spmm_exec(("sell", False, False, None, None), ja.T,
                                jnp.asarray(h))
    _close(got, want, GRAD_TOL, "Aᵀ H on the transposed sell operand")
    b, c = _normal(20, N, K), _normal(21, K, N)
    got = autodiff.sample_exec("sell", a.T, torch.from_numpy(b),
                               torch.from_numpy(c))
    want = j_autodiff.sample_exec(("sell", False, False, None, None), ja.T,
                                  jnp.asarray(b), jnp.asarray(c))
    _close(got, want, GRAD_TOL, "sampled dots on the transposed sell operand")


def _vjp_plans(log):
    return [(p.op, p.path, p.reason) for p in log if p.policy == "vjp"]


@pytest.mark.parametrize("path", ["ell", "sell", "csr", "dense"])
def test_spmm_backward_plans_match_reference(path):
    fmt = {"csr": "csr", "sell": "sell"}.get(path, "ell")
    a, ja = _pair(_dense(22, 0.9), fmt)
    h = _normal(23, N, D)
    j_clear_log()
    jax.jit(jax.grad(lambda v, hh: jnp.sum(j_matmul(
        ja.with_data(v), hh, policy=path) ** 2), argnums=(0, 1)))(
            ja.data, jnp.asarray(h))
    vals, th = _leaf(a.data.numpy()), _leaf(h)
    clear_log()
    (matmul(a.with_data(vals), th, policy=path) ** 2).sum().backward()
    want = _vjp_plans(j_dispatch_log())
    assert _vjp_plans(dispatch_log()) == want
    assert [op for op, _, _ in want] == ["spmm", "sddmm"]
    # A's values need no gradient: the dA SDDMM is skipped, not recorded
    clear_log()
    (matmul(a, _leaf(h), policy=path) ** 2).sum().backward()
    assert _vjp_plans(dispatch_log()) == want[:1]


def test_sddmm_backward_plans_match_reference():
    mask = (_dense(24, 0.9) != 0).astype(np.float32)
    a, ja = _pair(mask, "csr")
    b, c = _normal(25, N, 2), _normal(26, 2, N)
    j_clear_log()
    jax.jit(jax.grad(lambda v, bb, cc: jnp.sum(j_sddmm(
        ja.with_data(v), bb, cc, policy="csr").data ** 2),
        argnums=(0, 1, 2)))(ja.data, jnp.asarray(b), jnp.asarray(c))
    vals, tb, tc = _leaf(a.data.numpy()), _leaf(b), _leaf(c)
    clear_log()
    (sddmm(a.with_data(vals), tb, tc, policy="csr").data ** 2).sum() \
        .backward()
    want = _vjp_plans(j_dispatch_log())
    assert _vjp_plans(dispatch_log()) == want
    assert want == [("spmm", "csr", r) for _, _, r in want] \
        and len(want) == 2  # dB and dC


@pytest.mark.parametrize("path", ["ell", "sell", "csr"])
def test_fused_attention_backward_plans_match_reference(path):
    a, ja = _pair(_dense(27, 0.9, n=32), {"csr": "csr"}.get(path, path))
    q, k, v = _normal(28, 32, 2), _normal(29, 32, 2), _normal(30, 32, D)
    j_clear_log()
    jax.jit(jax.grad(lambda vv: j_fused_attention(
        ja, q, k, vv, policy=path).sum()))(jnp.asarray(v))
    want = _vjp_plans(j_dispatch_log())
    assert [op for op, _, _ in want] == ["sddmm"] * 2 + ["spmm"] * 3
    # on the ell path over a Block-ELL form (dk = 2) one K7b launch takes
    # the place of the score recompute, dα and dq; dk and dV as the
    # reference's
    fused = [("attention", "ell", "vjp: fused attention backward (K7b)")]
    if path == "ell":
        want_all, want_v = fused + want[3:], fused + want[-1:]
    else:
        want_all, want_v = want, [want[0], want[-1]]
    vals, tq, tk, tv = _leaf(a.data.numpy()), _leaf(q), _leaf(k), _leaf(v)
    clear_log()
    fused_graph_attention(a.with_data(vals), tq, tk, tv, policy=path).sum() \
        .backward()
    assert _vjp_plans(dispatch_log()) == want_all
    # only V needs a gradient: the score recompute and dV run, no more
    clear_log()
    fused_graph_attention(a, torch.from_numpy(q), torch.from_numpy(k), tv,
                          policy=path).sum().backward()
    assert _vjp_plans(dispatch_log()) == want_v
