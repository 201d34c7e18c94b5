"""Port parity: the SpMV lane (``repro_torch.sparse.ops.spmv``,
``paths.spmv_*``, ``autodiff.SpMV``) against ``repro.sparse.spmv`` and
``jax.grad`` of its ``custom_vjp``, on the same numpy inputs.

Every path and format at sparsity 0.5, 0.9 and 0.99, ``A.T``, ``A @ v``'s
delegation (plan op ``"spmv"``), the errors, ``plan_spmv``; values at
``tests/test_sparse_api.py``'s rtol = atol = 2e-4; and, on every path
and format at sparsity 0.9 (as the reference's own gradient test), dx and
dA at its 1e-5, with the ``policy="vjp"`` plans the backward records.  The element
routes sum each row in one fixed order (``paths.row_order``): on a
triplet whose rows do not ascend (``A.T``'s swapped triplet) too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.formats import BlockCOO as JBlockCOO
from repro.dispatch import clear_log as j_clear_log
from repro.dispatch import dispatch_log as j_dispatch_log
from repro.dispatch.dispatcher import plan_spmv as j_plan_spmv
from repro.dispatch.stats import MatrixStats as JMatrixStats
from repro.sparse import SparseMatrix as JSparseMatrix
from repro.sparse import paths as j_paths
from repro.sparse import spmv as j_spmv
from repro_torch.core.formats import BlockCOO
from repro_torch.dispatch import clear_log, dispatch_log, last_plan
from repro_torch.dispatch.dispatcher import plan_spmv
from repro_torch.dispatch.stats import MatrixStats
from repro_torch.sparse import SparseMatrix, matmul, paths, spmv

N = 64
BLOCK = (16, 16)
SPARSITIES = (0.5, 0.9, 0.99)
TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
# (dispatch path, the one form the matrix carries), as the reference's
PATH_FORMATS = [("ell", "ell"), ("ell", "coo"), ("csr", "csr"),
                ("sell", "sell"), ("dense", "ell"), ("dense", "csr"),
                ("dense", "sell")]


def _dense(sparsity, seed=7, n=N):
    rng = np.random.default_rng(seed)
    return np.where(rng.random((n, n)) < 1.0 - sparsity,
                    rng.normal(size=(n, n)), 0.0).astype(np.float32)


def _pair(dense, fmt):
    return (SparseMatrix.from_dense(dense, formats=(fmt,), block=BLOCK,
                                    device="cpu"),
            JSparseMatrix.from_dense(dense, formats=(fmt,), block=BLOCK))


V = np.linspace(-1, 1, N, dtype=np.float32)


@pytest.mark.parametrize("sparsity", SPARSITIES)
@pytest.mark.parametrize("path,fmt", PATH_FORMATS)
def test_spmv_every_path_matches_reference(sparsity, path, fmt):
    dense = _dense(sparsity)
    a, ja = _pair(dense, fmt)
    y = spmv(a, torch.from_numpy(V), policy=path)
    want = np.asarray(j_spmv(ja, V, policy=path))
    assert y.shape == (N,) and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), want, **TOL)
    np.testing.assert_allclose(y.numpy(), dense @ V, **TOL)
    assert last_plan().op == "spmv" and last_plan().path == path
    # the transpose, under auto and forced onto each path it carries
    yt = spmv(a.T, torch.from_numpy(V))
    np.testing.assert_allclose(yt.numpy(), np.asarray(j_spmv(ja.T, V)),
                               **TOL)
    np.testing.assert_allclose(yt.numpy(), dense.T @ V, **TOL)
    assert last_plan().path == j_dispatch_log()[-1].path


@pytest.mark.parametrize("fmt", ["ell", "coo", "csr", "sell"])
@pytest.mark.parametrize("sparsity", SPARSITIES)
def test_spmv_transpose_every_path(fmt, sparsity):
    from repro_torch.sparse.ops import available_paths

    dense = _dense(sparsity, seed=8)
    a, ja = _pair(dense, fmt)
    for path in available_paths(a.T):
        got = spmv(a.T, torch.from_numpy(V), policy=path)
        want = j_spmv(ja.T, V, policy=path)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(got.numpy(), dense.T @ V, **TOL)


def test_matmul_1d_delegates_to_spmv():
    dense = _dense(0.9)
    a, _ = _pair(dense, "ell")
    clear_log()
    y = a @ torch.from_numpy(V)
    assert [p.op for p in dispatch_log()] == ["spmv"]
    np.testing.assert_allclose(y.numpy(), dense @ V, **TOL)
    clear_log()
    a @ torch.ones(N, 4)
    assert last_plan().op == "spmm"
    # a 1-D H with an epilogue stays an SpMM at D = 1
    clear_log()
    y = matmul(a, torch.from_numpy(V), epilogue="relu")
    assert last_plan().op == "spmm" and y.shape == (N,)
    np.testing.assert_allclose(y.numpy(), np.maximum(dense @ V, 0), **TOL)


def test_spmv_errors():
    a, _ = _pair(_dense(0.9), "csr")
    with pytest.raises(ValueError, match="rows but A has"):
        spmv(a, torch.ones(N - 4))
    with pytest.raises(ValueError, match="not among available paths"):
        spmv(a, torch.ones(N), policy="ell")
    with pytest.raises(ValueError, match="must be 1-D"):
        spmv(a, torch.ones(N, 2))
    with pytest.raises(TypeError, match="must be a tensor"):
        spmv(a, np.ones(N, np.float32))
    with pytest.raises(TypeError, match="expects a SparseMatrix"):
        spmv(np.eye(N), torch.ones(N))


@pytest.mark.parametrize("sparsity", (0.5, 0.9, 0.95, 0.99, 0.999))
@pytest.mark.parametrize("candidates", [None, ("ell", "csr"),
                                        ("ell", "sell", "csr")])
@pytest.mark.parametrize("policy", ["auto", "autotune", "csr"])
def test_plan_spmv_matches_reference(sparsity, candidates, policy):
    dense = _dense(sparsity, seed=3, n=256)
    rows, cols = np.nonzero(dense)
    ref = j_plan_spmv(JMatrixStats.from_coords(dense.shape, rows, cols, 16,
                                               16),
                      policy=policy, candidates=candidates)
    ours = plan_spmv(MatrixStats.from_coords(dense.shape, rows, cols, 16,
                                             16),
                     policy=policy, candidates=candidates)
    assert (ours.op, ours.path, ours.policy, ours.reason, ours.costs) == \
        (ref.op, ref.path, ref.policy, ref.reason, ref.costs)


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------


def _vjp_plans(log):
    return [(p.op, p.path, p.reason) for p in log if p.policy == "vjp"]


@pytest.mark.parametrize("path,fmt", PATH_FORMATS)
def test_spmv_grads_match_reference(path, fmt):
    dense = _dense(0.9, seed=9)
    dense[0, 1] = 1.0  # at least one nonzero
    a, ja = _pair(dense, fmt)
    w = np.linspace(1, 2, N, dtype=np.float32)

    def j_loss(vals, x):
        return jnp.sum(jnp.tanh(j_spmv(ja.with_data(vals), x,
                                       policy=path)) * w)

    j_clear_log()
    gv, gx = jax.grad(j_loss, argnums=(0, 1))(ja.data, jnp.asarray(V))
    vals = a.data.clone().requires_grad_(True)
    x = torch.from_numpy(V.copy()).requires_grad_(True)
    clear_log()
    loss = (torch.tanh(spmv(a.with_data(vals), x, policy=path))
            * torch.from_numpy(w)).sum()
    loss.backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gx), **GRAD_TOL)
    np.testing.assert_allclose(vals.grad.numpy(), np.asarray(gv),
                               **GRAD_TOL)
    # structural zeros (padding, pruned entries) get no gradient
    assert not bool(vals.grad[a.data == 0].any())
    assert _vjp_plans(dispatch_log()) == _vjp_plans(j_dispatch_log())
    assert [p[0] for p in _vjp_plans(dispatch_log())] == ["spmv", "sddmm"]


# ---------------------------------------------------------------------------
# the fixed-order element and Block-COO routes
# ---------------------------------------------------------------------------


def _triplet(seed, n, nnz, shuffled):
    rng = np.random.default_rng(seed)
    rows = np.sort(rng.integers(0, n, nnz)).astype(np.int32)
    cols = rng.integers(0, n, nnz).astype(np.int32)
    vals = rng.normal(size=nnz).astype(np.float32)
    if shuffled:
        order = rng.permutation(nnz)
        rows, cols, vals = rows[order], cols[order], vals[order]
    return rows, cols, vals


@pytest.mark.parametrize("shuffled", [False, True])
def test_element_routes_match_reference_segment_sum(shuffled):
    n, d = 96, 5
    rows, cols, vals = _triplet(11, n, 700, shuffled)
    h = np.random.default_rng(12).normal(size=(n, d)).astype(np.float32)
    t = [torch.from_numpy(x) for x in (rows, cols, vals)]
    jt = [jnp.asarray(x) for x in (rows, cols, vals)]
    np.testing.assert_allclose(
        paths.spmm_elements(*t, torch.from_numpy(h), n).numpy(),
        np.asarray(j_paths.spmm_elements(*jt, jnp.asarray(h), n)), **TOL)
    np.testing.assert_allclose(
        paths.spmv_elements(*t, torch.from_numpy(h[:, 0]), n).numpy(),
        np.asarray(j_paths.spmv_elements(*jt, jnp.asarray(h[:, 0]), n)),
        **TOL)
    perm, cols_in_order, lengths = paths.row_order(t[0], t[1], n)
    assert perm.tolist() == np.argsort(rows, kind="stable").tolist()
    assert torch.equal(cols_in_order, t[1][perm])
    assert lengths.tolist() == np.bincount(rows, minlength=n).tolist()
    # built once per structure
    assert paths.row_order(t[0], t[1], n)[2] is lengths


def test_element_route_empty_and_trailing_empty_rows():
    rows = torch.tensor([0, 0, 2], dtype=torch.int32)
    cols = torch.tensor([1, 2, 0], dtype=torch.int32)
    vals = torch.tensor([1.0, 2.0, 3.0])
    y = paths.spmv_elements(rows, cols, vals, torch.tensor([1., 10., 100.]),
                            5)
    assert y.tolist() == [210.0, 0.0, 3.0, 0.0, 0.0]
    empty = torch.zeros(0, dtype=torch.int32)
    assert paths.spmm_elements(empty, empty, torch.zeros(0),
                               torch.ones(3, 2), 4).tolist() == [[0, 0]] * 4


def test_spmv_coo_unsorted_block_rows_match_reference():
    dense = _dense(0.7, seed=13)
    coo = BlockCOO.from_dense(dense, 16, 16, device="cpu")
    jcoo = JBlockCOO.from_dense(dense, 16, 16)
    order = torch.from_numpy(np.random.default_rng(14).permutation(
        coo.nnzb))
    shuffled = BlockCOO(rows=coo.rows[order], cols=coo.cols[order],
                        blocks=coo.blocks[order], shape=coo.shape)
    got = paths.spmv_coo(shuffled, torch.from_numpy(V))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(j_paths.spmv_coo(jcoo, jnp.asarray(V))),
        **TOL)
    np.testing.assert_allclose(got.numpy(), dense @ V, **TOL)
