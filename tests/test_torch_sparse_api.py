"""Port parity: the rest of ``SparseMatrix``'s public surface
(``repro_torch.sparse.matrix``) against ``repro.sparse.SparseMatrix``.

``from_csr`` / ``from_blockell`` / ``from_blockcoo`` / ``from_sellcs``
(the same stats and arrays), ``nnz``, ``density``, ``dtype``, ``ndim``,
``nbytes`` (the reference's bytes for the same forms), ``with_stats``,
``A @ H`` and ``x @ A`` at 1-D and 2-D, and ``A.matmul`` with a fused
epilogue; values at ``tests/test_sparse_api.py``'s rtol = atol = 2e-4.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.formats import CSR as JCSR
from repro.core.formats import BlockCOO as JBlockCOO
from repro.core.formats import BlockELL as JBlockELL
from repro.core.formats import SellCS as JSellCS
from repro.sparse import SparseMatrix as JSparseMatrix
from repro_torch.core.formats import CSR, BlockCOO, BlockELL, SellCS
from repro_torch.dispatch import last_plan
from repro_torch.sparse import FORMATS, SparseMatrix

TOL = dict(rtol=2e-4, atol=2e-4)
N, D = 80, 8
BLOCK = (16, 16)


def _dense(sparsity, seed=7, m=N, n=N):
    rng = np.random.default_rng(seed)
    return np.where(rng.random((m, n)) < 1.0 - sparsity,
                    rng.normal(size=(m, n)), 0.0).astype(np.float32)


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _same_stats(a, ja):
    assert dataclasses.asdict(a.stats) == dataclasses.asdict(ja.stats)


def _arrays(form):
    if isinstance(form, tuple):
        return [np.asarray(x) for x in form]
    return [np.asarray(getattr(form, f.name)) for f in dataclasses.fields(form)
            if not isinstance(getattr(form, f.name), (int, tuple))]


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sparsity", [0.5, 0.9, 0.99])
def test_from_csr(sparsity):
    dense = _dense(sparsity, m=70)
    a = SparseMatrix.from_csr(CSR.from_dense(dense), block=BLOCK,
                              device="cpu")
    ja = JSparseMatrix.from_csr(JCSR.from_dense(dense), block=BLOCK)
    assert a.formats == ja.formats == ("csr",) and a.shape == ja.shape
    _same_stats(a, ja)
    for x, y in zip(_arrays(a.form("csr")), _arrays(ja.form("csr"))):
        np.testing.assert_array_equal(x.cpu() if hasattr(x, "cpu") else x,
                                      y)
    np.testing.assert_array_equal(a.to_dense(), dense)


@pytest.mark.parametrize("sparsity", [0.5, 0.9, 0.99])
def test_from_blockell_and_blockcoo(sparsity):
    dense = _dense(sparsity, seed=8, m=70)
    a = SparseMatrix.from_blockell(BlockELL.from_dense(dense, 16, 16,
                                                       device="cpu"))
    ja = JSparseMatrix.from_blockell(JBlockELL.from_dense(dense, 16, 16))
    _same_stats(a, ja)
    np.testing.assert_array_equal(a.to_dense(), ja.to_dense())
    a = SparseMatrix.from_blockcoo(BlockCOO.from_dense(dense, 16, 16,
                                                       device="cpu"))
    ja = JSparseMatrix.from_blockcoo(JBlockCOO.from_dense(dense, 16, 16))
    _same_stats(a, ja)
    np.testing.assert_array_equal(a.to_dense(), ja.to_dense())
    # given stats (and nnz) are taken as they are
    given = dataclasses.replace(a.stats, nnz=1)
    assert SparseMatrix.from_blockcoo(a.form("coo"), stats=given).stats \
        is given
    assert SparseMatrix.from_blockell(
        BlockELL.from_dense(dense, 16, 16, device="cpu"), nnz=3).nnz == 3


@pytest.mark.parametrize("sparsity", [0.9, 0.99])
def test_from_sellcs(sparsity):
    dense = _dense(sparsity, seed=9)
    a = SparseMatrix.from_sellcs(SellCS.from_dense(dense, block=BLOCK,
                                                   device="cpu"))
    ja = JSparseMatrix.from_sellcs(JSellCS.from_dense(dense, block=BLOCK))
    assert a.format == "sell"
    _same_stats(a, ja)
    np.testing.assert_array_equal(a.to_dense(), dense)


# ---------------------------------------------------------------------------
# metadata
# ---------------------------------------------------------------------------


FORM_SETS = [("ell",), ("coo",), ("csr",), ("sell",), ("ell", "csr"),
             ("ell", "sell", "csr"), FORMATS]


@pytest.mark.parametrize("formats", FORM_SETS, ids="+".join)
def test_metadata_matches_reference(formats):
    dense = _dense(0.9, seed=10)
    a = SparseMatrix.from_dense(dense, formats=formats, block=BLOCK,
                                device="cpu")
    ja = JSparseMatrix.from_dense(dense, formats=formats, block=BLOCK)
    assert a.ndim == ja.ndim == 2
    assert a.nnz == ja.nnz and a.density == ja.density
    assert str(a.dtype).split(".")[-1] == str(ja.dtype)
    assert a.nbytes() == ja.nbytes()
    assert a.to("ell").nbytes() == ja.to("ell").nbytes()


def test_metadata_without_stats_raises():
    a = SparseMatrix.from_dense(_dense(0.9), formats=("csr",), device="cpu")
    bare = SparseMatrix(a._forms, a.shape, None)
    with pytest.raises(ValueError, match="no sparsity stats"):
        bare.nnz
    with pytest.raises(ValueError, match="no sparsity stats"):
        bare.density
    assert bare.dtype == torch.float32


def test_with_stats_restates_and_drops_the_plan_memo():
    dense = _dense(0.9, seed=11)
    a = SparseMatrix.from_dense(dense, formats=("ell", "csr"), block=BLOCK,
                                device="cpu")
    h = torch.from_numpy(_normal(12, N, D))
    a @ h
    assert len(a.plan_cache) == 1
    b = a.with_stats(a.stats)
    assert b.stats is a.stats and b.plan_cache is not a.plan_cache
    assert len(b.plan_cache) == 0 and b.form("ell") is a.form("ell")
    restated = dataclasses.replace(a.stats, nnz=a.stats.nnz * 2)
    assert a.with_stats(restated).nnz == 2 * a.nnz
    ja = JSparseMatrix.from_dense(dense, formats=("ell", "csr"),
                                  block=BLOCK)
    small = dataclasses.replace(a.stats, shape=(16, 16))
    with pytest.raises(ValueError, match="does not cover"):
        a.with_stats(small)
    with pytest.raises(ValueError, match="does not cover"):
        ja.with_stats(dataclasses.replace(ja.stats, shape=(16, 16)))
    # a transpose keeps its in-place source form
    t = a.T.with_stats(a.T.stats)
    assert t.transposed_form("ell") is a.form("ell")
    np.testing.assert_allclose((t @ h).numpy(), dense.T @ h.numpy(), **TOL)


# ---------------------------------------------------------------------------
# operators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["ell", "coo", "csr", "sell"])
def test_matmul_and_rmatmul_1d_and_2d(fmt):
    dense = _dense(0.9, seed=13)
    a = SparseMatrix.from_dense(dense, formats=(fmt,), block=BLOCK,
                                device="cpu")
    ja = JSparseMatrix.from_dense(dense, formats=(fmt,), block=BLOCK)
    h, v = _normal(14, N, D), _normal(15, N)
    x2 = _normal(16, D, N)
    cases = [(a @ torch.from_numpy(h), ja @ jnp.asarray(h), dense @ h),
             (a @ torch.from_numpy(v), ja @ jnp.asarray(v), dense @ v),
             (torch.from_numpy(v) @ a, jnp.asarray(v) @ ja, v @ dense),
             (torch.from_numpy(x2) @ a, jnp.asarray(x2) @ ja, x2 @ dense)]
    for got, jgot, want in cases:
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(jgot), **TOL)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert a.__matmul__(a) is NotImplemented
    assert a.__rmatmul__(torch.ones(2, 2, 2)) is NotImplemented


@pytest.mark.parametrize("act", ["identity", "relu", "leaky_relu"])
def test_matmul_method_with_epilogue(act):
    dense = _dense(0.9, seed=17)
    a = SparseMatrix.from_dense(dense, formats=("ell", "csr"), block=BLOCK,
                                device="cpu")
    ja = JSparseMatrix.from_dense(dense, formats=("ell", "csr"),
                                  block=BLOCK)
    h, bias, res = _normal(18, N, D), _normal(19, D), _normal(20, N, D)
    got = a.matmul(torch.from_numpy(h), epilogue=act,
                   bias=torch.from_numpy(bias),
                   residual=torch.from_numpy(res), policy="ell")
    jgot = ja.matmul(h, epilogue=act, bias=bias, residual=res,
                     policy="ell")
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), **TOL)
    assert last_plan("spmm").fused is not None
    # a 1-D H with a tail: a 1-D result
    y = a.matmul(torch.from_numpy(h[:, 0]), epilogue=act,
                 bias=torch.tensor(0.5))
    jy = ja.matmul(h[:, 0], epilogue=act, bias=0.5)
    assert y.shape == (N,)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
