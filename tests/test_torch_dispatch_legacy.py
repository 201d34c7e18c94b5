"""Port parity: the legacy entry points ``dispatch_spmm`` /
``dispatch_sddmm`` over ``LazyForms`` (``repro_torch.dispatch``) against
``repro.dispatch``'s, on the same numpy inputs.

BlockELL, dense, ``LazyForms`` and ``SparseMatrix`` operands; forced and
``auto`` plans equal to the reference's over a sparsity sweep; 1-D ``h``,
shapes off the block grid, the mismatched-rows error; and one
``obs.AUDIT`` record per call.  Outputs at ``tests/test_dispatch.py``'s
rtol = atol = 2e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as j_obs
from repro.core.formats import BlockCOO as JBlockCOO
from repro.core.formats import BlockELL as JBlockELL
from repro.dispatch import dispatch_sddmm as j_dispatch_sddmm
from repro.dispatch import dispatch_spmm as j_dispatch_spmm
from repro.dispatch import last_plan as j_last_plan
from repro.dispatch._forms import LazyForms as JLazyForms
from repro.sparse import SparseMatrix as JSparseMatrix
from repro_torch import obs
from repro_torch.core.formats import BlockCOO, BlockELL
from repro_torch.dispatch import dispatch_sddmm, dispatch_spmm, last_plan
from repro_torch.dispatch._forms import LazyForms
from repro_torch.sparse import SparseMatrix

TOL = dict(rtol=2e-4, atol=2e-4)
SWEEP = (0.5, 0.9, 0.99, 0.999)
N, D, K = 256, 16, 2


def _dense(sparsity, seed=42, n=N, m=None):
    rng = np.random.default_rng(seed)
    m = n if m is None else m
    return np.where(rng.random((m, n)) < 1.0 - sparsity,
                    rng.normal(size=(m, n)), 0.0).astype(np.float32)


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _plan_tuple(p):
    return (p.op, p.path, p.policy, p.reason, p.costs)


# ---------------------------------------------------------------------------
# dispatch_spmm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sparsity", SWEEP)
@pytest.mark.parametrize("policy", ["ell", "csr", "dense", "auto"])
def test_dispatch_spmm_plans_and_values_match_reference(sparsity, policy):
    dense = _dense(sparsity)
    h = _normal(7, N, D)
    y = dispatch_spmm(LazyForms.from_dense(dense, block_m=4, block_n=4,
                                           device="cpu"),
                      torch.from_numpy(h), policy=policy)
    jy = j_dispatch_spmm(JLazyForms.from_dense(dense, block_m=4,
                                               block_n=4),
                         jnp.asarray(h), policy=policy)
    assert _plan_tuple(last_plan("spmm")) == _plan_tuple(
        j_last_plan("spmm"))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(y.numpy(), dense @ h, **TOL)


def _operands(dense, fmt):
    """The same matrix as each operand type, in both packages."""
    if fmt == "blockell":
        return (BlockELL.from_dense(dense, 16, 16, device="cpu"),
                JBlockELL.from_dense(dense, 16, 16))
    if fmt == "dense":
        return dense, dense
    if fmt == "lazy":
        return (LazyForms.from_blockell(BlockELL.from_dense(
            dense, 16, 16, device="cpu")),
            JLazyForms.from_blockell(JBlockELL.from_dense(dense, 16, 16)))
    forms = ("csr",) if fmt == "sparse_csr" else ("ell", "csr")
    return (SparseMatrix.from_dense(dense, formats=forms, block=(16, 16),
                                    device="cpu"),
            JSparseMatrix.from_dense(dense, formats=forms, block=(16, 16)))


@pytest.mark.parametrize("fmt", ["blockell", "dense", "lazy", "sparse",
                                 "sparse_csr"])
@pytest.mark.parametrize("policy", ["ell", "csr", "dense", "auto"])
def test_dispatch_spmm_every_operand_type(fmt, policy):
    dense = _dense(0.9, seed=19, n=128)
    h = _normal(20, 128, 32)
    a, ja = _operands(dense, fmt)
    y = dispatch_spmm(a, torch.from_numpy(h), policy=policy)
    jy = j_dispatch_spmm(ja, jnp.asarray(h), policy=policy)
    assert _plan_tuple(last_plan("spmm")) == _plan_tuple(
        j_last_plan("spmm"))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(y.numpy(), dense @ h, **TOL)


def test_dense_operand_as_a_tensor():
    dense = _dense(0.9, seed=21, n=128)
    h = torch.from_numpy(_normal(22, 128, 8))
    np.testing.assert_allclose(
        dispatch_spmm(torch.from_numpy(dense), h, policy="csr").numpy(),
        dense @ h.numpy(), **TOL)


@pytest.mark.parametrize("policy", ["ell", "csr", "dense", "auto"])
def test_dispatch_spmm_1d_h(policy):
    dense = np.where(_normal(37, 64, 64) > 1.2, 1.0, 0.0).astype(np.float32)
    hv = _normal(38, 64)
    op = LazyForms.from_dense(dense, block_m=4, block_n=4, device="cpu")
    y = dispatch_spmm(op, torch.from_numpy(hv), policy=policy)
    jy = j_dispatch_spmm(JLazyForms.from_dense(dense, block_m=4, block_n=4),
                         jnp.asarray(hv), policy=policy)
    assert y.shape == (64,)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(y.numpy(), dense @ hv, **TOL)


@pytest.mark.parametrize("policy", ["ell", "csr", "dense", "auto"])
def test_dispatch_spmm_non_divisible_shapes(policy):
    """A 100 x 70 operand pads to the 16 x 16 block grid on the ell path;
    the output is trimmed back to 100 rows."""
    dense = _dense(0.9, seed=23, n=70, m=100)
    h = _normal(24, 70, 16)
    op = LazyForms.from_dense(dense, block_m=16, block_n=16, device="cpu")
    y = dispatch_spmm(op, torch.from_numpy(h), policy=policy)
    assert y.shape == (100, 16)
    np.testing.assert_allclose(y.numpy(), dense @ h, **TOL)
    jy = j_dispatch_spmm(JLazyForms.from_dense(dense, block_m=16,
                                               block_n=16),
                         jnp.asarray(h), policy=policy)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)


@pytest.mark.parametrize("policy", ["ell", "csr", "dense", "auto"])
def test_dispatch_spmm_mismatched_rows_raise(policy):
    with pytest.raises(ValueError, match="60 rows but A has 64"):
        dispatch_spmm(np.eye(64, dtype=np.float32), torch.ones(60, 4),
                      policy=policy)


def test_dispatch_spmm_sell_is_not_a_candidate():
    with pytest.raises(ValueError, match="not among available paths"):
        dispatch_spmm(_dense(0.99, n=64), torch.ones(64, 4), policy="sell")


# ---------------------------------------------------------------------------
# dispatch_sddmm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sparsity", SWEEP)
@pytest.mark.parametrize("policy", ["ell", "csr", "dense", "auto"])
def test_dispatch_sddmm_plans_and_values_match_reference(sparsity, policy):
    mask = (_normal(11, N, N) > np.quantile(_normal(11, N, N), sparsity)) \
        .astype(np.float32) * _normal(12, N, N)
    b, c = _normal(13, N, K), _normal(14, K, N)
    out = dispatch_sddmm(BlockCOO.from_dense(mask, 16, 16, device="cpu"),
                         torch.from_numpy(b), torch.from_numpy(c),
                         policy=policy)
    jout = j_dispatch_sddmm(JBlockCOO.from_dense(mask, 16, 16),
                            jnp.asarray(b), jnp.asarray(c), policy=policy)
    assert _plan_tuple(last_plan("sddmm")) == _plan_tuple(
        j_last_plan("sddmm"))
    assert isinstance(out, BlockCOO)
    np.testing.assert_allclose(out.blocks.numpy(), np.asarray(jout.blocks),
                               **TOL)
    np.testing.assert_allclose(out.to_dense(), mask * (b @ c), **TOL)


@pytest.mark.parametrize("fmt", ["dense", "sparse_coo", "sparse_ell"])
@pytest.mark.parametrize("policy", ["ell", "csr", "dense", "auto"])
def test_dispatch_sddmm_every_operand_type(fmt, policy):
    """A 100 x 100 operand pads to 128 x 128; B and C are padded to
    match."""
    mask = (_normal(31, 100, 100) > 0).astype(np.float32)
    b, c = _normal(32, 100, K), _normal(33, K, 100)
    if fmt == "dense":
        a, ja = mask, mask
    else:
        forms = ("coo",) if fmt == "sparse_coo" else ("ell",)
        a = SparseMatrix.from_dense(mask, formats=forms, block=(64, 64),
                                    device="cpu")
        ja = JSparseMatrix.from_dense(mask, formats=forms, block=(64, 64))
    out = dispatch_sddmm(a, torch.from_numpy(b), torch.from_numpy(c),
                         policy=policy)
    jout = j_dispatch_sddmm(ja, jnp.asarray(b), jnp.asarray(c),
                            policy=policy)
    assert _plan_tuple(last_plan("sddmm")) == _plan_tuple(
        j_last_plan("sddmm"))
    np.testing.assert_allclose(out.to_dense()[:100, :100],
                               mask * (b @ c), **TOL)
    np.testing.assert_allclose(out.to_dense(), jout.to_dense(), **TOL)


def test_dispatch_sddmm_shape_errors():
    coo = BlockCOO.from_dense(np.eye(64, dtype=np.float32), 16, 16,
                              device="cpu")
    with pytest.raises(ValueError, match="B has 80 rows but A has 64"):
        dispatch_sddmm(coo, torch.ones(80, 2), torch.ones(2, 64))
    with pytest.raises(ValueError, match="C has 70 columns but A has 64"):
        dispatch_sddmm(coo, torch.ones(64, 2), torch.ones(2, 70))


# ---------------------------------------------------------------------------
# the audit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["ell", "csr", "dense", "auto"])
def test_one_audit_record_per_call(policy):
    dense = _dense(0.99, seed=41)
    h = _normal(42, N, D)
    obs.AUDIT.clear()
    j_obs.AUDIT.clear()
    dispatch_spmm(dense, torch.from_numpy(h), policy=policy)
    j_dispatch_spmm(dense, jnp.asarray(h), policy=policy)
    mask = (dense != 0).astype(np.float32)
    dispatch_sddmm(mask, torch.from_numpy(h[:, :K]),
                   torch.from_numpy(h[:, :K].T.copy()), policy=policy)
    j_dispatch_sddmm(mask, jnp.asarray(h[:, :K]), jnp.asarray(h[:, :K].T),
                     policy=policy)
    rows, jrows = obs.AUDIT.rows(), j_obs.AUDIT.rows()
    assert len(rows) == len(jrows) == 2
    for got, want in zip(rows, jrows):
        assert (got.op, got.path, got.bucket, got.predicted, got.costs,
                got.policy) == (want.op, want.path, want.bucket,
                                want.predicted, want.costs, want.policy)
        assert got.measured_ms > 0
