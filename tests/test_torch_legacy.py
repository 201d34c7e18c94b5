"""Port parity: the deprecated shims (``repro_torch.core.spmm`` /
``core.sddmm``, ``dispatch.SparseOperand``, ``sparse.legacy``) against
the reference's on the same numpy inputs.

The shim cases of ``tests/test_dispatch.py`` (explicit kernel keywords
force the ell path, 1-D H, shapes off the block grid, mismatched H rows,
SDDMM on every path), of ``tests/test_sparse_api.py`` (the same warning
class and ``match`` text) and ``sddmm_coo`` from
``tests/test_kernels_sddmm.py``; what the legacy keywords mean in the port
(``use_kernel`` / ``interpret`` / ``out_dtype`` / ``bd`` / ``bk``); K3's
rounding on the Block-COO entry points (F4); and the port's own routes
clean under ``DeprecationWarning`` as an error.  Outputs at
``tests/test_dispatch.py``'s rtol = atol = 2e-4.
"""
import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dtypes import J_DTYPES, to_jax, torch_dtype
from repro.core.formats import BlockCOO as JBlockCOO
from repro.core.formats import BlockELL as JBlockELL
from repro.core.sddmm import sddmm as j_sddmm
from repro.core.sddmm import sddmm_coo as j_sddmm_coo
from repro.core.spmm import spmm as j_spmm
from repro.core.spmm import spmm_csr as j_spmm_csr
from repro.dispatch import SparseOperand as JSparseOperand
from repro.dispatch import last_plan as j_last_plan
from repro.kernels.sddmm.ops import sddmm_blockcoo as j_sddmm_blockcoo
from repro.sparse import legacy as j_legacy
from repro_torch.core.formats import BlockCOO, BlockELL
from repro_torch.core.sddmm import sddmm, sddmm_coo
from repro_torch.core.spmm import spmm, spmm_csr
from repro_torch.dispatch import SparseOperand, dispatch_sddmm, last_plan
from repro_torch.kernels.sddmm.ops import sddmm_blockcoo
from repro_torch.sparse import legacy

TOL = dict(rtol=2e-4, atol=2e-4)
N, D = 256, 16


def _sparse(rng, n, sparsity, m=None):
    m = n if m is None else m
    return np.where(rng.random((m, n)) < 1.0 - sparsity,
                    rng.normal(size=(m, n)), 0.0).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _quiet(fn, *args, **kw):
    """Call a deprecated entry point, its warning expected."""
    with pytest.warns(DeprecationWarning):
        return fn(*args, **kw)


# ---------------------------------------------------------------------------
# the warnings
# ---------------------------------------------------------------------------


def _messages(fn):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fn()
    return [(w.category, str(w.message)) for w in caught]


def test_warnings_match_the_reference():
    """One DeprecationWarning per call, with the reference's text, for
    ``spmm``, ``sddmm`` and ``SparseOperand`` (``tests/test_sparse_api.py``
    matches "repro.sparse" and "SparseMatrix")."""
    rng = np.random.default_rng(0)
    a = _sparse(rng, 64, 0.9)
    h = rng.normal(size=(64, 4)).astype(np.float32)
    b = rng.normal(size=(64, 2)).astype(np.float32)
    c = rng.normal(size=(2, 64)).astype(np.float32)
    pairs = [
        (lambda: spmm(a, _t(h), policy="csr"),
         lambda: j_spmm(a, jnp.asarray(h), policy="csr")),
        (lambda: sddmm(a, _t(b), _t(c), policy="csr"),
         lambda: j_sddmm(a, jnp.asarray(b), jnp.asarray(c), policy="csr")),
        (lambda: SparseOperand.from_dense(a, device="cpu"),
         lambda: JSparseOperand.from_dense(a)),
    ]
    for port, ref in pairs:
        got, want = _messages(port), _messages(ref)
        assert len(got) == 1 and got == want
    with pytest.warns(DeprecationWarning, match="repro.sparse"):
        spmm(a, _t(h), policy="csr")
    with pytest.warns(DeprecationWarning, match="repro.sparse"):
        sddmm(a, _t(b), _t(c), policy="csr")
    with pytest.warns(DeprecationWarning, match="SparseMatrix"):
        SparseOperand.from_dense(a, device="cpu")


def test_warning_points_at_the_caller():
    """``stacklevel=3``: the warning names this file, as the reference's
    names its caller's."""
    rng = np.random.default_rng(1)
    a = _sparse(rng, 64, 0.9)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        spmm(a, torch.ones(64, 2), policy="dense")
    assert caught[0].filename == __file__


@pytest.mark.parametrize("policy", ["auto", "autotune", "ell", "csr",
                                    "dense", "block", "coo"])
@pytest.mark.parametrize("use_kernel,interpret", [
    (None, None), (True, None), (False, None), (None, True), (True, False)])
def test_coerce_kernel_kwargs_matches_reference(policy, use_kernel,
                                                interpret):
    assert legacy.coerce_kernel_kwargs(policy, use_kernel, interpret) \
        == j_legacy.coerce_kernel_kwargs(policy, use_kernel, interpret)


# ---------------------------------------------------------------------------
# the shim cases of tests/test_dispatch.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(use_kernel=False),
                                dict(interpret=True),
                                dict(use_kernel=True, interpret=True)])
def test_explicit_kernel_args_force_ell_path(kw):
    """Legacy ``spmm(op, h, use_kernel=False)`` semantics survive dispatch:
    auto would pick csr at 99.9 % sparsity; both packages run ell."""
    rng = np.random.default_rng(17)
    dense = _sparse(rng, N, 0.999)
    h = rng.normal(size=(N, D)).astype(np.float32)
    y = _quiet(spmm, SparseOperand.from_dense(dense, block_m=4, block_n=4,
                                              device="cpu"), _t(h), **kw)
    want = _quiet(j_spmm, JSparseOperand.from_dense(dense, block_m=4,
                                                    block_n=4),
                  jnp.asarray(h), **kw)
    assert last_plan("spmm").path == j_last_plan("spmm").path == "ell"
    np.testing.assert_allclose(y.numpy(), np.asarray(want), **TOL)


def test_use_kernel_on_cpu_names_the_device():
    """``use_kernel=True`` on a CPU operand without ``interpret``: there is
    no kernel to run, and the error says where the operand is."""
    rng = np.random.default_rng(2)
    a = _sparse(rng, 64, 0.9)
    with pytest.warns(DeprecationWarning), \
            pytest.raises(ValueError, match="cpu"):
        spmm(a, torch.ones(64, 4), use_kernel=True)
    coo = BlockCOO.from_dense(a, 16, 16, device="cpu")
    with pytest.warns(DeprecationWarning), \
            pytest.raises(ValueError, match="cpu"):
        sddmm(coo, torch.ones(64, 2), torch.ones(2, 64), use_kernel=True)


@pytest.mark.parametrize("sparsity", [0.9, 0.999])
def test_spmm_kernel_path_interpret_matches_reference(sparsity):
    """The ell route with ``use_kernel=True, interpret=True`` (the plain
    version; Pallas in interpret mode in the reference)."""
    rng = np.random.default_rng(3)
    dense = _sparse(rng, 256, sparsity)
    h = rng.normal(size=(256, 128)).astype(np.float32)
    y = _quiet(spmm, BlockELL.from_dense(dense, 64, 128, device="cpu"),
               _t(h), policy="ell", use_kernel=True, interpret=True)
    want = _quiet(j_spmm, JBlockELL.from_dense(dense, 64, 128),
                  jnp.asarray(h), policy="ell", use_kernel=True,
                  interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=5e-4,
                               atol=5e-4)
    np.testing.assert_allclose(y.numpy(), dense @ h, rtol=5e-4, atol=5e-4)
    assert last_plan("spmm").path == "ell"


@pytest.mark.parametrize("path", ["ell", "csr", "dense", "auto"])
def test_spmm_mismatched_h_rows_raises(path):
    with pytest.warns(DeprecationWarning), \
            pytest.raises(ValueError, match="60 rows but A has 64"):
        spmm(np.eye(64, dtype=np.float32), torch.ones(60, 4), policy=path)


def test_spmm_non_divisible_shapes_trim_correctly():
    rng = np.random.default_rng(23)
    m, n, d = 100, 70, 16
    mask = rng.random((m, n)) < 0.1
    dense = np.where(mask, rng.normal(size=(m, n)), 0.0).astype(np.float32)
    op = _quiet(SparseOperand.from_dense, dense, block_m=16, block_n=16,
                device="cpu")
    jop = _quiet(JSparseOperand.from_dense, dense, block_m=16, block_n=16)
    h = rng.normal(size=(n, d)).astype(np.float32)
    for path in ("ell", "csr", "dense"):
        y = _quiet(spmm, op, _t(h), policy=path)
        want = _quiet(j_spmm, jop, jnp.asarray(h), policy=path)
        assert tuple(y.shape) == (m, d)
        np.testing.assert_allclose(y.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("path", ["ell", "csr", "dense", "auto"])
def test_spmm_1d_h_all_paths(path):
    rng = np.random.default_rng(37)
    dense = np.where(rng.random((64, 64)) < 0.1, 1.0, 0.0) \
        .astype(np.float32)
    hv = rng.normal(size=64).astype(np.float32)
    op = _quiet(SparseOperand.from_dense, dense, block_m=4, block_n=4,
                device="cpu")
    y = _quiet(spmm, op, _t(hv), policy=path)
    want = _quiet(j_spmm, _quiet(JSparseOperand.from_dense, dense,
                                 block_m=4, block_n=4),
                  jnp.asarray(hv), policy=path)
    assert tuple(y.shape) == (64,)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), **TOL)
    assert last_plan("spmm").path == j_last_plan("spmm").path


@pytest.mark.parametrize("path", ["ell", "csr", "dense", "auto"])
def test_sddmm_non_divisible_shapes_all_paths(path):
    """A 100x100 mask block-pads to 128x128; B/C are padded to match; the
    result a BlockCOO equal to the reference's."""
    rng = np.random.default_rng(31)
    mask = (rng.random((100, 100)) < 0.5).astype(np.float32)
    b = rng.normal(size=(100, 2)).astype(np.float32)
    c = rng.normal(size=(2, 100)).astype(np.float32)
    out = _quiet(sddmm, mask, _t(b), _t(c), policy=path)
    want = _quiet(j_sddmm, mask, jnp.asarray(b), jnp.asarray(c),
                  policy=path)
    assert isinstance(out, BlockCOO)
    np.testing.assert_allclose(out.to_dense()[:100, :100],
                               np.asarray(want.to_dense())[:100, :100],
                               **TOL)
    np.testing.assert_allclose(out.to_dense()[:100, :100], mask * (b @ c),
                               **TOL)
    assert last_plan("sddmm").path == j_last_plan("sddmm").path


def test_sddmm_kernel_path_interpret_matches_reference():
    rng = np.random.default_rng(5)
    n, k = 256, 128
    mask = (rng.random((n, n)) < 0.1).astype(np.float32)
    b = rng.normal(size=(n, k)).astype(np.float32)
    c = rng.normal(size=(k, n)).astype(np.float32)
    out = _quiet(sddmm, BlockCOO.from_dense(mask, 64, 64, device="cpu"),
                 _t(b), _t(c), policy="ell", use_kernel=True, interpret=True)
    want = _quiet(j_sddmm, JBlockCOO.from_dense(mask, 64, 64),
                  jnp.asarray(b), jnp.asarray(c), policy="ell",
                  use_kernel=True, interpret=True)
    np.testing.assert_allclose(out.blocks.numpy(), np.asarray(want.blocks),
                               rtol=1e-3, atol=1e-3)


def test_element_helpers_match_reference():
    """``spmm_csr`` and ``sddmm_coo`` (``tests/test_kernels_sddmm.py``)
    forward to the element routes."""
    rng = np.random.default_rng(8)
    dense = _sparse(rng, 48, 0.8, m=40)
    r, c = np.nonzero(dense)
    r, c = r.astype(np.int32), c.astype(np.int32)
    v = dense[r, c]
    h = rng.normal(size=(48, 5)).astype(np.float32)
    got = spmm_csr(_t(r), _t(c), _t(v), _t(h), 40)
    want = j_spmm_csr(jnp.asarray(r), jnp.asarray(c), jnp.asarray(v),
                      jnp.asarray(h), 40)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    bb = rng.normal(size=(40, 3)).astype(np.float32)
    cc = rng.normal(size=(3, 48)).astype(np.float32)
    got = sddmm_coo(_t(r), _t(c), _t(bb), _t(cc))
    want = j_sddmm_coo(jnp.asarray(r), jnp.asarray(c), jnp.asarray(bb),
                       jnp.asarray(cc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), (bb @ cc)[r, c], **TOL)


# ---------------------------------------------------------------------------
# out_dtype, bd / bk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", ["ell", "csr", "dense"])
@pytest.mark.parametrize("dt,out", [(torch.bfloat16, torch.float32),
                                    (torch.float32, torch.bfloat16),
                                    (torch.float16, None)])
def test_out_dtype_follows_the_reference(path, dt, out):
    """``out_dtype`` on both entry points: the reference's dtype, and its
    values (the f32 sums rounded once to it)."""
    rng = np.random.default_rng(9)
    a = _sparse(rng, 128, 0.9)
    ell = BlockELL.from_dense(a, 32, 32, device="cpu")
    ell = dataclasses.replace(ell, blocks=ell.blocks.to(dt))
    jell = JBlockELL.from_dense(a, 32, 32)
    jell = dataclasses.replace(jell, blocks=to_jax(ell.blocks))
    h = _t(rng.normal(size=(128, 8)).astype(np.float32)).to(dt)
    jout = None if out is None else J_DTYPES[out]
    y = _quiet(spmm, ell, h, policy=path, out_dtype=out)
    want = _quiet(j_spmm, jell, to_jax(h), policy=path, out_dtype=jout)
    assert y.dtype == torch_dtype(want.dtype)
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=1e-2, atol=1e-2)
    coo = BlockCOO.from_dense(a, 32, 32, device="cpu")
    coo = dataclasses.replace(coo, blocks=coo.blocks.to(dt))
    jcoo = JBlockCOO.from_dense(a, 32, 32)
    jcoo = dataclasses.replace(jcoo, blocks=to_jax(coo.blocks))
    b = _t(rng.integers(-3, 4, size=(128, 2)).astype(np.float32)).to(dt)
    c = _t(rng.integers(-3, 4, size=(2, 128)).astype(np.float32)).to(dt)
    s = _quiet(sddmm, coo, b, c, policy=path, out_dtype=out)
    want = _quiet(j_sddmm, jcoo, to_jax(b), to_jax(c), policy=path,
                  out_dtype=jout)
    assert s.blocks.dtype == torch_dtype(want.blocks.dtype)
    # exact dots: one rounding of value x dot, the same bits
    assert torch.equal(s.blocks.float(),
                       _t(np.asarray(want.blocks, np.float32)))


def test_tile_sizes_choose_nothing():
    """``bd`` / ``bk`` are the reference's TPU tiles: accepted, and the
    results are the same bits without them."""
    rng = np.random.default_rng(10)
    a = _sparse(rng, 128, 0.9)
    h = _t(rng.normal(size=(128, 256)).astype(np.float32))
    ell = BlockELL.from_dense(a, 64, 64, device="cpu")
    assert torch.equal(_quiet(spmm, ell, h, policy="ell", bd=128),
                       _quiet(spmm, ell, h, policy="ell"))
    coo = BlockCOO.from_dense(a, 64, 64, device="cpu")
    b = _t(rng.normal(size=(128, 256)).astype(np.float32))
    c = _t(rng.normal(size=(256, 128)).astype(np.float32))
    assert torch.equal(dispatch_sddmm(coo, b, c, policy="ell", bk=128).blocks,
                       dispatch_sddmm(coo, b, c, policy="ell").blocks)


# ---------------------------------------------------------------------------
# F4: K3 rounds once on the Block-COO entry points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_blockcoo_sddmm_rounds_once_as_the_reference(dtype):
    """A weighted bf16 / f16 mask with integer-valued B and C, so that the
    f32 dots are exact in both packages: the port's ``sddmm_blockcoo``,
    ``dispatch_sddmm``'s ell path and ``core.sddmm.sddmm`` equal the
    reference's Pallas kernel (interpret mode) under ``torch.equal``.

    The parent tree's K3 rounded the dot to the output dtype before the
    mask multiplied it (the ``SparseMatrix`` ELL path's composition) on
    these entry points too, and this test failed there (F4)."""
    rng = np.random.default_rng(12)
    a = _sparse(rng, 128, 0.7)
    coo = BlockCOO.from_dense(a, 32, 32, device="cpu")
    coo = dataclasses.replace(coo, blocks=coo.blocks.to(dtype))
    jcoo = JBlockCOO.from_dense(a, 32, 32)
    jcoo = dataclasses.replace(jcoo, blocks=to_jax(coo.blocks))
    # |dot| up to 8 * 40 * 40: exact in f32, often not in bf16 / f16
    b = _t(rng.integers(-40, 41, size=(128, 8)).astype(np.float32)).to(dtype)
    c = _t(rng.integers(-40, 41, size=(8, 128)).astype(np.float32)).to(dtype)
    want = j_sddmm_blockcoo(jcoo, to_jax(b), to_jax(c), interpret=True)
    want = _t(np.asarray(want.blocks.astype(jnp.float32))).to(dtype)
    got = sddmm_blockcoo(coo, b, c).blocks
    assert got.dtype == dtype
    assert torch.equal(got, want)
    assert torch.equal(dispatch_sddmm(coo, b, c, policy="ell").blocks, want)
    assert torch.equal(_quiet(sddmm, coo, b, c, policy="ell").blocks, want)
    # the round-the-dot-first epilogue differs here: the test has power
    first = sddmm_blockcoo(coo, b, c, round_dot=True).blocks
    assert not torch.equal(first, want)


# ---------------------------------------------------------------------------
# the port's own routes warn nothing
# ---------------------------------------------------------------------------


def test_port_routes_emit_no_deprecation_warning():
    """GNN serving, the ``SparseMatrix`` ops and the dispatch entry points
    run under ``DeprecationWarning`` as an error: no module of the port
    calls a deprecated shim (the reference holds its own code to the same
    in ``tests/test_sparse_api.py``)."""
    from repro_torch.configs.paper_gnn import SMOKE_CONFIG
    from repro_torch.data.pipeline import random_graph
    from repro_torch.dispatch import dispatch_spmm
    from repro_torch.models.gnn import build_graph, init_gat, init_gcn
    from repro_torch.serve.engine import GNNServeConfig, GNNServingEngine
    from repro_torch.sparse import SparseMatrix, fused_graph_attention, sample

    rng = np.random.default_rng(13)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        adj = random_graph(64, avg_degree=4, seed=5)
        graph = build_graph(adj, SMOKE_CONFIG, device="cpu")
        x = rng.normal(size=(64, SMOKE_CONFIG.in_features)).astype(
            np.float32)
        for model, params in (("gcn", init_gcn(SMOKE_CONFIG, device="cpu")),
                              ("gat", init_gat(SMOKE_CONFIG, device="cpu"))):
            eng = GNNServingEngine(params, graph, GNNServeConfig(model=model))
            assert tuple(eng.infer(x).shape) == (64, SMOKE_CONFIG.n_classes)
        a = _sparse(rng, 64, 0.9)
        A = SparseMatrix.from_dense(a, device="cpu")
        h = _t(rng.normal(size=(64, 8)).astype(np.float32))
        np.testing.assert_allclose((A @ h).numpy(), a @ h.numpy(), **TOL)
        b, c = h[:, :2].contiguous(), h[:, :2].T.contiguous()
        sample(A, b, c)
        fused_graph_attention(A, b, b, h)
        dispatch_spmm(a, h)
        dispatch_sddmm(a, b, c)


def test_front_end_keywords():
    """``sparse.ops.matmul`` / ``spmv`` / ``sddmm`` take the reference's
    keywords: ``out_dtype`` casts, ``bd`` / ``bk`` choose nothing, and
    ``use_kernel=True`` on a CPU matrix raises as the legacy entry points
    do (the front-ends plan as the reference's: no forced path)."""
    from repro_torch.sparse import SparseMatrix, matmul, sddmm as s_sddmm
    from repro_torch.sparse import spmv

    rng = np.random.default_rng(14)
    a = _sparse(rng, 64, 0.9)
    A = SparseMatrix.from_dense(a, device="cpu")
    h = _t(rng.normal(size=(64, 8)).astype(np.float32))
    y = matmul(A, h, out_dtype=torch.bfloat16, bd=128, use_kernel=False,
               interpret=True)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, matmul(A, h).to(torch.bfloat16))
    assert spmv(A, h[:, 0], out_dtype=torch.float16).dtype == torch.float16
    s = s_sddmm(A, h[:, :2].contiguous(), h[:, :2].T.contiguous(), bk=2,
                out_dtype=torch.bfloat16)
    assert s.data.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="cpu"):
        matmul(A, h, use_kernel=True)
