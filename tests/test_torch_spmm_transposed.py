"""Port parity: the transposed SpMM ``Y = Aᵀ H`` of the backward (N1's
plain version on the ell path, K2's plain version over Aᵀ's row view on
the sell path) against the reference's jnp routes on the same numpy
inputs, the per-structure lists both walk, and ``SparseMatrix``'s memos.

The reference runs this product as ``paths.spmm_coo`` over the transposed
Block-COO view of a Block-ELL form and as ``paths.spmm_elements`` over the
swapped slot triplet of a SELL-C-σ form (``repro.sparse.matrix``'s
``A.T``).  f32 at rtol = atol = 1e-5 (``tests/test_sparse_api.py``'s
gradient tolerance: the same f32 terms summed in another order); bf16 and
f16 at 2e-2 (``_torch_dtypes.NARROW_TOL``).
"""
import dataclasses
import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_dtypes import DTYPES, NARROW_TOL, result_type, to_jax

from repro.core.formats import BlockELL as JBlockELL
from repro.core.formats import SellCS as JSellCS
from repro.sparse import SparseMatrix as JSparseMatrix
from repro.sparse import autodiff as j_autodiff
from repro.sparse import matmul as j_matmul
from repro.sparse import paths as j_paths
from repro_torch.core.formats import BlockELL, SellCS
from repro_torch.dispatch.dispatcher import clear_log, last_plan
from repro_torch.kernels.spmm import transposed
from repro_torch.kernels.spmm.ref import spmm_blockell_t_ref
from repro_torch.sparse import autodiff, matrix
from repro_torch.sparse.matrix import SparseMatrix, single_form
from repro_torch.sparse.ops import matmul

SPARSITIES = (0.5, 0.9, 0.99)
TOL = dict(rtol=1e-5, atol=1e-5)
# (rows, columns, block): ragged shapes, a block wider than tall, and one
# whose bn is not a multiple of 4
SHAPES = [((100, 70), (16, 16)), ((90, 130), (32, 16)), ((61, 47), (8, 12))]
D = 5


def _dense(seed, shape, sparsity, block):
    rng = np.random.default_rng(seed)
    m, n = shape
    a = np.where(rng.random((m, n)) < 1.0 - sparsity,
                 rng.normal(size=(m, n)), 0.0).astype(np.float32)
    a[:, block[1]:2 * block[1]] = 0.0  # an empty block column
    a[block[0]:2 * block[0], 2 * block[1]:] = 0.0  # a short block-row:
    a[0, 0] = 1.0  # padded slots; and at least one nonzero
    return a


def _h(seed, rows, d=D):
    return np.random.default_rng(seed).normal(size=(rows, d)) \
        .astype(np.float32)


def _j_ell_t(jell, h):
    """The reference's route: Block-COO view, transposed, scatter-add."""
    coo = j_paths.transpose_coo(j_paths.ell_to_coo(jell))
    return np.asarray(j_paths.spmm_coo(coo, jnp.asarray(h)))


@pytest.mark.parametrize("sparsity", SPARSITIES)
@pytest.mark.parametrize("shape,block", SHAPES, ids=str)
def test_ell_transposed_matches_reference(shape, block, sparsity):
    a = _dense(1, shape, sparsity, block)
    ell = BlockELL.from_dense(a, *block, device="cpu")
    jell = JBlockELL.from_dense(a, *block)
    assert int(ell.nblocks.min()) < ell.ell_width  # padded slots
    h = _h(2, ell.shape[0])
    got = transposed.spmm_blockell_t(ell, torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), _j_ell_t(jell, h), **TOL)
    np.testing.assert_allclose(got.numpy(), ell.to_dense().T @ h,
                               rtol=1e-4, atol=1e-4)
    # the empty block column sums nothing
    assert not got[block[1]:2 * block[1]].any()


@pytest.mark.parametrize("dtype", DTYPES)
def test_ell_transposed_narrow_operands(dtype):
    block = (16, 16)
    a = _dense(3, (100, 70), 0.9, block)
    ell = BlockELL.from_dense(a, *block, device="cpu")
    blocks = ell.blocks.to(dtype)
    h = torch.from_numpy(_h(4, ell.shape[0])).to(dtype)
    got = transposed.spmm_blockell_t(
        dataclasses.replace(ell, blocks=blocks), h)
    jell = dataclasses.replace(JBlockELL.from_dense(a, *block),
                               blocks=to_jax(blocks))
    want = j_paths.spmm_coo(
        j_paths.transpose_coo(j_paths.ell_to_coo(jell)), to_jax(h))
    assert got.dtype == result_type(blocks, h)
    tol = TOL if dtype == torch.float32 else NARROW_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("sparsity", SPARSITIES)
@pytest.mark.parametrize("shape,block", SHAPES, ids=str)
def test_sell_transposed_matches_reference(shape, block, sparsity):
    a = _dense(5, shape, sparsity, block)
    sell = SellCS.from_dense(a, block=block, device="cpu")
    jsell = JSellCS.from_dense(a, block=block)
    h = _h(6, shape[0])
    got = transposed.spmm_sell_t(sell, torch.from_numpy(h))
    # the reference's route: the slot triplet, coordinates swapped
    want = j_paths.spmm_elements(jsell.slot_cols, jsell.slot_rows,
                                 jsell.slot_vals, jnp.asarray(h), shape[1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("dtype", DTYPES)
def test_sell_transposed_narrow_operands(dtype):
    block = (16, 16)
    a = _dense(7, (100, 70), 0.9, block)
    sell = SellCS.from_dense(a, block=block, device="cpu")
    vals = sell.slot_vals.to(dtype)
    h = torch.from_numpy(_h(8, 100)).to(dtype)
    got = transposed.spmm_sell_t(dataclasses.replace(sell, slot_vals=vals),
                                 h)
    jsell = JSellCS.from_dense(a, block=block)
    want = j_paths.spmm_elements(jsell.slot_cols, jsell.slot_rows,
                                 to_jax(vals), to_jax(h), 70)
    assert got.dtype == result_type(vals, h)
    tol = TOL if dtype == torch.float32 else NARROW_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("fmt", ["ell", "sell"])
def test_spmm_exec_on_the_transpose_reads_the_source_form(fmt, monkeypatch):
    """``spmm_exec`` on ``A.T`` runs the transposed route of A's form (not
    the Block-COO / element route) and gives the reference's result."""
    a = _dense(9, (100, 70), 0.9, (16, 16))
    mat = SparseMatrix.from_dense(a, formats=(fmt,), block=(16, 16),
                                  device="cpu")
    jmat = JSparseMatrix.from_dense(a, formats=(fmt,), block=(16, 16))
    h = _h(10, 100)
    calls = []
    for name in ("spmm_blockell_t", "spmm_sell_t"):
        fn = getattr(transposed, name)
        monkeypatch.setattr(transposed, name,
                            lambda *args, _fn=fn, _n=name:
                            calls.append(_n) or _fn(*args))
    got = autodiff.spmm_exec(fmt, mat.T, torch.from_numpy(h))
    assert calls == [{"ell": "spmm_blockell_t", "sell": "spmm_sell_t"}[fmt]]
    assert mat.T.transposed_form(fmt) is mat.form(fmt)
    assert mat.transposed_form(fmt) is None
    want = j_autodiff.spmm_exec((fmt, False, False, None, None), jmat.T,
                                jnp.asarray(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_plain_version_sums_each_block_column_in_list_order():
    """The plain version equals a loop that adds each listed tile's
    product in the list's order (ascending block-row)."""
    block = (16, 16)
    ell = BlockELL.from_dense(_dense(11, (100, 70), 0.5, block), *block,
                              device="cpu")
    col_ptr, col_slots = transposed.blockell_columns(ell)
    h = torch.from_numpy(_h(12, ell.shape[0]))
    got = spmm_blockell_t_ref(col_ptr, col_slots, ell.blocks, h)
    flat = ell.blocks.reshape(-1, *block)
    want = torch.zeros(ell.shape[1], D)
    for j in range(col_ptr.shape[0] - 1):
        for e in range(int(col_ptr[j]), int(col_ptr[j + 1])):
            s = int(col_slots[e])
            i = s // ell.ell_width
            want[j * 16:(j + 1) * 16] += flat[s].T @ h[i * 16:(i + 1) * 16]
    torch.testing.assert_close(got, want, **TOL)


# ---------------------------------------------------------------------------
# N1's paths: the rule and the stream path's chunks
# ---------------------------------------------------------------------------

F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16


@pytest.mark.parametrize("d,dtype,block,nbr,nbc,want", [
    (4, F32, (64, 64), 160, 40, ("stream", 4)),     # the LM's wo, decode
    (8, F32, (64, 64), 40, 160, ("stream", 1)),     # the LM's wi, decode
    (1, F32, (64, 64), 256, 256, ("stream", 1)),    # graph (a), SpMV's dx
    (2, BF16, (64, 64), 256, 100, ("stream", 2)),
    (8, F16, (48, 30), 3, 3, ("stream", 3)),        # at most nbr chunks
    (1, F32, (16, 16), 1, 1, ("stream", 1)),
    (5, F32, (8, 12), 40, 7, ("stream", 19)),
    (16, F32, (64, 64), 256, 256, ("sparse", 1)),   # mid D: FFMA wins
    (63, BF16, (64, 64), 256, 256, ("sparse", 1)),
    (64, F32, (64, 64), 256, 256, ("tensor", 1)),
    (128, F32, (64, 64), 256, 256, ("tensor", 1)),  # graph (a), dH
    (16384, F32, (64, 64), 40, 160, ("tensor", 1)),  # the LM's prefill
    (130, BF16, (32, 64), 9, 9, ("tensor", 1)),
    (2048, F16, (128, 64), 2, 2, ("tensor", 1)),
    (128, F32, (48, 30), 16, 16, ("sparse", 1)),    # bn not 64
    (128, F32, (8, 64), 16, 16, ("sparse", 1)),     # bm not 16k
    (9, F32, (64, 128), 16, 16, ("sparse", 1)),
])
def test_n1_plan_is_a_rule_on_width_dtype_block_and_shape(d, dtype, block,
                                                          nbr, nbc, want):
    """The path and chunks come from (D, dtype, block, nbr, nbc) alone:
    the same arguments give the same plan, and the stream path takes
    enough chunks for ``STREAM_CTAS`` CTAs, at most one a block-row."""
    got = transposed.n1_plan(d, dtype, block, nbr, nbc)
    assert got == want == transposed.n1_plan(d, dtype, block, nbr, nbc)
    if got[0] == "stream":
        assert got[1] == transposed.stream_chunks(nbr, nbc)
        assert got[1] * nbc >= min(transposed.STREAM_CTAS, nbr * nbc)


def _chunk_bounds(col_ptr, chunks):
    """(starts, ends) int64 [nbc * chunks]: entry ``j * chunks + q`` is the
    run of block column j's list that the stream path's CTA j * chunks + q
    sums, ``len * q // chunks`` .. ``len * (q + 1) // chunks`` past the
    list's start: the kernel's ``e0`` / ``e1``
    (``csrc/spmm_blockell_t.cu``, the stream kernel), written out here so
    that its split and its combine order can be checked on the CPU."""
    beg = col_ptr[:-1].long()[:, None]
    length = col_ptr[1:].long()[:, None] - beg
    q = torch.arange(chunks + 1)[None, :]
    edges = beg + length * q // chunks
    return edges[:, :-1].reshape(-1), edges[:, 1:].reshape(-1)


def _chunked_lists(ell, chunks):
    col_ptr, col_slots = transposed.blockell_columns(ell)
    starts, ends = _chunk_bounds(col_ptr, chunks)
    return col_ptr, col_slots, starts, ends


@pytest.mark.parametrize("chunks", [1, 2, 3, 7])
@pytest.mark.parametrize("shape,block", SHAPES, ids=str)
def test_stream_chunks_cover_each_list_in_order(shape, block, chunks):
    """A column's runs are consecutive, start at its list's start, end at
    its end and differ in length by at most one entry (the empty column's
    runs are all empty)."""
    ell = BlockELL.from_dense(_dense(21, shape, 0.5, block), *block,
                              device="cpu")
    col_ptr, _, starts, ends = _chunked_lists(ell, chunks)
    nbc = col_ptr.shape[0] - 1
    assert starts.shape == ends.shape == (nbc * chunks,)
    s, e = starts.reshape(nbc, chunks), ends.reshape(nbc, chunks)
    assert torch.equal(s[:, 0], col_ptr[:-1].long())
    assert torch.equal(e[:, -1], col_ptr[1:].long())
    assert torch.equal(s[:, 1:], e[:, :-1])
    sizes = e - s
    assert int((sizes.max(1).values - sizes.min(1).values).max()) <= 1
    assert not sizes[1].any()  # the empty block column


@pytest.mark.parametrize("chunks", [1, 3])
@pytest.mark.parametrize("shape,block", SHAPES, ids=str)
def test_stream_chunks_added_in_chunk_order_match_reference(shape, block,
                                                            chunks):
    """The stream path's arithmetic on the CPU: each run's f32 partial (the
    plain version over the runs as lists of their own), then each column's
    partials added in chunk order, held to the reference's route."""
    a = _dense(22, shape, 0.9, block)
    ell = BlockELL.from_dense(a, *block, device="cpu")
    col_ptr, col_slots, starts, ends = _chunked_lists(ell, chunks)
    run_ptr = torch.cat([starts, ends[-1:]]).to(torch.int32)
    h = _h(23, ell.shape[0])
    parts = spmm_blockell_t_ref(run_ptr, col_slots, ell.blocks,
                                torch.from_numpy(h))
    nbc = col_ptr.shape[0] - 1
    parts = parts.reshape(nbc, chunks, block[1], D)
    got = parts[:, 0].clone()
    for q in range(1, chunks):
        got += parts[:, q]
    got = got.reshape(nbc * block[1], D)
    np.testing.assert_allclose(got.numpy(), _j_ell_t(
        JBlockELL.from_dense(a, *block), h), **TOL)
    if chunks == 1:
        assert torch.equal(got, spmm_blockell_t_ref(col_ptr, col_slots,
                                                    ell.blocks,
                                                    torch.from_numpy(h)))


@pytest.mark.parametrize("path", transposed.N1_PATHS)
def test_forced_path_runs_the_plain_version_on_the_cpu(path):
    """A CPU tensor takes the plain version whatever path is asked; an
    unknown path is refused."""
    block = (16, 16)
    ell = BlockELL.from_dense(_dense(24, (100, 70), 0.5, block), *block,
                              device="cpu")
    ops = (*transposed.blockell_columns(ell), ell.blocks,
           torch.from_numpy(_h(25, ell.shape[0])))
    assert torch.equal(transposed.spmm_blockell_t_kernel(*ops, path=path),
                       spmm_blockell_t_ref(*ops))
    with pytest.raises(ValueError):
        transposed.spmm_blockell_t_kernel(*ops, path="dense")


# ---------------------------------------------------------------------------
# The per-structure lists
# ---------------------------------------------------------------------------


def test_blockell_columns_lists_live_slots_by_structure():
    block = (16, 16)
    a = _dense(13, (100, 70), 0.9, block)
    ell = BlockELL.from_dense(a, *block, device="cpu")
    col_ptr, col_slots = transposed.blockell_columns(ell)
    w = ell.ell_width
    idx, nblocks = ell.indices.numpy(), ell.nblocks.numpy()
    want = [[i * w + t for i in range(idx.shape[0])
             for t in range(int(nblocks[i])) if idx[i, t] == j]
            for j in range(ell.shape[1] // block[1])]
    got = [col_slots[int(col_ptr[j]):int(col_ptr[j + 1])].tolist()
           for j in range(len(want))]
    assert got == want  # padded slots out, ascending block-row
    assert want[1] == []  # the empty block column
    # stored zeros are still structural: the list reads no value
    zeros = dataclasses.replace(ell, indices=ell.indices.clone(),
                                blocks=torch.zeros_like(ell.blocks))
    assert torch.equal(transposed.blockell_columns(zeros)[1], col_slots)


@pytest.mark.parametrize("fmt", ["ell", "sell"])
def test_lists_built_once_per_structure(fmt, monkeypatch):
    """Two ``single_form``s of one matrix (the backward's per-step
    ``de_mat`` / ``alpha_mat``) share one list, built once."""
    a = _dense(14, (100, 70), 0.9, (16, 16))
    mat = SparseMatrix.from_dense(a, formats=(fmt,), block=(16, 16),
                                  device="cpu")
    vals = matrix.values_of(fmt, mat.form(fmt))
    one = single_form(mat, fmt, vals * 2)
    two = single_form(mat, fmt, vals * 3)
    lists = {"ell": transposed.blockell_columns,
             "sell": transposed.sell_t_operands}[fmt]
    built = []
    monkeypatch.setattr(transposed, "memoized",
                        lambda table, key, check, build,
                        _m=transposed.memoized:
                        _m(table, key, check,
                           lambda: built.append(1) or build()))
    first = lists(one.T.transposed_form(fmt))
    second = lists(two.T.transposed_form(fmt))
    assert all(x is y for x, y in zip(first, second))
    assert len(built) <= 1
    h = torch.from_numpy(_h(15, 100))
    torch.testing.assert_close(autodiff.spmm_exec(fmt, two.T, h),
                               1.5 * autodiff.spmm_exec(fmt, one.T, h),
                               **TOL)


def test_list_entry_goes_with_its_structure():
    block = (16, 16)
    ell = BlockELL.from_dense(_dense(16, (100, 70), 0.9, block), *block,
                              device="cpu")
    transposed.blockell_columns(ell)
    key = id(ell.indices)
    assert key in transposed._ELL_LISTS
    del ell
    gc.collect()
    assert key not in transposed._ELL_LISTS


@pytest.mark.parametrize("fmt", ["ell", "sell"])
def test_transpose_plans_unchanged(fmt):
    """``A.T`` carries the same forms and plans the same path, for the
    same reason, as the reference's: the transposed route is a view, not
    a form."""
    a = _dense(17, (100, 70), 0.99 if fmt == "sell" else 0.9, (16, 16))
    mat = SparseMatrix.from_dense(a, formats=(fmt, "csr"), block=(16, 16),
                                  device="cpu")
    jmat = JSparseMatrix.from_dense(a, formats=(fmt, "csr"),
                                    block=(16, 16))
    assert mat.T.formats == jmat.T.formats
    h = _h(18, 100)
    clear_log()
    got = matmul(mat.T, torch.from_numpy(h))
    plan = last_plan("spmm")
    from repro.dispatch.dispatcher import last_plan as j_last_plan
    want = j_matmul(jmat.T, jnp.asarray(h))
    jplan = j_last_plan("spmm")
    assert (plan.path, plan.reason) == (jplan.path, jplan.reason)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# The densify memo
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["ell", "coo", "sell", "csr"])
def test_densify_is_memoized(fmt):
    a = _dense(19, (100, 70), 0.9, (16, 16))
    mat = SparseMatrix.from_dense(a, formats=(fmt,), block=(16, 16),
                                  device="cpu")
    first = mat.densify()
    assert mat.densify() is first
    assert mat.to("dense") is first
    # a new SparseMatrix over the same tensors hits too (the reference's
    # memo survives pytree reconstruction the same way)
    again = SparseMatrix({fmt: mat.form(fmt)}, mat.shape, mat.stats)
    assert again.densify() is first
    np.testing.assert_array_equal(first.numpy(), a)
    np.testing.assert_array_equal(
        first.numpy(), np.asarray(JSparseMatrix.from_dense(
            a, formats=(fmt,), block=(16, 16)).densify()))


@pytest.mark.parametrize("fmt", ["ell", "sell", "csr"])
def test_densify_misses_after_an_in_place_update(fmt):
    a = _dense(20, (100, 70), 0.9, (16, 16))
    mat = SparseMatrix.from_dense(a, formats=(fmt,), block=(16, 16),
                                  device="cpu")
    before = mat.densify()
    matrix.values_of(fmt, mat.form(fmt)).mul_(2.0)
    after = mat.densify()
    assert after is not before
    np.testing.assert_array_equal(after.numpy(), 2 * a)
    np.testing.assert_array_equal(before.numpy(), a)
    assert mat.densify() is after


def test_densify_memo_entry_goes_with_the_values():
    a = _dense(21, (100, 70), 0.9, (16, 16))
    vals = None
    mat = SparseMatrix.from_dense(a, formats=("ell",), block=(16, 16),
                                  device="cpu")
    vals = id(mat.data)
    mat.densify()
    assert vals in matrix._DENSE_MEMO
    del mat
    gc.collect()
    assert vals not in matrix._DENSE_MEMO


def test_densify_of_values_needing_grad_is_not_memoized():
    a = _dense(22, (100, 70), 0.9, (16, 16))
    mat = SparseMatrix.from_dense(a, formats=("csr",), block=(16, 16),
                                  device="cpu")
    v = mat.data.clone().requires_grad_(True)
    grad_mat = mat.with_data(v)
    out = grad_mat.densify()
    assert out.requires_grad and id(v) not in matrix._DENSE_MEMO
    out.sum().backward()
    np.testing.assert_array_equal(v.grad.numpy(), np.ones(v.shape[0]))
