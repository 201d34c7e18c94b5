"""Port parity: SDDMM, its kernels' wrappers (K3, K4) and the SDDMM
front-end.

On the CPU each wrapper runs its kernel's plain version; it is held to
the JAX package's Pallas kernel run in interpret mode on the same numpy
inputs, at K = 2 (GAT's width) and 48, with a weighted mask for K3
(rtol 1e-5, atol 1e-5: f32 sums in another order); K4's slot plain
version is held besides to the tile route it replaced (the tile-granular
plain version gathered to slots).  The front-end
``repro_torch.sparse.ops.sddmm`` is held to ``repro.sparse.sddmm`` on
the same matrices: the same plan and values within rtol 3e-4, atol 3e-4
(the reference's own SDDMM tolerance).  bf16 and f16 operands (dots in
f32, one rounding at the end): rtol = atol = 2e-2, the reference's bf16
tolerance; K3 returns the reference's default ``jnp.result_type(mask,
B)`` and K4 f32, as the reference's ``sample_sell_blocked`` does.  K3
without a mask, and ``sddmm_blockcoo(..., weighted=False)`` whatever A's
values hold, are held to the reference's K3 over an all-ones mask (how
the reference's ELL path samples), and the ELL path's one weighted K3
launch to ``repro.sparse.sddmm`` in every dtype pair and, bit for bit,
to the composition it replaced (ones mask, then values times dots).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_dtypes import (DTYPE_PAIRS, DTYPES, J_DTYPES, NARROW_TOL,
                           assert_narrow_close, to_jax, torch_dtype)

from repro.configs.paper_gnn import SMOKE_CONFIG as J_SMOKE
from repro.core.formats import BlockCOO as JBlockCOO
from repro.core.formats import SellCS as JSellCS
from repro.kernels.sddmm.kernel import sddmm_blockcoo_kernel as j_k3
from repro.kernels.sddmm.ops import sddmm_blockcoo as j_sddmm_blockcoo
from repro.kernels.sddmm.sell import sample_sell_blocked as j_sample_sell
from repro.kernels.sddmm.sell import sddmm_sell_kernel as j_k4
from repro.models.gnn import build_graph as j_build_graph
from repro.models.gnn import graph_candidates as j_graph_candidates
from repro.sparse import SparseMatrix as JSparseMatrix
from repro.sparse import sddmm as j_sddmm
from repro.sparse.paths import sddmm_element_dots as j_element_dots
from repro_torch.configs.paper_gnn import SMOKE_CONFIG
from repro_torch.core.formats import BlockCOO, SellCS
from repro_torch.data.pipeline import random_graph
from repro_torch.dispatch.dispatcher import clear_log, dispatch_log
from repro_torch.kernels.sddmm.kernel import sddmm_blockcoo_kernel
from repro_torch.kernels.sddmm.ref import sddmm_blockcoo_ref
from repro_torch.kernels.sddmm.ops import sddmm_blockcoo
from repro_torch.kernels.sddmm.sell import (sample_sell_blocked,
                                            sddmm_sell_kernel,
                                            sddmm_sell_operands,
                                            sddmm_sell_slots_ref,
                                            sddmm_sell_tiles_ref)
from repro_torch.models.gnn import build_graph, graph_candidates
from repro_torch.sparse import autodiff, ops
from repro_torch.sparse.matrix import SparseMatrix, values_of, with_values
from repro_torch.sparse.paths import sddmm_element_dots

KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=3e-4, atol=3e-4)
M, N, BLOCK = 45, 40, (8, 8)  # ragged: M and N are not multiples of 8


def _weighted(seed, density=0.15, m=M, n=N):
    rng = np.random.default_rng(seed)
    a = np.where(rng.random((m, n)) < density, rng.normal(size=(m, n)),
                 0.0).astype(np.float32)
    a[7] = 0.0  # an empty row
    return a


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("k", [2, 48])
def test_k3_plain_matches_pallas_interpret(k):
    a = _weighted(k)
    rng = np.random.default_rng(k + 1)
    jcoo = JBlockCOO.from_dense(a, *BLOCK, pad_to=40)
    coo = BlockCOO.from_dense(a, *BLOCK, pad_to=40, device="cpu")
    for name in ("rows", "cols", "blocks"):
        np.testing.assert_array_equal(getattr(coo, name).numpy(),
                                      np.asarray(getattr(jcoo, name)))
    assert coo.shape == jcoo.shape and coo.nnzb == jcoo.nnzb == 40
    b = rng.normal(size=(coo.shape[0], k)).astype(np.float32)
    c = rng.normal(size=(k, coo.shape[1])).astype(np.float32)
    want = j_k3(jcoo.rows, jcoo.cols, jcoo.blocks, jnp.asarray(b),
                jnp.asarray(c), bk=k, interpret=True)
    before = sddmm_blockcoo_kernel.launches
    got = sddmm_blockcoo_kernel(coo.rows, coo.cols, coo.blocks, _t(b), _t(c))
    assert sddmm_blockcoo_kernel.launches == before  # plain version on CPU
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)
    # the weighted mask: Y = A ⊙ (B C) at A's blocks
    out = sddmm_blockcoo(coo, _t(b), _t(c))
    np.testing.assert_allclose(out.to_dense()[:M, :N],
                               a * (b @ c)[:M, :N], **TOL)


@pytest.mark.parametrize("k", [2, 48])
def test_k4_plain_matches_pallas_interpret(k):
    """The tile-granular plain version against the Pallas kernel, and the
    SELL sampling entry point (K4's slot plain version on the CPU)
    against the reference's."""
    a = _weighted(k, density=0.05)
    rng = np.random.default_rng(k + 2)
    jsell = JSellCS.from_dense(a, block=BLOCK)
    sell = SellCS.from_dense(a, block=BLOCK, device="cpu")
    bm, bn = BLOCK
    mask = (sell.tile_slot_map < sell.n_slots).float()
    b_perm = rng.normal(size=(sell.n_live_block_rows * bm, k)) \
        .astype(np.float32)
    c = rng.normal(size=(k, -(-N // bn) * bn)).astype(np.float32)
    want = j_k4(jsell.tile_rows, jsell.tile_cols,
                jnp.asarray(mask.numpy()), jnp.asarray(b_perm),
                jnp.asarray(c), bk=k, interpret=True)
    got = sddmm_sell_tiles_ref(sell.tile_rows, sell.tile_cols, mask,
                               _t(b_perm), _t(c))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)
    # slot-ordered dots, padding slots zero
    b = rng.normal(size=(M, k)).astype(np.float32)
    c = rng.normal(size=(k, N)).astype(np.float32)
    before = sddmm_sell_kernel.launches
    got = sample_sell_blocked(sell, _t(b), _t(c))
    assert sddmm_sell_kernel.launches == before  # plain version on CPU
    np.testing.assert_allclose(
        got.numpy(), np.asarray(j_sample_sell(jsell, jnp.asarray(b),
                                              jnp.asarray(c),
                                              interpret=True)),
        **KERNEL_TOL)


def _tile_path_slots(sell, b, c):
    """The tile route K4 replaced: the tile-granular plain version over
    the 0/1 tile mask, gathered back to slot order (dead cells read an
    appended zero)."""
    bn = sell.bn
    b_perm = torch.cat([b, b.new_zeros((1, b.shape[1]))])[sell.perm]
    c_pad = torch.nn.functional.pad(c, (0, -(-c.shape[1] // bn) * bn
                                        - c.shape[1]))
    tiles = sddmm_sell_tiles_ref(sell.tile_rows, sell.tile_cols,
                                 (sell.tile_slot_map < sell.n_slots).float(),
                                 b_perm, c_pad)
    return torch.cat([tiles.reshape(-1), tiles.new_zeros(1)])[
        sell.slot_tile_pos]


@pytest.mark.parametrize("k", [2, 48])
def test_k4_slots_plain_matches_tile_path(k):
    """K4's slot plain version, on its slot operands, against the JAX
    ``sample_sell_blocked`` (Pallas in interpret mode) and against the
    tile route it replaced, on a ragged matrix with skewed rows."""
    a = _weighted(k + 20, density=0.08, m=97, n=83)
    a[11, :70] = 1.0  # a long row beside short ones
    rng = np.random.default_rng(k + 21)
    sell = SellCS.from_dense(a, block=BLOCK, device="cpu")
    b = rng.normal(size=(97, k)).astype(np.float32)
    c = rng.normal(size=(k, 83)).astype(np.float32)
    got = sddmm_sell_kernel(*sddmm_sell_operands(sell), _t(b), _t(c))
    assert got.shape == (sell.n_slots,) and got.dtype == torch.float32
    np.testing.assert_allclose(
        got.numpy(), np.asarray(j_sample_sell(
            JSellCS.from_dense(a, block=BLOCK), jnp.asarray(b),
            jnp.asarray(c), interpret=True)), **KERNEL_TOL)
    np.testing.assert_allclose(got.numpy(),
                               _tile_path_slots(sell, _t(b), _t(c)).numpy(),
                               **KERNEL_TOL)
    # each structural slot is its own dot of B's row and C's column
    live = sell.slot_vals != 0
    rows, cols = sell.slot_rows[live].long(), sell.slot_cols[live].long()
    np.testing.assert_allclose(got[live].numpy(),
                               (b[rows] * c.T[cols]).sum(-1), **KERNEL_TOL)


def test_k4_slots_are_zero_off_the_nonzeros():
    """Edge-less rows and the padding slots of short rows come out
    exactly 0; the output has every slot."""
    a = _weighted(31, density=0.1)
    a[[0, 7, 30]] = 0.0  # edge-less rows
    a[5, :35] = 1.0      # widens its slice: the other rows pad
    # sort windows of one slice keep each empty row beside live ones
    sell = SellCS.from_dense(a, block=BLOCK, sigma=8, device="cpu")
    rng = np.random.default_rng(31)
    b = _t(rng.normal(size=(M, 2)).astype(np.float32) + 3.0)
    c = _t(rng.normal(size=(2, N)).astype(np.float32) + 3.0)
    got = sample_sell_blocked(sell, b, c)
    live = sell.slot_vals != 0
    assert got.shape == (sell.n_slots,) and int((~live).sum()) > 40
    assert bool((got[~live] == 0).all()) and bool((got[live] != 0).all())
    empty = torch.isin(sell.slot_rows, torch.tensor([0, 7, 30]))
    assert bool(empty.any()) and bool((got[empty] == 0).all())


def test_sample_sell_without_live_tiles_is_zero():
    sell = SellCS.from_dense(np.zeros((20, 20), np.float32), block=BLOCK,
                             device="cpu")
    out = sample_sell_blocked(sell, torch.ones(20, 2), torch.ones(2, 20))
    assert out.shape == (sell.n_slots,) and not bool(out.any())


def _graph_adjacency(kind, n=256):
    rng = np.random.default_rng(7)
    if kind == "ell":  # uniform density 0.1
        return (rng.random((n, n)) < 0.1).astype(np.float32)
    if kind == "sell":  # skewed, > 99 % sparse
        return random_graph(n, 1.0, seed=1)
    return (rng.random((n, n)) < 0.01).astype(np.float32)  # csr


@pytest.mark.parametrize("kind", ["ell", "sell", "csr"])
def test_front_end_on_graphs_matches_reference(kind):
    adj = _graph_adjacency(kind)
    rng = np.random.default_rng(3)
    b = rng.normal(size=(256, 2)).astype(np.float32)
    c = rng.normal(size=(2, 256)).astype(np.float32)
    jg = j_build_graph(adj, J_SMOKE)
    want = j_sddmm(jg.adj, jnp.asarray(b), jnp.asarray(c),
                   candidates=j_graph_candidates(jg.adj))
    graph = build_graph(adj, SMOKE_CONFIG, device="cpu")
    clear_log()
    got = ops.sddmm(graph.adj, _t(b), _t(c),
                    candidates=graph_candidates(graph.adj))
    (plan,) = dispatch_log()
    assert plan.op == "sddmm" and plan.path == kind
    assert got.formats == want.formats == (kind,)
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data),
                               **TOL)
    # the plan is memoized per matrix: a second call hits it
    hits = graph.adj.plan_cache.hits
    ops.sample(graph.adj, _t(b), _t(c),
               candidates=graph_candidates(graph.adj))
    assert graph.adj.plan_cache.hits == hits + 1


@pytest.mark.parametrize("path", ["ell", "sell", "csr", "dense"])
@pytest.mark.parametrize("k", [2, 48])
def test_front_end_forced_paths_match_reference(path, k):
    a = _weighted(k + 5, density=0.1)
    rng = np.random.default_rng(k)
    b = rng.normal(size=(M, k)).astype(np.float32)
    c = rng.normal(size=(k, N)).astype(np.float32)
    formats = ("ell", "sell", "csr")
    want = j_sddmm(JSparseMatrix.from_dense(a, formats=formats, block=BLOCK),
                   jnp.asarray(b), jnp.asarray(c), policy=path)
    got = SparseMatrix.from_dense(a, formats=formats, block=BLOCK,
                                  device="cpu").sddmm(_t(b), _t(c),
                                                      policy=path)
    assert got.formats == want.formats
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data),
                               **TOL)
    np.testing.assert_allclose(got.to_dense(), a * (b @ c), **TOL)


def test_coo_form_samples_on_the_ell_path():
    a = _weighted(11)
    rng = np.random.default_rng(11)
    b = rng.normal(size=(M, 2)).astype(np.float32)
    c = rng.normal(size=(2, N)).astype(np.float32)
    mat = SparseMatrix.from_dense(a, formats=("coo",), block=BLOCK,
                                  device="cpu")
    assert ops.available_paths(mat) == ("ell", "dense")
    want = j_sddmm(JSparseMatrix.from_dense(a, formats=("coo",),
                                            block=BLOCK),
                   jnp.asarray(b), jnp.asarray(c), policy="ell")
    got = ops.sddmm(mat, _t(b), _t(c), policy="ell")
    assert got.formats == ("coo",)
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data),
                               **TOL)
    np.testing.assert_allclose(mat.to_dense(), a)


def test_pattern_with_data_and_to():
    a = _weighted(12)
    mat = SparseMatrix.from_dense(a, formats=("ell", "csr"), block=BLOCK,
                                  device="cpu")
    csr = mat.to("csr")
    assert csr.formats == ("csr",) and csr.plan_cache is mat.plan_cache
    patt = csr.pattern()
    np.testing.assert_array_equal(patt.to_dense(), (a != 0).astype(a.dtype))
    doubled = patt.with_data(2 * patt.data)
    np.testing.assert_array_equal(doubled.to_dense(), 2 * (a != 0))
    assert mat.to("coo").formats == ("coo",)
    np.testing.assert_allclose(mat.to("coo").to_dense(), a)
    np.testing.assert_allclose(mat.to("dense").numpy(), a)
    assert ops.sample is ops.sddmm


def test_front_end_rejects_bad_operands():
    mat = SparseMatrix.from_dense(_weighted(13), block=BLOCK, device="cpu")
    with pytest.raises(ValueError, match="rows"):
        ops.sddmm(mat, torch.ones(M + 1, 2), torch.ones(2, N))
    with pytest.raises(ValueError, match="columns"):
        ops.sddmm(mat, torch.ones(M, 2), torch.ones(2, N + 1))
    with pytest.raises(ValueError, match="inner dims"):
        ops.sddmm(mat, torch.ones(M, 2), torch.ones(3, N))
    with pytest.raises(TypeError):
        ops.sddmm(mat, np.ones((M, 2)), torch.ones(2, N))


# ---------------------------------------------------------------------------
# bf16 and f16 operands
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_k3_k4_narrow_operands_match_pallas(dtype):
    """K3 against ``repro.kernels.sddmm.ops.sddmm_blockcoo`` (Pallas in
    interpret mode, its default output dtype) and K4's entry point
    against ``sample_sell_blocked`` (interpret mode; f32 out there), on
    bf16 / f16 / f32 masks and factors."""
    a = _weighted(40)
    rng = np.random.default_rng(40)
    coo = BlockCOO.from_dense(a, *BLOCK, pad_to=40, device="cpu")
    coo = dataclasses.replace(coo, blocks=coo.blocks.to(dtype))
    jcoo = JBlockCOO.from_dense(a, *BLOCK, pad_to=40)
    jcoo = dataclasses.replace(jcoo, blocks=to_jax(coo.blocks))
    b = _t(rng.normal(size=(coo.shape[0], 2)).astype(np.float32)).to(dtype)
    c = _t(rng.normal(size=(2, coo.shape[1])).astype(np.float32)).to(dtype)
    want = j_sddmm_blockcoo(jcoo, to_jax(b), to_jax(c), interpret=True).blocks
    got = sddmm_blockcoo(coo, b, c).blocks
    assert got.dtype == dtype == torch_dtype(want.dtype)
    assert_narrow_close(got, want)
    sell = SellCS.from_dense(a, block=BLOCK, device="cpu")
    b, c = b[:M].contiguous(), c[:, :N].contiguous()
    want = j_sample_sell(JSellCS.from_dense(a, block=BLOCK), to_jax(b), to_jax(c),
                         interpret=True)
    got = sample_sell_blocked(sell, b, c)
    assert got.dtype == torch_dtype(want.dtype) == torch.float32
    assert_narrow_close(got, want)


@pytest.mark.parametrize("mask_dt,b_dt", DTYPE_PAIRS)
def test_sddmm_output_dtypes_follow_the_reference(mask_dt, b_dt):
    """K3's wrapper and plain version, and K4's tile plain version, return
    ``jnp.result_type(mask, B)`` (``repro.kernels.sddmm.ops:30``); K4's
    wrapper and plain version and the SELL entry point f32, which the
    reference's ``sample_sell_blocked`` asks of its kernel; the element
    dots the reference's dtype."""
    a = _weighted(41, density=0.08)
    rng = np.random.default_rng(41)
    coo = BlockCOO.from_dense(a, *BLOCK, device="cpu")
    mask = coo.blocks.to(mask_dt)
    b = _t(rng.normal(size=(coo.shape[0], 3)).astype(np.float32)).to(b_dt)
    c = _t(rng.normal(size=(3, coo.shape[1])).astype(np.float32)).to(b_dt)
    ops3 = (coo.rows, coo.cols, mask, b, c)
    want3 = torch_dtype(jnp.result_type(J_DTYPES[mask_dt], J_DTYPES[b_dt]))
    assert sddmm_blockcoo_kernel(*ops3).dtype == want3
    assert sddmm_blockcoo_ref(*ops3).dtype == want3
    sell = SellCS.from_dense(a, block=BLOCK, device="cpu")
    c_mixed = c.to(mask_dt)
    bm, bn = BLOCK
    for cc in (c, c_mixed):
        ops4 = (*sddmm_sell_operands(sell), b[:M], cc[:, :N])
        assert sddmm_sell_kernel(*ops4).dtype == torch.float32
        assert sddmm_sell_slots_ref(*ops4).dtype == torch.float32
        assert sample_sell_blocked(sell, b[:M], cc[:, :N]).dtype \
            == torch.float32
    tmask = (sell.tile_slot_map < sell.n_slots).to(mask_dt)
    b_perm = b[: sell.n_live_block_rows * bm]
    assert sddmm_sell_tiles_ref(sell.tile_rows, sell.tile_cols, tmask,
                                b_perm, c).dtype == want3
    rows, cols = (_t(x.astype(np.int32)) for x in np.nonzero(a))
    assert sddmm_element_dots(rows, cols, b, c).dtype == torch_dtype(
        j_element_dots(jnp.asarray(rows.numpy()), jnp.asarray(cols.numpy()),
                       to_jax(b), to_jax(c)).dtype)


def _narrow_matrix(a, dtype, formats):
    mat = SparseMatrix.from_dense(a, formats=formats, block=BLOCK,
                                  device="cpu")
    return SparseMatrix(
        {name: with_values(name, mat.form(name),
                           values_of(name, mat.form(name)).to(dtype))
         for name in formats}, mat.shape, mat.stats)


@pytest.mark.parametrize("dtype", DTYPES)
def test_sddmm_paths_agree_on_dtype(dtype):
    """The raw dots of every path (csr: element dots, ell: K3 without a
    mask, sell: K4's f32 dots cast once by ``sample_exec``,
    dense) and the SDDMM values come out in one dtype on the same
    operands, with the same values."""
    a = _weighted(42, density=0.1)
    rng = np.random.default_rng(42)
    b = _t(rng.normal(size=(M, 2)).astype(np.float32)).to(dtype)
    c = _t(rng.normal(size=(2, N)).astype(np.float32)).to(dtype)
    mat = _narrow_matrix(a, dtype, ("ell", "sell", "csr"))
    for path in ("ell", "sell", "csr", "dense"):
        raw = autodiff.sample_exec(path, mat, b, c)
        assert raw.dtype == dtype, path
        got = ops.sddmm(mat, b, c, policy=path)
        assert got.data.dtype == dtype, path
        np.testing.assert_allclose(got.densify().float().numpy(),
                                   a * (b.float() @ c.float()).numpy(),
                                   **NARROW_TOL)


# ---------------------------------------------------------------------------
# K3 without a mask, and the ELL path's one weighted launch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [2, 48])
def test_k3_without_mask_matches_pallas_ones_mask(k, dtype):
    """K3 with ``mask_blocks=None`` (every cell of each tile sampled)
    against the reference's K3 over an all-ones mask of the same dtype
    (Pallas in interpret mode), which is how the reference's ELL path
    samples; the output dtype is ``result_type(ones, B)``."""
    a = _weighted(k + 50)
    rng = np.random.default_rng(k + 50)
    coo = BlockCOO.from_dense(a, *BLOCK, pad_to=40, device="cpu")
    jcoo = JBlockCOO.from_dense(a, *BLOCK, pad_to=40)
    ones = torch.ones(coo.blocks.shape, dtype=dtype)
    jcoo = dataclasses.replace(jcoo, blocks=to_jax(ones))
    b = _t(rng.normal(size=(coo.shape[0], k)).astype(np.float32)).to(dtype)
    c = _t(rng.normal(size=(k, coo.shape[1])).astype(np.float32)).to(dtype)
    want = j_sddmm_blockcoo(jcoo, to_jax(b), to_jax(c), interpret=True).blocks
    before = sddmm_blockcoo_kernel.launches
    got = sddmm_blockcoo_kernel(coo.rows, coo.cols, None, b, c,
                                block=BLOCK, out_dtype=dtype)
    assert sddmm_blockcoo_kernel.launches == before  # plain version on CPU
    assert got.dtype == torch_dtype(want.dtype) == dtype
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **KERNEL_TOL)
    else:
        assert_narrow_close(got, want)
    # the no-mask result is the ones mask's, bit for bit (1 * dot == dot)
    assert torch.equal(got, sddmm_blockcoo_ref(coo.rows, coo.cols, ones, b,
                                               c))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_sddmm_blockcoo_unweighted_reads_no_values(dtype):
    """``sddmm_blockcoo(..., weighted=False)``: B @ C at every cell of the
    nonzero blocks in ``result_type(blocks, B)``, the reference's K3 over a
    ones mask, whatever A's values hold (NaN here)."""
    a = _weighted(7)
    rng = np.random.default_rng(7)
    coo = BlockCOO.from_dense(a, *BLOCK, pad_to=40, device="cpu")
    ones = torch.ones(coo.blocks.shape, dtype=dtype)
    jcoo = dataclasses.replace(JBlockCOO.from_dense(a, *BLOCK, pad_to=40),
                               blocks=to_jax(ones))
    b = _t(rng.normal(size=(coo.shape[0], 2)).astype(np.float32)).to(dtype)
    c = _t(rng.normal(size=(2, coo.shape[1])).astype(np.float32)).to(dtype)
    nan = dataclasses.replace(coo, blocks=torch.full_like(ones, float("nan")))
    got = sddmm_blockcoo(nan, b, c, weighted=False)
    assert (got.rows is coo.rows) and got.shape == coo.shape
    want = j_sddmm_blockcoo(jcoo, to_jax(b), to_jax(c), interpret=True).blocks
    assert got.blocks.dtype == torch_dtype(want.dtype) == dtype
    assert torch.equal(got.blocks, sddmm_blockcoo(
        dataclasses.replace(coo, blocks=ones), b, c).blocks)
    if dtype == torch.float32:
        np.testing.assert_allclose(got.blocks.numpy(), np.asarray(want),
                                   **KERNEL_TOL)
    else:
        assert_narrow_close(got.blocks, want)


@pytest.mark.parametrize("val_dt,b_dt", DTYPE_PAIRS)
def test_ell_sddmm_matches_reference_in_every_dtype(val_dt, b_dt):
    """The ELL path's values (one K3 launch with A's values as its mask)
    through ``sddmm_values`` and ``ops.sddmm`` against
    ``repro.sparse.sddmm`` on the ell path, values and factors in each
    dtype pair: the same dtype, and values within the reference's bf16
    tolerance (f32: its SDDMM tolerance)."""
    a = _weighted(43, density=0.1)
    rng = np.random.default_rng(43)
    b = _t(rng.normal(size=(M, 2)).astype(np.float32)).to(b_dt)
    c = _t(rng.normal(size=(2, N)).astype(np.float32)).to(b_dt)
    mat = _narrow_matrix(a, val_dt, ("ell",))
    jmat = JSparseMatrix.from_dense(a, formats=("ell",), block=BLOCK)
    jmat = jmat.with_data(to_jax(values_of("ell", mat.form("ell"))))
    want = j_sddmm(jmat, to_jax(b), to_jax(c), policy="ell")
    vals = autodiff.sddmm_values("ell", mat, b, c)
    got = ops.sddmm(mat, b, c, policy="ell")
    assert got.formats == want.formats == ("ell",)
    assert vals.dtype == got.data.dtype == torch_dtype(want.data.dtype)
    assert torch.equal(vals, got.data)
    if val_dt == b_dt == torch.float32:
        np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data),
                                   **TOL)
    else:
        assert_narrow_close(got.data, want.data)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ell_one_launch_equals_ones_mask_then_values(dtype):
    """The ELL path's single weighted K3 launch against the composition it
    replaced: K3 over an all-ones mask, then the values times the dots in
    f32, rounded once to ``result_type(values, B)``.  K3 rounds each dot
    to the output dtype before the mask multiplies it, so the two agree
    bit for bit in every dtype (in f32 the rounding is a no-op)."""
    a = _weighted(44, density=0.2)
    rng = np.random.default_rng(44)
    b = _t(rng.normal(size=(M, 3)).astype(np.float32)).to(dtype)
    c = _t(rng.normal(size=(3, N)).astype(np.float32)).to(dtype)
    mat = _narrow_matrix(a, dtype, ("ell",))
    ell = mat.form("ell")
    coo = BlockCOO(rows=torch.arange(ell.n_block_rows, dtype=torch.int32)
                   .repeat_interleave(ell.ell_width),
                   cols=ell.indices.reshape(-1),
                   blocks=ell.blocks.reshape(-1, *BLOCK), shape=ell.shape)
    b_pad = torch.nn.functional.pad(b, (0, 0, 0, ell.shape[0] - M))
    c_pad = torch.nn.functional.pad(c, (0, ell.shape[1] - N))
    raw = sddmm_blockcoo_ref(coo.rows, coo.cols, torch.ones_like(coo.blocks),
                             b_pad, c_pad)
    old = (coo.blocks.float() * raw.float()).to(
        torch.promote_types(coo.blocks.dtype, b.dtype))
    got = autodiff.sddmm_values("ell", mat, b, c)
    assert got.dtype == dtype
    assert torch.equal(got, old.reshape(ell.blocks.shape))
    # and the raw dots: K3 without a mask, no ones array
    assert torch.equal(autodiff.sample_exec("ell", mat, b, c),
                       raw.reshape(ell.blocks.shape))
