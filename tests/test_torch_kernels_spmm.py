"""Port parity: the four SpMM kernels' wrappers (K1, K2, K5, K6).

On the CPU each wrapper runs its kernel's plain version; it is held to
the JAX package's Pallas kernel run in interpret mode on the same numpy
inputs.  Tolerance: rtol 1e-5, atol 1e-5 (f32 sums in another order).
bf16 and f16 operands (sums in f32, one rounding at the end): rtol =
atol = 2e-2, the reference's ``test_spmm_kernel_bf16``; their output
dtype is the reference's default, ``jnp.result_type`` of the operands.
The CUDA kernels themselves are held to the same plain versions on the
card by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""
import dataclasses
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_dtypes import (DTYPE_PAIRS, DTYPES, NARROW_TOL,
                           assert_narrow_close, result_type, to_jax,
                           torch_dtype)

from repro.core.formats import BlockCOO as JBlockCOO
from repro.core.formats import BlockELL as JBlockELL
from repro.core.formats import SellCS as JSellCS
from repro.kernels.fused.epilogue import Epilogue as JEpilogue
from repro.kernels.fused.epilogue import apply_epilogue as j_apply_epilogue
from repro.kernels.fused.spmm import spmm_blockell_fused as j_ell_fused
from repro.kernels.fused.spmm import spmm_sell_fused as j_sell_fused
from repro.kernels.spmm.ops import spmm_blockell as j_spmm_blockell
from repro.kernels.spmm.sell import sell_tile_blocks as j_tile_blocks
from repro.kernels.spmm.sell import spmm_sell_blocked as j_spmm_sell
from repro.kernels.spmm.sell import spmm_sell_tiles_ref as j_tiles_ref
from repro.sparse.paths import spmm_coo as j_spmm_coo
from repro.sparse.paths import spmm_elements as j_spmm_elements
from repro_torch.configs.paper_gnn import SMOKE_CONFIG
from repro_torch.core.formats import BlockCOO, BlockELL, SellCS
from repro_torch.data.pipeline import random_graph
from repro_torch.kernels.fused.epilogue import Epilogue
from repro_torch.kernels.fused.spmm import (spmm_blockell_epilogue_kernel,
                                            spmm_blockell_epilogue_ref,
                                            spmm_blockell_fused,
                                            spmm_sell_epilogue_kernel,
                                            spmm_sell_epilogue_ref,
                                            spmm_sell_epilogue_slots_ref,
                                            spmm_sell_fused)
from repro_torch.kernels.spmm.kernel import spmm_blockell_kernel
from repro_torch.kernels.spmm.ops import spmm_blockell
from repro_torch.kernels.spmm.ref import spmm_blockell_ref
from repro_torch.kernels.spmm.sell import (sell_row_operands,
                                           sell_tile_blocks,
                                           spmm_sell_blocked,
                                           spmm_sell_kernel,
                                           spmm_sell_slots_ref,
                                           spmm_sell_tiles_ref)
from repro_torch.models.gnn import build_graph, init_gcn
from repro_torch.serve.engine import GNNServingEngine
from repro_torch.sparse.matrix import SparseMatrix, values_of, with_values
from repro_torch.sparse.ops import matmul
from repro_torch.sparse.paths import pad_rows, spmm_coo, spmm_elements

TOL = dict(rtol=1e-5, atol=1e-5)
M, N, BLOCK = 45, 40, (8, 8)  # ragged: M and N are not multiples of 8
EPILOGUES = [(act, has_bias, has_res)
             for act in ("identity", "relu", "leaky_relu")
             for has_bias in (False, True) for has_res in (False, True)]
WRAPPERS = (spmm_blockell_kernel, spmm_sell_kernel,
            spmm_blockell_epilogue_kernel, spmm_sell_epilogue_kernel)


def _inputs(seed, d, density=0.15):
    rng = np.random.default_rng(seed)
    a = np.where(rng.random((M, N)) < density, rng.normal(size=(M, N)),
                 0.0).astype(np.float32)
    a[7] = 0.0  # an empty row (pruned by the SELL packing)
    h = rng.normal(size=(N, d)).astype(np.float32)
    bias = rng.normal(size=(d,)).astype(np.float32)
    res = rng.normal(size=(M, d)).astype(np.float32)
    return a, h, bias, res


def _epilogues(act, has_bias, has_res):
    slope = 0.2 if act == "leaky_relu" else 0.01
    kw = dict(act=act, negative_slope=slope, has_bias=has_bias,
              has_residual=has_res)
    return JEpilogue(**kw), Epilogue(**kw)


@pytest.mark.parametrize("d", [4, 16, 32])
def test_k1_blockell_matches_pallas(d):
    a, h, _, _ = _inputs(0, d)
    jell = JBlockELL.from_dense(a, *BLOCK)
    ell = BlockELL.from_dense(a, *BLOCK, device="cpu")
    hp = pad_rows(torch.from_numpy(h), ell.shape[1])
    ref = j_spmm_blockell(jell, jnp.asarray(hp.numpy()), use_kernel=True,
                          interpret=True)
    out = spmm_blockell(ell, hp)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(out.numpy()[:M], a @ h, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("d", [4, 16, 32])
def test_k2_sell_matches_pallas(d):
    a, h, _, _ = _inputs(1, d)
    jsell = JSellCS.from_dense(a, block=BLOCK)
    sell = SellCS.from_dense(a, block=BLOCK, device="cpu")
    ref = j_spmm_sell(jsell, jnp.asarray(h), interpret=True)
    out = spmm_sell_blocked(sell, torch.from_numpy(h))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


# every epilogue at D=16, and the full one at the other widths
CASES = [(spec, 16) for spec in EPILOGUES] \
    + [(("relu", True, True), d) for d in (4, 32)]


@pytest.mark.parametrize("spec,d", CASES)
def test_k5_blockell_epilogue_matches_pallas(spec, d):
    a, h, bias, res = _inputs(2, d)
    jepi, epi = _epilogues(*spec)
    b = bias if epi.has_bias else None
    r = res if epi.has_residual else None
    jell = JBlockELL.from_dense(a, *BLOCK)
    ell = BlockELL.from_dense(a, *BLOCK, device="cpu")
    hp = pad_rows(torch.from_numpy(h), ell.shape[1])
    ref = j_ell_fused(jell, jnp.asarray(hp.numpy()), jepi,
                      None if b is None else jnp.asarray(b),
                      None if r is None else jnp.asarray(r), interpret=True)
    out = spmm_blockell_fused(
        ell, hp, epi, None if b is None else torch.from_numpy(b),
        None if r is None else torch.from_numpy(r))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("spec,d", CASES)
def test_k6_sell_epilogue_matches_pallas(spec, d):
    a, h, bias, res = _inputs(3, d)
    jepi, epi = _epilogues(*spec)
    b = bias if epi.has_bias else None
    r = res if epi.has_residual else None
    jsell = JSellCS.from_dense(a, block=BLOCK)
    sell = SellCS.from_dense(a, block=BLOCK, device="cpu")
    ref = j_sell_fused(jsell, jnp.asarray(h), jepi,
                       None if b is None else jnp.asarray(b),
                       None if r is None else jnp.asarray(r), interpret=True)
    out = spmm_sell_fused(
        sell, torch.from_numpy(h), epi,
        None if b is None else torch.from_numpy(b),
        None if r is None else torch.from_numpy(r))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_sell_without_live_tiles():
    a = np.zeros((20, 12), np.float32)
    sell = SellCS.from_dense(a, block=BLOCK, device="cpu")
    jsell = JSellCS.from_dense(a, block=BLOCK)
    h = np.ones((12, 4), np.float32)
    bias = np.arange(4, dtype=np.float32) - 1.5
    jepi, epi = _epilogues("relu", True, False)
    out = spmm_sell_fused(sell, torch.from_numpy(h), epi,
                          torch.from_numpy(bias))
    ref = j_sell_fused(jsell, jnp.asarray(h), jepi, jnp.asarray(bias),
                       interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert not spmm_sell_blocked(sell, torch.from_numpy(h)).any()


def test_cpu_path_launches_no_kernel():
    a, h, bias, _ = _inputs(4, 16)
    before = [w.launches for w in WRAPPERS]
    ell = BlockELL.from_dense(a, *BLOCK, device="cpu")
    sell = SellCS.from_dense(a, block=BLOCK, device="cpu")
    hp = pad_rows(torch.from_numpy(h), ell.shape[1])
    _, epi = _epilogues("relu", True, False)
    spmm_blockell(ell, hp)
    spmm_blockell_fused(ell, hp, epi, torch.from_numpy(bias))
    spmm_sell_blocked(sell, torch.from_numpy(h))
    spmm_sell_fused(sell, torch.from_numpy(h), epi, torch.from_numpy(bias))
    assert [w.launches for w in WRAPPERS] == before


def test_wrappers_refuse_other_devices():
    """Tensors that are neither on the CPU nor on CUDA get no kernel and
    no plain version."""
    meta = dict(device="meta")
    idx = torch.zeros((2, 1), dtype=torch.int32, **meta)
    blocks = torch.zeros((2, 1, 8, 8), **meta)
    h = torch.zeros((8, 4), **meta)
    with pytest.raises(ValueError, match="neither CPU"):
        spmm_blockell_kernel(idx, blocks, h)
    with pytest.raises(ValueError, match="neither CPU"):
        spmm_sell_kernel(idx[:, 0], idx[:, 0], idx[:, 0], h[:, 0], h,
                         heavy_rows=idx[:, 0])


def test_epilogue_operands_must_match_spec():
    a, h, bias, _ = _inputs(5, 4)
    ell = BlockELL.from_dense(a, *BLOCK, device="cpu")
    hp = pad_rows(torch.from_numpy(h), ell.shape[1])
    _, epi = _epilogues("relu", True, False)
    with pytest.raises(ValueError, match="disagrees"):
        spmm_blockell_epilogue_kernel(ell.indices, ell.blocks, hp, None,
                                      None, epi=epi)


# The nonzero-granular plain versions of K2/K6 (the kernels' own operands:
# the row view and the slots) against the tile-granular ones on the same
# matrix, torch's and the JAX package's.  Tolerance 1e-5: the same
# nonzero terms, summed in the same column order, but the tile versions
# also add the zero cells of each tile.
SLOT_TOL = dict(rtol=1e-5, atol=1e-5)
SLOT_WIDTHS = [1, 16, 48, 100]


def _slot_case(seed, d, a=None):
    """A ragged SELL matrix with rows of no nonzeros inside its live
    block-rows, its (torch, JAX) packings, H and H padded to the
    block-column grid."""
    if a is None:
        a, h, _, _ = _inputs(seed, d)
        a[[20, 21, 30]] = 0.0
    else:
        h = np.random.default_rng(seed).normal(
            size=(a.shape[1], d)).astype(np.float32)
    sell = SellCS.from_dense(a, block=BLOCK, device="cpu")
    n_pad = -(-a.shape[1] // BLOCK[1]) * BLOCK[1]
    hp = pad_rows(torch.from_numpy(h), n_pad)
    return sell, JSellCS.from_dense(a, block=BLOCK), torch.from_numpy(h), hp


def _tile_ops(sell, hp):
    return (sell.tile_rows, sell.tile_cols, sell_tile_blocks(sell), hp)


def _j_tile_ref(jsell, hp):
    return np.asarray(j_tiles_ref(
        jsell.tile_rows, jsell.tile_cols, j_tile_blocks(jsell),
        jnp.asarray(hp.numpy()), n_live_block_rows=jsell.n_live_block_rows))


def test_slot_case_has_empty_live_rows():
    sell, _, _, _ = _slot_case(6, 4)
    empty = sell.tile_row_nnz == 0
    assert bool((empty & (sell.perm < M)).any())  # a real row, no nonzeros
    assert bool((empty & (sell.perm == M)).any())  # a padding row


@pytest.mark.parametrize("d", SLOT_WIDTHS)
def test_k2_slot_plain_version_matches_tile_refs(d):
    sell, jsell, h, hp = _slot_case(6, d)
    got = spmm_sell_slots_ref(*sell_row_operands(sell), h)
    kw = dict(n_live_block_rows=sell.n_live_block_rows)
    np.testing.assert_allclose(
        got.numpy(), spmm_sell_tiles_ref(*_tile_ops(sell, hp), **kw).numpy(),
        **SLOT_TOL)
    np.testing.assert_allclose(got.numpy(), _j_tile_ref(jsell, hp),
                               **SLOT_TOL)
    # the wrapper on CPU tensors is this plain version
    torch.testing.assert_close(
        spmm_sell_kernel(*sell_row_operands(sell), h,
                         heavy_rows=sell.tile_heavy_rows), got, rtol=0,
        atol=0)


@pytest.mark.parametrize("act", ["identity", "relu", "leaky_relu"])
@pytest.mark.parametrize("d", SLOT_WIDTHS)
def test_k6_slot_plain_version_matches_tile_refs(act, d):
    sell, jsell, h, hp = _slot_case(7, d)
    jepi, epi = _epilogues(act, True, True)
    rng = np.random.default_rng(d)
    bias = rng.normal(size=(d,)).astype(np.float32)
    res = rng.normal(size=(sell.n_live_block_rows * BLOCK[0], d)) \
        .astype(np.float32)
    tail = (torch.from_numpy(bias), torch.from_numpy(res))
    got = spmm_sell_epilogue_slots_ref(*sell_row_operands(sell), h, *tail,
                                       epi=epi)
    want = spmm_sell_epilogue_ref(
        *_tile_ops(sell, hp), *tail, epi=epi,
        n_live_block_rows=sell.n_live_block_rows)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **SLOT_TOL)
    jwant = j_apply_epilogue(jnp.asarray(_j_tile_ref(jsell, hp)), jepi,
                             jnp.asarray(bias), jnp.asarray(res))
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), **SLOT_TOL)
    # rows without nonzeros (padding rows too) are act(bias + res)
    empty = (sell.tile_row_nnz == 0).numpy()
    np.testing.assert_allclose(
        got.numpy()[empty],
        spmm_sell_epilogue_slots_ref(
            *sell_row_operands(sell), torch.zeros_like(h), *tail,
            epi=epi).numpy()[empty], rtol=0, atol=0)
    torch.testing.assert_close(
        spmm_sell_epilogue_kernel(*sell_row_operands(sell), h, *tail,
                                  epi=epi, heavy_rows=sell.tile_heavy_rows),
        got, rtol=0, atol=0)


def test_slot_plain_versions_without_live_tiles():
    sell, jsell, h, hp = _slot_case(8, 4, a=np.zeros((20, 12), np.float32))
    assert sell.n_live_block_rows == 0
    got = spmm_sell_slots_ref(*sell_row_operands(sell), h)
    assert got.shape == (0, 4)
    np.testing.assert_array_equal(got.numpy(), _j_tile_ref(jsell, hp))
    _, epi = _epilogues("relu", True, True)
    out = spmm_sell_epilogue_slots_ref(
        *sell_row_operands(sell), h, torch.ones(4), torch.ones((0, 4)),
        epi=epi)
    assert out.shape == (0, 4)


def test_sell_path_needs_no_tile_view(monkeypatch):
    """SpMM, the fused SpMM and a GCN request on the sell path build no
    tile data and no row pointer."""
    def refuse(*args, **kwargs):
        raise AssertionError("the SELL SpMM path touched the tile view")

    for name, module in list(sys.modules.items()):
        if name.startswith("repro_torch"):
            for fn in ("sell_tile_blocks", "sell_row_ptr"):
                if hasattr(module, fn):
                    monkeypatch.setattr(module, fn, refuse)
    a, h, bias, res = _inputs(9, 16)
    jsell = JSellCS.from_dense(a, block=BLOCK)
    sell = SellCS.from_dense(a, block=BLOCK, device="cpu")
    np.testing.assert_allclose(
        spmm_sell_blocked(sell, torch.from_numpy(h)).numpy(),
        np.asarray(j_spmm_sell(jsell, jnp.asarray(h), interpret=True)),
        **TOL)
    jepi, epi = _epilogues("relu", True, True)
    ref = j_sell_fused(jsell, jnp.asarray(h), jepi, jnp.asarray(bias),
                       jnp.asarray(res), interpret=True)
    out = spmm_sell_fused(sell, torch.from_numpy(h), epi,
                          torch.from_numpy(bias), torch.from_numpy(res))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    graph = build_graph(random_graph(256, 1.0, seed=1), SMOKE_CONFIG,
                        device="cpu")
    eng = GNNServingEngine(init_gcn(SMOKE_CONFIG, seed=3, device="cpu"),
                           graph)
    assert eng.plan.path == "sell"
    x = np.random.default_rng(0).standard_normal(
        (256, SMOKE_CONFIG.in_features)).astype(np.float32)
    assert bool(torch.isfinite(eng.infer(x)).all())


# ---------------------------------------------------------------------------
# bf16 and f16 operands (the reference takes any float dtype, sums in f32
# and returns jnp.result_type of its operands by default)
# ---------------------------------------------------------------------------


def _j_ell(a, blocks, block):
    jell = JBlockELL.from_dense(a, *block)
    return dataclasses.replace(jell, blocks=to_jax(blocks))


@pytest.mark.parametrize("dtype", DTYPES)
def test_k1_narrow_operands_match_pallas(dtype):
    """The reference's ``tests/test_kernels_spmm.py::test_spmm_kernel_bf16``
    in the port: bf16 (and f16, f32) blocks and H, the Pallas kernel in
    interpret mode with its default output dtype."""
    rng = np.random.default_rng(0)
    dense = np.where(rng.random((128, 256)) < 0.2,
                     rng.normal(size=(128, 256)), 0.0).astype(np.float32)
    ell = BlockELL.from_dense(dense, 64, 128, device="cpu")
    blocks = ell.blocks.to(dtype)
    h = torch.from_numpy(rng.normal(size=(256, 128)).astype(
        np.float32)).to(dtype)
    want = j_spmm_blockell(_j_ell(dense, blocks, (64, 128)), to_jax(h),
                           interpret=True)
    got = spmm_blockell_kernel(ell.indices, blocks, h)
    assert got.dtype == dtype == torch_dtype(want.dtype)
    assert_narrow_close(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_k5_narrow_operands_match_pallas(dtype):
    a, h, bias, res = _inputs(10, 16)
    jepi, epi = _epilogues("leaky_relu", True, True)
    ell = BlockELL.from_dense(a, *BLOCK, device="cpu")
    blocks = ell.blocks.to(dtype)
    hp = pad_rows(torch.from_numpy(h), ell.shape[1]).to(dtype)
    b, r = (torch.from_numpy(x).to(dtype) for x in (bias, res))
    want = j_ell_fused(_j_ell(a, blocks, BLOCK), to_jax(hp), jepi, to_jax(b), to_jax(r),
                       interpret=True)
    got = spmm_blockell_fused(dataclasses.replace(ell, blocks=blocks), hp,
                              epi, b, r)
    assert got.dtype == dtype == torch_dtype(want.dtype)
    assert_narrow_close(got, want)


def _narrow_sell(a, dtype):
    sell = SellCS.from_dense(a, block=BLOCK, device="cpu")
    sell = dataclasses.replace(sell, slot_vals=sell.slot_vals.to(dtype))
    jsell = JSellCS.from_dense(a, block=BLOCK)
    return sell, dataclasses.replace(jsell, slot_vals=to_jax(sell.slot_vals))


@pytest.mark.parametrize("dtype", DTYPES)
def test_k2_k6_narrow_operands_match_pallas(dtype):
    a, h, bias, res = _inputs(13, 16)
    sell, jsell = _narrow_sell(a, dtype)
    ht, b, r = (torch.from_numpy(x).to(dtype) for x in (h, bias, res))
    want = j_spmm_sell(jsell, to_jax(ht), interpret=True)
    got = spmm_sell_blocked(sell, ht)
    assert got.dtype == dtype == torch_dtype(want.dtype)
    assert_narrow_close(got, want)
    jepi, epi = _epilogues("relu", True, True)
    want = j_sell_fused(jsell, to_jax(ht), jepi, to_jax(b), to_jax(r), interpret=True)
    got = spmm_sell_fused(sell, ht, epi, b, r)
    assert got.dtype == dtype == torch_dtype(want.dtype)
    assert_narrow_close(got, want)


@pytest.mark.parametrize("vals_dt,h_dt", DTYPE_PAIRS)
def test_spmm_output_dtypes_follow_the_reference(vals_dt, h_dt):
    """Every wrapper and plain version of K1, K2, K5 and K6 returns
    ``jnp.result_type(values, H)``; the element and Block-COO paths return
    what the reference's own functions return on the same operands."""
    a, h, bias, res = _inputs(11, 8)
    ell = BlockELL.from_dense(a, *BLOCK, device="cpu")
    sell, _ = _narrow_sell(a, vals_dt)
    blocks = ell.blocks.to(vals_dt)
    hp = pad_rows(torch.from_numpy(h), ell.shape[1]).to(h_dt)
    ht = torch.from_numpy(h).to(h_dt)
    want = result_type(blocks, hp)
    _, epi = _epilogues("relu", True, True)
    b = torch.from_numpy(bias).to(h_dt)
    r_ell = pad_rows(torch.from_numpy(res), ell.shape[0]).to(h_dt)
    r_sell = torch.zeros((sell.n_live_block_rows * BLOCK[0], 8), dtype=h_dt)
    ell_ops = (ell.indices, blocks, hp)
    sell_ops = (*sell_row_operands(sell), ht)
    tiles = (sell.tile_rows, sell.tile_cols, sell_tile_blocks(sell),
             pad_rows(ht, -(-N // BLOCK[1]) * BLOCK[1]))
    kw = dict(n_live_block_rows=sell.n_live_block_rows)
    heavy = dict(heavy_rows=sell.tile_heavy_rows)
    outs = {
        "K1": spmm_blockell_kernel(*ell_ops),
        "K1 plain": spmm_blockell_ref(*ell_ops),
        "K5": spmm_blockell_epilogue_kernel(*ell_ops, b, r_ell, epi=epi),
        "K5 plain": spmm_blockell_epilogue_ref(*ell_ops, b, r_ell, epi=epi),
        "K2": spmm_sell_kernel(*sell_ops, **heavy),
        "K2 plain": spmm_sell_slots_ref(*sell_ops),
        "K2 tiles": spmm_sell_tiles_ref(*tiles, **kw),
        "K6": spmm_sell_epilogue_kernel(*sell_ops, b, r_sell, epi=epi,
                                        **heavy),
        "K6 plain": spmm_sell_epilogue_slots_ref(*sell_ops, b, r_sell,
                                                 epi=epi),
        "K6 tiles": spmm_sell_epilogue_ref(*tiles, b, r_sell, epi=epi, **kw),
        "spmm_blockell": spmm_blockell(dataclasses.replace(
            ell, blocks=blocks), hp),
        "spmm_sell_blocked": spmm_sell_blocked(sell, ht),
        "spmm_sell_fused": spmm_sell_fused(sell, ht, epi, b,
                                           torch.from_numpy(res).to(h_dt)),
    }
    assert {k: v.dtype for k, v in outs.items()} == dict.fromkeys(outs, want)
    rows, cols = (torch.from_numpy(x.astype(np.int32)) for x in np.nonzero(a))
    vals = torch.from_numpy(a[np.nonzero(a)]).to(vals_dt)
    got = spmm_elements(rows, cols, vals, ht, M)
    assert got.dtype == torch_dtype(j_spmm_elements(
        jnp.asarray(rows.numpy()), jnp.asarray(cols.numpy()), to_jax(vals),
        to_jax(ht), M).dtype)
    coo = BlockCOO.from_dense(a, *BLOCK, device="cpu")
    coo = dataclasses.replace(coo, blocks=coo.blocks.to(vals_dt))
    jcoo = JBlockCOO.from_dense(a, *BLOCK)
    jcoo = dataclasses.replace(jcoo, blocks=to_jax(coo.blocks))
    assert spmm_coo(coo, hp).dtype == torch_dtype(
        j_spmm_coo(jcoo, to_jax(hp)).dtype) == want


def _narrow_matrix(a, dtype, formats):
    mat = SparseMatrix.from_dense(a, formats=formats, block=BLOCK,
                                  device="cpu")
    return SparseMatrix(
        {name: with_values(name, mat.form(name),
                           values_of(name, mat.form(name)).to(dtype))
         for name in formats}, mat.shape, mat.stats)


@pytest.mark.parametrize("dtype", DTYPES)
def test_spmm_paths_agree_on_dtype(dtype):
    """The element (csr), dense, Block-ELL, Block-COO and SELL paths of
    ``matmul`` return the same dtype and values on the same operands,
    with and without a fused epilogue."""
    a, h, bias, res = _inputs(12, 16)
    ht, b, r = (torch.from_numpy(x).to(dtype) for x in (h, bias, res))
    want = {"plain": a @ h,
            "fused": np.maximum(a @ h + bias + res, 0.0)}
    mats = {"ell": _narrow_matrix(a, dtype, ("ell", "sell", "csr")),
            "coo": _narrow_matrix(a, dtype, ("coo",))}
    for path, mat in (("ell", mats["ell"]), ("sell", mats["ell"]),
                      ("csr", mats["ell"]), ("dense", mats["ell"]),
                      ("ell", mats["coo"])):
        for kind, kw in (("plain", {}),
                         ("fused", dict(epilogue="relu", bias=b,
                                        residual=r))):
            got = matmul(mat, ht, policy=path, **kw)
            assert got.dtype == dtype, (path, mat.formats, kind)
            np.testing.assert_allclose(got.float().numpy(), want[kind],
                                       **NARROW_TOL)
