"""Port parity: one-pass fused graph attention, its kernels' wrappers (K7,
K8) and ``fused_graph_attention``.

On the CPU each wrapper runs its kernel's plain version (the two-sweep
softmax); it is held to the JAX package's Pallas kernel run in interpret
mode (the online softmax) on the same numpy inputs, for all three edge
activations.  K8 takes ``SellCS``'s row view, the Pallas K8 the live
tiles and their 0/1 masks: its plain version is held to the Pallas kernel
and to the port's tile-granular plain version on a pattern with a row
above ``SELL_HEAVY_ROW_NNZ`` nonzeros, edge-less and padding rows and a
stored zero (which must mask out), and the SELL entry point must build
no tile data.  The front-end is held to ``repro.sparse
.fused_graph_attention`` on every path.  Tolerance: rtol 1e-4, atol 1e-5
(the reference's fused-attention tolerance: exp and f32 sums in another
order).  Edge-less rows must come out exactly 0.  bf16 and f16 q, k and
v (computed in f32, one rounding at the end): rtol = atol = 2e-2, the
reference's bf16 tolerance, in the reference's default output dtype,
``jnp.result_type(q, v)``, on every path.
"""
import dataclasses
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_dtypes import (DTYPE_PAIRS, DTYPES, J_DTYPES,
                           assert_narrow_close, to_jax, torch_dtype)

from repro.core.formats import BlockELL as JBlockELL
from repro.core.formats import SellCS as JSellCS
from repro.kernels.fused.attention import \
    fused_attn_blockell_kernel as j_k7
from repro.kernels.fused.attention import fused_attn_blockell as j_attn_ell
from repro.kernels.fused.attention import fused_attn_sell as j_attn_sell
from repro.kernels.fused.attention import fused_attn_sell_kernel as j_k8
from repro.kernels.spmm.sell import sell_tile_blocks as j_tile_blocks
from repro.sparse import SparseMatrix as JSparseMatrix
from repro.sparse import fused_graph_attention as j_attention
from repro_torch.core.formats import (SELL_HEAVY_ROW_NNZ, BlockCOO, BlockELL,
                                      SellCS)
from repro_torch.dispatch.dispatcher import clear_log, dispatch_log
from repro_torch.kernels.fused.attention import (fused_attn_blockcoo_ref,
                                                 fused_attn_blockell,
                                                 fused_attn_blockell_kernel,
                                                 fused_attn_blockell_ref,
                                                 fused_attn_dense,
                                                 fused_attn_elements,
                                                 fused_attn_sell,
                                                 fused_attn_sell_kernel,
                                                 fused_attn_sell_operands,
                                                 fused_attn_sell_rows_ref,
                                                 fused_attn_sell_slots_ref,
                                                 fused_attn_sell_tiles_ref)
from repro_torch.kernels.spmm.sell import sell_tile_blocks
from repro_torch.sparse.matrix import SparseMatrix
from repro_torch.sparse.ops import fused_graph_attention

TOL = dict(rtol=1e-4, atol=1e-5)
M, N, BLOCK = 45, 40, (8, 8)  # ragged: M and N are not multiples of 8
ACTS = ["identity", "relu", "leaky_relu"]
EMPTY_ROWS = (5, 17, 30, 31)


def _pattern(seed, density=0.3, m=M, n=N):
    rng = np.random.default_rng(seed)
    a = np.where(rng.random((m, n)) < density, rng.random((m, n)) + 0.5,
                 0.0).astype(np.float32)
    a[list(EMPTY_ROWS)] = 0.0
    return a


def _qkv(seed, dk, d, m=M, n=N):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(m, dk)).astype(np.float32),
            rng.normal(size=(n, dk)).astype(np.float32),
            rng.normal(size=(n, d)).astype(np.float32))


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _pad(x, rows, cols=None):
    out = np.zeros((rows, x.shape[1] if cols is None else cols), x.dtype)
    out[: x.shape[0], : x.shape[1]] = x
    return out


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dk,d", [(2, 16), (48, 12)])
def test_k7_plain_matches_pallas_interpret(act, dk, d):
    a = _pattern(dk + d)
    q, k, v = _qkv(1, dk, d)
    jell = JBlockELL.from_dense(a, *BLOCK)
    ell = BlockELL.from_dense(a, *BLOCK, device="cpu")
    mp, np_ = ell.shape
    q, kt, v = _pad(q, mp), _pad(k.T, dk, np_), _pad(v, np_)
    want = j_k7(jell.indices, jell.blocks, jnp.asarray(q), jnp.asarray(kt),
                jnp.asarray(v), act=act, slope=0.2, interpret=True)
    before = fused_attn_blockell_kernel.launches
    got = fused_attn_blockell_kernel(ell.indices, ell.blocks, _t(q), _t(kt),
                                     _t(v), act=act, slope=0.2)
    assert fused_attn_blockell_kernel.launches == before  # plain on CPU
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not got[list(EMPTY_ROWS)].any()


HEAVY_M, HEAVY_N, HEAVY_ROW = 61, 160, 7


def _heavy_sell():
    """A SELL packing (8 x 8 tiles) with a row above SELL_HEAVY_ROW_NNZ
    nonzeros, the edge-less rows of ``_pattern``, padding rows, and one
    stored value zeroed by hand in a row that keeps other nonzeros: the
    numpy pattern without that entry, the JAX packing and the port's."""
    a = _pattern(7, density=0.08, m=HEAVY_M, n=HEAVY_N)
    a[HEAVY_ROW, :150] = 1.0 + np.arange(150, dtype=np.float32) / 150
    sell = SellCS.from_dense(a, block=BLOCK, device="cpu")
    jsell = JSellCS.from_dense(a, block=BLOCK)
    assert int(sell.tile_row_nnz.max()) > SELL_HEAVY_ROW_NNZ
    assert bool((sell.perm == HEAVY_M).any())  # padding rows
    r = 11  # a row with several nonzeros loses its first to a stored zero
    assert (a[r] != 0).sum() >= 2
    slot = int(sell.tile_row_slot[int(sell.tile_out_gather[r])])
    vals = sell.slot_vals.clone()
    vals[slot] = 0.0
    a[r, int(sell.slot_cols[slot])] = 0.0
    return a, dataclasses.replace(sell, slot_vals=vals), jsell


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dk,d", [(2, 16), (48, 12)])
def test_k8_plain_matches_pallas_interpret(act, dk, d):
    """K8's plain version over the row view against the Pallas K8 in
    interpret mode and the port's tile-granular plain version, on the
    same packing; edge-less, padding and all-masked rows exactly 0."""
    a, sell, jsell = _heavy_sell()
    q, k, v = _qkv(2, dk, d, m=HEAVY_M, n=HEAVY_N)
    bn = BLOCK[1]
    n_pad = -(-HEAVY_N // bn) * bn
    q_perm = np.concatenate([q, np.zeros((1, dk), np.float32)])[
        sell.perm.numpy()]
    kt, v = _pad(k.T, dk, n_pad), _pad(v, n_pad)
    mask = (sell_tile_blocks(sell) != 0).float()
    want_mask = np.asarray(j_tile_blocks(jsell) != 0)
    assert (mask.numpy() != want_mask).sum() == 1  # the stored zero
    kw = dict(n_live_block_rows=sell.n_live_block_rows, act=act, slope=0.2)
    want = j_k8(jsell.tile_rows, jsell.tile_cols, jnp.asarray(mask.numpy()),
                jnp.asarray(q_perm), jnp.asarray(kt), jnp.asarray(v),
                interpret=True, **kw)
    tiles = fused_attn_sell_tiles_ref(sell.tile_rows, sell.tile_cols, mask,
                                      _t(q_perm), _t(kt), _t(v), **kw)
    before = fused_attn_sell_kernel.launches
    got = fused_attn_sell_kernel(
        *fused_attn_sell_operands(sell), _t(q_perm), _t(k.T.copy()),
        _t(v[:HEAVY_N]), heavy_rows=sell.tile_heavy_rows, act=act, slope=0.2)
    assert fused_attn_sell_kernel.launches == before  # plain on CPU
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), tiles.numpy(), **TOL)
    np.testing.assert_array_equal(
        got.numpy(), fused_attn_sell_rows_ref(
            *fused_attn_sell_operands(sell), _t(q_perm), _t(k.T.copy()),
            _t(v[:HEAVY_N]), act=act, slope=0.2).numpy())
    no_edge = (sell.tile_row_nnz == 0).numpy()
    assert no_edge.any() and not got[no_edge].any()


@pytest.mark.parametrize("act", ACTS)
def test_sell_entry_point_reads_no_tile_view(act, monkeypatch):
    """``fused_attn_sell`` with the tile-view helpers patched to raise:
    held to the reference's SELL entry point (Pallas in interpret mode) on
    the pattern with a heavy row and a stored zero, and to the dense path
    of the pattern without that entry."""
    def refuse(*args, **kwargs):
        raise AssertionError("the SELL attention path touched the tile view")

    a, sell, jsell = _heavy_sell()
    # the reference's packing, with the same value zeroed
    slot = int(np.nonzero(np.asarray(jsell.slot_vals)
                          != sell.slot_vals.numpy())[0][0])
    jsell = dataclasses.replace(
        jsell, slot_vals=jsell.slot_vals.at[slot].set(0.0))
    q, k, v = _qkv(8, 2, 16, m=HEAVY_M, n=HEAVY_N)
    for name, module in list(sys.modules.items()):
        if name.startswith("repro_torch"):
            for fn in ("sell_tile_blocks", "sell_row_ptr"):
                if hasattr(module, fn):
                    monkeypatch.setattr(module, fn, refuse)
    got = fused_attn_sell(sell, _t(q), _t(k.T), _t(v), act=act)
    want = j_attn_sell(jsell, jnp.asarray(q), jnp.asarray(k.T),
                       jnp.asarray(v), act=act, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        got.numpy(), fused_attn_dense(_t(a), _t(q), _t(k.T), _t(v),
                                      act=act).numpy(), **TOL)
    assert got.shape == (HEAVY_M, 16)
    assert not got[list(EMPTY_ROWS)].any()


@pytest.mark.parametrize("act", ACTS)
def test_sell_tile_route_matches_slot_reference(act):
    """The wrapper's gathers (q into packed order, the output back to
    logical rows, pruned rows zero) against the element reference."""
    a = _pattern(3, density=0.08)
    q, k, v = (_t(x) for x in _qkv(3, 2, 8))
    sell = SellCS.from_dense(a, block=BLOCK, device="cpu")
    got = fused_attn_sell(sell, q, k.T, v, act=act)
    want = fused_attn_sell_slots_ref(sell, q, k.T, v, act=act)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    assert not got[list(EMPTY_ROWS)].any()


@pytest.mark.parametrize("path", ["ell", "sell", "csr", "dense"])
@pytest.mark.parametrize("act", ACTS)
def test_front_end_matches_reference(path, act):
    a = _pattern(4)
    q, k, v = _qkv(4, 2, 16)
    formats = ("ell", "sell", "csr")
    want = j_attention(JSparseMatrix.from_dense(a, formats=formats,
                                                block=BLOCK),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       edge_act=act, policy=path)
    mat = SparseMatrix.from_dense(a, formats=formats, block=BLOCK,
                                  device="cpu")
    clear_log()
    got = fused_graph_attention(mat, _t(q), _t(k), _t(v), edge_act=act,
                                policy=path)
    (plan,) = dispatch_log()  # the whole pipeline is one plan
    assert (plan.op, plan.path, plan.fused) == ("fused_attn", path, "attn")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert got.shape == (M, 16)
    assert not got[list(EMPTY_ROWS)].any()  # exactly 0


def test_auto_plan_and_coo_form_match_reference():
    a = _pattern(5)
    q, k, v = _qkv(5, 2, 8)
    for formats in (("ell", "sell", "csr"), ("coo",)):
        jmat = JSparseMatrix.from_dense(a, formats=formats, block=BLOCK)
        mat = SparseMatrix.from_dense(a, formats=formats, block=BLOCK,
                                      device="cpu")
        want = j_attention(jmat, jnp.asarray(q), jnp.asarray(k),
                           jnp.asarray(v))
        clear_log()
        got = fused_graph_attention(mat, _t(q), _t(k), _t(v))
        (plan,) = dispatch_log()
        jplan = jmat.plan_cache.entries
        (jp,) = [p for p in jplan.values() if p.op == "fused_attn"]
        assert plan.path == jp.path and plan.reason == jp.reason
        assert plan.reason.startswith("one-stream fused pricing (k=2, d=8)")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_one_dimensional_lanes_and_shape_checks():
    a = _pattern(6)
    q, k, v = _qkv(6, 1, 1)
    mat = SparseMatrix.from_dense(a, block=BLOCK, device="cpu")
    want = j_attention(JSparseMatrix.from_dense(a, formats=("ell", "csr"),
                                                block=BLOCK),
                       jnp.asarray(q[:, 0]), jnp.asarray(k[:, 0]),
                       jnp.asarray(v[:, 0]), policy="ell")
    got = fused_graph_attention(mat, _t(q[:, 0]), _t(k[:, 0]), _t(v[:, 0]),
                                policy="ell")
    assert got.shape == (M,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    q, k, v = (_t(x) for x in _qkv(6, 2, 4))
    with pytest.raises(ValueError, match="q has"):
        fused_graph_attention(mat, q[1:], k, v)
    with pytest.raises(ValueError, match="k has"):
        fused_graph_attention(mat, q, k[1:], v)
    with pytest.raises(ValueError, match="v has"):
        fused_graph_attention(mat, q, k, v[1:])
    with pytest.raises(ValueError, match="score widths"):
        fused_graph_attention(mat, q, k[:, :1], v)


# ---------------------------------------------------------------------------
# bf16 and f16 operands
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_k7_k8_narrow_operands_match_pallas(dtype):
    """K7 and K8 through their entry points against the reference's
    (Pallas in interpret mode, its default output dtype)."""
    a = _pattern(20, density=0.1)
    q, k, v = (_t(x).to(dtype) for x in _qkv(20, 2, 16))
    ell = BlockELL.from_dense(a, *BLOCK, device="cpu")
    ell = dataclasses.replace(ell, blocks=ell.blocks.to(dtype))
    jell = dataclasses.replace(JBlockELL.from_dense(a, *BLOCK),
                               blocks=to_jax(ell.blocks))
    want = j_attn_ell(jell, to_jax(q), to_jax(k.T), to_jax(v), interpret=True)
    got = fused_attn_blockell(ell, q, k.T, v)
    assert got.dtype == dtype == torch_dtype(want.dtype)
    assert_narrow_close(got, want)
    sell = SellCS.from_dense(a, block=BLOCK, device="cpu")
    want = j_attn_sell(JSellCS.from_dense(a, block=BLOCK), to_jax(q), to_jax(k.T),
                       to_jax(v), interpret=True)
    got = fused_attn_sell(sell, q, k.T, v)
    assert got.dtype == dtype == torch_dtype(want.dtype)
    assert_narrow_close(got, want)
    assert not got[list(EMPTY_ROWS)].any()


@pytest.mark.parametrize("q_dt,v_dt", DTYPE_PAIRS)
def test_attention_output_dtypes_follow_the_reference(q_dt, v_dt):
    """K7's and K8's wrappers and plain versions, and the Block-COO,
    element and dense paths, return ``jnp.result_type(q, v)``
    (``repro.kernels.fused.attention:183``)."""
    a = _pattern(21, density=0.1)
    q, k, v = _qkv(21, 2, 8)
    want = torch_dtype(jnp.result_type(J_DTYPES[q_dt], J_DTYPES[v_dt]))
    ell = BlockELL.from_dense(a, *BLOCK, device="cpu")
    mp, np_ = ell.shape
    qp, kt, vp = (_t(x) for x in (_pad(q, mp), _pad(k.T, 2, np_),
                                  _pad(v, np_)))
    qp, kt, vp = qp.to(q_dt), kt.to(q_dt), vp.to(v_dt)
    blocks = ell.blocks.to(q_dt)
    ops7 = (ell.indices, blocks, qp, kt, vp)
    sell = SellCS.from_dense(a, block=BLOCK, device="cpu")
    bn = BLOCK[1]
    q_perm = torch.cat([qp[:M], qp.new_zeros((1, 2))])[sell.perm]
    ops8 = (*fused_attn_sell_operands(sell), q_perm, kt[:, :N].contiguous(),
            vp[:N])
    tiles8 = (sell.tile_rows, sell.tile_cols,
              (sell_tile_blocks(sell) != 0).to(q_dt), q_perm,
              kt[:, : -(-N // bn) * bn], vp[: -(-N // bn) * bn])
    kw8 = dict(n_live_block_rows=sell.n_live_block_rows)
    coo = BlockCOO.from_dense(a, *BLOCK, device="cpu")
    rows, cols = (_t(x.astype(np.int32)) for x in np.nonzero(a))
    vals = _t(a[np.nonzero(a)])
    outs = {
        "K7": fused_attn_blockell_kernel(*ops7),
        "K7 plain": fused_attn_blockell_ref(*ops7),
        "K8": fused_attn_sell_kernel(*ops8, heavy_rows=sell.tile_heavy_rows),
        "K8 plain": fused_attn_sell_rows_ref(*ops8),
        "K8 tiles": fused_attn_sell_tiles_ref(*tiles8, **kw8),
        "sell": fused_attn_sell(sell, qp[:M], kt[:, :N], vp[:N]),
        "coo": fused_attn_blockcoo_ref(coo, qp, kt, vp),
        "elements": fused_attn_elements(rows, cols, vals, qp[:M], kt[:, :N],
                                        vp[:N], M),
        "dense": fused_attn_dense(_t(a), qp[:M], kt[:, :N], vp[:N]),
    }
    assert {n: o.dtype for n, o in outs.items()} == dict.fromkeys(outs, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("path", ["ell", "sell", "csr", "dense"])
def test_front_end_narrow_matches_reference(path, dtype):
    """Every path of ``fused_graph_attention`` on bf16 / f16 q, k, v:
    the reference's dtype and values."""
    a = _pattern(22)
    q, k, v = (_t(x).to(dtype) for x in _qkv(22, 2, 16))
    formats = ("ell", "sell", "csr")
    want = j_attention(JSparseMatrix.from_dense(a, formats=formats,
                                                block=BLOCK),
                       to_jax(q), to_jax(k), to_jax(v), policy=path)
    got = fused_graph_attention(
        SparseMatrix.from_dense(a, formats=formats, block=BLOCK,
                                device="cpu"), q, k, v, policy=path)
    assert got.dtype == dtype == torch_dtype(want.dtype)
    assert_narrow_close(got, want)
    assert not got[list(EMPTY_ROWS)].any()
