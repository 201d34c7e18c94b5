"""The CUDA kernels K1-K9 on the card, held to their plain PyTorch
versions (tolerance rtol 1e-4, atol 1e-5: f32 sums in another order, and
for K7/K8 the online softmax against the two-sweep; K9 in bf16 at rtol =
atol = 2e-2, the output and p rounded to bf16), across block shapes,
ragged edges, K / dk and D-tile widths, all three edge activations, and
for K9 the causal / window flags, GQA and custom ELL patterns (and for its
bf16 and f32 tensor-core instances padded head dims, key chunks cut by
block_kv, q tiles cut by block_q, rescaled running maxima and empty
block-rows, and for the f32 ones the longest causal rows of S = 32768,
row by row against an f64 oracle at the 1e-4 row gate); K3 besides without a mask, on native bf16 / f16 operands,
and its weighted launch bit for bit against the unweighted one times the
values; K3 at a pattern (K3p) at block fills 0 to 100 % with an
all-padding block-row, K = 1 to 128, f32 / bf16 / f16, equal to its plain
version, bit for bit to K3 without a mask at every set bit and exactly 0
elsewhere, launched twice for equal bits; K4 besides, exactly, against
the tile kernel it replaced; K1/K5's streaming kernel at block fills 0 to 100 %,
all-padding and empty block-rows, ragged D, bm != bn, grids that the
kernel splits over clusters of 2 and 4 CTAs, in f32, bf16 and f16,
launched twice for equal bits; K2-K4 and K6-K8 on bf16
and f16 operands (one rounding to the output dtype: rtol 1e-2 is more
than one bf16 ulp, 2^-7, atol 1e-3); and GCN and GAT serving, the SDDMM
front-end and block-sparse attention on the card against the same calls
on the CPU.  For training: K1 / K2 at D = 1 and 2 and K3 / K4 at K = 16,
17 and 128 (the backward's widths) against their plain versions, and the
backward of each ``torch.autograd.Function`` (SpMM, SDDMM, the fused
epilogue and the fused attention) on the ell and sell paths against the
same backward on the CPU (rtol 1e-4, atol 1e-5), A's values trained
where the rule reads them, so ``dA`` runs through K3p / K4, with the
kernels each backward launches counted (the transposed products on N1 or
on K2 over Aᵀ's row view).  N1 (the transposed SpMM) against its plain
version at every block fill, six block shapes, D = 1 to 2048 and f32 /
bf16 / f16, by its rule and down each of its paths forced (stream,
tensor, sparse), and at the pruned gemma3-4b MLP weights' shapes, two
launches equal bit for bit; K2 over Aᵀ's row view against
the dense product and the CPU; and a GCN and a GAT training step on
graphs of (a)'s and (b)'s structure run twice without
``torch.use_deterministic_algorithms``, every gradient equal per
``torch.equal``; the routes that sum in ``paths.row_order`` (a csr
attention request, an unfused GAT request, the attention backward on a
csr-only and a coo-only matrix, the Block-COO transpose) run twice, equal
per ``torch.equal``.  Batched serving's operands: K5 / K1 on a bucket-padded
16 x 16 block-diagonal composition with all-zero dummy graphs, the batched
engine at ``form="ell"`` against the CPU with its launches counted, K2 /
K6 / K4 / K8 on a SELL composition and on a ``DeltaGraph`` overlay after
slack inserts, and N1's gradients over a block-diagonal composition run
twice, equal per ``torch.equal``; a failing K1 launch under ``form="auto"``
fails its requests and leaves the ell form in service.  The serving
fleet: a 2-worker thread fleet at ``form="ell"`` on the card (K1 launched)
against the f64 ``dense @ h``, and one spawned worker with its own CUDA
context that serves a request and exits with code 0 on ``close()``.  The
LM models: every arch's smoke model in f32, prefill and decode on the
card against the CPU (rtol = atol = 1e-4), and a gemma3 smoke model with
its MLP weights pruned onto Block-ELL launching N1 three times a layer a
decode step.

These need an NVIDIA GPU and ``nvcc``; without them they skip.  Run them
on the card with ``python -m pytest -m cuda tests/test_torch_cuda.py``.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs.paper_gnn import SMOKE_CONFIG
from repro_torch.core.attention import local_block_attention
from repro_torch.core.formats import BlockCOO, BlockELL, SellCS
from repro_torch.data.pipeline import random_graph
from repro_torch.kernels import _build
from repro_torch.kernels.bsattn import block_sparse_flash_attention
from repro_torch.kernels.bsattn.kernel import bsattn_kernel, bsattn_ref
from repro_torch.kernels.bsattn.ops import banded_ell
from repro_torch.kernels.fused.attention import (fused_attn_blockell_bwd,
                                                 fused_attn_blockell_bwd_kernel,
                                                 fused_attn_blockell_kernel,
                                                 fused_attn_blockell_ref,
                                                 fused_attn_sell_kernel,
                                                 fused_attn_sell_operands,
                                                 fused_attn_sell_rows_ref,
                                                 fused_attn_sell_tiles_ref)
from repro_torch.kernels.fused.epilogue import Epilogue
from repro_torch.kernels.fused.spmm import (spmm_blockell_epilogue_kernel,
                                            spmm_blockell_epilogue_ref,
                                            spmm_sell_epilogue_kernel,
                                            spmm_sell_epilogue_ref,
                                            spmm_sell_epilogue_slots_ref)
from repro_torch.kernels.sddmm.kernel import (launch_tiles,
                                              sddmm_blockcoo_kernel,
                                              sddmm_pattern_kernel)
from repro_torch.kernels.sddmm.ref import (pack_occupancy,
                                           sddmm_blockcoo_ref,
                                           sddmm_pattern_ref,
                                           unpack_occupancy)
from repro_torch.kernels.sddmm.sell import (sddmm_sell_kernel,
                                            sddmm_sell_operands,
                                            sddmm_sell_slots_ref)
from repro_torch.kernels.spmm.kernel import (launch_blockell,
                                             spmm_blockell_kernel)
from repro_torch.kernels.spmm.ref import (spmm_blockell_ref,
                                          spmm_blockell_t_ref)
from repro_torch.kernels.spmm.transposed import (blockell_columns,
                                                 sell_t_operands,
                                                 spmm_blockell_t_kernel,
                                                 spmm_sell_t)
from repro_torch.kernels.spmm.sell import (sell_row_operands,
                                           sell_tile_blocks,
                                           spmm_sell_kernel,
                                           spmm_sell_slots_ref,
                                           spmm_sell_tiles_ref)
from repro_torch.models.gnn import (build_graph, graph_candidates, init_gat,
                                    init_gcn)
from repro_torch.serve.engine import GNNServeConfig, GNNServingEngine
from repro_torch.sparse.matrix import SparseMatrix
from repro_torch.sparse.paths import ell_to_coo
from repro_torch.sparse.ops import (fused_graph_attention, matmul, sddmm,
                                    spmv)

pytestmark = pytest.mark.cuda
TOL = dict(rtol=1e-4, atol=1e-5)
BLOCKS = [(64, 64), (16, 16), (8, 16), (48, 32), (128, 128)]
WIDTHS = [4, 16, 33, 64, 128]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _sparse(seed, m, n, density):
    rng = np.random.default_rng(seed)
    return np.where(rng.random((m, n)) < density, rng.standard_normal((m, n)),
                    0).astype(np.float32)


NARROW_TOL = dict(rtol=1e-2, atol=1e-3)
DTYPE_TOL = {torch.float32: TOL, torch.bfloat16: NARROW_TOL,
             torch.float16: NARROW_TOL}
NARROW = [torch.bfloat16, torch.float16]


def test_kernels_build(dev):
    _build.build()
    for name in _build.SOURCES:
        assert _build.lib_path(name).exists()
        assert _build.entry(name) is not None


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("d", WIDTHS)
def test_blockell_kernels_match_plain(dev, block, d):
    bm, bn = block
    ell = BlockELL.from_dense(_sparse(d, 301, 277, 0.05), bm, bn,
                              device=dev)
    h = torch.randn(ell.shape[1], d, device=dev)
    ops = (ell.indices, ell.blocks, h)
    before = spmm_blockell_kernel.launches
    torch.testing.assert_close(spmm_blockell_kernel(*ops),
                               spmm_blockell_ref(*ops), **TOL)
    assert spmm_blockell_kernel.launches == before + 1
    for act in ("identity", "relu", "leaky_relu"):
        epi = Epilogue(act=act, negative_slope=0.2, has_bias=True,
                       has_residual=True)
        tail = (torch.randn(d, device=dev),
                torch.randn(ell.shape[0], d, device=dev))
        torch.testing.assert_close(
            spmm_blockell_epilogue_kernel(*ops, *tail, epi=epi),
            spmm_blockell_epilogue_ref(*ops, *tail, epi=epi), **TOL)


FILLS = [0.0, 0.01, 0.1, 1.0]
ELL_BLOCKS = [(64, 64), (64, 32), (32, 64), (128, 128), (5, 7)]
ELL_WIDTHS = [16, 48, 128, 130]


def _ell_operands(dev, seed, fill, block, d, dtype, m=301, n=277):
    """Block-ELL of a (m x n) matrix at the given fill, whose block-row 1
    holds no nonzero (all padding slots), with H, bias and residual."""
    bm, bn = block
    a = _sparse(seed, m, n, fill)
    if fill == 1.0:
        a[a == 0] = 1.0
    a[bm:2 * bm] = 0.0
    ell = BlockELL.from_dense(a, bm, bn, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn(ell.shape[1], d, device=dev, generator=gen).to(dtype)
    tail = (torch.randn(d, device=dev, generator=gen),
            torch.randn(ell.shape[0], d, device=dev, generator=gen))
    return ell.indices, ell.blocks.to(dtype), h, tail


def _assert_ell_sums_close(got, want, ops):
    """Sums of up to W*bn f32 terms in two orders (the kernel's, nonzeros
    in ascending k, slots in order, and einsum's) differ by about
    √n · eps · Σ|term|, which for a full block-row that cancels is far
    above TOL's atol; held to twice that on top of the dtype's tolerance
    (the plain version's own rounding of the same sum)."""
    idx, blocks, h = ops
    mag = spmm_blockell_ref(idx, blocks.abs(), h.abs()).float()
    eps = torch.finfo(torch.float32).eps
    tol = DTYPE_TOL[got.dtype]
    n = blocks.shape[1] * blocks.shape[3]
    bound = tol["atol"] + tol["rtol"] * want.float().abs() \
        + 2 * eps * n ** 0.5 * mag
    worst = float(((got.float() - want.float()).abs() / bound).max())
    assert worst <= 1, f"an element is {worst:.2f}x its tolerance"


@pytest.mark.parametrize("dtype", [torch.float32] + NARROW)
@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("block", ELL_BLOCKS)
@pytest.mark.parametrize("d", ELL_WIDTHS)
def test_blockell_streaming_kernel(dev, dtype, fill, block, d):
    """K1 and K5 (leaky_relu, bias, residual) against their plain versions
    at block fills 0, 1 %, 10 % and 100 %, on blocks whose bytes are not a
    multiple of 16 (5 x 7: copied by the producer's lanes), two D-tiles
    (D = 130, and 128 at 128 x 128 blocks), in the output dtype; the
    all-padding block-row is exactly act(bias + res)."""
    bm = block[0]
    idx, blocks, h, tail = _ell_operands(dev, d + bm, fill, block, d, dtype)
    epi = Epilogue(act="leaky_relu", negative_slope=0.2, has_bias=True,
                   has_residual=True)
    before = (spmm_blockell_kernel.launches,
              spmm_blockell_epilogue_kernel.launches)
    got = spmm_blockell_kernel(idx, blocks, h)
    assert got.dtype == dtype
    _assert_ell_sums_close(got, spmm_blockell_ref(idx, blocks, h),
                           (idx, blocks, h))
    assert bool((got[bm:2 * bm] == 0).all())
    got = spmm_blockell_epilogue_kernel(idx, blocks, h, *tail, epi=epi)
    want = spmm_blockell_epilogue_ref(idx, blocks, h, *tail, epi=epi)
    _assert_ell_sums_close(got, want, (idx, blocks, h))
    torch.testing.assert_close(got[bm:2 * bm], want[bm:2 * bm], rtol=0,
                               atol=0)
    assert (spmm_blockell_kernel.launches,
            spmm_blockell_epilogue_kernel.launches) == (before[0] + 1,
                                                        before[1] + 1)


@pytest.mark.parametrize("dtype", [torch.float32] + NARROW)
@pytest.mark.parametrize("block_rows", [16, 66, 100])
def test_blockell_split_is_deterministic(dev, dtype, block_rows):
    """The kernel splits a block-row's slots over a cluster of CTAs
    (reduced through distributed shared memory in rank order) where that
    takes fewer waves for the same work: on an H100 (132 SMs, one CTA
    each) 16 block-rows take 4 CTAs each, 66 take 2 and 100 take 1.
    Each matches the plain version, and two launches give the same
    bits."""
    idx, blocks, h, tail = _ell_operands(dev, 7, 0.1, (64, 64), 128, dtype,
                                         m=64 * block_rows, n=4000)
    epi = Epilogue(act="relu", has_bias=True, has_residual=True)
    runs = [launch_blockell(idx, blocks, h, *tail, epi, "K5")
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    _assert_ell_sums_close(
        runs[0], spmm_blockell_epilogue_ref(idx, blocks, h, *tail, epi=epi),
        (idx, blocks, h))


@pytest.mark.parametrize("dtype", [torch.float32] + NARROW)
def test_blockell_edges(dev, dtype):
    """H that is not 16-byte aligned (copied by the producer's lanes),
    mixed operand dtypes (promoted), and W = 0 (every row act(bias +
    res))."""
    idx, blocks, h, tail = _ell_operands(dev, 3, 0.1, (64, 64), 48, dtype)
    flat = torch.empty(h.numel() + 1, dtype=dtype, device=dev)
    flat[1:] = h.reshape(-1)
    h_off = flat[1:].view(h.shape)
    assert h_off.data_ptr() % 16
    torch.testing.assert_close(spmm_blockell_kernel(idx, blocks, h_off),
                               spmm_blockell_ref(idx, blocks, h),
                               **DTYPE_TOL[dtype])
    got = spmm_blockell_kernel(idx, blocks, h.float())
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, spmm_blockell_ref(idx, blocks,
                                                      h.float()), **TOL)
    epi = Epilogue(act="relu", has_bias=True, has_residual=True)
    nbr = idx.shape[0]
    got = spmm_blockell_epilogue_kernel(
        idx[:, :0].contiguous(), blocks[:, :0].contiguous(), h, *tail,
        epi=epi)
    want = torch.relu(tail[0] + tail[1]).to(dtype)
    assert got.shape == (nbr * 64, 48)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", NARROW)
def test_narrow_operands_of_the_f32_kernels(dev, dtype):
    """K2, K4 and K6 keep f32 loads: bf16 and f16 operands are promoted by
    their wrappers and the result cast back (K4's stays f32); K3, K7 and
    K8 read them natively.  Each held to its plain version on the same
    narrow operands (K8 also to its tile-granular plain version)."""
    def cast(*ts):
        return tuple(t.to(dtype) for t in ts)

    sell = SellCS.from_dense(_sparse(11, 301, 277, 0.004), block=(64, 64),
                             device=dev)
    row_slot, row_nnz, cols, vals = sell_row_operands(sell)
    h, bias = cast(torch.randn(277, 48, device=dev),
                   torch.randn(48, device=dev))
    res, = cast(torch.randn(sell.n_live_block_rows * 64, 48, device=dev))
    ops = (row_slot, row_nnz, cols, vals.to(dtype), h)
    heavy = dict(heavy_rows=sell.tile_heavy_rows)
    got = spmm_sell_kernel(*ops, **heavy)
    assert got.dtype == dtype
    torch.testing.assert_close(got, spmm_sell_slots_ref(*ops), **NARROW_TOL)
    epi = Epilogue(act="leaky_relu", negative_slope=0.2, has_bias=True,
                   has_residual=True)
    torch.testing.assert_close(
        spmm_sell_epilogue_kernel(*ops, bias, res, epi=epi, **heavy),
        spmm_sell_epilogue_slots_ref(*ops, bias, res, epi=epi),
        **NARROW_TOL)
    coo = BlockCOO.from_dense(_sparse(12, 301, 277, 0.05), 64, 64,
                              device=dev)
    b, c = cast(torch.randn(coo.shape[0], 17, device=dev),
                torch.randn(17, coo.shape[1], device=dev))
    ops = (coo.rows, coo.cols, coo.blocks.to(dtype), b, c)
    got = sddmm_blockcoo_kernel(*ops)
    assert got.dtype == dtype
    torch.testing.assert_close(got, sddmm_blockcoo_ref(*ops), **NARROW_TOL)
    ops = (*sddmm_sell_operands(sell), b[:301], c[:, :277].contiguous())
    got = sddmm_sell_kernel(*ops)
    assert got.dtype == torch.float32  # as the reference's tile route
    torch.testing.assert_close(got, sddmm_sell_slots_ref(*ops), **TOL)
    ell = BlockELL.from_dense(_sparse(13, 301, 277, 0.05), 64, 64,
                              device=dev)
    q, kt, v = cast(torch.randn(ell.shape[0], 2, device=dev),
                    torch.randn(2, ell.shape[1], device=dev),
                    torch.randn(ell.shape[1], 33, device=dev))
    ops = (ell.indices, ell.blocks.to(dtype), q, kt, v)
    got = fused_attn_blockell_kernel(*ops)
    assert got.dtype == dtype
    torch.testing.assert_close(got, fused_attn_blockell_ref(*ops),
                               **NARROW_TOL)
    n_pad = -(-277 // 64) * 64
    q_perm = q[: sell.n_live_block_rows * 64]
    ops = (row_slot, row_nnz, cols, vals.to(dtype), q_perm,
           kt[:, :277].contiguous(), v[:277])
    got = fused_attn_sell_kernel(*ops, **heavy)
    assert got.dtype == dtype
    torch.testing.assert_close(got, fused_attn_sell_rows_ref(*ops),
                               **NARROW_TOL)
    tiles = (sell.tile_rows, sell.tile_cols,
             (sell_tile_blocks(sell) != 0).to(dtype), q_perm,
             kt[:, :n_pad].contiguous(), v[:n_pad])
    torch.testing.assert_close(
        got, fused_attn_sell_tiles_ref(
            *tiles, n_live_block_rows=sell.n_live_block_rows), **NARROW_TOL)


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("d", WIDTHS)
def test_sell_kernels_match_plain(dev, block, d):
    """K2/K6 on their slot operands against their plain versions and the
    tile-granular plain versions of the same matrix."""
    bm, bn = block
    sell = SellCS.from_dense(_sparse(d, 301, 277, 0.004), block=block,
                             device=dev)
    h = torch.randn(277, d, device=dev)
    ops = (*sell_row_operands(sell), h)
    tiles = (sell.tile_rows, sell.tile_cols, sell_tile_blocks(sell),
             torch.nn.functional.pad(h, (0, 0, 0, -(-277 // bn) * bn - 277)))
    kw = dict(n_live_block_rows=sell.n_live_block_rows)
    heavy = dict(heavy_rows=sell.tile_heavy_rows)
    before = spmm_sell_kernel.launches
    got = spmm_sell_kernel(*ops, **heavy)
    assert spmm_sell_kernel.launches == before + 1
    torch.testing.assert_close(got, spmm_sell_slots_ref(*ops), **TOL)
    torch.testing.assert_close(got, spmm_sell_tiles_ref(*tiles, **kw), **TOL)
    for act in ("identity", "relu", "leaky_relu"):
        epi = Epilogue(act=act, negative_slope=0.2, has_bias=True,
                       has_residual=True)
        tail = (torch.randn(d, device=dev),
                torch.randn(sell.n_live_block_rows * bm, d, device=dev))
        before = spmm_sell_epilogue_kernel.launches
        got = spmm_sell_epilogue_kernel(*ops, *tail, epi=epi, **heavy)
        assert spmm_sell_epilogue_kernel.launches == before + 1
        torch.testing.assert_close(
            got, spmm_sell_epilogue_slots_ref(*ops, *tail, epi=epi), **TOL)
        torch.testing.assert_close(
            got, spmm_sell_epilogue_ref(*tiles, *tail, epi=epi, **kw), **TOL)


def _assert_sums_close(got, want, ops):
    """Row sums of n f32 terms taken in two orders (the kernel's, in
    chunks for a heavy row, and the plain version's atomics) differ by
    about √n · eps · Σ|term|, far above TOL's atol for an element of a
    long row that cancels; held to twice that on top of TOL."""
    row_slot, row_nnz, cols, vals, h = ops
    mag = spmm_sell_slots_ref(row_slot, row_nnz, cols, vals.abs(), h.abs())
    n = row_nnz.float().clamp_min(1).sqrt()[:, None]
    eps = torch.finfo(torch.float32).eps
    tol = TOL["atol"] + TOL["rtol"] * want.abs() + 2 * eps * n * mag
    worst = float(((got - want).abs() / tol).max())
    assert worst <= 1, f"an element is {worst:.2f}x its tolerance"


@pytest.mark.parametrize("d", [1, 16, 48, 100, 128, 256])
def test_sell_kernels_heavy_and_empty_rows(dev, d):
    """A ragged matrix with a row of 1,200 nonzeros and others above the
    heavy threshold (a CTA each), rows of a few, and empty rows inside
    live block-rows: K2/K6 against their plain versions, and empty rows
    (padding rows too) exactly act(bias + res) (K6) or 0 (K2)."""
    a = _sparse(d + 1, 1000, 1500, 0.004)
    a[17, :1200] = np.random.default_rng(d).standard_normal(1200)
    a[40:45, 200:400] = 1.0 + a[40:45, 200:400]  # 5 rows of >= 200
    a[np.arange(1000), np.arange(1000)] = 1.0  # no row empty by chance
    a[[3, 500, 999]] = 0.0  # 3 empty rows: they share a slice with others
    sell = SellCS.from_dense(a, block=(64, 64), device=dev)
    nnz = sell.tile_row_nnz
    assert int(nnz.max()) >= 1200 and sell.tile_heavy_rows.shape[0] == 6
    empty = nnz == 0
    assert bool((empty & (sell.perm < 1000)).any())
    ops = (*sell_row_operands(sell), torch.randn(1500, d, device=dev))
    heavy = dict(heavy_rows=sell.tile_heavy_rows)
    before = spmm_sell_kernel.launches
    got = spmm_sell_kernel(*ops, **heavy)
    assert spmm_sell_kernel.launches == before + 1
    _assert_sums_close(got, spmm_sell_slots_ref(*ops), ops)
    assert bool((got[empty] == 0).all())
    for act in ("identity", "relu", "leaky_relu"):
        epi = Epilogue(act=act, negative_slope=0.2, has_bias=True,
                       has_residual=True)
        tail = (torch.randn(d, device=dev),
                torch.randn(sell.n_live_block_rows * 64, d, device=dev))
        before = spmm_sell_epilogue_kernel.launches
        got = spmm_sell_epilogue_kernel(*ops, *tail, epi=epi, **heavy)
        assert spmm_sell_epilogue_kernel.launches == before + 1
        want = spmm_sell_epilogue_slots_ref(*ops, *tail, epi=epi)
        _assert_sums_close(got, want, ops)
        torch.testing.assert_close(got[empty], want[empty], rtol=0, atol=0)


def test_sell_kernel_takes_unaligned_h(dev):
    """H at an offset that is not 16-byte aligned takes the scalar path."""
    sell = SellCS.from_dense(_sparse(5, 301, 277, 0.004), block=(64, 64),
                             device=dev)
    flat = torch.randn(277 * 16 + 1, device=dev)
    h = flat[1:].view(277, 16)
    assert h.data_ptr() % 16
    ops = (*sell_row_operands(sell), h)
    torch.testing.assert_close(
        spmm_sell_kernel(*ops, heavy_rows=sell.tile_heavy_rows),
        spmm_sell_slots_ref(*ops), **TOL)


@pytest.mark.parametrize("kind", ["ell", "sell"])
@pytest.mark.parametrize("fuse", [True, False])
def test_serving_on_card_matches_cpu(dev, kind, fuse):
    rng = np.random.default_rng(0)
    adj = (rng.random((256, 256)) < 0.1).astype(np.float32) \
        if kind == "ell" else random_graph(256, 1.0, seed=1)
    x = rng.standard_normal((256, SMOKE_CONFIG.in_features)) \
        .astype(np.float32)
    out = {}
    for device in ("cpu", "cuda"):
        graph = build_graph(adj, SMOKE_CONFIG, device=device)
        params = init_gcn(SMOKE_CONFIG, seed=3, bias=True, device=device)
        eng = GNNServingEngine(params, graph, GNNServeConfig(fuse=fuse))
        assert eng.plan.path == kind
        assert eng.plan.use_kernel == (device == "cuda")
        out[device] = eng.infer(x).cpu()
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("k", [1, 2, 17, 48])
def test_sddmm_kernels_match_plain(dev, block, k):
    bm, bn = block
    coo = BlockCOO.from_dense(_sparse(k, 301, 277, 0.05), bm, bn,
                              device=dev)  # weighted mask
    b = torch.randn(coo.shape[0], k, device=dev)
    c = torch.randn(k, coo.shape[1], device=dev)
    ops = (coo.rows, coo.cols, coo.blocks, b, c)
    before = sddmm_blockcoo_kernel.launches
    torch.testing.assert_close(sddmm_blockcoo_kernel(*ops),
                               sddmm_blockcoo_ref(*ops), **TOL)
    assert sddmm_blockcoo_kernel.launches == before + 1
    sell = SellCS.from_dense(_sparse(k, 301, 277, 0.004), block=block,
                             device=dev)
    _check_k4(sell, torch.randn(301, k, device=dev),
              torch.randn(k, 277, device=dev))


SDDMM_BLOCKS = BLOCKS + [(5, 7), (16, 12)]  # bn 7 and 12: not whole vectors


@pytest.mark.parametrize("dtype", [torch.float32, *NARROW])
@pytest.mark.parametrize("block", SDDMM_BLOCKS)
@pytest.mark.parametrize("k", [1, 3, 17, 48])
def test_sddmm_kernel_without_mask(dev, dtype, block, k):
    """K3 with no mask (every cell of each tile sampled), B and C read
    natively in ``dtype``, against its plain version, in ``dtype`` and
    in f32; then the weighted launch (A's values as the mask) with
    ``round_dot`` against the unweighted dots times the values in f32,
    rounded once: equal bit for bit, since that epilogue rounds each dot
    to the output dtype first.  K <= 16 with
    tile rows of whole 16-byte vectors takes the streaming kernel, the
    rest (K = 17, 48; bn = 7, and 12 in bf16 / f16) the staged one."""
    bm, bn = block
    coo = BlockCOO.from_dense(_sparse(k + 7, 301, 277, 0.05), bm, bn,
                              device=dev)
    b = torch.randn(coo.shape[0], k, device=dev).to(dtype)
    c = torch.randn(k, coo.shape[1], device=dev).to(dtype)
    ops = (coo.rows, coo.cols, None, b, c)
    for out in (dtype, torch.float32):
        kw = dict(block=block, out_dtype=out)
        before = sddmm_blockcoo_kernel.launches
        got = sddmm_blockcoo_kernel(*ops, **kw)
        assert sddmm_blockcoo_kernel.launches == before + 1
        assert got.dtype == out
        torch.testing.assert_close(got, sddmm_blockcoo_ref(*ops, **kw),
                                   **DTYPE_TOL[out])
    dots = sddmm_blockcoo_kernel(*ops, block=block, out_dtype=dtype)
    vals = coo.blocks.to(dtype)
    weighted = sddmm_blockcoo_kernel(coo.rows, coo.cols, vals, b, c,
                                     round_dot=True)
    assert weighted.dtype == dtype
    assert torch.equal(weighted, (vals.float() * dots.float()).to(dtype))


def _bits(x):
    """x's bit patterns, for comparisons that tell -0 from 0."""
    return x.view(torch.int32 if x.element_size() == 4 else torch.int16)


@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("dtype", [torch.float32, *NARROW])
@pytest.mark.parametrize("block", SDDMM_BLOCKS)
@pytest.mark.parametrize("k", [1, 3, 17, 48, 128])
def test_sddmm_pattern_kernel(dev, fill, dtype, block, k):
    """K3 at a pattern, over the Block-COO view of a Block-ELL form at
    block fills 0 to 100 % with an all-padding block-row, B and C read
    natively in ``dtype`` (C as a transposed view): against its plain
    version (in ``dtype`` and in f32), and at every set bit equal, bit for
    bit, to K3 without a mask (its streaming kernel at K <= 16 with tile
    rows of whole vectors, its staged kernel otherwise), exact 0 at every
    other cell; two launches give the same bits, each counted once."""
    bm, bn = block
    a = _sparse(k + 70, 301, 277, fill)
    if fill == 1.0:
        a[a == 0] = 1.0
    a[bm:2 * bm] = 0.0
    ell = BlockELL.from_dense(a, bm, bn, device=dev)
    coo = ell_to_coo(ell)
    occ = pack_occupancy(ell.blocks)
    keep = coo.blocks != 0
    assert torch.equal(unpack_occupancy(occ, bn), keep)
    b = torch.randn(coo.shape[0], k, device=dev).to(dtype)
    c = torch.randn(coo.shape[1], k, device=dev).to(dtype).T
    ops = (coo.rows, coo.cols, occ, b, c)
    for out in (dtype, torch.float32):
        kw = dict(block=block, out_dtype=out)
        before = sddmm_pattern_kernel.launches
        got = sddmm_pattern_kernel(*ops, **kw)
        again = sddmm_pattern_kernel(*ops, **kw)
        assert sddmm_pattern_kernel.launches == before + 2
        assert got.dtype == out
        assert torch.equal(_bits(got), _bits(again))
        torch.testing.assert_close(got, sddmm_pattern_ref(*ops, **kw),
                                   **DTYPE_TOL[out])
        every = sddmm_blockcoo_kernel(coo.rows, coo.cols, None, b,
                                      c.contiguous(), **kw)
        assert torch.equal(_bits(got[keep]), _bits(every[keep]))
        assert not bool(_bits(got[~keep]).any())


def _check_k4(sell, b, c):
    """K4 on its slot operands against its plain version (TOL) and against
    the tile kernel's output gathered to slots.  The tile kernel sums each
    dot over K in ascending order with fmaf from 0, as K4 does, so the two
    agree exactly (rtol = atol = 0)."""
    ops = (*sddmm_sell_operands(sell), b, c)
    before = sddmm_sell_kernel.launches
    got = sddmm_sell_kernel(*ops)
    assert sddmm_sell_kernel.launches == before + 1
    torch.testing.assert_close(got, sddmm_sell_slots_ref(*ops), **TOL)
    bn = sell.bn
    tiles = launch_tiles(
        sell.tile_rows, sell.tile_cols,
        (sell.tile_slot_map < sell.n_slots).float(),
        torch.cat([b, b.new_zeros((1, b.shape[1]))])[sell.perm].contiguous(),
        torch.nn.functional.pad(c, (0, -(-c.shape[1] // bn) * bn
                                    - c.shape[1])).contiguous(),
        "K3's tile kernel over the SELL tiles")
    want = torch.cat([tiles.reshape(-1), tiles.new_zeros(1)])[
        sell.slot_tile_pos]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    return got


@pytest.mark.parametrize("k", [2, 48])
def test_k4_heavy_and_empty_rows(dev, k):
    """A row of 1,200 nonzeros, rows of a few and edge-less rows: K4
    against its plain version and the tile kernel, every slot that is not
    a nonzero exactly 0."""
    a = _sparse(k + 3, 1000, 1500, 0.004)
    a[17, :1200] = 1.0
    a[[3, 500, 999]] = 0.0
    sell = SellCS.from_dense(a, block=(64, 64), sigma=8, device=dev)
    assert int(sell.tile_row_nnz.max()) >= 1200
    got = _check_k4(sell, torch.randn(1000, k, device=dev),
                    torch.randn(k, 1500, device=dev))
    assert bool((got[sell.slot_vals == 0] == 0).all())


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("dk,d", [(2, 4), (2, 33), (48, 16), (2, 128)])
@pytest.mark.parametrize("act", ["identity", "relu", "leaky_relu"])
def test_attention_kernels_match_plain(dev, block, dk, d, act):
    bm, bn = block
    a = _sparse(dk + d, 301, 277, 0.05)
    a[5] = 0.0  # edge-less rows
    a[100:140] = 0.0
    ell = BlockELL.from_dense(a, bm, bn, device=dev)
    ops = (ell.indices, ell.blocks, torch.randn(ell.shape[0], dk, device=dev),
           torch.randn(dk, ell.shape[1], device=dev),
           torch.randn(ell.shape[1], d, device=dev))
    before = fused_attn_blockell_kernel.launches
    got = fused_attn_blockell_kernel(*ops, act=act, slope=0.2)
    torch.testing.assert_close(got, fused_attn_blockell_ref(
        *ops, act=act, slope=0.2), **TOL)
    assert fused_attn_blockell_kernel.launches == before + 1
    assert bool((got[5] == 0).all()) and bool((got[100:140] == 0).all())
    sell = SellCS.from_dense(_sparse(dk + d, 301, 277, 0.004), block=block,
                             device=dev)
    n_pad = -(-277 // bn) * bn
    q_perm = torch.randn(sell.n_live_block_rows * bm, dk, device=dev)
    kt = torch.randn(dk, n_pad, device=dev)
    v = torch.randn(n_pad, d, device=dev)
    ops = (*fused_attn_sell_operands(sell), q_perm, kt[:, :277].contiguous(),
           v[:277])
    tiles = (sell.tile_rows, sell.tile_cols,
             (sell_tile_blocks(sell) != 0).float(), q_perm, kt, v)
    kw = dict(act=act, slope=0.2)
    before = fused_attn_sell_kernel.launches
    got = fused_attn_sell_kernel(*ops, heavy_rows=sell.tile_heavy_rows, **kw)
    assert fused_attn_sell_kernel.launches == before + 1
    torch.testing.assert_close(got, fused_attn_sell_rows_ref(*ops, **kw),
                               **TOL)
    torch.testing.assert_close(got, fused_attn_sell_tiles_ref(
        *tiles, n_live_block_rows=sell.n_live_block_rows, **kw), **TOL)


ATTN_BLOCKS = [(64, 64), (48, 30)]  # 48 x 30: kT and mask read 1 a lane


@pytest.mark.parametrize("fill", [0.0, 0.1, 1.0])
@pytest.mark.parametrize("block", ATTN_BLOCKS)
@pytest.mark.parametrize("d", [16, 100, 128, 200])
@pytest.mark.parametrize("dk", [2, 48])
def test_blockell_attention_streaming(dev, fill, block, d, dk):
    """K7 against its plain version at empty, sparse and full blocks, a
    block-row of padding slots and edge-less rows (exactly 0), one and
    two D-tiles, in f32, bf16 and f16 (blocks, q, kT and V alike); two
    launches give the same bits."""
    bm = block[0]
    for dtype in [torch.float32] + NARROW:
        idx, blocks, v, _ = _ell_operands(dev, d + dk, fill, block, d, dtype)
        gen = torch.Generator(device=dev).manual_seed(dk)
        q = torch.randn(blocks.shape[0] * bm, dk, device=dev,
                        generator=gen).to(dtype)
        kt = torch.randn(dk, v.shape[0], device=dev, generator=gen).to(dtype)
        ops = (idx, blocks, q, kt, v)
        before = fused_attn_blockell_kernel.launches
        got = fused_attn_blockell_kernel(*ops)
        again = fused_attn_blockell_kernel(*ops)
        assert fused_attn_blockell_kernel.launches == before + 2
        assert got.dtype == dtype and torch.equal(got, again)
        torch.testing.assert_close(got, fused_attn_blockell_ref(*ops),
                                   **DTYPE_TOL[dtype])
        assert bool((got[bm:2 * bm] == 0).all())  # the padding block-row
        if fill == 0.0:
            assert not bool(got.any())


@pytest.mark.parametrize("dtype", [torch.float32] + NARROW)
def test_blockell_attention_edges(dev, dtype):
    """K7 on V and q that are not 16-byte aligned (V copied by the
    producer's lanes), on f32 blocks with narrow q, kT and V and on
    mixed q / V dtypes (promoted; the output ``result_type(q, v)``), with
    every edge activation, and at W = 0 (every row exactly 0)."""
    idx, blocks, v, _ = _ell_operands(dev, 5, 0.1, (64, 64), 48, dtype)
    q = torch.randn(blocks.shape[0] * 64, 2, device=dev).to(dtype)
    kt = torch.randn(2, v.shape[0], device=dev).to(dtype)

    def offset(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        flat[1:] = t.reshape(-1)
        return flat[1:].view(t.shape)

    v_off, q_off = offset(v), offset(q)
    assert v_off.data_ptr() % 16 and q_off.data_ptr() % 16
    for act in ("identity", "relu", "leaky_relu"):
        torch.testing.assert_close(
            fused_attn_blockell_kernel(idx, blocks, q_off, kt, v_off,
                                       act=act),
            fused_attn_blockell_ref(idx, blocks, q, kt, v, act=act),
            **DTYPE_TOL[dtype])
    ops = (idx, blocks.float(), q, kt, v)
    torch.testing.assert_close(fused_attn_blockell_kernel(*ops),
                               fused_attn_blockell_ref(*ops),
                               **DTYPE_TOL[dtype])
    ops = (idx, blocks, q, kt.float(), v.float())
    got = fused_attn_blockell_kernel(*ops)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, fused_attn_blockell_ref(*ops), **TOL)
    got = fused_attn_blockell_kernel(idx[:, :0].contiguous(),
                                     blocks[:, :0].contiguous(), q, kt, v)
    assert got.shape == (idx.shape[0] * 64, 48) and not bool(got.any())


def _attention_rows_sell(dev):
    """A SELL packing (64 x 64 tiles, sigma 8) whose rows have 0, 31, 32,
    33, 200 and 1,200 nonzeros (the last two above SELL_HEAVY_ROW_NNZ: a
    CTA each) besides the random ones, with row 23's values all stored as
    zeros (every entry masked).  Returns the packing and the compact
    indices of rows 3 (edge-less) and 23."""
    rng = np.random.default_rng(21)
    a = _sparse(21, 1000, 1500, 0.004)
    a[[3, 500, 999]] = 0.0
    a[17, :1200] = 1.0
    a[18, 100:300] = rng.standard_normal(200)
    for r, k in ((20, 31), (21, 32), (22, 33), (23, 40)):
        a[r] = 0.0
        a[r, rng.choice(1500, k, replace=False)] = rng.random(k) + 0.5
    sell = SellCS.from_dense(a, block=(64, 64), sigma=8, device=dev)
    assert int(sell.tile_row_nnz.max()) >= 1200
    assert sell.tile_heavy_rows.shape[0] == 2
    r23 = int(sell.tile_out_gather[23])
    s0 = int(sell.tile_row_slot[r23])
    vals = sell.slot_vals.clone()
    vals[s0:s0 + 40] = 0.0
    return dataclasses.replace(sell, slot_vals=vals), \
        int(sell.tile_out_gather[3]), r23


@pytest.mark.parametrize("d", [4, 16, 33, 100, 128, 200])
def test_sell_attention_rows(dev, d):
    """K8 against its plain version and the tile-granular one on rows of
    0, 31, 32, 33 and more than 128 nonzeros and an all-masked row
    (exactly 0), in f32, bf16 and f16 and on mixed dtypes (q and kT,
    V, the values: promoted, the output ``result_type(q, v)``); two
    launches give the same bits, and so does kT passed as a transposed
    view."""
    sell, r_empty, r_masked = _attention_rows_sell(dev)
    n_rows = sell.n_live_block_rows * 64
    gen = torch.Generator(device=dev).manual_seed(d)
    q = torch.randn(n_rows, 2, device=dev, generator=gen)
    kt = torch.randn(2, 1536, device=dev, generator=gen)
    v = torch.randn(1536, d, device=dev, generator=gen)
    f32, b16, f16 = torch.float32, torch.bfloat16, torch.float16
    for q_dt, v_dt, vals_dt in ((f32, f32, f32), (b16, b16, b16),
                                (f16, f16, f32), (b16, f32, f32),
                                (f16, b16, f16)):
        ops = (sell.tile_row_slot, sell.tile_row_nnz, sell.slot_cols,
               sell.slot_vals.to(vals_dt), q.to(q_dt),
               kt[:, :1500].to(q_dt).contiguous(), v[:1500].to(v_dt))
        before = fused_attn_sell_kernel.launches
        got = fused_attn_sell_kernel(*ops, heavy_rows=sell.tile_heavy_rows)
        again = fused_attn_sell_kernel(*ops, heavy_rows=sell.tile_heavy_rows)
        assert fused_attn_sell_kernel.launches == before + 2
        assert torch.equal(got, again)
        out = torch.promote_types(q_dt, v_dt)
        assert got.dtype == out
        tol = DTYPE_TOL[out]
        torch.testing.assert_close(got, fused_attn_sell_rows_ref(*ops), **tol)
        tiles = (sell.tile_rows, sell.tile_cols,
                 (sell_tile_blocks(sell) != 0).float(), q.to(q_dt),
                 kt.to(q_dt), v.to(v_dt))
        torch.testing.assert_close(got, fused_attn_sell_tiles_ref(
            *tiles, n_live_block_rows=sell.n_live_block_rows), **tol)
        assert not bool(got[[r_empty, r_masked]].any())
        # kT as the transposed view the model passes (k.T, read through
        # its strides): the same values in the same order, the same bits
        k_rows = ops[5].T.contiguous()
        assert not k_rows.T.is_contiguous()
        assert torch.equal(got, fused_attn_sell_kernel(
            *ops[:5], k_rows.T, ops[6], heavy_rows=sell.tile_heavy_rows))


@pytest.mark.parametrize("kind", ["ell", "sell"])
def test_sddmm_front_end_on_card_matches_cpu(dev, kind):
    rng = np.random.default_rng(1)
    adj = (rng.random((256, 256)) < 0.1).astype(np.float32) \
        if kind == "ell" else random_graph(256, 1.0, seed=1)
    b = rng.standard_normal((256, 2)).astype(np.float32)
    c = rng.standard_normal((2, 256)).astype(np.float32)
    out = {}
    for device in ("cpu", "cuda"):
        graph = build_graph(adj, SMOKE_CONFIG, device=device)
        s = sddmm(graph.adj, torch.from_numpy(b).to(device),
                  torch.from_numpy(c).to(device),
                  candidates=graph_candidates(graph.adj))
        assert s.format == kind
        out[device] = s.data.cpu()
    torch.testing.assert_close(out["cuda"], out["cpu"], **TOL)


@pytest.mark.parametrize("kind", ["ell", "sell"])
@pytest.mark.parametrize("fuse", [True, False])
def test_gat_serving_on_card_matches_cpu(dev, kind, fuse):
    rng = np.random.default_rng(0)
    adj = (rng.random((256, 256)) < 0.1).astype(np.float32) \
        if kind == "ell" else random_graph(256, 1.0, seed=1)
    x = rng.standard_normal((256, SMOKE_CONFIG.in_features)) \
        .astype(np.float32)
    out = {}
    for device in ("cpu", "cuda"):
        graph = build_graph(adj, SMOKE_CONFIG, device=device)
        params = init_gat(SMOKE_CONFIG, seed=3, device=device)
        eng = GNNServingEngine(params, graph,
                               GNNServeConfig(model="gat", fuse=fuse))
        assert eng.plan.path == kind
        out[device] = eng.infer(x).cpu()
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=1e-4,
                               atol=1e-5)


BSATTN_BLOCKS = [(64, 64), (64, 32), (128, 64), (32, 64), (96, 48)]
BSATTN_TOL = {torch.float32: TOL, torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


def _bsattn_inputs(dev, seed, dtype, s=384, d=64, bh=8, bkv=2):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(
        (n, s, d), dtype=np.float32)).to(dev, dtype) for n in (bh, bkv, bkv))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 64, 100, 256])
@pytest.mark.parametrize("blocks", BSATTN_BLOCKS)
def test_bsattn_kernel_matches_plain(dev, dtype, d, blocks):
    bq, bk = blocks
    q, k, v = _bsattn_inputs(dev, d + bq, dtype, d=d)
    s = q.shape[1]
    for window, causal in ((0, True), (0, False), (64, True), (96, False)):
        ell, val = (torch.from_numpy(a).to(dev)
                    for a in banded_ell(s, bq, bk, window))
        kw = dict(block_q=bq, block_kv=bk, causal=causal, window=window)
        before = bsattn_kernel.launches
        got = bsattn_kernel(ell, val, q, k, v, **kw)
        assert bsattn_kernel.launches == before + 1
        assert got.dtype == dtype
        torch.testing.assert_close(
            got.float(), bsattn_ref(ell, val, q, k, v, scale=d ** -0.5,
                                    **kw).float(), **BSATTN_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bsattn_custom_pattern_on_card(dev, dtype):
    """Invalid slots, a slot listed twice, a block-row with no valid slot
    and one whose only block lies above the diagonal (rows exactly 0)."""
    q, k, v = _bsattn_inputs(dev, 1, dtype, s=256, d=256)
    ell = torch.tensor([[0, 2, 3, 0], [1, 0, 0, 0], [3, 3, 1, 1],
                        [2, 0, 3, 2]], dtype=torch.int32, device=dev)
    val = torch.tensor([[1, 0, 1, 1], [0, 0, 0, 0], [1, 0, 0, 0],
                        [1, 1, 1, 0]], dtype=torch.int32, device=dev)
    kw = dict(block_q=64, block_kv=64, causal=True, window=0)
    got = bsattn_kernel(ell, val, q, k, v, **kw)
    torch.testing.assert_close(
        got.float(), bsattn_ref(ell, val, q, k, v, scale=1 / 16,
                                **kw).float(), **BSATTN_TOL[dtype])
    assert bool((got[:, 64:192] == 0).all())


@pytest.mark.parametrize("d", [16, 100, 256])
@pytest.mark.parametrize("blocks", [(64, 48), (96, 80), (64, 64)])
def test_bsattn_bf16_tensor_core_edges(dev, d, blocks):
    """K9's bf16 tensor-core instances: head dims padded with zeros to the
    tile (16, and 100, which is also loaded without cp.async) and the full
    256; ``block_kv`` not a multiple of the 32-key chunk; q and k scaled
    x8 (logits x64), so the running max jumps between chunks and the
    online rescale runs; and a block-row with no valid slot, exactly 0.
    V keeps its scale: scaling it would only scale the output, and with it
    the one-ulp differences of p's bf16 rounding, past BSATTN_TOL's
    absolute part."""
    bq, bk = blocks
    s = 960  # a multiple of every block size above
    q, k, v = _bsattn_inputs(dev, d + bq, torch.bfloat16, s=s, d=d)
    q, k = 8 * q, 8 * k
    for window, causal in ((0, True), (200, True), (0, False)):
        ell, val = (torch.from_numpy(a).to(dev)
                    for a in banded_ell(s, bq, bk, window))
        val[2] = 0  # block-row 2: no valid slot
        kw = dict(block_q=bq, block_kv=bk, causal=causal, window=window)
        got = bsattn_kernel(ell, val, q, k, v, **kw)
        torch.testing.assert_close(
            got.float(), bsattn_ref(ell, val, q, k, v, scale=d ** -0.5,
                                    **kw).float(),
            **BSATTN_TOL[torch.bfloat16])
        assert bool((got[:, 2 * bq:3 * bq] == 0).all())


@pytest.mark.parametrize("d", [16, 33, 100, 256])
@pytest.mark.parametrize("blocks", [(64, 48), (96, 80), (128, 40)])
def test_bsattn_f32_tensor_core_edges(dev, d, blocks):
    """K9's f32 instances (three TF32 products for each f32 product on the
    tensor cores): head dims padded with zeros to the tile (16; 33, not a
    multiple of 4, so loaded without cp.async; 100) and the full 256
    (two warps a row group, each with 128 columns); ``block_kv`` not a
    multiple of the 32-key chunk and ``block_q`` not a multiple of the
    64-row tile; q scaled x2,
    so the running max moves between chunks; a block-row with no valid
    slot, exactly 0; at the f32 tolerance."""
    bq, bk = blocks
    s = 1920  # a multiple of every block size above
    q, k, v = _bsattn_inputs(dev, d + bq, torch.float32, s=s, d=d)
    q = 2 * q
    for window, causal in ((0, True), (200, True), (0, False)):
        ell, val = (torch.from_numpy(a).to(dev)
                    for a in banded_ell(s, bq, bk, window))
        val[2] = 0  # block-row 2: no valid slot
        kw = dict(block_q=bq, block_kv=bk, causal=causal, window=window)
        got = bsattn_kernel(ell, val, q, k, v, **kw)
        torch.testing.assert_close(
            got, bsattn_ref(ell, val, q, k, v, scale=d ** -0.5, **kw),
            **TOL)
        assert bool((got[:, 2 * bq:3 * bq] == 0).all())


@pytest.mark.parametrize("d", [64, 128, 256])
def test_bsattn_f32_long_causal_rows(dev, d):
    """K9 f32 under the full causal mask at S = 32768 (a global layer's
    mask at gemma3's prefill length): the last q block, whose rows sum
    32257 to 32768 keys, held row by row to an f64 oracle at the 1e-4 row
    gate of chip_smoke.py's phase 4.  Error that grows with a row's keys
    (O summed across chunks with truncating adds) shows here first."""
    s, blk = 32768, 512
    q, k, v = _bsattn_inputs(dev, d, torch.float32, s=s, d=d, bh=2, bkv=1)
    ell, val = (torch.from_numpy(a).to(dev)
                for a in banded_ell(s, blk, blk, 0))
    got = bsattn_kernel(ell, val, q, k, v, block_q=blk, block_kv=blk,
                        causal=True, window=0)[:, s - blk:]
    keep = torch.arange(s, device=dev)[None, :] \
        <= torch.arange(s - blk, s, device=dev)[:, None]
    sc = (q[:, s - blk:].double() @ k.double().transpose(1, 2)) * d ** -0.5
    want = torch.softmax(sc.masked_fill(~keep, -math.inf), dim=-1) \
        @ v.double()
    row_err = torch.linalg.vector_norm(got.double() - want, dim=-1)
    row_want = torch.linalg.vector_norm(want, dim=-1)
    worst = float((row_err / row_want).max())
    assert bool((row_err <= 1e-4 * row_want).all()), worst


def test_bsattn_gqa_head_mapping_on_card(dev):
    q, k, v = _bsattn_inputs(dev, 2, torch.float32, s=256)
    kw = dict(window=64, block_q=64, block_kv=64)
    torch.testing.assert_close(
        block_sparse_flash_attention(q, k, v, **kw),
        block_sparse_flash_attention(q, k.repeat_interleave(4, 0),
                                     v.repeat_interleave(4, 0), **kw),
        **TOL)


def test_bsattn_rejects_bad_operands(dev):
    q, k, v = _bsattn_inputs(dev, 3, torch.float32, s=128)
    ell, val = (torch.from_numpy(a).to(dev)
                for a in banded_ell(128, 64, 64, 64))
    with pytest.raises(ValueError):
        bsattn_kernel(ell + 5, val, q, k, v, block_q=64, block_kv=64)
    with pytest.raises(TypeError):
        bsattn_kernel(ell, val, q.half(), k.half(), v.half(), block_q=64,
                      block_kv=64)
    with pytest.raises(ValueError):
        bsattn_kernel(ell, val, q, k[:, :, :32].contiguous(), v,
                      block_q=64, block_kv=64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,causal", [(0, True), (128, True),
                                           (64, False)])
def test_bsattn_entry_on_card_matches_cpu(dev, dtype, window, causal):
    x = _bsattn_inputs(torch.device("cpu"), 4, torch.float32, s=512, d=256)
    kw = dict(window=window, causal=causal, block_q=128, block_kv=128)
    out = {device: block_sparse_flash_attention(
        *(t.to(device, dtype) for t in x), **kw).float().cpu()
        for device in ("cpu", "cuda")}
    torch.testing.assert_close(out["cuda"], out["cpu"], **BSATTN_TOL[dtype])


def test_bsattn_entry_matches_local_block_attention(dev):
    """The banded entry point equals the model's own jnp-style path when
    the blocks are square and divide the window."""
    q, k, v = _bsattn_inputs(dev, 5, torch.float32, s=1024, d=256)
    out = block_sparse_flash_attention(q, k, v, window=256, block_q=128,
                                       block_kv=128)
    want = local_block_attention(*(t.transpose(0, 1)[None] for t in (q, k, v)),
                                 window=256, block=128)[0].transpose(0, 1)
    torch.testing.assert_close(out, want, **TOL)


# ---------------------------------------------------------------------------
# The backward rules: the kernels at the shapes a training step gives them
# (K1 / K2 at D = 1 and 2 for GAT's dq; K3 / K4 at K = 16, 17 and 128 for
# dα and a trained A's dA), and each rule on the card against the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("block", [(64, 64), (16, 16)])
@pytest.mark.parametrize("d", [1, 2])
def test_spmm_kernels_at_backward_widths(dev, block, d):
    bm, bn = block
    ell = BlockELL.from_dense(_sparse(d + 40, 301, 277, 0.05), bm, bn,
                              device=dev)
    h = torch.randn(ell.shape[1], d, device=dev)
    ops = (ell.indices, ell.blocks, h)
    torch.testing.assert_close(spmm_blockell_kernel(*ops),
                               spmm_blockell_ref(*ops), **TOL)
    sell = SellCS.from_dense(_sparse(d + 41, 301, 277, 0.004), block=block,
                             device=dev)
    ops = (*sell_row_operands(sell), torch.randn(277, d, device=dev))
    torch.testing.assert_close(
        spmm_sell_kernel(*ops, heavy_rows=sell.tile_heavy_rows),
        spmm_sell_slots_ref(*ops), **TOL)


@pytest.mark.parametrize("block", [(64, 64), (16, 16)])
@pytest.mark.parametrize("k", [16, 17, 128])
def test_sddmm_kernels_at_backward_widths(dev, block, k):
    """K3 without a mask and weighted, and K4, at the backward's K, with C
    made from a transposed view as the rules hand it over."""
    bm, bn = block
    coo = BlockCOO.from_dense(_sparse(k + 50, 301, 277, 0.05), bm, bn,
                              device=dev)
    b = torch.randn(coo.shape[0], k, device=dev)
    c = torch.randn(coo.shape[1], k, device=dev).T.contiguous()
    for mask in (coo.blocks, None):
        ops = (coo.rows, coo.cols, mask, b, c)
        kw = dict(block=block, out_dtype=torch.float32)
        torch.testing.assert_close(sddmm_blockcoo_kernel(*ops, **kw),
                                   sddmm_blockcoo_ref(*ops, **kw), **TOL)
    sell = SellCS.from_dense(_sparse(k + 51, 301, 277, 0.004), block=block,
                             device=dev)
    _check_k4(sell, torch.randn(301, k, device=dev),
              torch.randn(277, k, device=dev).T.contiguous())


RULES = ["spmm", "sddmm", "epilogue", "attention"]
# the kernels a rule's backward launches on each path when every input,
# A's values included, needs a gradient: the transposed products (dH, dC,
# dk, dV) on N1 (ell) or K2 over Aᵀ's row view (sell); on the ell path dA
# at K = 128 is sampled at A's pattern (K3p), and the attention's score
# recompute, dα, softmax JVP and dq at dk = 2 are one K7b launch
BACKWARD_LAUNCHES = {
    ("spmm", "ell"): {"K3p": 1, "N1": 1}, ("spmm", "sell"): {"K4": 1,
                                                             "K2": 1},
    ("sddmm", "ell"): {"K1": 1, "N1": 1}, ("sddmm", "sell"): {"K2": 2},
    ("epilogue", "ell"): {"K3p": 1, "N1": 1},
    ("epilogue", "sell"): {"K4": 1, "K2": 1},
    ("attention", "ell"): {"K7b": 1, "N1": 2},
    ("attention", "sell"): {"K4": 2, "K2": 3},
}
BACKWARD_KERNELS = {"K1": spmm_blockell_kernel, "K2": spmm_sell_kernel,
                    "K3": sddmm_blockcoo_kernel, "K3p": sddmm_pattern_kernel,
                    "K4": sddmm_sell_kernel, "N1": spmm_blockell_t_kernel,
                    "K7b": fused_attn_blockell_bwd_kernel}


def _rule_grads(device, kind, rule):
    """Gradients of one rule on one path at D = 128 (K = 128 for dα);
    returns them on the CPU with the launches the backward made."""
    n, d = 300, 128
    density = 0.1 if kind == "ell" else 0.004
    dense = _sparse(60, n, n, density)
    a = SparseMatrix.from_dense(dense, formats=(kind,), block=(64, 64),
                                device=device)
    rng = np.random.default_rng(61)

    def leaf(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device).requires_grad_(True)

    vals = a.data.detach().clone().requires_grad_(True)
    av = a.with_data(vals)
    if rule == "spmm":
        inputs = (vals, leaf(n, d))
        y = matmul(av, inputs[1], policy=kind)
    elif rule == "sddmm":
        inputs = (vals, leaf(n, 16), leaf(16, n))
        y = sddmm(av, *inputs[1:], policy=kind).densify()
    elif rule == "epilogue":
        inputs = (vals, leaf(n, d), leaf(d), leaf(n, d))
        y = matmul(av, inputs[1], policy=kind, epilogue="leaky_relu",
                   bias=inputs[2], residual=inputs[3])
    else:
        inputs = (leaf(n, 2), leaf(n, 2), leaf(n, d))
        y = fused_graph_attention(a, *inputs, policy=kind)
    w = torch.from_numpy(rng.standard_normal(tuple(y.shape)).astype(
        np.float32)).to(device)
    before = {k: f.launches for k, f in BACKWARD_KERNELS.items()}
    (torch.tanh(y) * w).sum().backward()
    launches = {k: f.launches - before[k]
                for k, f in BACKWARD_KERNELS.items()}
    return [x.grad.cpu() for x in inputs], launches


@pytest.mark.parametrize("kind", ["ell", "sell"])
@pytest.mark.parametrize("rule", RULES)
def test_backward_on_card_matches_cpu(dev, kind, rule):
    """Each rule's backward through the kernels against the same backward
    on the CPU (their plain versions); A's values trained where the rule
    reads them, so dA runs through K3 / K4."""
    got, launches = _rule_grads("cuda", kind, rule)
    want, _ = _rule_grads("cpu", kind, rule)
    want_launches = dict.fromkeys(BACKWARD_KERNELS, 0)
    want_launches.update(BACKWARD_LAUNCHES[rule, kind])
    assert launches == want_launches
    for i, (g, w) in enumerate(zip(got, want)):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5,
                                   msg=f"{rule} {kind} input {i}")


# ---------------------------------------------------------------------------
# K7b, the fused attention's backward chain over a Block-ELL pattern
# ---------------------------------------------------------------------------


def _k7b_case(dev, sparsity, block, d, dk, act="leaky_relu",
              dtype=torch.float32, m=301, n=277):
    """K7b's operands on the card, with an all-padding block-row, empty
    rows and padded slots: (ell, occupancy, q, kt, v, g, rowdot), kt a
    transposed view of k as the rule hands it over."""
    bm = block[0]
    dense = _sparse(d + dk + bm, m, n, 1.0 - sparsity)
    dense[bm:2 * bm] = 0.0
    dense[[3, m - 1]] = 0.0
    dense[0, 1] = 1.0
    a = SparseMatrix.from_dense(dense, formats=("ell",), block=block,
                                device=dev)
    rng = np.random.default_rng(d * 10 + dk)

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, dtype)

    q, k, v, g = normal(m, dk), normal(n, dk), normal(n, d), normal(m, d)
    rowdot = normal(m).float()
    return a.form("ell"), a.tile_occupancy(), q, k.T, v, g, rowdot


@pytest.mark.parametrize("dk", [1, 2, 8])
@pytest.mark.parametrize("d", [2, 16, 128, 130])
@pytest.mark.parametrize("block", [(64, 64), (32, 64), (5, 7)])
@pytest.mark.parametrize("sparsity", [0.5, 0.9, 0.99])
def test_k7b_matches_plain(dev, sparsity, block, d, dk):
    """K7b against its plain version on the CPU; α and de exactly 0 off
    the pattern; two launches equal bit for bit."""
    ell, occ, *ops = _k7b_case(dev, sparsity, block, d, dk)
    before = fused_attn_blockell_bwd_kernel.launches
    got = fused_attn_blockell_bwd(ell, occ, *ops)
    again = fused_attn_blockell_bwd(ell, occ, *ops)
    assert fused_attn_blockell_bwd_kernel.launches == before + 2
    want = fused_attn_blockell_bwd_kernel(
        ell.indices.cpu(), occ.cpu(), *(t.cpu() for t in ops),
        block=(ell.bm, ell.bn))
    dead = ell.blocks == 0
    for name, x, y, w in zip(("alpha", "de", "dq"), got, again, want):
        assert torch.equal(x, y), f"{name}: two launches differ"
        torch.testing.assert_close(x.cpu(), w, **TOL, msg=name)
    assert not got[0][dead].any() and not got[1][dead].any()


@pytest.mark.parametrize("act", ["identity", "relu", "leaky_relu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k7b_acts_and_operands(dev, act, dtype):
    """Every edge activation, and bf16 operands (widened to f32 exactly
    before the launch, as the plain version widens them)."""
    ell, occ, *ops = _k7b_case(dev, 0.9, (64, 64), 128, 2, dtype=dtype)
    got = fused_attn_blockell_bwd(ell, occ, *ops, act=act, slope=0.2)
    want = fused_attn_blockell_bwd_kernel(
        ell.indices.cpu(), occ.cpu(), *(t.cpu() for t in ops),
        block=(ell.bm, ell.bn), act=act, slope=0.2)
    for name, x, w in zip(("alpha", "de", "dq"), got, want):
        torch.testing.assert_close(x.cpu(), w, **TOL, msg=f"{name} {act}")


# ---------------------------------------------------------------------------
# N1, the transposed SpMM, and the training step's bits
# ---------------------------------------------------------------------------

T_BLOCKS = [(64, 64), (64, 32), (32, 64), (128, 128), (5, 7), (48, 30)]
T_WIDTHS = [1, 2, 4, 8, 16, 128, 130, 2048]


def _transposed_operands(dev, dtype, fill, block, d, m=301, n=277):
    """N1's operands at one block fill, with an all-padding block-row
    (padded slots) and an empty block column (rows bn..2 bn of Y)."""
    bm, bn = block
    a = _sparse(d + bm + bn, m, n, fill)
    if fill == 1.0:
        a[a == 0] = 1.0
    a[bm:2 * bm] = 0.0
    a[:, bn:2 * bn] = 0.0
    ell = BlockELL.from_dense(a, bm, bn, device=dev)
    gen = torch.Generator(device=dev).manual_seed(d)
    h = torch.randn(ell.shape[0], d, device=dev, generator=gen).to(dtype)
    return (*blockell_columns(ell), ell.blocks.to(dtype), h)


def _assert_transposed_close(got, ops):
    """N1 against its plain version: sums of up to nbr * bm terms in
    another order, held to the dtype's tolerance plus twice √n · eps ·
    Σ|term|."""
    col_ptr, col_slots, blocks, h = ops
    want = spmm_blockell_t_ref(*ops)
    assert got.dtype == want.dtype == blocks.dtype
    mag = spmm_blockell_t_ref(col_ptr, col_slots, blocks.abs(), h.abs())
    eps = torch.finfo(torch.float32).eps
    tol = DTYPE_TOL[blocks.dtype]
    bound = tol["atol"] + tol["rtol"] * want.float().abs() \
        + 2 * eps * h.shape[0] ** 0.5 * mag.float()
    worst = float(((got.float() - want.float()).abs() / bound).max())
    assert worst <= 1, f"an element is {worst:.2f}x its tolerance"


@pytest.mark.parametrize("dtype", [torch.float32] + NARROW)
@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("block", T_BLOCKS)
@pytest.mark.parametrize("d", T_WIDTHS)
def test_transposed_spmm_kernel(dev, dtype, fill, block, d):
    """N1 on the path its rule picks, against its plain version at block
    fills 0 to 100 %, with an all-padding block-row (padded slots) and an
    empty block column, blocks whose bytes are not a multiple of 16
    (copied by the producer's lanes), D = 1 to 8 (the stream path), 16,
    128, 130 (two D-tiles) and 2048, f32 / bf16 / f16; two launches equal
    bit for bit, the empty block column exactly 0."""
    bn = block[1]
    ops = _transposed_operands(dev, dtype, fill, block, d)
    before = spmm_blockell_t_kernel.launches
    got = spmm_blockell_t_kernel(*ops)
    again = spmm_blockell_t_kernel(*ops)
    assert spmm_blockell_t_kernel.launches == before + 2
    assert torch.equal(got, again)
    assert bool((got[bn:2 * bn] == 0).all())
    _assert_transposed_close(got, ops)


@pytest.mark.parametrize("path", ["sparse", "tensor", "stream"])
@pytest.mark.parametrize("dtype", [torch.float32] + NARROW)
@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("d", T_WIDTHS)
def test_transposed_spmm_each_path(dev, path, dtype, fill, d):
    """Each of N1's paths forced on 64 x 64 blocks (which all three take;
    the stream path only up to D = 8) at every fill, width and dtype:
    held to the plain version, two launches equal bit for bit, the empty
    block column 0, and the rule's launch equal bit for bit to the same
    path forced where the rule picks it."""
    from repro_torch.kernels.spmm.transposed import n1_plan

    if path == "stream" and d > 8:
        pytest.skip("the stream path takes D <= 8")
    ops = _transposed_operands(dev, dtype, fill, (64, 64), d)
    got = spmm_blockell_t_kernel(*ops, path=path)
    assert torch.equal(got, spmm_blockell_t_kernel(*ops, path=path))
    assert bool((got[64:128] == 0).all())
    _assert_transposed_close(got, ops)
    nbr, nbc = ops[2].shape[0], ops[0].shape[0] - 1
    if n1_plan(d, dtype, (64, 64), nbr, nbc)[0] == path:
        assert torch.equal(got, spmm_blockell_t_kernel(*ops))


def _lm_weight_ell(dev, key):
    """A pruned gemma3-4b MLP weight's Block-ELL (``wi`` 2560 x 10240,
    ``wo`` 10240 x 2560): 10 % of its 64 x 64 tiles kept whole."""
    m, n = {"wi": (2560, 10240), "wo": (10240, 2560)}[key]
    rng = np.random.default_rng(len(key) + m)
    keep = np.kron(rng.random((m // 64, n // 64)) < 0.1,
                   np.ones((64, 64), np.float32))
    w = rng.standard_normal((m, n)).astype(np.float32) * 0.02 * keep
    return BlockELL.from_dense(w, 64, 64, device=dev)


@pytest.mark.parametrize("key", ["wi", "wo"])
@pytest.mark.parametrize("d", [4, 8, 2048])
def test_transposed_spmm_at_lm_weight_shapes(dev, key, d):
    """N1 at the pruned LM's shapes (x @ W runs Wᵀ xᵀ on W's blocks) and
    widths (decode D = B, prefill D = B S), f32: every path that takes D
    held to the plain version, two launches equal, the rule's launch
    equal to its path's."""
    from repro_torch.kernels.spmm.transposed import n1_plan

    ell = _lm_weight_ell(dev, key)
    gen = torch.Generator(device=dev).manual_seed(d)
    ops = (*blockell_columns(ell), ell.blocks,
           torch.randn(ell.shape[0], d, device=dev, generator=gen))
    outs = {}
    for path in (["stream"] if d <= 8 else []) + ["tensor", "sparse"]:
        got = spmm_blockell_t_kernel(*ops, path=path)
        assert torch.equal(got, spmm_blockell_t_kernel(*ops, path=path))
        _assert_transposed_close(got, ops)
        outs[path] = got
    nbr, nbc = ell.indices.shape[0], ops[0].shape[0] - 1
    rule = n1_plan(d, torch.float32, (64, 64), nbr, nbc)[0]
    assert rule == ("stream" if d <= 8 else "tensor")
    assert torch.equal(spmm_blockell_t_kernel(*ops), outs[rule])


@pytest.mark.parametrize("d", [2, 16, 128])
def test_transposed_sell_row_view_on_card(dev, d):
    """K2 over Aᵀ's row view against the element route on the card (the
    reference's: the swapped slot triplet) and against the CPU, heavy rows
    of Aᵀ included; two launches equal bit for bit."""
    a = _sparse(d, 301, 277, 0.004)
    a[:200, 7] = 1.0  # a column of A above SELL_HEAVY_ROW_NNZ nonzeros
    sell = SellCS.from_dense(a, block=(64, 64), device=dev)
    assert sell_t_operands(sell)[4].numel() == 1
    h = torch.randn(301, d, device=dev)
    before = spmm_sell_kernel.launches
    got, again = spmm_sell_t(sell, h), spmm_sell_t(sell, h)
    assert spmm_sell_kernel.launches == before + 2
    assert torch.equal(got, again)
    want = torch.from_numpy(a).to(dev).T @ h
    torch.testing.assert_close(got, want, **TOL)
    cpu = SellCS.from_dense(a, block=(64, 64), device="cpu")
    torch.testing.assert_close(got.cpu(), spmm_sell_t(cpu, h.cpu()), **TOL)


def _training_grads(graph, kind, params, x, labels):
    from repro_torch.train import gnn as train

    _, _, grads = train.loss_and_grads(params, graph, x, labels, kind=kind)
    return [g for _, g in train.named_parameters(grads)]


@pytest.mark.parametrize("kind", ["gcn", "gat"])
@pytest.mark.parametrize("graph_kind", ["ell", "sell"])
def test_training_step_gradients_are_reproducible(dev, kind, graph_kind):
    """One training step run twice on the card, without
    ``torch.use_deterministic_algorithms``, gives equal gradients bit for
    bit (``torch.equal``) for every parameter: every transposed product
    sums in one fixed order (N1 / K2), as every other kernel does.  Graphs
    of (a)'s and (b)'s structure at 4096 nodes."""
    from repro_torch.configs.paper_gnn import CONFIG
    from repro_torch.train import gnn as train

    assert not torch.are_deterministic_algorithms_enabled()
    n = 4096
    rng = np.random.default_rng(7)
    adj = (rng.random((n, n)) < 0.1).astype(np.float32) \
        if graph_kind == "ell" else random_graph(n, 16, seed=1)
    graph = build_graph(adj, CONFIG, device=dev)
    x = torch.from_numpy(rng.standard_normal(
        (n, CONFIG.in_features)).astype(np.float32)).to(dev)
    labels = torch.from_numpy(train.planted_labels(n, CONFIG.n_classes)) \
        .to(dev)
    params = train.init_params(kind, CONFIG, seed=0, device=dev)
    transposed = spmm_blockell_t_kernel if graph_kind == "ell" \
        else spmm_sell_kernel
    before = transposed.launches
    first = _training_grads(graph, kind, params, x, labels)
    second = _training_grads(graph, kind, params, x, labels)
    assert transposed.launches > before  # the step's path is graph_kind's
    assert len(first) == len(second) > 0
    for i, (g, h) in enumerate(zip(first, second)):
        assert torch.equal(g, h), f"{kind} on {graph_kind}: gradient {i}"


# ---------------------------------------------------------------------------
# Batched serving operands: 16 x 16 block-diagonal compositions with bucket
# padding and all-zero dummy graphs (K5 / K1, N1), the SELL composition
# and the DeltaGraph overlay after slack inserts (K2, K6, K4, K8)
# ---------------------------------------------------------------------------


def _bucketed_composition(device, n_dummies=2):
    """Three graphs padded into one 16 x 16 bucket (pad slots repeat the
    row's slot-0 column), plus ``n_dummies`` all-zero graphs, composed
    block-diagonally on ``device``."""
    from repro_torch.batch import (BatchedSparseMatrix, bucket_for,
                                   empty_in_bucket, pad_to_bucket)

    mats = [SparseMatrix.from_dense(_sparse(60 + i, n, n, 0.08),
                                    formats=("ell", "csr"), block=(16, 16),
                                    device=device)
            for i, n in enumerate((70, 90, 100))]
    bucket = bucket_for(mats[2].stats)
    padded = [pad_to_bucket(m, bucket, form="ell") for m in mats] + [
        empty_in_bucket(bucket, form="ell", device=device)] * n_dummies
    return BatchedSparseMatrix.from_matrices(padded, formats=("ell",))


@pytest.mark.parametrize("d", [16, 128])
def test_blockell_kernels_on_bucketed_block_diagonal(dev, d):
    """K5 and K1 on a padded 16 x 16 block-diagonal composition with dummy
    graphs against their plain versions: the repeated-column pad slots and
    the zero blocks add nothing (the dummy rows are exactly 0)."""
    B = _bucketed_composition(dev)
    ell = B.matrix.form("ell")
    assert ell.bm == ell.bn == 16
    gen = torch.Generator(device=dev).manual_seed(d)
    h = torch.randn(ell.shape[1], d, device=dev, generator=gen)
    got = spmm_blockell_kernel(ell.indices, ell.blocks, h)
    torch.testing.assert_close(
        got, spmm_blockell_ref(ell.indices, ell.blocks, h), **TOL)
    epi = Epilogue(act="relu", has_bias=True)
    bias = torch.randn(d, device=dev, generator=gen)
    got5 = spmm_blockell_epilogue_kernel(ell.indices, ell.blocks, h, bias,
                                         None, epi=epi)
    torch.testing.assert_close(got5, spmm_blockell_epilogue_ref(
        ell.indices, ell.blocks, h, bias, None, epi=epi), **TOL)
    dummy_rows = B.segments[3].row_start
    assert bool((got[dummy_rows:] == 0).all())
    assert torch.equal(got, spmm_blockell_kernel(ell.indices, ell.blocks, h))


def test_batched_gcn_serving_on_card_matches_cpu(dev):
    """``BatchServingEngine.for_gcn`` at ``form="ell"`` on the card: K5 x2
    and K1 x1 per executed batch, logits against the same engine on the
    CPU."""
    from repro_torch.serve.engine import BatchServeConfig, BatchServingEngine

    cfg = SMOKE_CONFIG
    adjs = [random_graph(n, avg_degree=4, seed=n) for n in (48, 80, 33, 48)]
    xs = [np.random.default_rng(i).standard_normal(
        (a.shape[0], cfg.in_features)).astype(np.float32)
        for i, a in enumerate(adjs)]
    outs = {}
    for device in ("cpu", dev):
        params = init_gcn(cfg, seed=0, device=device)
        graphs = [build_graph(a, cfg, device=device) for a in adjs]
        before = (spmm_blockell_epilogue_kernel.launches,
                  spmm_blockell_kernel.launches)
        with BatchServingEngine.for_gcn(params, scfg=BatchServeConfig(
                max_batch=4, max_delay_ms=50.0, form="ell",
                device=str(device))) as eng:
            futs = [eng.submit(g, x) for g, x in zip(graphs, xs)]
            outs[str(device)] = [f.result(timeout=120) for f in futs]
            calls = eng.report()["executor"]["calls"]
        if device != "cpu":
            assert (spmm_blockell_epilogue_kernel.launches - before[0],
                    spmm_blockell_kernel.launches - before[1]) \
                == (2 * calls, calls)
    for got, want in zip(outs[str(dev)], outs["cpu"]):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_kernel_fault_fails_the_request_and_keeps_ell_in_service(
        dev, monkeypatch):
    """K1's launch fails (its entry point returns cudaErrorIllegalAddress
    and the wrapper's own check raises) under ``form="auto"`` on a bucket
    planned ell: each request fails with ``KernelError``, more times than
    ``degrade_after``, nothing is retried, degraded or quarantined, and
    the next request launches K1 on the ell form."""
    from repro_torch import obs
    from repro_torch.resilience.errors import KernelError
    from repro_torch.serve.engine import BatchServeConfig, BatchServingEngine

    dense = _sparse(3, 48, 48, 0.3)
    m = SparseMatrix.from_dense(dense, formats=("ell", "csr"),
                                block=(16, 16), device=dev)
    h = torch.randn(48, 8, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(3))
    real = _build.entry
    obs.reset()
    with BatchServingEngine(scfg=BatchServeConfig(
            max_batch=2, max_delay_ms=0.0, device=str(dev))) as eng:
        monkeypatch.setattr(_build, "entry", lambda name: (
            lambda *args: 700) if name == "spmm_blockell" else real(name))
        for _ in range(eng.executor.degrade_after + 1):
            with pytest.raises(KernelError):
                eng.infer(m, h)
        monkeypatch.setattr(_build, "entry", real)
        before = spmm_blockell_kernel.launches
        got = eng.infer(m, h)
        assert spmm_blockell_kernel.launches == before + 1
        assert not eng.executor._degraded
        assert {p.path for p in eng.executor._bucket_plans.values()} \
            == {"ell"}
    np.testing.assert_allclose(got, dense @ h.cpu().numpy(), rtol=1e-4,
                               atol=1e-4)
    counters = obs.snapshot()["metrics"]["counters"]
    assert not any(k.startswith("resilience_") for k in counters)


def _sell_rows_check(dev, sell, d=48):
    """K2, K6, K4 and K8 on ``sell``'s row view against their plain
    versions; each launched twice for equal bits."""
    gen = torch.Generator(device=dev).manual_seed(d)
    n = sell.shape[1]
    h = torch.randn(n, d, device=dev, generator=gen)
    ops = (*sell_row_operands(sell), h)
    heavy = dict(heavy_rows=sell.tile_heavy_rows)
    got = spmm_sell_kernel(*ops, **heavy)
    assert torch.equal(got, spmm_sell_kernel(*ops, **heavy))
    torch.testing.assert_close(got, spmm_sell_slots_ref(*ops), **TOL)
    epi = Epilogue(act="relu", has_bias=True)
    bias = torch.randn(d, device=dev, generator=gen)
    got6 = spmm_sell_epilogue_kernel(*ops, bias, None, epi=epi, **heavy)
    torch.testing.assert_close(got6, spmm_sell_epilogue_slots_ref(
        *ops, bias, None, epi=epi), **TOL)
    b = torch.randn(sell.shape[0], 2, device=dev, generator=gen)
    c = torch.randn(2, n, device=dev, generator=gen)
    sops = (*sddmm_sell_operands(sell), b, c)
    torch.testing.assert_close(sddmm_sell_kernel(*sops),
                               sddmm_sell_slots_ref(*sops), **TOL)
    q = torch.randn(sell.shape[0], 2, device=dev, generator=gen)
    k = torch.randn(n, 2, device=dev, generator=gen)
    aops = fused_attn_sell_operands(sell)
    q_perm = torch.cat([q, q.new_zeros(1, 2)])[sell.perm.long()]
    kw = dict(act="leaky_relu", slope=0.2)
    got8 = fused_attn_sell_kernel(*aops, q_perm, k.T, h, **heavy, **kw)
    assert torch.equal(got8, fused_attn_sell_kernel(
        *aops, q_perm, k.T, h, **heavy, **kw))
    torch.testing.assert_close(got8, fused_attn_sell_rows_ref(
        *aops, q_perm, k.T, h, **kw), **TOL)


def test_sell_kernels_on_block_diagonal_composition(dev):
    """K2, K6, K4 and K8 on ``_concat_sell``'s output (the row view offset
    per graph), and one planned SpMM over it against the dense
    block-diagonal product."""
    from repro_torch.batch import BatchedSparseMatrix

    denses = [_sparse(70 + i, n, n, 0.02) for i, n in
              enumerate((400, 300, 500))]
    denses[1][5, :200] = 1.0  # a heavy row in the second graph
    mats = [SparseMatrix.from_dense(a, formats=("sell",), block=(8, 8),
                                    device=dev) for a in denses]
    B = BatchedSparseMatrix.from_matrices(mats)
    sell = B.matrix.form("sell")
    assert sell.tile_heavy_rows.numel() == 1
    _sell_rows_check(dev, sell)
    h = torch.randn(B.shape[1], 16, device=dev)
    block = torch.zeros(B.shape, device=dev)
    for seg, a in zip(B.segments, denses):
        block[seg.row_start:seg.row_start + a.shape[0],
              seg.col_start:seg.col_start + a.shape[1]] = \
            torch.from_numpy(a).to(dev)
    torch.testing.assert_close(matmul(B.matrix, h, policy="sell"),
                               block @ h, **TOL)


def test_sell_kernels_on_delta_overlay_after_slack_inserts(dev):
    """K2, K6, K4 and K8 on a ``DeltaGraph`` sell overlay after slack
    inserts (claimed past each row's nonzeros), deletes and value updates,
    and the overlay's SpMM against the same deltas on the CPU and a
    rebuild."""
    from repro_torch.serve.runtime import DeltaGraph

    adj = random_graph(2048, 16, seed=1)
    out = {}
    for device in ("cpu", dev):
        dg = DeltaGraph(adj, form="sell", device=device)
        ov = dg._overlay
        rng = np.random.default_rng(3)
        rows = [p for p, free in ov.row_free.items() if free][:200]
        inserted = 0
        for p in rows:
            r = ov.packed_to_orig.get(p)
            pbr = ov.compact_of_pbr.get(p // ov.bm)
            if r is None or pbr is None:
                continue
            for (tr_, tc_), _ in list(ov.tiles_index.items()):
                if tr_ != pbr:
                    continue
                c = int(tc_ * ov.bn + rng.integers(ov.bn))
                if c < adj.shape[1] and (r, c) not in ov.edge_map:
                    dg.insert(r, c, float(rng.normal()) or 1.0)
                    inserted += 1
                    break
        edges = list(ov.edge_map)[:50]
        for r, c in edges[:25]:
            dg.delete(r, c)
        for r, c in edges[25:]:
            dg.insert(r, c, 2.5)
        assert dg.repacks == 0 and inserted > 50
        if device != "cpu":
            _sell_rows_check(dev, dg.matrix.form("sell"))
        h = torch.from_numpy(np.random.default_rng(4).standard_normal(
            (adj.shape[1], 32)).astype(np.float32)).to(device)
        out[str(device)] = matmul(dg.matrix, h, policy="sell").cpu()
        final = dg.matrix.to_dense()
    torch.testing.assert_close(out[str(dev)], out["cpu"], **TOL)
    torch.testing.assert_close(
        out["cpu"], torch.from_numpy(final) @ torch.from_numpy(
            np.random.default_rng(4).standard_normal(
                (adj.shape[1], 32)).astype(np.float32)), **TOL)


def test_blockdiag_gradients_are_reproducible_on_card(dev):
    """The gradient test's composition (three graphs of 48, 80 and 33
    nodes at sparsity 0.9, 16 x 16 blocks) in the ell form: the backward's
    dH runs N1 over the block-diagonal blocks, whose per-block-column
    lists hold the pad slots' repeated columns; two runs give equal
    gradients (``torch.equal``), and they agree with the CPU."""
    from repro_torch.batch import BatchedSparseMatrix

    rng = np.random.default_rng(0)
    denses = [np.where(rng.random((n, n)) < 0.1, rng.normal(size=(n, n)),
                       0.0).astype(np.float32) for n in (48, 80, 33)]
    hs = [rng.normal(size=(a.shape[1], 8)).astype(np.float32)
          for a in denses]
    grads = {}
    for device in ("cpu", dev):
        mats = [SparseMatrix.from_dense(a, formats=("ell",), block=(16, 16),
                                        device=device) for a in denses]
        B = BatchedSparseMatrix.from_matrices(mats)
        runs = []
        for _ in range(2):
            vals = B.matrix.data.clone().requires_grad_(True)
            H = B.batch_features(hs).requires_grad_(True)
            before = spmm_blockell_t_kernel.launches
            torch.tanh(matmul(B.matrix.with_data(vals), H)).sum().backward()
            if device != "cpu":
                assert spmm_blockell_t_kernel.launches == before + 1
            runs.append((vals.grad, H.grad))
        if device != "cpu":
            assert all(torch.equal(a, b) for a, b in zip(*runs))
        grads[str(device)] = runs[0]
    for got, want in zip(grads[str(dev)], grads["cpu"]):
        torch.testing.assert_close(got.cpu(), want, **TOL)


# ---------------------------------------------------------------------------
# The dispatch remainder: autotune on the card, the SpMV lane, the csr
# route's fixed order
# ---------------------------------------------------------------------------

DISPATCH_KERNELS = {"K1": spmm_blockell_kernel, "K2": spmm_sell_kernel,
                    "K3": sddmm_blockcoo_kernel, "K4": sddmm_sell_kernel,
                    "N1": spmm_blockell_t_kernel}


def _launches():
    return {k: f.launches for k, f in DISPATCH_KERNELS.items()}


def _launched(before):
    return {k: n - before[k] for k, n in _launches().items() if n - before[k]}


def test_autotune_measure_waits_for_the_card(dev):
    """A thunk that only queues work (the card spins ≈ 20 ms) is timed at
    the card's pace: ``measure`` synchronizes after every call."""
    from repro_torch.dispatch import measure

    cycles = 40_000_000

    def spin():
        torch.cuda._sleep(cycles)
        return torch.empty(1, device=dev)

    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    spin_us = start.elapsed_time(end) * 1e3
    m = measure({"spin": spin, "empty": lambda: torch.empty(1, device=dev)},
                warmup=1, iters=3)
    assert m.path == "empty"
    assert m.timings_us["spin"] >= 0.9 * spin_us > 1000


@pytest.mark.parametrize("formats", [("ell", "csr"), ("ell", "sell", "csr")])
def test_autotune_on_card_picks_a_finite_winner(dev, formats):
    """Every candidate is timed (finite), the winner is cached, and a
    matrix with a fresh plan memo plans it as "autotune: cached winner"
    and launches only the winner's kernel."""
    from repro_torch.dispatch import AutotuneCache, last_plan

    density = 0.1 if "sell" not in formats else 0.005
    dense = _sparse(70, 2048, 2048, density)
    a = SparseMatrix.from_dense(dense, formats=formats, block=(64, 64),
                                device=dev)
    h = torch.randn(2048, 16, device=dev)
    cache = AutotuneCache()
    y = matmul(a, h, policy="autotune", autotune_cache=cache)
    plan = last_plan("spmm")
    assert set(plan.timings_us) == set(formats) | {"dense"}
    assert all(math.isfinite(t) for t in plan.timings_us.values())
    torch.testing.assert_close(
        y, torch.from_numpy(dense).to(dev) @ h, **TOL)
    before = _launches()
    again = matmul(a.with_stats(a.stats), h, policy="autotune",
                   autotune_cache=cache)
    torch.cuda.synchronize()
    hit = last_plan("spmm")
    assert hit.reason == "autotune: cached winner" and hit.path == plan.path
    want = {"ell": {"K1": 1}, "sell": {"K2": 1}}.get(plan.path, {})
    assert _launched(before) == want
    torch.testing.assert_close(again, y, **TOL)


def test_autotune_lets_a_failing_kernel_raise(dev, monkeypatch):
    """K1's launch fails (its entry point returns an error) while autotune
    times the ell candidate: ``KernelError`` propagates; nothing is
    cached."""
    from repro_torch.dispatch import AutotuneCache
    from repro_torch.resilience.errors import KernelError

    a = SparseMatrix.from_dense(_sparse(71, 512, 512, 0.1),
                                formats=("ell", "csr"), device=dev)
    h = torch.randn(512, 8, device=dev)
    real = _build.entry
    monkeypatch.setattr(_build, "entry", lambda name: (
        lambda *args: 700) if name == "spmm_blockell" else real(name))
    cache = AutotuneCache()
    with pytest.raises(KernelError):
        matmul(a, h, policy="autotune", autotune_cache=cache)
    assert len(cache) == 0


def test_k3_k4_at_k1_and_n1_at_d1(dev):
    """The SpMV backward's widths: K3 (weighted and without a mask) and K4
    at K = 1, N1 at D = 1 (with an empty block column and a padding
    block-row), each against its plain version and launched twice for
    equal bits."""
    dense = _sparse(72, 301, 277, 0.05)
    dense[64:128] = 0.0
    dense[:, 64:128] = 0.0
    coo = BlockCOO.from_dense(dense, 64, 64, device=dev)
    b = torch.randn(coo.shape[0], 1, device=dev)
    c = torch.randn(1, coo.shape[1], device=dev)
    for mask in (coo.blocks, None):
        ops = (coo.rows, coo.cols, mask, b, c)
        kw = dict(block=(64, 64), out_dtype=torch.float32)
        got = sddmm_blockcoo_kernel(*ops, **kw)
        torch.testing.assert_close(got, sddmm_blockcoo_ref(*ops, **kw),
                                   **TOL)
        assert torch.equal(got, sddmm_blockcoo_kernel(*ops, **kw))
    sell = SellCS.from_dense(_sparse(73, 301, 277, 0.004), block=(64, 64),
                             device=dev)
    ops = (*sddmm_sell_operands(sell), torch.randn(301, 1, device=dev),
           torch.randn(1, 277, device=dev))
    got = sddmm_sell_kernel(*ops)
    torch.testing.assert_close(got, sddmm_sell_slots_ref(*ops), **TOL)
    assert torch.equal(got, sddmm_sell_kernel(*ops))
    ell = BlockELL.from_dense(dense, 64, 64, device=dev)
    ops = (*blockell_columns(ell), ell.blocks,
           torch.randn(ell.shape[0], 1, device=dev))
    got = spmm_blockell_t_kernel(*ops)
    torch.testing.assert_close(got, spmm_blockell_t_ref(*ops), **TOL)
    assert torch.equal(got, spmm_blockell_t_kernel(*ops))
    assert not bool(got[64:128].any())
    x = torch.randn(301, device=dev)
    torch.testing.assert_close(spmm_sell_t(sell, x[:, None]),
                               torch.from_numpy(sell.to_dense()).to(dev).T
                               @ x[:, None], **TOL)


@pytest.mark.parametrize("kind", ["ell", "sell", "csr"])
def test_spmv_gradients_are_reproducible(dev, kind):
    """``loss = (tanh(A.with_data(w) @ x) * weight).sum()`` (``spmv``
    forced onto the path; tanh keeps the cotangent's scale at 1, as the
    other backward tests do) twice without
    deterministic mode: dx and dA equal per ``torch.equal``, within
    tolerance of the CPU, with the backward's launches counted (ell: N1
    for dx at D = 1, K3 for dA at K = 1; sell: K2 over Aᵀ's row view and
    K4; csr: none, the fixed-order segmented sums)."""
    density = 0.004 if kind == "sell" else 0.1
    dense = _sparse(74, 1000, 900, density)
    x_np = np.random.default_rng(75).standard_normal(900).astype(np.float32)
    weight = torch.from_numpy(np.random.default_rng(77).standard_normal(
        1000).astype(np.float32))
    grads = {}
    for device in ("cpu", dev):
        a = SparseMatrix.from_dense(dense, formats=(kind,), block=(64, 64),
                                    device=device)
        runs = []
        for _ in range(2):
            w = a.data.clone().requires_grad_(True)
            x = torch.from_numpy(x_np).to(device).requires_grad_(True)
            before = _launches()
            (torch.tanh(spmv(a.with_data(w), x, policy=kind))
             * weight.to(device)).sum().backward()
            if device != "cpu":
                torch.cuda.synchronize()
                want = {"ell": {"N1": 1, "K3": 1},
                        "sell": {"K2": 1, "K4": 1}, "csr": {}}[kind]
                assert _launched(before) == want
            runs.append((w.grad, x.grad))
        if device != "cpu":
            assert all(torch.equal(g, h) for g, h in zip(*runs))
        grads[str(device)] = runs[0]
    for got, want in zip(grads[str(dev)], grads["cpu"]):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)


def test_csr_element_route_sums_in_a_fixed_order(dev):
    """``spmm_elements`` / ``spmv_elements`` on a triplet whose rows do not
    ascend (as ``A.T``'s swapped triplet), with hub rows: two runs equal
    per ``torch.equal``, and within tolerance of the CPU."""
    from repro_torch.sparse import paths

    rng = np.random.default_rng(76)
    n, nnz = 4096, 200_000
    rows = np.concatenate([rng.integers(0, n, nnz - 20_000),
                           np.full(20_000, 7)]).astype(np.int32)
    cols = rng.integers(0, n, nnz).astype(np.int32)
    vals = rng.standard_normal(nnz).astype(np.float32)
    order = rng.permutation(nnz)
    t = [torch.from_numpy(x[order]).to(dev) for x in (rows, cols, vals)]
    gen = torch.Generator(device=dev).manual_seed(76)
    h = torch.randn(n, 64, device=dev, generator=gen)
    first = paths.spmm_elements(*t, h, n)
    assert torch.equal(first, paths.spmm_elements(*t, h, n))
    v = h[:, 0].contiguous()
    y = paths.spmv_elements(*t, v, n)
    assert torch.equal(y, paths.spmv_elements(*t, v, n))
    cpu = [x.cpu() for x in t]
    _hold_reordered_sums(first.cpu(), paths.spmm_elements(*cpu, h.cpu(), n),
                         rows[order], cols[order], vals[order], h.cpu())
    _hold_reordered_sums(y.cpu(), paths.spmv_elements(*cpu, v.cpu(), n),
                         rows[order], cols[order], vals[order],
                         v.cpu()[:, None])


def _hold_reordered_sums(got, want, rows, cols, vals, h):
    """Each row of the card's sums against the CPU's: two orders of an
    n-term f32 sum differ by at most (n - 1) eps * sum |a_ij h_j| to first
    order (n - 1 roundings each way at eps / 2), plus one rounding of each
    product (a fused multiply-add on the card): the multiple is the row's
    term count plus one, times f32's eps, times the row's sum of |a_ij h_j|
    in f64."""
    n_rows = got.shape[0]
    terms = np.abs(vals.astype(np.float64))[:, None] \
        * np.abs(h.numpy().astype(np.float64))[cols.astype(np.int64)]
    mass = np.zeros((n_rows, terms.shape[1]))
    np.add.at(mass, rows.astype(np.int64), terms)
    count = np.bincount(rows.astype(np.int64), minlength=n_rows)
    bound = (count + 1)[:, None] * np.finfo(np.float32).eps * mass
    err = np.abs(got.reshape(n_rows, -1).numpy().astype(np.float64)
                 - want.reshape(n_rows, -1).numpy().astype(np.float64))
    assert (err <= bound).all(), float((err / np.maximum(bound, 1e-300))
                                       .max())


def _gat_inputs(dev, n=600, d=32, seed=80):
    rng = np.random.default_rng(seed)

    def leaf(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev).requires_grad_(True)

    return _sparse(seed, n, n, 0.05), leaf(n, 2), leaf(n, 2), leaf(n, d)


def test_csr_attention_request_sums_in_a_fixed_order(dev):
    """A fused GAT aggregation planned csr (``fused_attn_elements``: the
    softmax denominators in ``row_order``) twice: equal bits, and within
    tolerance of the CPU."""
    dense, q, k, v = _gat_inputs(dev)
    a = SparseMatrix.from_dense(dense, formats=("csr",), device=dev)
    with torch.no_grad():
        first = fused_graph_attention(a, q, k, v, policy="csr")
        assert torch.equal(first, fused_graph_attention(a, q, k, v,
                                                        policy="csr"))
        cpu = SparseMatrix.from_dense(dense, formats=("csr",), device="cpu")
        want = fused_graph_attention(cpu, q.cpu(), k.cpu(), v.cpu(),
                                     policy="csr")
    torch.testing.assert_close(first.cpu(), want, **TOL)


def test_unfused_gat_request_sums_in_a_fixed_order(dev):
    """A ``fuse=False`` GAT request (``_segment_softmax`` over the csr
    pattern) twice on the card: equal bits, within tolerance of the
    CPU."""
    from repro_torch.models.gnn import gat_forward

    rng = np.random.default_rng(81)
    adj = (rng.random((N_GAT, N_GAT)) < 0.05).astype(np.float32)
    params = init_gat(SMOKE_CONFIG, seed=0, device="cpu")
    x = torch.from_numpy(rng.standard_normal(
        (N_GAT, SMOKE_CONFIG.in_features)).astype(np.float32))
    on = {k: [t.to(dev) for t in v] for k, v in params.items()}
    graph = build_graph(adj, SMOKE_CONFIG, device=dev)
    with torch.no_grad():
        first = gat_forward(on, graph, x.to(dev), fuse=False)
        assert torch.equal(first, gat_forward(on, graph, x.to(dev),
                                              fuse=False))
        want = gat_forward(params, build_graph(adj, SMOKE_CONFIG,
                                               device="cpu"), x, fuse=False)
    torch.testing.assert_close(first.cpu(), want, **TOL)


N_GAT = 500


@pytest.mark.parametrize("fmt,policy", [("csr", "csr"), ("coo", "ell")])
def test_gat_backward_planned_csr_or_coo_sums_in_a_fixed_order(dev, fmt,
                                                                policy):
    """The fused attention's backward on a matrix carrying only a csr (or
    only a coo) form: the row softmax's denominators in ``row_order``
    (``_form_row_softmax``'s csr and coo branches; on coo also dV through
    the Block-COO transpose, ``spmm_coo``); the gradients of two runs
    equal per ``torch.equal``, within tolerance of the CPU's."""
    dense, *_ = _gat_inputs(dev)

    def grads(device):
        _, q, k, v = _gat_inputs(device)
        a = SparseMatrix.from_dense(dense, formats=(fmt,), block=(64, 64),
                                    device=device)
        y = fused_graph_attention(a, q, k, v, policy=policy)
        w = torch.linspace(-1, 1, y.numel(), device=device).reshape(y.shape)
        (torch.tanh(y) * w).sum().backward()
        return [t.grad for t in (q, k, v)]

    first, second = grads(dev), grads(dev)
    for i, (g, h) in enumerate(zip(first, second)):
        assert torch.equal(g, h), f"{fmt}: gradient {i}"
    for g, w in zip(first, grads("cpu")):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-5)


def test_blockcoo_transpose_sums_in_a_fixed_order(dev):
    """``Aᵀ @ H`` with A carrying only a Block-COO form (``spmm_coo`` over
    the transposed Block-COO view, its blocks in ``row_order``): two runs
    equal per ``torch.equal``, within tolerance of the CPU."""
    dense = _sparse(82, 700, 500, 0.05)
    h = torch.randn(700, 48, device=dev)
    a = SparseMatrix.from_dense(dense, formats=("coo",), block=(64, 64),
                                device=dev)
    first = matmul(a.T, h, policy="ell")
    assert torch.equal(first, matmul(a.T, h, policy="ell"))
    cpu = SparseMatrix.from_dense(dense, formats=("coo",), block=(64, 64),
                                  device="cpu")
    torch.testing.assert_close(first.cpu(),
                               matmul(cpu.T, h.cpu(), policy="ell"), **TOL)
    torch.testing.assert_close(first.cpu(), torch.from_numpy(dense).T
                               @ h.cpu(), **TOL)


def _fleet_requests(seed, sizes, d=8):
    rng = np.random.default_rng(seed)
    reqs = []
    for n in sizes:
        dense = (rng.random((n, n)) < 0.1).astype(np.float32)
        reqs.append((dense, rng.standard_normal((n, d)).astype(np.float32)))
    return reqs


def test_thread_fleet_on_card_matches_the_oracle(dev):
    """A 2-worker thread fleet serving on the card at ``form="ell"`` (K1
    on 16 x 16 blocks over the block-diagonal composition): every result
    a host array within 1e-4 of the f64 ``dense @ h``, K1 launched, no
    request failed or lost."""
    from repro_torch.serve.fleet import (FleetConfig, ServingFleet,
                                         WorkerConfig)

    reqs = _fleet_requests(81, [24, 40, 96, 130, 24, 200, 40, 96])
    before = spmm_blockell_kernel.launches
    fleet = ServingFleet(FleetConfig(
        backend="thread", workers=2, hedge_after_ms=10_000.0,
        worker=WorkerConfig(form="ell", device="cuda")))
    try:
        assert fleet.wait_live(2, timeout=60)
        outs = [f.result(timeout=120) for f in
                [fleet.submit(dense, h) for dense, h in reqs]]
        rep = fleet.report()
    finally:
        fleet.close()
    assert spmm_blockell_kernel.launches > before
    for (dense, h), out in zip(reqs, outs):
        assert isinstance(out, np.ndarray)
        np.testing.assert_allclose(
            out, dense.astype(np.float64) @ h.astype(np.float64),
            rtol=1e-4, atol=1e-5)
    assert (rep["completed"], rep["failed"]) == (len(reqs), 0)
    assert rep["fleet"]["requests_lost"] == 0


def test_spawned_worker_serves_on_card_and_closes(dev):
    """One ``spawn`` child worker on the card (its own CUDA context, the
    kernels loaded from the build directory) serves a request at
    ``form="ell"`` and exits with code 0 on ``close()``."""
    from repro_torch.kernels import _build
    from repro_torch.serve.fleet import (FleetConfig, ServingFleet,
                                         WorkerConfig)

    _build.build(["spmm_blockell"])  # the child loads it, never builds
    (dense, h), = _fleet_requests(82, [96])
    fleet = ServingFleet(FleetConfig(
        backend="process", workers=1, hedge_after_ms=10_000.0,
        worker=WorkerConfig(form="ell", device="cuda")))
    try:
        assert fleet.wait_live(1, timeout=120)
        out = fleet.infer(dense, h, timeout=120)
        rep = fleet.report()
    finally:
        fleet.close()
    np.testing.assert_allclose(
        out, dense.astype(np.float64) @ h.astype(np.float64),
        rtol=1e-4, atol=1e-5)
    assert rep["fleet"]["requests_lost"] == 0 and rep["failed"] == 0
    (ws,) = fleet.sup.states()
    assert ws.restarts == 0 and not ws.handle.alive()
    assert ws.handle._proc.exitcode == 0


# -- LM models (slice 15) ----------------------------------------------------


def _lm_smoke(arch, device, seed=0):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    params = T.init_lm(cfg, seed=seed, device="cpu")
    return cfg, T, params, T.tree_map(lambda a: a.to(device), params)


LM_ARCHS = ["llama4-scout-17b-a16e", "llama4-maverick-400b-a17b",
            "nemotron-4-15b", "granite-20b", "qwen1.5-110b", "gemma3-4b",
            "mamba2-2.7b", "recurrentgemma-2b", "internvl2-26b",
            "whisper-small"]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_prefill_and_decode_on_card_match_cpu(dev, arch):
    """Each smoke arch in f32 (TF32 off): prefill and 6 decode steps on the
    card against the same weights and tokens on the CPU (rtol = atol =
    1e-4: f32 sums in another order over a few layers)."""
    cfg, T, p_cpu, p_dev = _lm_smoke(arch, dev)
    rng = np.random.default_rng(1)
    n_text = 24 - cfg.vision_tokens
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, n_text + 6))
                            .astype(np.int32))
    side = {}
    if cfg.vision_tokens:
        side["vision_embeds"] = torch.from_numpy(rng.normal(
            size=(2, cfg.vision_tokens, cfg.d_model)).astype(np.float32))
    if cfg.encoder_layers:
        side["enc_embeds"] = torch.from_numpy(rng.normal(
            size=(2, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    runs = []
    for p, d in ((p_cpu, torch.device("cpu")), (p_dev, dev)):
        kw = {k: v.to(d) for k, v in side.items()}
        logits, cache = T.prefill(p, cfg, toks[:, :n_text].to(d), 32, **kw)
        outs = [logits.cpu()]
        for t in range(6):
            logits, cache = T.decode_step(
                p, cfg, toks[:, n_text + t:n_text + t + 1].to(d), cache)
            outs.append(logits.cpu())
        runs.append(outs)
    for got, want in zip(runs[1], runs[0]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_pruned_lm_decode_launches_n1_three_times_a_layer(dev):
    """gemma3 smoke with its MLP weights pruned onto 8 x 8 Block-ELL tiles:
    every MLP product plans ell, so a decode step launches N1 three times a
    layer; the logits equal the CPU's (rtol = atol = 1e-4)."""
    from repro_torch.models import pruning as P

    cfg, T, p_cpu, p_dev = _lm_smoke("gemma3-4b", dev)
    kw = dict(sparsity=0.8, prune_block=(8, 8), block=(8, 8))
    sp_cpu, sp_dev = P.sparsify_lm(p_cpu, cfg, **kw), \
        P.sparsify_lm(p_dev, cfg, **kw)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 20)).astype(np.int32))
    lc, cc = T.prefill(sp_cpu, cfg, toks[:, :16], 24)
    ld, cd = T.prefill(sp_dev, cfg, toks[:, :16].to(dev), 24)
    torch.testing.assert_close(ld.cpu(), lc, rtol=1e-4, atol=1e-4)
    for t in range(16, 20):
        spmm_blockell_t_kernel.launches = 0
        ld, cd = T.decode_step(sp_dev, cfg, toks[:, t:t + 1].to(dev), cd)
        torch.cuda.synchronize()
        assert spmm_blockell_t_kernel.launches == 3 * cfg.n_layers
        lc, cc = T.decode_step(sp_cpu, cfg, toks[:, t:t + 1], cc)
        torch.testing.assert_close(ld.cpu(), lc, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# The LM training step and the mesh at world size 1
# ---------------------------------------------------------------------------


def _train_inputs(arch, dev, s=128):
    from repro_torch.data.pipeline import DataConfig, make_lm_batch

    cfg, T, p_cpu, _ = _lm_smoke(arch, dev)
    batch = make_lm_batch(cfg, s, 2, 0, DataConfig(seed=1), device="cpu")
    return cfg, T, p_cpu, batch


def _one_step(cfg, T, p_cpu, batch, d):
    from repro_torch.train.loop import (TrainConfig, init_train_state,
                                        make_grad_fn, make_train_step)
    from repro_torch.train.optimizer import OptConfig

    tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=0,
                                     total_steps=10))
    params = T.tree_map(lambda a: a.to(d, copy=True), p_cpu)
    b = {k: v.to(d) for k, v in batch.items()}
    loss, grads = make_grad_fn(cfg, tcfg)(params, b)
    state = init_train_state(params, tcfg)
    params, state, m = make_train_step(cfg, tcfg)(params, state, b)
    torch.cuda.synchronize() if d.type == "cuda" else None
    return loss, T.tree_leaves(grads), T.tree_leaves(params), m


@pytest.mark.parametrize("arch", ["gemma3-4b", "granite-20b"])
def test_lm_train_step_twice_equal_bits(dev, arch):
    """A smoke-size AdamW step (gemma3: S = 128 over its window of 64, so
    its local layers take the banded gather) run twice on the card without
    deterministic mode: the loss, every gradient and every updated param
    equal per ``torch.equal``; the gradients within 1e-4 x max|want| of the
    CPU's (f32 sums in another order)."""
    cfg, T, p_cpu, batch = _train_inputs(arch, dev)
    first = _one_step(cfg, T, p_cpu, batch, dev)
    again = _one_step(cfg, T, p_cpu, batch, dev)
    assert torch.equal(first[0], again[0])
    for a, b in zip(first[1] + first[2], again[1] + again[2]):
        assert torch.equal(a, b)
    cpu = _one_step(cfg, T, p_cpu, batch, torch.device("cpu"))
    assert abs(float(first[0]) - float(cpu[0])) <= 1e-5 * abs(float(cpu[0]))
    for g, w in zip(first[1], cpu[1]):
        assert float((g.cpu() - w).abs().max()) \
            <= 1e-4 * float(w.abs().max()) + 1e-12


def test_lm_train_step_runs_in_deterministic_mode(dev):
    """The gemma3 smoke step under ``torch.use_deterministic_algorithms``:
    no op of its forward or backward lacks a deterministic kernel (one
    would raise), and the bits are the normal run's, so the port's own
    fixed-order sums (the embedding rows, the banded gather) are the ones
    it runs either way."""
    cfg, T, p_cpu, batch = _train_inputs("gemma3-4b", dev)
    normal = _one_step(cfg, T, p_cpu, batch, dev)
    torch.use_deterministic_algorithms(True)
    try:
        det = _one_step(cfg, T, p_cpu, batch, dev)
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(normal[0], det[0])
    for a, b in zip(normal[1] + normal[2], det[1] + det[2]):
        assert torch.equal(a, b)


@pytest.fixture
def nccl_one_rank(dev, tmp_path):
    import torch.distributed as dist

    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield dist
    finally:
        dist.destroy_process_group()


def test_make_mesh_with_no_group_keeps_the_step_on_the_card(dev):
    """``make_mesh`` with no process group and no ``device`` starts a
    one-rank NCCL group: ``place_tree`` keeps every leaf of the params and
    the optimizer state on the card, and a sharded step leaves them there,
    equal per ``torch.equal`` to the unsharded step."""
    import torch.distributed as dist

    from repro_torch.sharding.specs import make_mesh
    from repro_torch.sharding.step import make_sharded_train_step, place_tree
    from repro_torch.train.loop import (TrainConfig, init_train_state,
                                        make_train_step)
    from repro_torch.train.optimizer import OptConfig

    cfg, T, p_cpu, batch = _train_inputs("gemma3-4b", dev)
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=0,
                                     total_steps=10))
    b = {k: v.to(dev) for k, v in batch.items()}
    assert not dist.is_initialized()
    mesh = make_mesh((1, 1), ("data", "model"))
    try:
        assert dist.get_backend() == "nccl" and mesh.device_type == "cuda"
        params = T.tree_map(lambda a: a.to(dev, copy=True), p_cpu)
        p_sh = place_tree(params, mesh)
        s_sh = place_tree(init_train_state(params, tcfg), mesh)
        p_sh, s_sh, m = make_sharded_train_step(cfg, tcfg, mesh)(p_sh, s_sh,
                                                                b)
        leaves = T.tree_leaves((p_sh, s_sh))
        assert all(x.to_local().is_cuda for x in leaves)
        p1, s1, m1 = make_train_step(cfg, tcfg)(
            params, init_train_state(params, tcfg), b)
        torch.cuda.synchronize()
        assert torch.equal(m["loss"], m1["loss"])
        for got, want in zip(leaves, T.tree_leaves((p1, s1))):
            assert torch.equal(got.full_tensor(), want)
    finally:
        dist.destroy_process_group()


def test_distributed_spmm_at_world_size_one_is_k1(dev, nccl_one_rank):
    """``spmm_1p5d`` / ``spmm_2d`` / ``spmm_2p5d`` on a one-rank NCCL mesh:
    the local product is K1 (launches counted), equal per ``torch.equal``
    to ``spmm_blockell`` on the same operands."""
    from repro_torch.core.distributed import spmm_1p5d, spmm_2d, spmm_2p5d
    from repro_torch.kernels.spmm.ops import spmm_blockell
    from repro_torch.sharding.specs import make_mesh

    dense = _sparse(90, 512, 512, 0.1)
    ell = BlockELL.from_dense(dense, 64, 64, device=dev)
    h = torch.from_numpy(np.random.default_rng(90).standard_normal(
        (512, 128)).astype(np.float32)).to(dev)
    want = spmm_blockell(ell, h)
    mesh = make_mesh((1, 1), ("data", "model"))
    mesh3 = make_mesh((1, 1, 1), ("pod", "data", "model"))
    for fn, m in ((spmm_1p5d, mesh), (spmm_2d, mesh), (spmm_2p5d, mesh3)):
        spmm_blockell_kernel.launches = 0
        got = fn(ell, h, m).full_tensor()
        torch.cuda.synchronize()
        assert spmm_blockell_kernel.launches == 1, fn.__name__
        assert torch.equal(got, want), fn.__name__


# ---------------------------------------------------------------------------
# K3's two epilogues and the deprecated shims
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, *NARROW])
@pytest.mark.parametrize("block", [(64, 64), (48, 32)])
@pytest.mark.parametrize("k", [2, 17])
def test_k3_epilogues_equal_their_plain_versions(dev, dtype, block, k):
    """K3's weighted launch with each epilogue (round once, the Block-COO
    entry points'; the dot rounded first, the ``SparseMatrix`` ELL
    path's) against its plain version on integer B and C (exact f32
    dots): equal per ``torch.equal`` on the streaming kernel (K = 2) and
    the staged one (K = 17).  In bf16 / f16 the two epilogues differ
    somewhere (the dots reach past the dtype's integers); in f32 they
    agree."""
    bm, bn = block
    coo = BlockCOO.from_dense(_sparse(k + 11, 301, 277, 0.1), bm, bn,
                              device=dev)
    gen = torch.Generator(device=dev).manual_seed(k)
    b = torch.randint(-40, 41, (coo.shape[0], k), generator=gen,
                      device=dev).to(dtype)
    c = torch.randint(-40, 41, (k, coo.shape[1]), generator=gen,
                      device=dev).to(dtype)
    ops = (coo.rows, coo.cols, coo.blocks.to(dtype), b, c)
    got = {}
    for round_dot in (False, True):
        before = sddmm_blockcoo_kernel.launches
        got[round_dot] = sddmm_blockcoo_kernel(*ops, round_dot=round_dot)
        assert sddmm_blockcoo_kernel.launches == before + 1
        assert torch.equal(got[round_dot],
                           sddmm_blockcoo_ref(*ops, round_dot=round_dot))
    assert torch.equal(got[False], got[True]) == (dtype == torch.float32)


def test_legacy_keywords_on_the_card(dev):
    """``core.spmm.spmm`` on CUDA tensors: ``use_kernel=True`` launches K1,
    ``use_kernel=False`` runs the plain version (no launch), both equal to
    the plain version; on a CPU tensor ``use_kernel=True`` raises; and
    ``core.sddmm.sddmm`` launches K3 with the round-once epilogue."""
    from repro_torch.core.sddmm import sddmm as legacy_sddmm
    from repro_torch.core.spmm import spmm as legacy_spmm

    a = _sparse(5, 200, 150, 0.1)
    ell = BlockELL.from_dense(a, 64, 64, device=dev)
    h = torch.randn(ell.shape[1], 32, device=dev)
    want = spmm_blockell_ref(ell.indices, ell.blocks, h)
    for use_kernel, launches in ((True, 1), (False, 0)):
        before = spmm_blockell_kernel.launches
        with pytest.warns(DeprecationWarning):
            y = legacy_spmm(ell, h, use_kernel=use_kernel)
        assert spmm_blockell_kernel.launches == before + launches
        torch.testing.assert_close(y, want, **TOL)  # the padded rows too
    with pytest.warns(DeprecationWarning), \
            pytest.raises(ValueError, match="cpu"):
        legacy_spmm(BlockELL.from_dense(a, 64, 64, device="cpu"), h.cpu(),
                    use_kernel=True)
    coo = BlockCOO.from_dense(a, 64, 64, device=dev)
    coo = dataclasses.replace(coo, blocks=coo.blocks.to(torch.bfloat16))
    b = torch.randint(-40, 41, (coo.shape[0], 2), device=dev).bfloat16()
    c = torch.randint(-40, 41, (2, coo.shape[1]), device=dev).bfloat16()
    before = sddmm_blockcoo_kernel.launches
    with pytest.warns(DeprecationWarning):
        s = legacy_sddmm(coo, b, c, policy="ell")
    assert sddmm_blockcoo_kernel.launches == before + 1
    assert torch.equal(s.blocks, sddmm_blockcoo_ref(
        coo.rows, coo.cols, coo.blocks, b, c))
