"""The CUDA kernels K1-K9 on the card, held to their plain PyTorch
versions (tolerance rtol 1e-4, atol 1e-5: f32 sums in another order, and
for K7/K8 the online softmax against the two-sweep; K9 in bf16 at rtol =
atol = 2e-2, the output and p rounded to bf16), across block shapes,
ragged edges, K / dk and D-tile widths, all three edge activations, and
for K9 the causal / window flags, GQA and custom ELL patterns; and GCN and
GAT serving, the SDDMM front-end and block-sparse attention on the card
against the same calls on the CPU.

These need an NVIDIA GPU and ``nvcc``; without them they skip.  Run them
on the card with ``python -m pytest -m cuda tests/test_torch_cuda.py``.
"""
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
from repro_torch.kernels.fused.attention import (fused_attn_blockell_kernel,
                                                 fused_attn_blockell_ref,
                                                 fused_attn_sell_kernel,
                                                 fused_attn_sell_tiles_ref)
from repro_torch.kernels.fused.epilogue import Epilogue
from repro_torch.kernels.fused.spmm import (spmm_blockell_epilogue_kernel,
                                            spmm_blockell_epilogue_ref,
                                            spmm_sell_epilogue_kernel,
                                            spmm_sell_epilogue_ref,
                                            spmm_sell_epilogue_slots_ref)
from repro_torch.kernels.sddmm.kernel import sddmm_blockcoo_kernel
from repro_torch.kernels.sddmm.ref import sddmm_blockcoo_ref
from repro_torch.kernels.sddmm.sell import (sddmm_sell_kernel,
                                            sddmm_sell_tiles_ref)
from repro_torch.kernels.spmm.kernel import spmm_blockell_kernel
from repro_torch.kernels.spmm.ref import spmm_blockell_ref
from repro_torch.kernels.spmm.sell import (sell_row_operands,
                                           sell_tile_blocks,
                                           spmm_sell_kernel,
                                           spmm_sell_slots_ref,
                                           spmm_sell_tiles_ref)
from repro_torch.models.gnn import (build_graph, graph_candidates, init_gat,
                                    init_gcn)
from repro_torch.serve.engine import GNNServeConfig, GNNServingEngine
from repro_torch.sparse.ops import sddmm

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
    ops = (sell.tile_rows, sell.tile_cols,
           (sell_tile_blocks(sell) != 0).float(),
           torch.randn(sell.n_live_block_rows * bm, k, device=dev),
           torch.randn(k, -(-277 // bn) * bn, device=dev))
    before = sddmm_sell_kernel.launches
    torch.testing.assert_close(sddmm_sell_kernel(*ops),
                               sddmm_sell_tiles_ref(*ops), **TOL)
    assert sddmm_sell_kernel.launches == before + 1


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
    ops = (sell.tile_rows, sell.tile_cols,
           (sell_tile_blocks(sell) != 0).float(),
           torch.randn(sell.n_live_block_rows * bm, dk, device=dev),
           torch.randn(dk, n_pad, device=dev),
           torch.randn(n_pad, d, device=dev))
    kw = dict(n_live_block_rows=sell.n_live_block_rows, act=act, slope=0.2)
    before = fused_attn_sell_kernel.launches
    torch.testing.assert_close(fused_attn_sell_kernel(*ops, **kw),
                               fused_attn_sell_tiles_ref(*ops, **kw), **TOL)
    assert fused_attn_sell_kernel.launches == before + 1


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
