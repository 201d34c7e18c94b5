"""Port parity: K3 at a pattern (``sddmm_pattern_kernel``) and the ell
path's pattern sampling of the backward rules
(``autodiff.sample_pattern_exec``).

On the CPU the wrapper runs its plain version.  It is held, per
``torch.equal``, to the every-cell plain version (``sddmm_blockcoo_ref``
without a mask) with the cells off the pattern set to 0, in f32, bf16 and
f16, at K = 2, 17, 128 and 130, bn = 64 and 128, over a Block-ELL form
with padded slots, empty tile rows and an all-padding block-row.  The
pattern route's dots at A's nonzeros are held to the reference's
``sample_exec`` on the ell path, its K3 in Pallas interpret mode over
the all-ones mask (rtol = atol = 1e-4, the reference's own K3 test
tolerance).  The gradients of ``SpMM``, ``SDDMMValues``,
``SpMMEpilogue`` and ``FusedAttention`` on the ell path (over an ell and
over a coo form) equal, per ``torch.equal``, those of the every-cell
route.  ``SparseMatrix.tile_occupancy`` is built once per matrix and
unpacks to ``blocks != 0``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sparse import SparseMatrix as JSparseMatrix
from repro.sparse import autodiff as j_autodiff
from repro_torch.kernels.sddmm import ref as sddmm_ref
from repro_torch.kernels.sddmm.kernel import (sddmm_blockcoo_kernel,
                                              sddmm_pattern_kernel)
from repro_torch.kernels.sddmm.ref import (pack_occupancy,
                                           sddmm_pattern_ref,
                                           unpack_occupancy)
from repro_torch.sparse import autodiff
from repro_torch.sparse.matrix import SparseMatrix
from repro_torch.sparse.ops import fused_graph_attention, matmul, sddmm
from repro_torch.sparse.paths import ell_to_coo

DTYPES = [torch.float32, torch.bfloat16, torch.float16]
REF_TOL = dict(rtol=1e-4, atol=1e-4)
M, N = 100, 300  # ragged: neither is a multiple of the block


def _dense(seed, m=M, n=N, density=0.1, bm=16):
    """Density ``density``, with block-row 1 all zero (its slots all
    padding) and a few empty rows inside live block-rows."""
    rng = np.random.default_rng(seed)
    a = np.where(rng.random((m, n)) < density, rng.normal(size=(m, n)),
                 0.0).astype(np.float32)
    a[bm:2 * bm] = 0.0
    a[[40, 41, 77]] = 0.0
    return a


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _ell(seed, block):
    mat = SparseMatrix.from_dense(_dense(seed, bm=block[0]),
                                  formats=("ell",), block=block,
                                  device="cpu")
    return mat, mat.form("ell")


@pytest.mark.parametrize("bn", [64, 128])
@pytest.mark.parametrize("k", [2, 17, 128, 130])
@pytest.mark.parametrize("dtype", DTYPES)
def test_pattern_plain_equals_masked_every_cell(dtype, k, bn):
    block = (16, bn)
    _, ell = _ell(k + bn, block)
    assert bool((ell.blocks == 0).all(dim=(2, 3)).any())  # padded slots
    coo = ell_to_coo(ell)
    occ = pack_occupancy(ell.blocks)
    b = torch.from_numpy(_normal(k, coo.shape[0], k)).to(dtype)
    c = torch.from_numpy(_normal(k + 1, coo.shape[1], k)).to(dtype).T
    kw = dict(block=block, out_dtype=dtype)
    before = sddmm_pattern_kernel.launches
    got = sddmm_pattern_kernel(coo.rows, coo.cols, occ, b, c, **kw)
    assert sddmm_pattern_kernel.launches == before  # plain version on CPU
    every = sddmm_blockcoo_kernel(coo.rows, coo.cols, None, b, c, **kw)
    keep = coo.blocks != 0
    assert got.dtype == every.dtype == dtype
    assert torch.equal(got, torch.where(keep, every, 0.0))
    assert not bool(got[~keep].any())
    assert torch.equal(got, sddmm_pattern_ref(coo.rows, coo.cols, occ, b,
                                              c, **kw))


@pytest.mark.parametrize("bn", [5, 32, 33, 64, 100, 128])
def test_occupancy_packs_and_unpacks(bn):
    rng = np.random.default_rng(bn)
    blocks = torch.from_numpy(np.where(rng.random((9, 7, bn)) < 0.3, 1.0,
                                       0.0).astype(np.float32))
    blocks[0] = 1.0  # every bit of a tile, bit 31 included
    blocks[1] = 0.0
    occ = pack_occupancy(blocks)
    assert occ.dtype == torch.int32
    assert occ.shape == (9, 7, -(-bn // 32))
    assert torch.equal(unpack_occupancy(occ, bn), blocks != 0)
    # bits past bn are 0, and the words are as the bits say
    for t, r in ((0, 0), (2, 3), (8, 6)):
        for w in range(occ.shape[2]):
            want = sum(1 << i for i in range(32)
                       if 32 * w + i < bn and blocks[t, r, 32 * w + i] != 0)
            assert int(occ[t, r, w]) & 0xFFFFFFFF == want


@pytest.mark.parametrize("fmt", ["ell", "coo"])
def test_tile_occupancy_is_built_once(fmt, monkeypatch):
    """One packing per matrix, whatever samples it; it unpacks to the
    pattern the backward masks with (``read_values(a, "ell") != 0``)."""
    mat = SparseMatrix.from_dense(_dense(3), formats=(fmt,), block=(16, 64),
                                  device="cpu")
    from repro_torch.sparse import matrix as matrix_mod

    calls = []
    real = matrix_mod.pack_occupancy
    monkeypatch.setattr(matrix_mod, "pack_occupancy",
                        lambda blocks: calls.append(1) or real(blocks))
    h = torch.from_numpy(_normal(4, N, 32))
    vals = autodiff.read_values(mat, "ell").clone().requires_grad_(True)
    for _ in range(2):  # two backward passes, each sampling dA at K = 32
        autodiff.SpMM.apply("ell", mat, vals, h).sum().backward()
    occ = mat.tile_occupancy()
    assert occ is mat.tile_occupancy()
    assert len(calls) == 1
    blocks = autodiff.read_values(mat, "ell")
    assert torch.equal(unpack_occupancy(occ, blocks.shape[-1])
                       .reshape(blocks.shape), blocks != 0)


@pytest.mark.parametrize("fmt", ["ell", "coo"])
@pytest.mark.parametrize("k", [17, 32])
def test_pattern_route_matches_reference_sample_exec(fmt, k):
    """The pattern route's dots at A's nonzeros against the reference's
    ell ``sample_exec`` (its K3 in Pallas interpret mode over an all-ones
    mask); 0 off the pattern."""
    dense = _dense(k, n=120)
    a = SparseMatrix.from_dense(dense, formats=(fmt,), block=(16, 64),
                                device="cpu")
    ja = JSparseMatrix.from_dense(dense, formats=(fmt,), block=(16, 64))
    b, c = _normal(k + 2, M, k), _normal(k + 3, k, 120)
    got = autodiff.sample_pattern_exec("ell", a, torch.from_numpy(b),
                                       torch.from_numpy(c))
    want = np.asarray(j_autodiff.sample_exec(
        ("ell", True, True, None, None), ja, jnp.asarray(b),
        jnp.asarray(c)))
    keep = (autodiff.read_values(a, "ell") != 0).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy()[keep], want[keep], **REF_TOL)
    assert not got.numpy()[~keep].any()


@pytest.mark.parametrize("k", [2, 15])
def test_pattern_route_below_its_width_is_sample_exec(k):
    """Below ``PATTERN_MIN_K`` the ell path keeps sampling every cell, as
    ``sample_exec`` does; the csr and dense paths always do."""
    assert k < autodiff.PATTERN_MIN_K
    mat = SparseMatrix.from_dense(_dense(5), formats=("ell", "csr"),
                                  block=(16, 64), device="cpu")
    b = torch.from_numpy(_normal(6, M, k))
    c = torch.from_numpy(_normal(7, k, N))
    for path in ("ell", "csr", "dense"):
        assert torch.equal(autodiff.sample_pattern_exec(path, mat, b, c),
                           autodiff.sample_exec(path, mat, b, c))
    b = torch.from_numpy(_normal(8, M, 40))
    c = torch.from_numpy(_normal(9, 40, N))
    for path in ("csr", "dense"):
        assert torch.equal(autodiff.sample_pattern_exec(path, mat, b, c),
                           autodiff.sample_exec(path, mat, b, c))


def _leaf(seed, *shape):
    return torch.from_numpy(_normal(seed, *shape)).requires_grad_(True)


def _rule_grads(rule, fmt, every_cell, monkeypatch):
    """Gradients of one rule on the ell path at D = K = 32, every input
    (A's values included where the rule reads them) needing one; with
    ``every_cell`` the pattern route is turned off."""
    if every_cell:
        monkeypatch.setattr(autodiff, "PATTERN_MIN_K", 1 << 30)
    d = 32
    a = SparseMatrix.from_dense(_dense(11, m=N), formats=(fmt,),
                                block=(16, 64), device="cpu")
    vals = a.data.detach().clone().requires_grad_(True)
    av = a.with_data(vals)
    if rule == "spmm":
        inputs = (vals, _leaf(12, N, d))
        y = matmul(av, inputs[1], policy="ell")
    elif rule == "sddmm":
        inputs = (vals, _leaf(13, N, d), _leaf(14, d, N))
        y = sddmm(av, *inputs[1:], policy="ell").densify()
    elif rule == "epilogue":
        inputs = (vals, _leaf(15, N, d), _leaf(16, d), _leaf(17, N, d))
        y = matmul(av, inputs[1], policy="ell", epilogue="leaky_relu",
                   bias=inputs[2], residual=inputs[3])
    else:
        inputs = (_leaf(18, N, 2), _leaf(19, N, 2), _leaf(20, N, d))
        y = fused_graph_attention(a, *inputs, policy="ell")
    w = torch.from_numpy(_normal(21, *y.shape))
    (torch.tanh(y) * w).sum().backward()
    return [x.grad for x in inputs]


@pytest.mark.parametrize("fmt", ["ell", "coo"])
@pytest.mark.parametrize("rule", ["spmm", "sddmm", "epilogue", "attention"])
def test_gradients_equal_the_every_cell_route(rule, fmt, monkeypatch):
    got = _rule_grads(rule, fmt, False, monkeypatch)
    want = _rule_grads(rule, fmt, True, monkeypatch)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g is not None and torch.isfinite(g).all()
        assert torch.equal(g, w), f"{rule} {fmt} input {i}"


def test_pattern_route_runs_the_pattern_plain_version(monkeypatch):
    """At K >= PATTERN_MIN_K the ell path goes through K3 at the pattern
    (its plain version on the CPU), once per sampled product."""
    calls = []
    real = sddmm_ref.sddmm_pattern_ref
    from repro_torch.kernels.sddmm import kernel as kernel_mod

    monkeypatch.setattr(kernel_mod, "sddmm_pattern_ref",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    mat = SparseMatrix.from_dense(_dense(22), formats=("ell",),
                                  block=(16, 64), device="cpu")
    k = autodiff.PATTERN_MIN_K
    b = torch.from_numpy(_normal(23, M, k))
    c = torch.from_numpy(_normal(24, N, k)).T
    out = autodiff.sample_pattern_exec("ell", mat, b, c)
    assert len(calls) == 1
    assert out.shape == mat.form("ell").blocks.shape
    keep = mat.form("ell").blocks != 0
    assert torch.equal(out[keep],
                       autodiff.sample_exec("ell", mat, b, c)[keep])
