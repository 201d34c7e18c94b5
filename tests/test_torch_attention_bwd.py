"""Port parity: K7b, the fused attention's backward chain over a Block-ELL
pattern (``fused_attn_blockell_bwd_kernel``), and the rule that takes it.

On the CPU the wrapper runs its plain version.  Its α, de and dq are
held, per ``torch.equal``, to the composed rule's (the score recompute,
the row softmax, dα, the softmax JVP and dq = de k, run here through
``autodiff``'s own helpers) on ell forms at sparsity 0.5 / 0.9 / 0.99,
blocks (64, 64), (32, 64) and a ragged (5, 7), D = 2 / 16 / 128 / 130 and
dk = 1 / 2 / 8, with rows that have no edge, an all-padding block-row and
padded slots, where α and de are exactly 0.  The rule's gradients through
K7b equal, per ``torch.equal``, those of the composition
(``PATTERN_MIN_K`` at 0 turns K7b off), for every edge activation, and
are held to ``jax.grad`` of the reference's rule (rtol 1e-4, atol 1e-5,
``tests/test_torch_autodiff.py``'s fused tolerance).  The dispatch log
records K7b (``op="attention"``) on the ell path over an ell form below
``PATTERN_MIN_K``, and the composition at dk >= ``PATTERN_MIN_K``, over a
coo form and on the sell and csr paths.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sparse import SparseMatrix as JSparseMatrix
from repro.sparse import fused_graph_attention as j_fused_attention
from repro_torch.dispatch.dispatcher import clear_log, dispatch_log
from repro_torch.kernels.fused import attention as fat
from repro_torch.kernels.fused.epilogue import act_grad_from_out, apply_act
from repro_torch.sparse import autodiff
from repro_torch.sparse.matrix import SparseMatrix, single_form
from repro_torch.sparse.ops import fused_graph_attention

M, N = 150, 300  # ragged: neither is a multiple of the blocks
FUSED_TOL = dict(rtol=1e-4, atol=1e-5)
K7B_PLAN = ("attention", "ell", "vjp: fused attention backward (K7b)")


def _dense(seed, sparsity, bm, m=M, n=N):
    """Density 1 - ``sparsity``, with A's second block-row all zero (its
    slots all padding) and a few empty rows inside live block-rows."""
    rng = np.random.default_rng(seed)
    a = np.where(rng.random((m, n)) < 1.0 - sparsity,
                 rng.normal(size=(m, n)), 0.0).astype(np.float32)
    a[bm:2 * bm] = 0.0
    a[[3, 2 * bm + 1, m - 1]] = 0.0
    a[0, 1] = 1.0  # at least one edge
    return a


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _by_row(t):
    """A Block-ELL values tensor [nbr, W, bm, bn] as its M logical rows."""
    return t.permute(0, 2, 1, 3).reshape(-1, t.shape[1] * t.shape[3])[:M]


def _composed(a, q, k, v, g, act, slope):
    """α, de and dq as the composed rule computes them on the ell path."""
    mask = autodiff.read_values(a, "ell") != 0
    raw = autodiff.sample_pattern_exec("ell", a, q, k.T).float()
    e = torch.where(mask, apply_act(raw, act, slope), fat.NEG_INF)
    alpha = autodiff._form_row_softmax(a, "ell", e, mask)
    dalpha = autodiff.sample_pattern_exec("ell", a, g, v.T).float()
    out = autodiff.fused_attention_exec("ell", a, q, k, v, act, slope)
    rowdot = (g * out).sum(dim=-1)
    de = dalpha.sub_(autodiff._form_broadcast_rows(a, "ell", rowdot))
    de.mul_(alpha).mul_(act_grad_from_out(raw, act, slope)).mul_(mask)
    dq = autodiff.spmm_exec("ell", single_form(a, "ell", de), k)
    return alpha, de, dq, rowdot


@pytest.mark.parametrize("dk", [1, 2, 8])
@pytest.mark.parametrize("d", [2, 16, 128, 130])
@pytest.mark.parametrize("block", [(64, 64), (32, 64), (5, 7)])
@pytest.mark.parametrize("sparsity", [0.5, 0.9, 0.99])
def test_plain_version_equals_the_composed_rule(sparsity, block, d, dk):
    bm = block[0]
    dense = _dense(d + dk + bm, sparsity, bm)
    a = SparseMatrix.from_dense(dense, formats=("ell",), block=block,
                                device="cpu")
    ell = a.form("ell")
    assert bool((ell.blocks == 0).all(dim=(2, 3)).any())  # padded slots
    q, k = (torch.from_numpy(_normal(s, n, dk)) for s, n in ((1, M), (2, N)))
    v, g = torch.from_numpy(_normal(3, N, d)), torch.from_numpy(
        _normal(4, M, d))
    want_alpha, want_de, want_dq, rowdot = _composed(a, q, k, v, g,
                                                     "leaky_relu", 0.2)
    before = fat.fused_attn_blockell_bwd_kernel.launches
    alpha, de, dq = fat.fused_attn_blockell_bwd(ell, a.tile_occupancy(), q,
                                                k.T, v, g, rowdot)
    assert fat.fused_attn_blockell_bwd_kernel.launches == before  # plain
    assert alpha.dtype == de.dtype == dq.dtype == torch.float32
    assert alpha.shape == de.shape == ell.blocks.shape
    assert dq.shape == (M, dk)
    assert torch.equal(alpha, want_alpha)
    assert torch.equal(de, want_de)
    assert torch.equal(dq, want_dq)
    # exact 0 off the pattern: dead cells, padded slots, edge-less rows
    dead = ell.blocks == 0
    assert not alpha[dead].any() and not de[dead].any()
    empty = torch.from_numpy((dense == 0).all(axis=1))
    assert bool(empty.any())
    assert not _by_row(alpha)[empty].any() and not _by_row(de)[empty].any()
    assert not dq[empty].any()
    assert torch.allclose(_by_row(alpha)[~empty].sum(dim=1),
                          torch.ones(int((~empty).sum())))


def _grads(a, fmt_path, q, k, v, w, act="leaky_relu"):
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    y = fused_graph_attention(a, tq, tk, tv, edge_act=act, policy=fmt_path)
    (y * torch.from_numpy(w)).sum().backward()
    return tq.grad, tk.grad, tv.grad


@pytest.mark.parametrize("act", ["identity", "relu", "leaky_relu"])
@pytest.mark.parametrize("block", [(64, 64), (5, 7)])
@pytest.mark.parametrize("dk", [1, 2, 8])
def test_rule_through_k7b_equals_the_composition(dk, block, act,
                                                 monkeypatch):
    a = SparseMatrix.from_dense(_dense(dk, 0.9, block[0]), formats=("ell",),
                                block=block, device="cpu")
    q, k, v, w = (_normal(5, M, dk), _normal(6, N, dk), _normal(7, N, 16),
                  _normal(8, M, 16))
    clear_log()
    got = _grads(a, "ell", q, k, v, w, act)
    assert K7B_PLAN in [(p.op, p.path, p.reason) for p in dispatch_log()]
    monkeypatch.setattr(autodiff, "PATTERN_MIN_K", 0)
    clear_log()
    want = _grads(a, "ell", q, k, v, w, act)
    assert "attention" not in [p.op for p in dispatch_log()]
    for name, g, h in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(g).all()
        assert torch.equal(g, h), name


@pytest.mark.parametrize("dk", [1, 2, 8])
@pytest.mark.parametrize("sparsity", [0.5, 0.9, 0.99])
def test_rule_through_k7b_matches_reference(sparsity, dk):
    dense = _dense(dk + 20, sparsity, 16, m=48, n=48)
    a = SparseMatrix.from_dense(dense, formats=("ell",), block=(16, 16),
                                device="cpu")
    ja = JSparseMatrix.from_dense(dense, formats=("ell",), block=(16, 16))
    q, k, v, w = (_normal(9, 48, dk), _normal(10, 48, dk), _normal(11, 48, 8),
                  _normal(12, 48, 8))

    def j_loss(qq, kk, vv):
        return (j_fused_attention(ja, qq, kk, vv, policy="ell") * w).sum()

    want = jax.jit(jax.grad(j_loss, argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    clear_log()
    got = _grads(a, "ell", q, k, v, w)
    assert K7B_PLAN in [(p.op, p.path, p.reason) for p in dispatch_log()]
    for name, g, h in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(h), err_msg=name,
                                   **FUSED_TOL)


@pytest.mark.parametrize("path,fmt,dk,k7b", [
    ("ell", "ell", 1, True), ("ell", "ell", 15, True),
    ("ell", "ell", 16, False), ("ell", "ell", 40, False),
    ("ell", "coo", 2, False), ("sell", "sell", 2, False),
    ("csr", "csr", 2, False), ("dense", "ell", 2, False)])
def test_routing(path, fmt, dk, k7b):
    """K7b where the ell path reads a Block-ELL form at dk below
    ``PATTERN_MIN_K``; the composition (its score recompute and dα
    sampled, dq an SpMM) everywhere else."""
    assert (dk < autodiff.PATTERN_MIN_K) or not k7b
    a = SparseMatrix.from_dense(_dense(dk + 30, 0.9, 16, m=48, n=48),
                                formats=(fmt,), block=(16, 16),
                                device="cpu")
    clear_log()
    _grads(a, path, _normal(13, 48, dk), _normal(14, 48, dk),
           _normal(15, 48, 8), _normal(16, 48, 8))
    ops = [p.op for p in dispatch_log() if p.policy == "vjp"]
    if k7b:
        assert ops == ["attention", "spmm", "spmm"]
        assert [(p.op, p.path, p.reason) for p in dispatch_log()
                if p.policy == "vjp"][0] == K7B_PLAN
    else:
        assert ops == ["sddmm", "sddmm", "spmm", "spmm", "spmm"]
