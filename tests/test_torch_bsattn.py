"""Port parity: block-sparse flash attention (``repro_torch.kernels
.bsattn``: the K9 wrapper's plain version, the entry point, the ELL
helpers and the dense oracle) against ``repro.kernels.bsattn``.

The JAX side runs the Pallas kernel in interpret mode, as its own tests
do; the port side runs on CPU tensors, so the wrapper takes its plain
version.  Every case of ``tests/test_kernels_bsattn.py`` is here, f32 at
its tolerance (rtol = atol = 2e-5); bf16 port vs JAX at 1e-2 and each vs
the f32 oracle at the reference's 3e-2.  The ELL helpers must equal the
reference's arrays exactly, and the known gap of ``banded_ell`` at
``block_q > block_kv`` is pinned in both packages.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bsattn import ops as jops
from repro.kernels.bsattn import ref as jref
from repro_torch.kernels.bsattn import (block_sparse_attention_ref,
                                        block_sparse_flash_attention)
from repro_torch.kernels.bsattn.kernel import bsattn_kernel, bsattn_ref
from repro_torch.kernels.bsattn.ops import banded_ell
from repro_torch.kernels.bsattn.ref import dense_mask_from_ell

TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(seed, bh=4, bkv=2, s=256, d=64):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(n, s, d)).astype(np.float32)
                 for n in (bh, bkv, bkv))


def _t(*xs):
    return tuple(torch.from_numpy(x) for x in xs)


def _j(*xs):
    return tuple(jnp.asarray(x) for x in xs)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("window,bq,bk", [
    (64, 64, 64), (128, 64, 64), (64, 64, 32), (128, 128, 64),
])
def test_banded_kernel_matches_oracle(window, bq, bk):
    x = _qkv(0)
    s = x[0].shape[1]
    kw = dict(window=window, block_q=bq, block_kv=bk)
    out = block_sparse_flash_attention(*_t(*x), **kw)
    _close(out, jops.block_sparse_flash_attention(*_j(*x), interpret=True,
                                                  **kw))
    ell, val = banded_ell(s, bq, bk, window)
    mask = dense_mask_from_ell(ell, val, s, bq, bk, causal=True,
                               window=window)
    _close(out, block_sparse_attention_ref(*_t(*x), mask))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 64])
def test_causal_and_window_flags(causal, window):
    """``causal`` and ``window`` are independent predicates."""
    x = _qkv(1, s=128)
    kw = dict(window=window, causal=causal, block_q=64, block_kv=32)
    out = block_sparse_flash_attention(*_t(*x), **kw)
    _close(out, jops.block_sparse_flash_attention(*_j(*x), interpret=True,
                                                  **kw))
    ell, val = banded_ell(128, 64, 32, window)
    mask = dense_mask_from_ell(ell, val, 128, 64, 32, causal=causal,
                               window=window if window > 0 else None)
    _close(out, block_sparse_attention_ref(*_t(*x), mask))


def test_full_causal_window0():
    x = _qkv(2, s=128)
    kw = dict(window=0, block_q=64, block_kv=64)
    out = block_sparse_flash_attention(*_t(*x), **kw)
    _close(out, jops.block_sparse_flash_attention(*_j(*x), interpret=True,
                                                  **kw))
    ell, val = banded_ell(128, 64, 64, 0)
    mask = dense_mask_from_ell(ell, val, 128, 64, 64, causal=True)
    _close(out, block_sparse_attention_ref(*_t(*x), mask))


def test_custom_block_pattern():
    """Every q block sees block 0 (global) + itself."""
    x = _qkv(3)
    nq = 4
    ell = np.stack([np.zeros(nq), np.arange(nq)], axis=1).astype(np.int32)
    val = np.ones_like(ell)
    out = block_sparse_flash_attention(*_t(*x), causal=True, block_q=64,
                                       block_kv=64, ell_idx=ell, valid=val)
    _close(out, jops.block_sparse_flash_attention(
        *_j(*x), causal=True, block_q=64, block_kv=64,
        ell_idx=jnp.asarray(ell), valid=jnp.asarray(val), interpret=True))
    mask = dense_mask_from_ell(ell, val, 256, 64, 64, causal=True)
    _close(out, block_sparse_attention_ref(*_t(*x), mask))


def test_invalid_slots_and_fully_masked_rows():
    """Invalid slots are ignored; a block-row with no valid slot, and one
    whose only block lies above the diagonal, come out exactly 0."""
    x = _qkv(4)
    ell = np.array([[0, 2, 3], [1, 0, 0], [3, 3, 1], [2, 0, 3]], np.int32)
    val = np.array([[1, 0, 1], [0, 0, 0], [1, 0, 0], [1, 1, 1]], np.int32)
    kw = dict(causal=True, block_q=64, block_kv=64)
    out = block_sparse_flash_attention(*_t(*x), ell_idx=ell, valid=val, **kw)
    _close(out, jops.block_sparse_flash_attention(
        *_j(*x), ell_idx=jnp.asarray(ell), valid=jnp.asarray(val),
        interpret=True, **kw))
    mask = dense_mask_from_ell(ell, val, 256, 64, 64, causal=True)
    _close(out, block_sparse_attention_ref(*_t(*x), mask))
    assert bool((out[:, 64:192] == 0).all())
    assert bool((out[:, :64] != 0).any())


def test_bf16_inputs():
    x = _qkv(5, s=128)
    xb = tuple(t.to(torch.bfloat16) for t in _t(*x))
    kw = dict(window=64, block_q=64, block_kv=64)
    out = block_sparse_flash_attention(*xb, **kw)
    assert out.dtype == torch.bfloat16
    jout = jops.block_sparse_flash_attention(
        *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in xb),
        interpret=True, **kw)
    _close(out.float(), jout, dict(rtol=1e-2, atol=1e-2))
    ell, val = banded_ell(128, 64, 64, 64)
    mask = dense_mask_from_ell(ell, val, 128, 64, 64, causal=True,
                               window=64)
    oracle = block_sparse_attention_ref(*(t.float() for t in xb), mask)
    _close(out.float(), oracle, dict(rtol=3e-2, atol=3e-2))
    _close(jout, oracle, dict(rtol=3e-2, atol=3e-2))


def test_gqa_head_mapping():
    """8 q heads on 2 kv heads: the head arithmetic == repeated KV."""
    q, k, v = _t(*_qkv(6, bh=8, bkv=2, s=128))
    kw = dict(window=64, block_q=64, block_kv=64)
    out = block_sparse_flash_attention(q, k, v, **kw)
    out2 = block_sparse_flash_attention(q, k.repeat_interleave(4, 0),
                                        v.repeat_interleave(4, 0), **kw)
    _close(out, out2, dict(rtol=1e-5, atol=1e-5))
    _close(out, jops.block_sparse_flash_attention(
        *_j(q.numpy(), k.numpy(), v.numpy()), interpret=True, **kw))


GRID = list(itertools.product(
    [128, 256], [(32, 32), (64, 32), (64, 64), (128, 64), (32, 64)],
    [0, 32, 64, 128]))


@pytest.mark.parametrize("s,blocks,window", GRID)
def test_ell_helpers_equal_reference(s, blocks, window):
    bq, bk = blocks
    ell, val = banded_ell(s, bq, bk, window)
    jell, jval = jops.banded_ell(s, bq, bk, window)
    assert ell.dtype == jell.dtype and val.dtype == jval.dtype
    np.testing.assert_array_equal(ell, jell)
    np.testing.assert_array_equal(val, jval)
    for causal in (True, False):
        w = window if window > 0 else None
        np.testing.assert_array_equal(
            dense_mask_from_ell(ell, val, s, bq, bk, causal, w),
            jref.dense_mask_from_ell(jell, jval, s, bq, bk, causal, w))


def _true_window(s, window):
    pos = np.arange(s)
    return (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None]
                                             - window)


@pytest.mark.parametrize("bq,bk,missing", [(64, 32, 2112), (64, 64, 0),
                                           (32, 32, 0)])
def test_banded_ell_gap_at_block_q_above_block_kv(bq, bk, missing):
    """Known gap, carried from the reference on purpose: at s = 256 and
    window 64 with blocks 64 / 32, the ELL mask of both packages misses
    2112 pairs of the true causal window (128 of them self-pairs); with
    block_q == block_kv nothing is missing."""
    s, window = 256, 64
    truth = _true_window(s, window)
    masks = [dense_mask_from_ell(*banded_ell(s, bq, bk, window), s, bq, bk,
                                 True, window),
             jref.dense_mask_from_ell(*jops.banded_ell(s, bq, bk, window), s,
                                      bq, bk, True, window)]
    for mask in masks:
        assert not (mask & ~truth).any()  # never more than the window
        assert int((truth & ~mask).sum()) == missing
    if missing:
        assert int((np.diag(truth) & ~np.diag(masks[0])).sum()) == 128


@pytest.mark.parametrize("causal", [True, False])
def test_dense_oracle_parity(causal):
    x = _qkv(7, s=128)
    rng = np.random.default_rng(8)
    mask = rng.random((128, 128)) < 0.2
    mask[5] = False  # a fully masked row comes out 0
    if causal:
        mask &= np.tril(np.ones((128, 128), bool))
    out = block_sparse_attention_ref(*_t(*x), mask)
    _close(out, jref.block_sparse_attention_ref(*_j(*x), jnp.asarray(mask)))
    assert bool((out[:, 5] == 0).all())


def test_wrapper_on_cpu_runs_plain_version():
    q, k, v = _t(*_qkv(9, s=128))
    ell, val = (torch.from_numpy(a) for a in banded_ell(128, 64, 64, 64))
    kw = dict(block_q=64, block_kv=64, causal=True, window=64)
    before = bsattn_kernel.launches
    out = bsattn_kernel(ell, val, q, k, v, **kw)
    assert bsattn_kernel.launches == before  # counts only card launches
    torch.testing.assert_close(out, bsattn_ref(ell, val, q, k, v,
                                               scale=0.125, **kw))
    with pytest.raises(AssertionError):
        bsattn_kernel(ell, val, q, k, v, block_q=48, block_kv=64)
    with pytest.raises(AssertionError):
        bsattn_kernel(ell[:1], val[:1], q, k, v, block_q=64, block_kv=64)
