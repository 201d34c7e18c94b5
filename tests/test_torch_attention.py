"""Port parity: the LM attention library (``repro_torch.core.attention``)
against ``repro.core.attention`` on the same numpy inputs.

Every case of ``tests/test_attention.py`` but the cost-mode one, whose
counterpart here is ``flash_attention(skip_masked_blocks=True)``: each
feeds the same inputs (numpy, from a seed) to the JAX function and to the
port's, f32, at the reference tests' tolerance (rtol = atol = 2e-5), and
the port is also held to its own dense oracle as the reference tests hold
the JAX package.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma3_4b as j_gemma
from repro.core import attention as jatt
from repro_torch.configs import gemma3_4b
from repro_torch.core import attention as att

TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(seed, b=2, s=256, hq=8, hkv=2, d=32):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d)))


def _t(*xs):
    return tuple(torch.from_numpy(x) for x in xs)


def _j(*xs):
    return tuple(jnp.asarray(x) for x in xs)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, 64])
def test_mha_reference_parity(causal, window):
    x = _qkv(0)
    _close(att.mha_reference(*_t(*x), causal=causal, window=window),
           jatt.mha_reference(*_j(*x), causal=causal, window=window))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("chunk", [64, 128])
def test_flash_matches_reference(causal, chunk):
    x = _qkv(1)
    out = att.flash_attention(*_t(*x), causal=causal, q_chunk=chunk,
                              kv_chunk=chunk)
    _close(out, jatt.flash_attention(*_j(*x), causal=causal, q_chunk=chunk,
                                     kv_chunk=chunk))
    _close(out, att.mha_reference(*_t(*x), causal=causal))


@pytest.mark.parametrize("chunk", [64, 128])
def test_flash_skip_masked_blocks(chunk):
    """Skipping the kv chunks above the diagonal changes no value (the
    counterpart of the reference's cost-mode causal skip)."""
    x = _qkv(2)
    kw = dict(causal=True, q_chunk=chunk, kv_chunk=chunk)
    out = att.flash_attention(*_t(*x), skip_masked_blocks=True, **kw)
    _close(out, jatt.flash_attention(*_j(*x), skip_masked_blocks=True, **kw))
    _close(out, att.flash_attention(*_t(*x), **kw))
    _close(out, att.mha_reference(*_t(*x), causal=True))


def test_flash_unequal_chunks():
    x = _qkv(3)
    kw = dict(causal=True, q_chunk=128, kv_chunk=64, skip_masked_blocks=True)
    _close(att.flash_attention(*_t(*x), **kw),
           jatt.flash_attention(*_j(*x), **kw))


@pytest.mark.parametrize("window,block", [(64, 32), (128, 64), (64, 64)])
def test_local_block_attention(window, block):
    x = _qkv(4)
    out = att.local_block_attention(*_t(*x), window=window, block=block)
    _close(out, jatt.local_block_attention(*_j(*x), window=window,
                                           block=block))
    _close(out, att.mha_reference(*_t(*x), causal=True, window=window))


def test_decode_matches_last_position():
    q, k, v = _qkv(5)
    s = q.shape[1]
    dec = att.decode_attention(*_t(q[:, -1:], k, v), length=s)
    _close(dec, jatt.decode_attention(*_j(q[:, -1:], k, v), length=s))
    _close(dec[:, 0], att.mha_reference(*_t(q, k, v), causal=True)[:, -1])


def test_decode_window():
    q, k, v = _qkv(6)
    s = q.shape[1]
    dec = att.decode_attention(*_t(q[:, -1:], k, v), length=s, window=64)
    _close(dec, jatt.decode_attention(*_j(q[:, -1:], k, v), length=s,
                                      window=64))
    _close(dec[:, 0], att.mha_reference(*_t(q, k, v), causal=True,
                                        window=64)[:, -1])


def test_decode_per_row_length():
    q, k, v = _qkv(7)
    length = np.array([100, 256])
    dec = att.decode_attention(*_t(q[:, -1:], k, v),
                               length=torch.from_numpy(length), window=32)
    _close(dec, jatt.decode_attention(*_j(q[:, -1:], k, v),
                                      length=jnp.asarray(length), window=32))


@pytest.mark.parametrize("n_shards", [2, 4])
def test_flash_decode_partial_merge(n_shards):
    """Sequence-parallel decode: per-shard partials merge exactly."""
    q, k, v = _qkv(8)
    b, s = q.shape[0], q.shape[1]
    full = att.decode_attention(*_t(q[:, -1:], k, v), length=s)
    per = s // n_shards
    parts, jparts = [], []
    for i in range(n_shards):
        sl = slice(i * per, (i + 1) * per)
        mask = np.ones((b, per), bool)
        parts.append(att.decode_attention_partial(
            *_t(q[:, -1:], k[:, sl], v[:, sl], mask)))
        jparts.append(jatt.decode_attention_partial(
            *_j(q[:, -1:], k[:, sl], v[:, sl], mask)))
    for got, want in zip(parts[0], jparts[0]):
        _close(got, want)
    acc, jacc = parts[0], jparts[0]
    for p, jp in zip(parts[1:], jparts[1:]):
        acc, jacc = att.merge_partials(acc, p), jatt.merge_partials(jacc, jp)
    for got, want in zip(acc, jacc):
        _close(got, want)
    n, l, _ = acc
    _close((n / l[..., None]).reshape(full.shape), full)


def test_merge_partials_associative():
    """Merge is associative (required for tree folding), and matches the
    JAX package's merge of the same partials."""
    q, k, v = _qkv(9, s=96)
    b = q.shape[0]
    ps, jps = [], []
    for i in range(3):
        sl = slice(i * 32, (i + 1) * 32)
        mask = np.ones((b, 32), bool)
        ps.append(att.decode_attention_partial(
            *_t(q[:, -1:], k[:, sl], v[:, sl], mask)))
        jps.append(jatt.decode_attention_partial(
            *_j(q[:, -1:], k[:, sl], v[:, sl], mask)))
    left = att.merge_partials(att.merge_partials(ps[0], ps[1]), ps[2])
    right = att.merge_partials(ps[0], att.merge_partials(ps[1], ps[2]))
    jleft = jatt.merge_partials(jatt.merge_partials(jps[0], jps[1]), jps[2])
    for a, bb, ja in zip(left, right, jleft):
        _close(a, bb, dict(rtol=1e-5, atol=1e-5))
        _close(a, ja)


def test_bf16_keeps_dtype():
    x = _qkv(10, s=128)
    qb, kb, vb = (t.to(torch.bfloat16) for t in _t(*x))
    out = att.local_block_attention(qb, kb, vb, window=64, block=64)
    assert out.dtype == torch.bfloat16
    want = jatt.local_block_attention(
        *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
          for t in (qb, kb, vb)), window=64, block=64)
    _close(out.float(), np.asarray(want, np.float32),
           dict(rtol=1e-2, atol=1e-2))


@pytest.mark.parametrize("name", ["CONFIG", "SMOKE_CONFIG"])
def test_gemma3_config_matches_reference(name):
    # the port carries the reference's fields that it reads, and no other
    port, ref = getattr(gemma3_4b, name), getattr(j_gemma, name)
    fields = [f.name for f in dataclasses.fields(port)]
    assert {f: getattr(ref, f) for f in fields} == dataclasses.asdict(port)
    assert {"n_heads", "n_kv_heads", "head_dim", "window",
            "attn_block"} <= set(fields)


def test_model_config_head_dim_default():
    from repro.configs.base import ModelConfig as JModelConfig
    from repro_torch.configs.base import ModelConfig
    kw = dict(name="x", family="dense", n_layers=2, d_model=96, n_heads=3,
              n_kv_heads=1, d_ff=8, vocab_size=16)
    assert ModelConfig(**kw).head_dim == JModelConfig(**kw).head_dim == 32
    with pytest.raises(AssertionError):
        ModelConfig(**dict(kw, n_layers=1, layer_pattern=("a", "b")))
