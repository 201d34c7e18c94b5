"""Port parity: the LM building blocks (``repro_torch.models.layers``)
against ``repro.models.layers`` on the same numpy inputs and weights.

Every function of the module: the norms, the activations (GELU is
``jax.nn.gelu``'s tanh form), RoPE, the sinusoid table, the MLP (dense
and with a pruned ``SparseMatrix`` weight), the attention projections
with and without QKV bias, ``self_attention`` on each of its three
routes (the banded local gather, the flash loop at S = 2080 with
``attn_block`` 32, the plain masked softmax), ``cross_attention``
chunked and whole, ``encode_cross_kv``, and cached decode on a local
layer's ring cache past its wrap and on a global layer, the cache
compared leaf by leaf after every step.  The port's inits give the
reference's tree and shapes.  f32 throughout; tolerance rtol = atol =
2e-5 (the reference attention tests' own: the same f32 sums in another
order), 1e-6 for the elementwise functions.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import layers as JL
from repro.sparse.matrix import SparseMatrix as JSparse
from repro_torch.configs import get_smoke_config
from repro_torch.models import layers as L
from repro_torch.sparse.matrix import SparseMatrix

TOL = dict(rtol=2e-5, atol=2e-5)
ELEM_TOL = dict(rtol=1e-6, atol=1e-6)


def _cfgs(arch, **kw):
    kw.setdefault("dtype", "float32")
    return (dataclasses.replace(j_smoke(arch), **kw),
            dataclasses.replace(get_smoke_config(arch), **kw))


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


def _both(tree):
    """A numpy tree as (JAX tree, torch tree)."""
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            jax.tree_util.tree_map(torch.from_numpy, tree))


def _attn_params(rng, cfg, bias=False):
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": rng.normal(size=(d, hq * hd)) / np.sqrt(d),
         "wk": rng.normal(size=(d, hkv * hd)) / np.sqrt(d),
         "wv": rng.normal(size=(d, hkv * hd)) / np.sqrt(d),
         "wo": rng.normal(size=(hq * hd, d)) / np.sqrt(hq * hd)}
    if bias:
        p.update(bq=rng.normal(size=hq * hd) * 0.1,
                 bk=rng.normal(size=hkv * hd) * 0.1,
                 bv=rng.normal(size=hkv * hd) * 0.1)
    return {k: v.astype(np.float32) for k, v in p.items()}


def _shapes(tree):
    return jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), tree)


# -- norms, activations, positions ------------------------------------------


def test_norms():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 48)).astype(np.float32) * 3
    w, b = (rng.normal(size=48).astype(np.float32) for _ in range(2))
    _close(L.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6), ELEM_TOL)
    _close(L.layer_norm(*map(torch.from_numpy, (x, w, b))),
           JL.layer_norm(*map(jnp.asarray, (x, w, b))), ELEM_TOL)


@pytest.mark.parametrize("kind", ["silu", "gelu", "relu2"])
def test_activation(kind):
    x = np.random.default_rng(1).normal(size=(4, 64)).astype(np.float32) * 4
    _close(L.activation(torch.from_numpy(x), kind),
           JL.activation(jnp.asarray(x), kind), ELEM_TOL)
    with pytest.raises(ValueError):
        L.activation(torch.from_numpy(x), "tanh")


@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_rope(theta):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 9, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 9)).astype(np.int32)
    _close(L.rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           JL.rope(jnp.asarray(x), jnp.asarray(pos), theta), TOL)


def test_sinusoid_positions():
    assert np.array_equal(L.sinusoid_positions(37, 24).numpy(),
                          np.asarray(JL.sinusoid_positions(37, 24)))


# -- MLP ---------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["gemma3-4b", "nemotron-4-15b"])
def test_mlp(arch):
    """Gated GELU (gemma3) and plain squared ReLU (nemotron); the port's
    init_mlp gives the reference's keys and shapes."""
    jcfg, cfg = _cfgs(arch)
    gen = torch.Generator().manual_seed(0)
    pinit = L.init_mlp(gen, cfg)
    jinit = JL.init_mlp(jax.random.PRNGKey(0), jcfg)
    assert _shapes(pinit) == _shapes(jinit)
    rng = np.random.default_rng(3)
    p = jax.tree_util.tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32) / 8, jinit)
    x = rng.normal(size=(2, 7, cfg.d_model)).astype(np.float32)
    jp, tp = _both(p)
    _close(L.mlp(tp, torch.from_numpy(x), cfg),
           JL.mlp(jp, jnp.asarray(x), jcfg))


def test_wmat_sparse_weight():
    """x @ W with W a pruned ``SparseMatrix`` (the port's CPU path of the
    ell plan, N1's plain version) against the reference's."""
    rng = np.random.default_rng(4)
    w = rng.normal(size=(64, 96)).astype(np.float32)
    w[:, 32:64] = 0.0
    w[:8] = 0.0
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    got = L._wmat(torch.from_numpy(x),
                  SparseMatrix.from_dense(w, block=(8, 8), device="cpu"))
    want = JL._wmat(jnp.asarray(x), JSparse.from_dense(w, block=(8, 8)))
    assert tuple(got.shape) == want.shape == (3, 5, 96)
    _close(got, want)
    _close(got, x @ w, TOL)


# -- attention ---------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen1.5-110b", "gemma3-4b"])
def test_init_attn_and_qkv(arch):
    jcfg, cfg = _cfgs(arch)
    gen = torch.Generator().manual_seed(0)
    assert _shapes(L.init_attn(gen, cfg)) \
        == _shapes(JL.init_attn(jax.random.PRNGKey(0), jcfg))
    assert _shapes(L.init_attn(gen, cfg, cross=True)) \
        == _shapes(JL.init_attn(jax.random.PRNGKey(0), jcfg, cross=True))
    rng = np.random.default_rng(5)
    jp, tp = _both(_attn_params(rng, cfg, bias=cfg.qkv_bias))
    x = rng.normal(size=(2, 6, cfg.d_model)).astype(np.float32)
    kv = rng.normal(size=(2, 11, cfg.d_model)).astype(np.float32)
    for got, want in zip(L._qkv(tp, torch.from_numpy(x),
                                torch.from_numpy(kv), cfg),
                         JL._qkv(jp, jnp.asarray(x), jnp.asarray(kv), jcfg)):
        _close(got, want)


# (kind, S, config changes): the route self_attention takes
ROUTES = {
    "local_block": ("local", 128, dict(window=32, attn_block=32)),
    "flash": ("attn", 2080, dict(attn_block=32, d_model=32, n_heads=2,
                                 n_kv_heads=1, head_dim=16)),
    "mha_local": ("local", 48, dict(window=32, attn_block=32)),
    "mha_global": ("attn", 48, {}),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_self_attention_routes(route, monkeypatch):
    kind, s, kw = ROUTES[route]
    jcfg, cfg = _cfgs("gemma3-4b", **kw)
    taken = []
    for name in ("local_block_attention", "flash_attention", "mha_reference"):
        fn = getattr(L.attn_lib, name)
        monkeypatch.setattr(L.attn_lib, name,
                            lambda *a, _f=fn, _n=name, **k:
                            (taken.append(_n), _f(*a, **k))[1])
    want_route = {"local_block": "local_block_attention",
                  "flash": "flash_attention"}.get(route, "mha_reference")
    rng = np.random.default_rng(6)
    jp, tp = _both(_attn_params(rng, cfg))
    x = rng.normal(size=(1, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s), (1, s)).astype(np.int32)
    got = L.self_attention(tp, torch.from_numpy(x), cfg, kind=kind,
                           positions=torch.from_numpy(pos))
    assert taken == [want_route]
    want = JL.self_attention(jp, jnp.asarray(x), jcfg, kind=kind,
                             positions=jnp.asarray(pos))
    _close(got, want)


@pytest.mark.parametrize("s", [32, 96])
def test_cross_attention(s):
    """Whisper's cross attention, whole (S = attn_block) and chunked
    over three decoder blocks of 32, with its encoded k / v."""
    jcfg, cfg = _cfgs("whisper-small", attn_block=32)
    rng = np.random.default_rng(7)
    jp, tp = _both(_attn_params(rng, cfg))
    x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    enc = rng.normal(size=(2, 40, cfg.d_model)).astype(np.float32)
    tkv = L.encode_cross_kv(tp, torch.from_numpy(enc), cfg)
    jkv = JL.encode_cross_kv(jp, jnp.asarray(enc), jcfg)
    for got, want in zip(tkv, jkv):
        _close(got, want)
    _close(L.cross_attention(tp, torch.from_numpy(x), tkv, cfg),
           JL.cross_attention(jp, jnp.asarray(x), jkv, jcfg))


@pytest.mark.parametrize("kind", ["local", "attn"])
def test_decode_self_attention_cache(kind):
    """20 decode steps from an empty cache: a local layer's ring of 8
    slots wraps twice (kpos -1 in empty slots until then); a global
    layer's cache of 24 fills.  Output and every cache leaf after each
    step."""
    jcfg, cfg = _cfgs("gemma3-4b", window=8)
    rng = np.random.default_rng(8)
    jp, tp = _both(_attn_params(rng, cfg))
    tc = L.init_attn_cache(cfg, 2, 24, kind, torch.float32, "cpu")
    jc = JL.init_attn_cache(jcfg, 2, 24, kind, jnp.float32)
    assert _shapes(tc) == _shapes(jc)
    for pos in range(20):
        x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        got, tc = L.decode_self_attention(tp, torch.from_numpy(x), tc, cfg,
                                          kind=kind, pos=pos)
        want, jc = JL.decode_self_attention(jp, jnp.asarray(x), jc, jcfg,
                                            kind=kind,
                                            pos=jnp.asarray(pos, jnp.int32))
        _close(got, want)
        for key in ("k", "v"):
            _close(tc[key], jc[key])
        assert np.array_equal(tc["kpos"].numpy(), np.asarray(jc["kpos"]))
    if kind == "local":
        assert (tc["kpos"] >= 12).all()  # the ring holds the last 8
