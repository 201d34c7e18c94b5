"""Port parity: the LM training step (``repro_torch.train.{optimizer,
grad_compress,loop}``) against ``repro.train``.

``tests/test_train.py``'s eight cases run on the port; the optimizer, the
schedule, the clip and both compressions are held to the reference's
functions on the same numpy inputs (rtol 1e-6: f32 elementwise terms in
the same order, XLA's and PyTorch's CPU kernels rounding alike but for
fused multiply-adds and the transcendental's last bit); one train step on
granite-20b's and gemma3-4b's ``SMOKE_CONFIG`` in f32 is held to the
reference's jitted step (loss rtol 1e-5, gradients 1e-4 x max|want| before
AdamW: the same f32 sums in another order; params 3e-3 after it, the
reference's own bound in ``tests/test_distributed.py``, as the first Adam
step moves every weight by about ±lr and a near-zero gradient's sign can
flip).  ``tests/test_resilience.py``'s two ``train_loop`` crash cases,
microbatches 2 and 4 and both compressions in a step are in
``tests/test_torch_lm_train_b.py``, which shares this file's reference
steps (each file runs on one worker).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.configs import get_smoke_config as j_smoke
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import make_lm_batch as j_make_lm_batch
from repro.models.transformer import init_lm as j_init_lm
from repro.models.transformer import lm_loss as j_lm_loss
from repro.train import grad_compress as JG
from repro.train import loop as JL
from repro.train import optimizer as JO
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import DataConfig, lm_data_iter, make_lm_batch
from repro_torch.models import transformer as T
from repro_torch.train import loop as L
from repro_torch.train import optimizer as O
from repro_torch.train.grad_compress import (compress_int8, compress_topk_ef,
                                             init_residual, int8_roundtrip)
from repro_torch.train.loop import (TrainConfig, init_train_state,
                                    make_train_step)
from repro_torch.train.optimizer import (OptConfig, adamw_update,
                                         clip_by_global_norm, global_norm,
                                         init_opt_state, schedule)

ELEM = dict(rtol=1e-6, atol=1e-7)
PARAM_ATOL = 3e-3
CPU = "cpu"


def tt(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol=ELEM, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), err_msg=what,
                               **tol)


# ---------------------------------------------------------------------------
# tests/test_train.py's cases, on the port
# ---------------------------------------------------------------------------


def test_schedule_warmup_and_decay():
    cfg = OptConfig(lr=1.0, warmup_steps=10, total_steps=100,
                    min_lr_frac=0.1)
    s = lambda t: float(schedule(torch.tensor(t), cfg))  # noqa: E731
    assert s(0) == 0.0
    assert abs(s(10) - 1.0) < 1e-6
    assert s(50) < 1.0
    assert abs(s(100) - 0.1) < 1e-6
    assert s(100) <= s(60) <= s(20)


def test_clip_by_global_norm():
    g = {"a": torch.full((4,), 3.0), "b": torch.full((4,), 4.0)}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert abs(float(norm) - 10.0) < 1e-5
    assert abs(float(global_norm(clipped)) - 1.0) < 1e-5


def test_adamw_moves_towards_minimum():
    params = {"w": torch.tensor([5.0, -3.0])}
    state = init_opt_state(params)
    cfg = OptConfig(lr=0.5, warmup_steps=0, total_steps=200,
                    weight_decay=0.0, clip_norm=1e9)
    for _ in range(200):
        grads = {"w": params["w"].clone()}  # d/dw (w^2/2)
        params, state, _ = adamw_update(params, grads, state, cfg)
    assert float(params["w"].abs().max()) < 0.2


def test_int8_roundtrip_error_bounded(rng):
    g = torch.from_numpy(rng.normal(size=(256,)).astype(np.float32))
    out = int8_roundtrip(g)
    scale = float(g.abs().max()) / 127.0
    assert float((out - g).abs().max()) <= scale * 0.5 + 1e-7


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), k=st.floats(0.01, 0.5))
def test_topk_error_feedback_conserves_mass(seed, k):
    """sent + residual == grad + old residual (nothing lost); the same
    entries are sent as by the reference."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(64,)).astype(np.float32)
    g = {"w": torch.from_numpy(w)}
    res = init_residual(g)
    sent, new_res = compress_topk_ef(g, res, k_frac=k)
    np.testing.assert_allclose((sent["w"] + new_res["w"]).numpy(), w,
                               rtol=1e-6, atol=1e-6)
    assert int((sent["w"] != 0).sum()) <= 64
    j_sent, _ = JG.compress_topk_ef({"w": jnp.asarray(w)},
                                    JG.init_residual({"w": jnp.asarray(w)}),
                                    k_frac=k)
    np.testing.assert_array_equal(sent["w"].numpy(), np.asarray(j_sent["w"]))


def test_loss_decreases_on_structured_stream():
    cfg = dataclasses.replace(get_smoke_config("granite-20b"),
                              dtype="float32")
    shape = ShapeConfig("tiny", 64, 8, "train")
    tcfg = TrainConfig(opt=OptConfig(lr=1e-2, warmup_steps=5,
                                     total_steps=50))
    params = T.init_lm(cfg, seed=0, device=CPU)
    state = init_train_state(params, tcfg)
    step = make_train_step(cfg, tcfg)
    it = lm_data_iter(cfg, shape, DataConfig(seed=3), device=CPU)
    losses = []
    for _ in range(30):
        params, state, m = step(params, state, next(it))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.3, losses[:3] + losses[-3:]


def test_microbatching_matches_full_batch():
    """Grad accumulation over microbatches == one big batch (linear loss)."""
    cfg = dataclasses.replace(get_smoke_config("nemotron-4-15b"),
                              dtype="float32")
    batch = make_lm_batch(cfg, 32, 8, 0, DataConfig(seed=0), device=CPU)
    t1 = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=0, total_steps=10),
                     microbatches=1)
    t2 = dataclasses.replace(t1, microbatches=4)
    outs = []
    for tcfg in (t1, t2):
        params = T.init_lm(cfg, seed=0, device=CPU)
        outs.append(make_train_step(cfg, tcfg)(
            params, init_train_state(params, tcfg), batch))
    (p1, _, m1), (p2, _, m2) = outs
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 2e-3
    assert max(float((a - b).abs().max()) for a, b in
               zip(T.tree_leaves(p1), T.tree_leaves(p2))) < 5e-3


def test_deterministic_data_pipeline():
    cfg = get_smoke_config("granite-20b")
    b1 = make_lm_batch(cfg, 32, 8, step=7, dcfg=DataConfig(seed=5),
                       device=CPU)
    b2 = make_lm_batch(cfg, 32, 8, step=7, dcfg=DataConfig(seed=5),
                       device=CPU)
    assert torch.equal(b1["tokens"], b2["tokens"])
    b3 = make_lm_batch(cfg, 32, 8, step=8, dcfg=DataConfig(seed=5),
                       device=CPU)
    assert not torch.equal(b1["tokens"], b3["tokens"])


# ---------------------------------------------------------------------------
# The optimizer and compressors against the reference's functions
# ---------------------------------------------------------------------------


def _tree(rng, scale=1.0):
    return {"a": (rng.normal(size=(5, 7)) * scale).astype(np.float32),
            "b": {"c": (rng.normal(size=(11,)) * scale).astype(np.float32),
                  "d": (rng.normal(size=(2, 3, 4)) * scale)
                  .astype(np.float32)}}


@pytest.mark.parametrize("cfg", [
    OptConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1),
    OptConfig(),
    OptConfig(lr=3e-3, warmup_steps=0, total_steps=7, min_lr_frac=0.0)],
    ids=["warmup10", "default", "no_warmup"])
def test_schedule_matches_reference(cfg):
    jcfg = JO.OptConfig(**dataclasses.asdict(cfg))
    steps = np.arange(0, 130, dtype=np.int32)
    got = schedule(torch.from_numpy(steps), cfg)
    want = JO.schedule(jnp.asarray(steps), jcfg)
    close(got, want)


@pytest.mark.parametrize("max_norm", [0.5, 1e9])
def test_clip_matches_reference(rng, max_norm):
    tree = _tree(rng, 3.0)
    got, norm = clip_by_global_norm(T.tree_map(tt, tree), max_norm)
    want, j_norm = JO.clip_by_global_norm(
        jax.tree_util.tree_map(jnp.asarray, tree), max_norm)
    close(norm, j_norm)
    for g, w in zip(T.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        close(g, w)


@pytest.mark.parametrize("clip_norm", [0.3, 1e9], ids=["clipped", "free"])
def test_adamw_update_matches_reference(rng, clip_norm):
    """Four AdamW steps (weight decay on, warm-up under way) on the same
    params and gradients: the port writes in place, the reference returns
    new trees; params, moments, lr and norm agree."""
    cfg = OptConfig(lr=1e-2, warmup_steps=3, total_steps=20,
                    weight_decay=0.1, clip_norm=clip_norm)
    jcfg = JO.OptConfig(**dataclasses.asdict(cfg))
    params = _tree(rng)
    p = T.tree_map(tt, params)
    ids = [id(x) for x in T.tree_leaves(p)]
    s = init_opt_state(p)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = JO.init_opt_state(jp)
    for _ in range(4):
        grads = _tree(rng, 2.0)
        p, s, m = adamw_update(p, T.tree_map(tt, grads), s, cfg)
        jp, js, jm = JO.adamw_update(
            jp, jax.tree_util.tree_map(jnp.asarray, grads), js, jcfg)
        close(m["lr"], jm["lr"])
        close(m["grad_norm"], jm["grad_norm"])
    assert [id(x) for x in T.tree_leaves(p)] == ids  # written in place
    assert int(s["step"]) == int(js["step"]) == 4
    assert s["step"].dtype == torch.int32
    for got, want in ((p, jp), (s["m"], js["m"]), (s["v"], js["v"])):
        for g, w in zip(T.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            close(g, w)


def test_adamw_chunks_leave_bits_unchanged(rng, monkeypatch):
    """The update in slices (``_CHUNK``) gives the bits of one slice."""
    cfg = OptConfig(lr=1e-2, warmup_steps=0, total_steps=10)
    params, grads = _tree(rng), _tree(rng, 2.0)
    outs = []
    for chunk in (1 << 26, 7):
        monkeypatch.setattr(O, "_CHUNK", chunk)
        p = T.tree_map(tt, params)
        s = init_opt_state(p)
        adamw_update(p, T.tree_map(tt, grads), s, cfg)
        outs.append(T.tree_leaves(p) + T.tree_leaves(s["m"])
                    + T.tree_leaves(s["v"]))
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_int8_matches_reference(rng):
    tree = _tree(rng, 5.0)
    got = compress_int8(T.tree_map(tt, tree))
    want = JG.compress_int8(jax.tree_util.tree_map(jnp.asarray, tree))
    for g, w in zip(T.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        close(g, w)


@pytest.mark.parametrize("k_frac", [0.05, 0.3])
def test_topk_ef_matches_reference_with_ties(rng, k_frac):
    """Integer-valued gradients tie at the threshold: every tied entry is
    sent, as the reference sends it (``torch.topk`` supplies only the
    threshold's value)."""
    tree = {"a": rng.integers(-4, 5, (9, 13)).astype(np.float32),
            "b": rng.integers(-2, 3, (40,)).astype(np.float32)}
    res = {"a": rng.normal(size=(9, 13)).astype(np.float32) * 0.1,
           "b": np.zeros((40,), np.float32)}
    sent, new_res = compress_topk_ef(T.tree_map(tt, tree),
                                     T.tree_map(tt, res), k_frac)
    j_sent, j_res = JG.compress_topk_ef(
        jax.tree_util.tree_map(jnp.asarray, tree),
        jax.tree_util.tree_map(jnp.asarray, res), k_frac)
    for got, want in ((sent, j_sent), (new_res, j_res)):
        for g, w in zip(T.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int((sent["b"] != 0).sum()) > max(1, int(40 * k_frac))  # ties


# ---------------------------------------------------------------------------
# One train step on the smoke models against the reference's jitted step
# ---------------------------------------------------------------------------

STEP_ARCHS = ("granite-20b", "gemma3-4b")
B, S = 8, 32


def _opt():
    return OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)


@functools.lru_cache(maxsize=None)
def reference_step(arch, microbatches=1, compression="none",
                   cast_params_once=False):
    """The reference's params, batch, gradients (before AdamW), loss and
    params after one jitted step, as numpy.  ``cast_params_once``: the
    loss and gradients of the bf16 compute from f32 masters, as the
    reference's step takes them (``repro/train/loop.py``)."""
    jcfg = dataclasses.replace(j_smoke(arch), dtype="float32")
    params = j_init_lm(jax.random.PRNGKey(0), jcfg)
    batch = j_make_lm_batch(jcfg, S, B, 0, JDataConfig(seed=0))
    tcfg = JL.TrainConfig(opt=JO.OptConfig(**dataclasses.asdict(_opt())),
                          microbatches=microbatches, compression=compression,
                          cast_params_once=cast_params_once)
    cdt = jnp.dtype(tcfg.compute_dtype)
    cast = (lambda p: jax.tree_util.tree_map(  # noqa: E731
        lambda x: x.astype(cdt)
        if jnp.issubdtype(x.dtype, jnp.floating) else x, p)) \
        if cast_params_once else (lambda p: p)
    loss_grad = jax.jit(jax.value_and_grad(
        lambda p, b: j_lm_loss(cast(p), jcfg, b,
                               aux_weight=tcfg.aux_weight)))
    if microbatches == 1:
        loss, grads = loss_grad(params, batch)
    else:  # the reference's scan, written out: f32 sums, then / nm
        loss, grads = 0.0, jax.tree_util.tree_map(jnp.zeros_like, params)
        for i in range(microbatches):
            mb = jax.tree_util.tree_map(
                lambda x: x.reshape((microbatches, B // microbatches)
                                    + x.shape[1:])[i], batch)
            li, gi = loss_grad(params, mb)
            loss = loss + li
            grads = jax.tree_util.tree_map(jnp.add, grads, gi)
        loss = loss / microbatches
        grads = jax.tree_util.tree_map(lambda g: g / microbatches, grads)
    state = JL.init_train_state(params, tcfg)
    new_p, new_s, m = jax.jit(JL.make_train_step(jcfg, tcfg))(
        params, state, batch)
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return {"params": np_(params), "batch": np_(batch),
            "grads": np_(grads), "loss": float(loss),
            "step_loss": float(m["loss"]), "new_params": np_(new_p),
            "new_state": np_(new_s), "grad_norm": float(m["grad_norm"])}


def _port_inputs(arch, ref):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    params = T.lm_params_from_numpy(ref["params"], device=CPU)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in
             ref["batch"].items()}
    return cfg, params, batch


def _hold_grads(got, want, what):
    for i, (g, w) in enumerate(zip(T.tree_leaves(got),
                                   jax.tree_util.tree_leaves(want))):
        tol = 1e-4 * float(np.abs(w).max())
        err = float(np.abs(g.numpy() - w).max())
        assert err <= tol, f"{what} leaf {i}: {err} > {tol}"


def _hold_params(got, want, what):
    for i, (g, w) in enumerate(zip(T.tree_leaves(got),
                                   jax.tree_util.tree_leaves(want))):
        err = float(np.abs(g.numpy() - w).max())
        assert err < PARAM_ATOL, f"{what} leaf {i}: {err}"


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_train_step_matches_reference(arch):
    ref = reference_step(arch)
    cfg, params, batch = _port_inputs(arch, ref)
    tcfg = TrainConfig(opt=_opt())
    loss, grads = L.make_grad_fn(cfg, tcfg)(params, batch)
    assert abs(float(loss) - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    _hold_grads(grads, ref["grads"], arch)
    state = init_train_state(params, tcfg)
    new_p, new_s, m = make_train_step(cfg, tcfg)(params, state, batch)
    assert abs(float(m["loss"]) - ref["step_loss"]) \
        <= 1e-5 * abs(ref["step_loss"])
    assert abs(float(m["grad_norm"]) - ref["grad_norm"]) \
        <= 1e-5 * ref["grad_norm"]
    _hold_params(new_p, ref["new_params"], arch)
    _hold_params(new_s["opt"]["m"], ref["new_state"]["opt"]["m"], arch)
    assert int(new_s["opt"]["step"]) == 1


def _count_products(cfg, tcfg, params, batch):
    """aten matrix products run by one loss + backward."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in T._DOTS:
                Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        out = L.make_grad_fn(cfg, tcfg)(params, batch)
    return out, Count.n


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_remat_dots_equals_nothing(arch):
    """``remat_policy="dots"`` saves the products' outputs (fewer products
    run: none is recomputed) and changes no bit of the loss or
    gradients."""
    ref = reference_step(arch)
    cfg, params, batch = _port_inputs(arch, ref)
    outs = {}
    for policy in ("nothing", "dots"):
        tcfg = TrainConfig(opt=_opt(), remat_policy=policy)
        outs[policy] = _count_products(cfg, tcfg, params, batch)
    (l0, g0), n0 = outs["nothing"]
    (l1, g1), n1 = outs["dots"]
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in
               zip(T.tree_leaves(g0), T.tree_leaves(g1)))
    assert n1 < n0, (n1, n0)
