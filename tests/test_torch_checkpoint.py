"""Port parity: ``repro_torch.ft.checkpoint`` against
``repro.ft.checkpoint``.

``tests/test_checkpoint_fuzz.py``'s six cases and the checkpoint cases of
``tests/test_fault_tolerance.py`` run on the port.  The two packages share
one on-disk layout, byte for byte: a checkpoint written by either restores
in the other bit for bit (f32, f16, int32 and bool leaves, and a whole
train state), and a bf16 leaf is the same file from both.  The reference
cannot restore a bf16 leaf, not even its own (``np.load`` gives raw
``'<V2'`` bytes that ``jnp.asarray(..., dtype=bfloat16)`` cannot cast);
the port reads the bits back through ``uint16`` views.
"""
import dataclasses
import filecmp
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.configs import get_smoke_config as j_smoke
from repro.ft.checkpoint import Checkpointer as JCheckpointer
from repro.models.transformer import init_lm as j_init_lm
from repro.train import loop as JL
from repro_torch import obs
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import DataConfig, lm_data_iter
from repro_torch.ft.checkpoint import Checkpointer
from repro_torch.models import transformer as T
from repro_torch.resilience import FaultPlan, FaultSpec, chaos
from repro_torch.train import loop as L
from repro_torch.train.optimizer import OptConfig

_dtypes = st.sampled_from([torch.float32, torch.int32, torch.float16,
                           torch.bool])


@st.composite
def leaf(draw):
    shape = tuple(draw(st.lists(st.integers(1, 5), min_size=0, max_size=3)))
    dt = draw(_dtypes)
    seed = draw(st.integers(0, 2**31 - 1))
    rng = np.random.default_rng(seed)
    if dt == torch.bool:
        return torch.from_numpy(np.asarray(rng.random(shape) < 0.5))
    if dt.is_floating_point:
        return torch.from_numpy(np.asarray(rng.normal(size=shape))).to(dt)
    return torch.from_numpy(np.asarray(rng.integers(-5, 5, shape))).to(dt)


@st.composite
def tree(draw, depth=2):
    if depth == 0:
        return draw(leaf())
    keys = draw(st.lists(
        st.text(alphabet="abcdefg_", min_size=1, max_size=6),
        min_size=1, max_size=3, unique=True))
    return {k: draw(tree(depth=depth - 1)) for k in keys}


def _same(a, b):
    la, lb = T.tree_leaves(a), T.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(la, lb))


@settings(max_examples=15, deadline=None)
@given(t=tree())
def test_checkpoint_roundtrip_arbitrary_tree(tmp_path_factory, t):
    d = tmp_path_factory.mktemp("ck")
    ck = Checkpointer(str(d), async_save=False)
    ck.save(1, t)
    assert _same(ck.restore(t), t)


# ---------------------------------------------------------------------------
# crash-mid-write + corrupt-directory fuzzing
# ---------------------------------------------------------------------------

_TREE = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
         "nested": {"b": torch.ones(5)}}


@pytest.fixture(autouse=True)
def _clean():
    obs.reset()
    chaos.uninstall()
    yield
    obs.reset()
    chaos.uninstall()


def _step_dir(ck, step):
    return os.path.join(ck.directory, f"step_{step:08d}")


def _corrupt(ck, step, how):
    d = _step_dir(ck, step)
    if how == "truncated_metadata":
        with open(os.path.join(d, "metadata.json"), "w") as f:
            f.write('{"step":')  # cut mid-object
    elif how == "partial_npy":
        name = next(n for n in os.listdir(d) if n.endswith(".npy"))
        with open(os.path.join(d, name), "wb") as f:
            f.write(b"\x93NUMPY")  # header cut short
    elif how == "missing_leaf":
        name = next(n for n in os.listdir(d) if n.endswith(".npy"))
        os.remove(os.path.join(d, name))
    elif how == "shape_drift":
        name = next(n for n in os.listdir(d) if n.endswith(".npy"))
        np.save(os.path.join(d, name), np.zeros((2, 2), np.float32))
    else:
        raise AssertionError(how)


def _counter(name):
    return sum(obs.snapshot()["metrics"]["counters"].get(name, {}).values())


def test_crash_mid_write_keeps_previous_step(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(1, _TREE)
    plan = FaultPlan([FaultSpec(site="checkpoint.write", kind="raise",
                                at=1, times=1)])
    with chaos.active(plan):
        with pytest.raises(RuntimeError):
            ck.save(2, _TREE)
    assert ck.all_steps() == [1]
    assert torch.equal(ck.restore(_TREE)["w"], _TREE["w"])
    assert not [n for n in os.listdir(str(tmp_path))
                if n.startswith(".tmp_")]


def test_async_crash_mid_write_is_recorded_not_silent(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=True)
    ck.save(1, _TREE)
    ck.wait()
    plan = FaultPlan([FaultSpec(site="checkpoint.write", kind="raise",
                                at=1, times=1)])
    with chaos.active(plan):
        ck.save(2, _TREE)
        ck.wait()
    assert ck.failed_saves == 1
    assert ck.last_error is not None
    assert ck.all_steps() == [1]
    assert _counter("resilience_ckpt_save_failures_total") == 1


@pytest.mark.parametrize("how", ["truncated_metadata", "partial_npy",
                                 "missing_leaf", "shape_drift"])
def test_restore_skips_corrupt_newest_step(tmp_path, how):
    ck = Checkpointer(str(tmp_path), keep=3, async_save=False)
    tree1 = {"w": torch.full((3, 4), 1.0), "nested": {"b": torch.ones(5)}}
    tree2 = {"w": torch.full((3, 4), 2.0), "nested": {"b": torch.ones(5)}}
    ck.save(1, tree1)
    ck.save(2, tree2)
    _corrupt(ck, 2, how)
    out = ck.restore(_TREE)  # newest (2) is corrupt: falls back to 1
    assert torch.equal(out["w"], torch.full((3, 4), 1.0))
    if how != "truncated_metadata":  # all_steps still lists step 2
        assert _counter("resilience_ckpt_corrupt_total") == 1
    with pytest.raises(Exception):
        ck.restore(_TREE, step=2)


def test_restore_all_corrupt_raises_structured(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(1, _TREE)
    ck.save(2, _TREE)
    _corrupt(ck, 1, "partial_npy")
    _corrupt(ck, 2, "truncated_metadata")
    with pytest.raises(FileNotFoundError, match="no intact checkpoint"):
        ck.restore(_TREE)


@settings(max_examples=10, deadline=None)
@given(plan=st.lists(
    st.tuples(st.integers(1, 4),
              st.sampled_from(["truncated_metadata", "partial_npy",
                               "missing_leaf", "shape_drift"])),
    min_size=0, max_size=3, unique_by=lambda t: t[0]))
def test_restore_fuzz_falls_back_to_newest_intact(tmp_path_factory, plan):
    d = tmp_path_factory.mktemp("ckfuzz")
    ck = Checkpointer(str(d), keep=4, async_save=False)
    for s in (1, 2, 3, 4):
        ck.save(s, {"w": torch.full((3, 4), float(s)),
                    "nested": {"b": torch.ones(5)}})
    corrupted = {s for s, _ in plan}
    for s, how in plan:
        _corrupt(ck, s, how)
    intact = [s for s in (1, 2, 3, 4) if s not in corrupted]
    if not intact:
        with pytest.raises(FileNotFoundError):
            ck.restore(_TREE)
        return
    out = ck.restore(_TREE)
    assert torch.equal(out["w"], torch.full((3, 4), float(max(intact))))


# ---------------------------------------------------------------------------
# tests/test_fault_tolerance.py's checkpoint cases
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip_and_gc(tmp_path, rng):
    ck = Checkpointer(str(tmp_path), keep=2, async_save=False)
    tree_ = {"a": torch.from_numpy(rng.normal(size=(4, 4)).astype(
        np.float32)), "nested": {"b": torch.arange(5)}}
    for s in (1, 2, 3):
        ck.save(s, tree_, meta={"tag": "x"})
    assert ck.all_steps() == [2, 3]  # keep=2 garbage-collects step 1
    assert _same(ck.restore(tree_), tree_)
    assert ck.metadata()["tag"] == "x"


def test_checkpoint_atomicity_on_partial_write(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    tree_ = {"a": torch.zeros(2)}
    ck.save(1, tree_)
    os.makedirs(os.path.join(str(tmp_path), ".tmp_crashed"), exist_ok=True)
    open(os.path.join(str(tmp_path), ".tmp_crashed", "a.npy"), "wb").close()
    assert ck.all_steps() == [1]
    ck.restore(tree_)  # still restores cleanly


def test_failure_restart_resumes_identically(tmp_path):
    """Train 6 steps; 'crash' after the checkpoint at 3; restore and replay
    give the same params, bit for bit."""
    cfg = dataclasses.replace(get_smoke_config("nemotron-4-15b"),
                              dtype="float32")
    tcfg = L.TrainConfig(opt=OptConfig(lr=5e-3, warmup_steps=0,
                                       total_steps=100))
    step = L.make_train_step(cfg, tcfg)
    make_it = lambda start: lm_data_iter(  # noqa: E731
        cfg, ShapeConfig("t", 32, 4, "train"), DataConfig(seed=9),
        start_step=start, device="cpu")

    def fresh():
        p = T.init_lm(cfg, seed=0, device="cpu")
        return p, L.init_train_state(p, tcfg)

    ck = Checkpointer(str(tmp_path), async_save=False)
    it = make_it(0)
    p, s = fresh()
    for i in range(6):
        p, s, _ = step(p, s, next(it))
        if i == 2:
            ck.save(3, {"params": p, "state": s})
    target = dict(zip(("params", "state"), fresh()))
    restored = ck.restore(target)
    p2, s2 = restored["params"], restored["state"]
    it2 = make_it(3)
    for _ in range(3):
        p2, s2, _ = step(p2, s2, next(it2))
    assert _same(p, p2) and _same(s, s2)


def test_async_save_snapshots_before_the_next_step(tmp_path):
    """The leaves go to the host before ``save`` returns: an in-place
    update right after an async save does not reach the files."""
    ck = Checkpointer(str(tmp_path), async_save=True)
    t = {"w": torch.zeros(64, 64)}
    ck.save(1, t)
    t["w"].add_(1.0)
    ck.wait()
    assert torch.equal(ck.restore(t)["w"], torch.zeros(64, 64))


# ---------------------------------------------------------------------------
# The two packages' checkpoints cross, bit for bit
# ---------------------------------------------------------------------------


def _mixed(rng):
    a = rng.normal(size=(3, 5)).astype(np.float32)
    return {"f32": a, "bf16": a * 3, "f16": (a * 2).astype(np.float16),
            "i32": rng.integers(-9, 9, (4,)).astype(np.int32),
            "b": rng.random((2, 2)) < 0.5,
            "n": ({"s": np.asarray(7, np.int32)},
                  rng.normal(size=(2,)).astype(np.float32))}


def _jax_tree(m):
    t = jax.tree_util.tree_map(jnp.asarray, m)
    if "bf16" in t:
        t["bf16"] = t["bf16"].astype(jnp.bfloat16)
    return t


def _torch_tree(m):
    t = T.tree_map(lambda a: torch.from_numpy(np.array(a)), m)
    if "bf16" in t:
        t["bf16"] = t["bf16"].to(torch.bfloat16)
    return t


def test_files_are_the_same_bytes(tmp_path, rng):
    """The same tree saved by each package gives the same files."""
    m = _mixed(rng)
    JCheckpointer(str(tmp_path / "j"), async_save=False).save(
        5, _jax_tree(m), meta={"mesh": "1"})
    Checkpointer(str(tmp_path / "t"), async_save=False).save(
        5, _torch_tree(m), meta={"mesh": "1"})
    dj, dt = tmp_path / "j" / "step_00000005", tmp_path / "t" / \
        "step_00000005"
    names = sorted(os.listdir(dj))
    assert names == sorted(os.listdir(dt))
    assert "d:bf16.npy" in names and "d:n__s:0__d:s.npy" in names
    for n in names:
        assert filecmp.cmp(dj / n, dt / n, shallow=False), n
    assert json.load(open(dt / "metadata.json")) == {"step": 5, "mesh": "1"}


def test_reference_checkpoint_restores_in_the_port(tmp_path, rng):
    m = _mixed(rng)
    jt = _jax_tree(m)
    JCheckpointer(str(tmp_path), async_save=False).save(2, jt)
    target = T.tree_map(torch.zeros_like, _torch_tree(m))
    out = Checkpointer(str(tmp_path)).restore(target)
    want = _torch_tree(m)
    assert _same(out, want)
    assert out["bf16"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        out["bf16"].view(torch.int16).numpy(),
        np.asarray(jt["bf16"]).view(np.int16))


def test_port_checkpoint_restores_in_the_reference(tmp_path, rng):
    m = _mixed(rng)
    m.pop("bf16")  # the reference cannot restore it (below)
    t = _torch_tree(m)
    Checkpointer(str(tmp_path), async_save=False).save(2, t)
    jtarget = jax.tree_util.tree_map(jnp.zeros_like, _jax_tree(m))
    out = JCheckpointer(str(tmp_path)).restore(jtarget)
    for g, w in zip(jax.tree_util.tree_leaves(out), T.tree_leaves(t)):
        assert np.asarray(g).dtype == w.numpy().dtype
        np.testing.assert_array_equal(np.asarray(g), w.numpy())


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_reference_cannot_restore_bf16(tmp_path, writer):
    """A fault of the reference: its restore of a bf16 leaf fails, on a
    file written by either package (the files are the same bytes)."""
    a = np.arange(6, dtype=np.float32).reshape(2, 3) * 1.5
    jt = {"a": jnp.asarray(a).astype(jnp.bfloat16)}
    if writer == "reference":
        JCheckpointer(str(tmp_path), async_save=False).save(1, jt)
    else:
        Checkpointer(str(tmp_path), async_save=False).save(
            1, {"a": torch.from_numpy(a).to(torch.bfloat16)})
    with pytest.raises(FileNotFoundError, match="No cast function"):
        JCheckpointer(str(tmp_path)).restore(jt)
    out = Checkpointer(str(tmp_path)).restore(
        {"a": torch.zeros(2, 3, dtype=torch.bfloat16)})
    assert torch.equal(out["a"], torch.from_numpy(a).to(torch.bfloat16))


def _reference_train_state():
    jcfg = dataclasses.replace(j_smoke("granite-20b"), dtype="float32")
    params = j_init_lm(jax.random.PRNGKey(0), jcfg)
    tcfg = JL.TrainConfig(compression="topk_ef")
    state = JL.init_train_state(params, tcfg)
    # moments and step not all zero: one plain AdamW step's worth
    state["opt"]["m"] = jax.tree_util.tree_map(lambda x: x * 0.5 + 0.25,
                                               params)
    state["opt"]["step"] = jnp.asarray(3, jnp.int32)
    return {"params": params, "state": state}


def test_train_state_crosses_both_ways(tmp_path):
    """A whole train state (params, AdamW moments, step, top-k residual)
    from each package restores in the other, bit for bit."""
    jtree = _reference_train_state()
    np_tree = jax.tree_util.tree_map(np.asarray, jtree)
    ttree = {"params": T.lm_params_from_numpy(np_tree["params"],
                                              device="cpu"),
             "state": L.train_state_from_numpy(np_tree["state"],
                                               device="cpu")}
    JCheckpointer(str(tmp_path / "j"), async_save=False).save(1, jtree)
    target = T.tree_map(torch.zeros_like, ttree)
    got = Checkpointer(str(tmp_path / "j")).restore(target)
    assert _same(got, ttree)
    assert got["state"]["opt"]["step"].dtype == torch.int32
    assert got["state"]["opt"]["step"].shape == ()

    Checkpointer(str(tmp_path / "t"), async_save=False).save(1, ttree)
    jtarget = jax.tree_util.tree_map(jnp.zeros_like, jtree)
    back = JCheckpointer(str(tmp_path / "t")).restore(jtarget)
    for g, w in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(np_tree)):
        np.testing.assert_array_equal(np.asarray(g), w)
        assert np.asarray(g).dtype == w.dtype
