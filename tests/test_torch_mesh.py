"""Port parity: the mesh (``repro_torch.sharding``, ``ft/resharding``,
``core/distributed``, ``core/topology``, ``train/pipeline`` and the MoE's
expert-parallel branch) against the reference.

* Specs, with no process group: ``param_spec`` / ``cache_spec`` for every
  leaf of every ``SMOKE_CONFIG`` and of gemma3-4b's ``CONFIG`` (params, the
  AdamW state's moments, caches) on fake meshes of several shapes, the
  reference's spec entry for entry; ``logical_to_spec`` / ``shard_hint``;
  ``core.topology`` on the same arrays.
* A mesh of size 1 in this process (``make_mesh(..., device="cpu")``
  starts a one-rank gloo group, torn down after):
  ``tests/test_fault_tolerance.py``'s reshard case; with no ``device``
  the mesh is the card's, which raises here.
* Gloo runs on the CPU (``tests/test_torch_mesh_ranks.py``: 4 and 8
  ranks on a ``FileStore``): ``spmm_1p5d`` / ``spmm_2d`` on 2 x 2,
  ``allgather_matmul_overlap``, ``pipeline_apply`` over 4 stages
  (outputs and each stage's gradient), the MoE's expert-parallel branch on
  2 x 2 (also against the port's local branch) and one sharded train
  step, each held to the reference's run of the same inputs
  (``tests/test_torch_mesh_b.py``: ``spmm_2p5d``, ``reshard`` and the
  elastic 4 x 2 -> 2 x 2 restart on 8 ranks).  The reference runs once,
  in a subprocess with
  ``XLA_FLAGS=--xla_force_host_platform_device_count=8`` (as
  ``tests/test_distributed.py`` runs it), beside the gloo ranks, and
  hands its outputs back as ``.npz``.

Tolerances are the reference tests': 2e-4 for the SpMMs and the ring
matmul, 2e-5 for the pipeline, 3e-3 on params after a sharded step (the
first Adam step moves a weight by about ±lr, and the order of the
gradients' sums can flip a near-zero one's sign), 1e-4 for the elastic
trajectory against the same package's run on one mesh.  The MoE's
branches hold to 1e-5 (f32 products over the same tokens in another
blocking).
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_config
from repro.configs import get_smoke_config as j_smoke
from repro.core import topology as JTop
from repro.launch.inputs import abstract_cache, abstract_params
from repro.models.moe import init_moe as j_init_moe
from repro.models.transformer import init_lm as j_init_lm
from repro.sharding import ctx as j_ctx
from repro.sharding import specs as JS
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import topology as Top
from repro_torch.models import transformer as T
from repro_torch.sharding import ctx as shard_ctx
from repro_torch.sharding import specs as S
from repro_torch.sharding.specs import PartitionSpec as P
from repro_torch.tree import DictKey, SequenceKey, tree_flatten_with_path

sys.path.insert(0, os.path.dirname(__file__))
import test_torch_mesh_ranks as ranks  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM_ARCHS = [a for a in J_ARCHS if a != "paper-gnn"]


class FakeMesh:
    """Axis names and sizes, all a spec function reads (the reference's
    ``tests/test_sharding.py`` uses the same)."""

    def __init__(self, **sizes):
        self.axis_names = tuple(sizes)
        self.shape = dict(sizes)


MESHES = {"16x16": FakeMesh(data=16, model=16),
          "2x4x8": FakeMesh(pod=2, data=4, model=8),
          "4x2x2": FakeMesh(pod=4, data=2, model=2),
          "1x1": FakeMesh(data=1, model=1),
          "model8": FakeMesh(model=8)}


def _port_path(path):
    out = []
    for p in path:
        if isinstance(p, jax.tree_util.DictKey):
            out.append(DictKey(p.key))
        elif isinstance(p, jax.tree_util.SequenceKey):
            out.append(SequenceKey(p.idx))
        else:
            raise AssertionError(p)
    return tuple(out)


def _state_of(tree):
    """The AdamW state's tree shape over ``tree`` (the moments' specs add
    ``pod`` to their fsdp dim)."""
    return {"opt": {"m": tree, "v": tree, "step": np.zeros((), np.int32)}}


def _hold_specs(jtree, mesh, spec_j, spec_t):
    n = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        want = spec_j(path, leaf)
        got = spec_t(_port_path(path), leaf)
        assert got == want, (jax.tree_util.keystr(path), got, want)
        assert isinstance(got, P)
        n += 1
    return n


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_specs_match_reference_on_smoke_models(arch):
    """The port's own smoke tree (its paths, leaf for leaf the
    reference's) and the reference's specs for it."""
    tree = T.init_lm(dataclasses.replace(get_smoke_config(arch),
                                         dtype="float32"), device="cpu")
    jtree = abstract_params(j_smoke(arch))
    assert [_port_path(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(jtree)[0]] \
        == [p for p, _ in tree_flatten_with_path(tree)]
    assert [tuple(x.shape) for x in T.tree_leaves(tree)] \
        == [tuple(x.shape) for x in jax.tree_util.tree_leaves(jtree)]
    for mesh in MESHES.values():
        for t in (jtree, _state_of(jtree)):
            _hold_specs(t, mesh,
                        lambda p, x: JS.param_spec(p, x, mesh),
                        lambda p, x: S.param_spec(p, x, mesh))


def test_param_specs_match_reference_on_gemma3_config():
    """gemma3-4b's full ``CONFIG`` (shapes only: 3.88 B parameters)."""
    jtree = abstract_params(j_config("gemma3-4b"))
    n = 0
    for mesh in MESHES.values():
        for t in (jtree, _state_of(jtree)):
            n += _hold_specs(t, mesh,
                             lambda p, x: JS.param_spec(p, x, mesh),
                             lambda p, x: S.param_spec(p, x, mesh))
    assert n > 100


SMALL_SHAPES = (ShapeConfig("decode_small", 64, 8, "decode"),
                ShapeConfig("long_500k", 64, 1, "decode"))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_cache_specs_match_reference_on_smoke_models(arch):
    jcfg = j_smoke(arch)
    cfg = get_smoke_config(arch)
    for shape in SMALL_SHAPES:
        cache = T.init_cache(cfg, shape.global_batch, shape.seq_len,
                             device="cpu")
        jcache = abstract_cache(jcfg, shape)
        assert [_port_path(p) for p, _ in
                jax.tree_util.tree_flatten_with_path(jcache)[0]] \
            == [p for p, _ in tree_flatten_with_path(cache)]
        for mesh in MESHES.values():
            _hold_specs(
                jcache, mesh,
                lambda p, x: JS.cache_spec(p, x, mesh, jcfg, shape),
                lambda p, x: S.cache_spec(p, x, mesh, cfg, shape))


@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
def test_cache_specs_match_reference_on_gemma3_config(shape_name):
    jcfg = j_config("gemma3-4b")
    shape = J_SHAPES[shape_name]
    jcache = abstract_cache(jcfg, shape)
    for mesh in MESHES.values():
        _hold_specs(jcache, mesh,
                    lambda p, x: JS.cache_spec(p, x, mesh, jcfg, shape),
                    lambda p, x: S.cache_spec(p, x, mesh, jcfg, shape))


@pytest.mark.parametrize("mesh", list(MESHES), ids=list(MESHES))
@pytest.mark.parametrize("global_batch", [1, 8, 32])
def test_batch_specs_match_reference(mesh, global_batch):
    m = MESHES[mesh]
    assert S.batch_axes(m) == JS.batch_axes(m)
    for nd in (1, 2, 3):
        for ok in (True, False):
            assert S.batch_spec(m, nd, batch_divisible=ok) \
                == JS.batch_spec(m, nd, batch_divisible=ok)
    assert S.batch_divides(m, global_batch) == (
        global_batch % int(np.prod([m.shape[a] for a in JS.batch_axes(m)]
                                   or [1])) == 0
        and global_batch >= int(np.prod([m.shape[a]
                                         for a in JS.batch_axes(m)] or [1])))


def test_fit_drops_non_divisible_axes():
    fm = MESHES["16x16"]
    assert S._fit(51865, ("model",), fm) is None  # whisper vocab (odd)
    assert S._fit(202048, ("model",), fm) == "model"
    assert S._fit(8, ("model",), fm) is None  # kv=8 heads < 16 shards
    assert S._fit(8, ("pod", "data"), MESHES["2x4x8"]) == ("pod", "data")
    assert S._fit(6, ("pod", "data"), MESHES["2x4x8"]) == "pod"


def test_partition_spec_compares_with_the_reference():
    from jax.sharding import PartitionSpec as JP

    assert P(("data",), "model", None) == JP(("data",), "model", None)
    assert P(("pod", "data"), None) == JP(("pod", "data"), None)
    assert P() == JP()
    assert P("data") != JP("model")
    assert hash(P(("data",))) == hash(P("data"))
    assert P((), "model") == JP(None, "model")


def test_logical_dedup():
    shard_ctx.set_mesh(MESHES["1x1"], {"seq": "model", "heads": "model",
                                       "batch": ("data",)})
    try:
        spec = shard_ctx.logical_to_spec(("batch", "seq", "heads", None))
        assert spec == P(("data",), "model", None, None)
    finally:
        shard_ctx.clear_mesh()


@pytest.mark.parametrize("mesh", list(MESHES), ids=list(MESHES))
def test_logical_to_spec_matches_reference(mesh):
    m = MESHES[mesh]
    queries = [("batch", "seq", "embed"), ("batch", None, "vocab"),
               ("batch", "heads", None, None), ("batch", "seq", "heads",
                                                None),
               ("fsdp", "mlp"), ("expert", "fsdp", None), ("stage",)]
    for rules in (None, {"seq": "model", "batch": ("data",)}):
        shard_ctx.set_mesh(m, rules)
        j_ctx.set_mesh(m, rules)
        try:
            assert shard_ctx.axis_rules() == j_ctx.axis_rules()
            for q in queries:
                assert shard_ctx.logical_to_spec(q) \
                    == j_ctx.logical_to_spec(q), q
        finally:
            shard_ctx.clear_mesh()
            j_ctx.clear_mesh()


def test_use_mesh_restores_and_shard_hint_is_the_identity():
    x = torch.ones(4, 4)
    assert shard_ctx.shard_hint(x, "batch", "embed") is x
    assert shard_ctx.current_mesh() is None
    with shard_ctx.use_mesh(MESHES["2x4x8"]):
        assert shard_ctx.current_mesh() is MESHES["2x4x8"]
        assert shard_ctx.shard_hint(x, "batch", "embed") is x
        with shard_ctx.use_mesh(MESHES["1x1"]):
            assert shard_ctx.axis_rules()["batch"] == ("data",)
        assert shard_ctx.axis_rules()["batch"] == ("pod", "data")
    assert shard_ctx.current_mesh() is None and shard_ctx.axis_rules() \
        is None


def test_topology_matches_reference(rng):
    dense = (rng.normal(size=(256, 256)) * (rng.random((256, 256)) < 0.02))
    dense[:16] = rng.normal(size=(16, 256))  # hot rows
    counts = Top.block_row_counts(dense, 16, 16)
    np.testing.assert_array_equal(counts,
                                  JTop.block_row_counts(dense, 16, 16))
    np.testing.assert_array_equal(Top.balance_permutation(counts),
                                  JTop.balance_permutation(counts))
    for parts in (2, 4, 8):
        np.testing.assert_array_equal(Top.snake_permutation(counts, parts),
                                      JTop.snake_permutation(counts, parts))
    # a fault of the reference, carried: parts that do not divide the rows
    # leave slots past the end
    for fn in (Top.snake_permutation, JTop.snake_permutation):
        with pytest.raises(IndexError):
            fn(counts, 3)
    for target in (0.0, 0.5, 0.9):
        assert Top.choose_ell_width(counts, target) \
            == JTop.choose_ell_width(counts, target)
    assert Top.padding_stats(counts) == JTop.padding_stats(counts)
    from repro.core.formats import CSR as JCSR
    from repro_torch.core.formats import CSR

    np.testing.assert_array_equal(
        Top.csr_row_counts(CSR.from_dense(dense)),
        JTop.csr_row_counts(JCSR.from_dense(dense)))


# ---------------------------------------------------------------------------
# A mesh of size 1 in this process
# ---------------------------------------------------------------------------


@pytest.fixture
def one_rank_mesh():
    import torch.distributed as dist

    assert not dist.is_initialized()
    mesh = S.make_mesh((1, 1), ("data", "model"), device="cpu")
    assert dist.get_backend() == "gloo" and mesh.device_type == "cpu"
    yield mesh
    dist.destroy_process_group()


def test_make_mesh_defaults_to_the_card():
    """A mesh asked for with no ``device`` is the card's: with no process
    group it starts a one-rank NCCL group, and with no card it raises and
    starts no group (no CPU fallback)."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    if torch.cuda.is_available():
        mesh = S.make_mesh((1, 1), ("data", "model"))
        try:
            assert dist.get_backend() == "nccl"
            assert mesh.device_type == "cuda"
        finally:
            dist.destroy_process_group()
        return
    with pytest.raises(RuntimeError, match="is_available"):
        S.make_mesh((1, 1), ("data", "model"))
    assert not dist.is_initialized()


def test_reshard_roundtrip(rng, one_rank_mesh):
    from repro_torch.ft.resharding import replicated_tree, reshard

    mesh = one_rank_mesh
    tree = {"w": torch.from_numpy(rng.normal(size=(8, 8)).astype(
        np.float32))}
    out = reshard(tree, mesh)
    assert torch.equal(out["w"].full_tensor(), tree["w"])
    sh = replicated_tree(tree, mesh)
    assert S.axis_sizes(sh["w"].mesh) == S.axis_sizes(mesh) \
        == {"data": 1, "model": 1}
    assert mesh.mesh_dim_names == ("data", "model")


def test_one_rank_mesh_runs_the_moe_expert_parallel_branch(one_rank_mesh):
    """On a 1 x 1 mesh the expert-parallel branch is the local branch, bit
    for bit (the card's phase 11 holds the same on NCCL)."""
    from repro_torch.models.moe import init_moe, moe_ffn

    cfg = dataclasses.replace(get_smoke_config("llama4-scout-17b-a16e"),
                              dtype="float32")
    p = init_moe(torch.Generator().manual_seed(3), cfg)
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 8, cfg.d_model)).astype(np.float32))
    with shard_ctx.use_mesh(one_rank_mesh):
        y, aux = moe_ffn(p, x, cfg)
    y0, aux0 = moe_ffn(p, x, cfg)
    assert torch.equal(y, y0) and torch.equal(aux, aux0)


# ---------------------------------------------------------------------------
# The gloo runs against the reference's forced-device run
# ---------------------------------------------------------------------------

_REFERENCE_HEAD = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, tempfile
    import numpy as np, jax, jax.numpy as jnp
    from repro.configs import get_smoke_config
    from repro.core.distributed import (allgather_matmul_overlap, spmm_1p5d,
                                        spmm_2d, spmm_2p5d)
    from repro.core.formats import BlockELL
    from repro.data.pipeline import DataConfig, make_lm_batch
    from repro.ft.checkpoint import Checkpointer
    from repro.models.moe import init_moe, moe_ffn
    from repro.models.transformer import init_lm, lm_loss
    from repro.sharding import ctx as shard_ctx
    from repro.sharding.specs import (data_sharding_tree, make_mesh,
                                      param_sharding_tree)
    from repro.train.loop import TrainConfig, init_train_state, \\
        make_train_step
    from repro.train.optimizer import OptConfig
    from repro.train.pipeline import pipeline_apply

    inputs = dict(np.load(sys.argv[1]))
    res = {}
    flat = lambda pre, t: {f"{pre}/{i}": np.asarray(x) for i, x in
                           enumerate(jax.tree_util.tree_leaves(t))}

""")

# the runs of this file: the 2 x 2 mesh and the 4-stage pipeline
_REFERENCE_4 = textwrap.dedent("""
    mesh = make_mesh((2, 2), ("data", "model"))
    ell = BlockELL.from_dense(inputs["dense"], bm=32, bn=32)
    h = jnp.asarray(inputs["h"])
    res["y15"] = np.asarray(spmm_1p5d(ell, h, mesh))
    res["y2"] = np.asarray(spmm_2d(ell, h, mesh))
    res["ym"] = np.asarray(allgather_matmul_overlap(
        jnp.asarray(inputs["x"]), jnp.asarray(inputs["w"]), mesh,
        axis="model"))

    pmesh = make_mesh((4,), ("pod",))
    ws, xs = jnp.asarray(inputs["ws"]), jnp.asarray(inputs["xs"])
    fn = lambda w, x: jnp.tanh(x @ w)
    res["pipe_out"] = np.asarray(pipeline_apply(fn, ws, xs, pmesh,
                                                axis="pod"))
    res["pipe_grad"] = np.asarray(jax.grad(
        lambda w: pipeline_apply(fn, w, xs, pmesh, axis="pod").sum())(ws))

    base = dataclasses.replace(get_smoke_config("llama4-scout-17b-a16e"),
                               dtype="float32")
    p = init_moe(jax.random.PRNGKey(0), base)
    x = jnp.asarray(inputs["moe_x"])
    for tag, cfg in (("", base), ("_nodrop", dataclasses.replace(
            base, capacity_factor=float(base.n_experts)))):
        shard_ctx.set_mesh(mesh)
        y, aux = jax.jit(lambda p, x: moe_ffn(p, x, cfg))(p, x)
        shard_ctx.clear_mesh()
        res["moe_y" + tag], res["moe_aux" + tag] = np.asarray(y), \\
            np.asarray(aux)

    cfg = dataclasses.replace(get_smoke_config("granite-20b"),
                              dtype="float32")
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=0,
                                     total_steps=10))
    params = init_lm(jax.random.PRNGKey(0), cfg)
    state = init_train_state(params, tcfg)
    batch = make_lm_batch(cfg, 32, 8, 0, DataConfig(seed=0))
    p_sh = param_sharding_tree(params, mesh)
    s_sh = param_sharding_tree(state, mesh)
    b_sh = data_sharding_tree(batch, mesh, 8)
    g_loss, g = jax.jit(jax.value_and_grad(lambda p, b: lm_loss(
        p, cfg, b, aux_weight=tcfg.aux_weight)))(params, batch)
    res.update(flat("grads", g))
    res["grads_loss"] = np.asarray(g_loss)
    shard_ctx.set_mesh(mesh)
    p2, _, m2 = jax.jit(make_train_step(cfg, tcfg),
                        in_shardings=(p_sh, s_sh, b_sh),
                        out_shardings=(p_sh, s_sh, None))(
        params, state, batch)
    shard_ctx.clear_mesh()
    res.update(flat("sharded", p2))
    res["sharded_loss"] = np.asarray(m2["loss"])
    res["sharded_grad_norm"] = np.asarray(m2["grad_norm"])

    np.savez(sys.argv[2], **res)
    print("reference OK")
""")

# those of tests/test_torch_mesh_b.py: 2 x 2 x 2 and the elastic restart
_REFERENCE_8 = textwrap.dedent("""
    ell = BlockELL.from_dense(inputs["dense"], bm=32, bn=32)
    h = jnp.asarray(inputs["h"])
    mesh3 = make_mesh((2, 2, 2), ("pod", "data", "model"))
    res["y25"] = np.asarray(spmm_2p5d(ell, h, mesh3))
    cfg = dataclasses.replace(get_smoke_config("granite-20b"),
                              dtype="float32")
    params = init_lm(jax.random.PRNGKey(0), cfg)
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=0,
                                     total_steps=20))
    state = init_train_state(params, tcfg)

    def run_steps(params, state, mesh, start, n):
        step = make_train_step(cfg, tcfg)
        p_sh = param_sharding_tree(params, mesh)
        s_sh = param_sharding_tree(state, mesh)
        params = jax.device_put(params, p_sh)
        state = jax.device_put(state, s_sh)
        shard_ctx.set_mesh(mesh)
        fn = jax.jit(step, in_shardings=(p_sh, s_sh, None),
                     out_shardings=(p_sh, s_sh, None))
        for i in range(n):
            batch = make_lm_batch(cfg, 32, 8, start + i, DataConfig(seed=4))
            params, state, m = fn(params, state, batch)
        shard_ctx.clear_mesh()
        return params, state, float(m["loss"])

    mesh_a = make_mesh((4, 2), ("data", "model"))
    mesh_b = make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4])
    p_ref, _, loss_ref = run_steps(params, state, mesh_a, 0, 6)
    res.update(flat("elastic_ref", p_ref))
    res["elastic_ref_loss"] = np.asarray(loss_ref)
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d, async_save=False)
        p1, s1, _ = run_steps(params, state, mesh_a, 0, 3)
        ck.save(3, {"params": p1, "state": s1}, meta={"mesh": "4x2"})
        restored = ck.restore({"params": params, "state": state})
        p2, _, loss_b = run_steps(restored["params"], restored["state"],
                                  mesh_b, 3, 3)
    res.update(flat("elastic", p2))
    res["elastic_loss"] = np.asarray(loss_b)
    np.savez(sys.argv[2], **res)
    print("reference OK")
""")


def _inputs(path):
    rng = np.random.default_rng(2)
    m = n = 256
    dense = (rng.normal(size=(m, n)) * (rng.random((m, n)) < 0.2)
             ).astype(np.float32)
    arrays = {"dense": dense,
              "h": rng.normal(size=(n, 64)).astype(np.float32),
              "x": rng.normal(size=(16, 64)).astype(np.float32),
              "w": rng.normal(size=(64, 32)).astype(np.float32)}
    prng = np.random.default_rng(0)
    arrays["ws"] = (prng.normal(size=(4, 16, 16)).astype(np.float32)
                    / np.float32(4.0))
    arrays["xs"] = prng.normal(size=(8, 4, 16)).astype(np.float32)
    moe_cfg = dataclasses.replace(j_smoke("llama4-scout-17b-a16e"),
                                  dtype="float32")
    arrays["moe_x"] = np.random.default_rng(5).normal(
        size=(4, 8, moe_cfg.d_model)).astype(np.float32)
    for i, leaf in enumerate(jax.tree_util.tree_leaves(
            j_init_moe(jax.random.PRNGKey(0), moe_cfg))):
        arrays[f"moe/{i}"] = np.asarray(leaf)
    gcfg = dataclasses.replace(j_smoke("granite-20b"), dtype="float32")
    for i, leaf in enumerate(jax.tree_util.tree_leaves(
            j_init_lm(jax.random.PRNGKey(0), gcfg))):
        arrays[f"granite/{i}"] = np.asarray(leaf)
    np.savez(path, **arrays)
    return arrays


def run_both(tmp_path_factory, fn, n, reference_part):
    """The reference's run (``_REFERENCE_HEAD`` + ``reference_part``) and
    the port's ``n``-rank gloo run ``fn`` of the same inputs, side by
    side."""
    d = str(tmp_path_factory.mktemp("mesh"))
    inputs_path = os.path.join(d, "inputs.npz")
    inputs = _inputs(inputs_path)
    ref_path = os.path.join(d, "reference.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE_HEAD + reference_part,
         inputs_path, ref_path], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        port = ranks.launch(fn, n, d, inputs_path)
        out, _ = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out
    return {"inputs": inputs, "ref": dict(np.load(ref_path)), "port": port}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_both(tmp_path_factory, ranks.rank4, 4, _REFERENCE_4)


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _leaves_of(res, prefix):
    n = sum(1 for k in res if k.startswith(prefix + "/"))
    assert n > 0, prefix
    return [res[f"{prefix}/{i}"] for i in range(n)]


@pytest.mark.parametrize("name", ["y15", "y2"])
def test_spmm_on_2x2_matches_reference(runs, name):
    want = runs["inputs"]["dense"] @ runs["inputs"]["h"]
    _close(runs["ref"][name], want, 2e-4)
    for r in runs["port"]:  # every rank gathers the same whole product
        _close(r[name], runs["ref"][name], 2e-4)
    _close(runs["port"][0]["y15_dt"], runs["ref"]["y15"], 2e-4)


def test_allgather_matmul_overlap_matches_reference(runs):
    want = runs["inputs"]["x"] @ runs["inputs"]["w"]
    for r in runs["port"]:
        _close(r["ym"], runs["ref"]["ym"], 2e-4)
        _close(r["ym"], want, 2e-4)


def test_pipeline_matches_reference(runs):
    ws, xs = runs["inputs"]["ws"], runs["inputs"]["xs"]
    seq = xs
    for s in range(4):
        seq = np.tanh(seq @ ws[s])
    for r in runs["port"]:
        _close(r["pipe_out"], runs["ref"]["pipe_out"], 2e-5)
        _close(r["pipe_out"], seq, 2e-5)


def test_pipeline_gradient_matches_reference(runs):
    """Each stage's gradient, on its rank, is the reference's."""
    g = runs["ref"]["pipe_grad"]
    for rank, r in enumerate(runs["port"]):
        np.testing.assert_allclose(r["pipe_grad"], g[rank], rtol=1e-4,
                                   atol=1e-4 * float(np.abs(g).max()))


@pytest.mark.parametrize("tag", ["", "_nodrop"], ids=["capacity", "no_drops"])
def test_moe_expert_parallel_matches_reference(runs, tag):
    for r in runs["port"]:
        _close(r["moe_y" + tag], runs["ref"]["moe_y" + tag], 1e-5)
        _close(r["moe_aux" + tag], runs["ref"]["moe_aux" + tag], 1e-5)


def test_moe_expert_parallel_matches_its_local_branch(runs):
    """Without capacity drops the two branches compute the same outputs
    (the expert-parallel fold adds one nonzero contribution a token).  The
    load-balance loss is not the same function: the expert-parallel
    branch averages each batch slice's (nonlinear) loss over the mesh, as
    the reference's ``pmean`` does."""
    for r in runs["port"]:
        _close(r["moe_y_nodrop"], r["moe_y_local_nodrop"], 1e-5)
        assert np.isfinite(r["moe_aux_nodrop"])


def _hold_grads(got, want, what):
    """Each leaf within 1e-4 x max|want| (f32 sums in another order)."""
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        err = float(np.abs(g - w).max())
        assert err <= 1e-4 * float(np.abs(w).max()), f"{what} leaf {i}: {err}"


def test_sharded_gradients_match_reference(runs):
    """The sharded step's gradients, averaged over the batch axes before
    AdamW, are the reference's ``value_and_grad`` on the whole batch: a
    missing, summed or one-slice mean fails here, where Adam's sign-only
    first step would hide it in the params."""
    want = _leaves_of(runs["ref"], "grads")
    loss = float(runs["ref"]["grads_loss"])
    for rank, r in enumerate(runs["port"]):
        assert abs(float(r["sharded_grads_loss"]) - loss) <= 1e-5 * loss
        _hold_grads(_leaves_of(r, "sharded_grads"), want, f"rank {rank}")


def test_sharded_train_step_matches_reference(runs):
    want = _leaves_of(runs["ref"], "sharded")
    loss = float(runs["ref"]["sharded_loss"])
    norm = float(runs["ref"]["sharded_grad_norm"])
    for r in runs["port"]:
        assert abs(float(r["sharded_loss"]) - loss) <= 1e-5 * loss
        # the global norm over the whole gradients, not one shard's
        assert abs(float(r["sharded_grad_norm"]) - norm) <= 1e-5 * norm
        assert int(r["sharded_step"]) == 1
        got = _leaves_of(r, "sharded")
        assert len(got) == len(want)
        worst = max(float(np.abs(a - b).max()) for a, b in zip(got, want))
        assert worst < 3e-3, worst


def test_sharded_train_step_matches_unsharded_step(runs):
    """Each rank's shards of the params and first moments are updated as
    AdamW on one rank updates the whole tree from the same averaged
    gradients, bit for bit; the loss and params are the unsharded step's
    within the reference's bounds (its gradients sum in another order)."""
    for r in runs["port"]:
        for tag in ("", "_m"):
            got = _leaves_of(r, "sharded" + tag)
            want = _leaves_of(r, "applied" + tag)
            assert len(got) == len(want)
            for i, (a, b) in enumerate(zip(got, want)):
                assert np.array_equal(a, b), f"{tag} leaf {i}"
    r = runs["port"][0]
    assert abs(float(r["sharded_loss"]) - float(r["single_loss"])) \
        <= 1e-5 * float(r["single_loss"])
    worst = max(float(np.abs(a - b).max()) for a, b in
                zip(_leaves_of(r, "sharded"), _leaves_of(r, "single")))
    assert worst < 3e-3, worst
