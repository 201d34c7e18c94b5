"""Ranks of the port's gloo runs for ``tests/test_torch_mesh.py`` and
``_b.py`` (no tests here; no JAX: each rank imports only torch and
``repro_torch``).

``launch`` spawns ``n`` CPU processes that join one gloo process group on
a ``FileStore``; each runs ``fn(rank, n, store, inputs, out)``, reading
the numpy inputs the test wrote and writing its results as ``.npz``
(``out.<rank>.npz``).  Every rank runs one thread of torch's, so the
ranks share the cores.
"""
import dataclasses
import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

CPU = "cpu"


def _main(rank, fn, n, store, inputs, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, n),
                            rank=rank, world_size=n)
    try:
        fn(rank, n, inputs, out)
    finally:
        dist.destroy_process_group()


def launch(fn, n, tmpdir, inputs, timeout=300.0):
    """Run ``fn`` on ``n`` gloo ranks; returns each rank's results (a list
    of dicts).  Fails on any rank's error, and after ``timeout`` s."""
    store = os.path.join(tmpdir, f"store_{fn.__name__}")
    out = os.path.join(tmpdir, f"out_{fn.__name__}")
    ctx = mp.start_processes(_main, args=(fn, n, store, inputs, out),
                             nprocs=n, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{fn.__name__} on {n} ranks: no end "
                                   f"after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [dict(np.load(f"{out}.{r}.npz")) for r in range(n)]


def _save(out, rank, **arrays):
    np.savez(f"{out}.{rank}.npz", **arrays)


# ---------------------------------------------------------------------------
# inputs shared with the reference's run
# ---------------------------------------------------------------------------


def _granite():
    from repro_torch.configs import get_smoke_config

    return dataclasses.replace(get_smoke_config("granite-20b"),
                               dtype="float32")


def _llama4(no_drops: bool):
    from repro_torch.configs import get_smoke_config

    cfg = dataclasses.replace(get_smoke_config("llama4-scout-17b-a16e"),
                              dtype="float32")
    if no_drops:
        cfg = dataclasses.replace(cfg,
                                  capacity_factor=float(cfg.n_experts))
    return cfg


def _tree_from(template, leaves):
    """``template``'s structure with the given leaves (in its order)."""
    from repro_torch.tree import tree_map

    it = iter(leaves)
    return tree_map(lambda _: torch.from_numpy(np.array(next(it))),
                    template)


def _leaves(inputs, prefix):
    n = sum(1 for k in inputs if k.startswith(prefix + "/"))
    return [inputs[f"{prefix}/{i}"] for i in range(n)]


def granite_params(inputs):
    from repro_torch.models import transformer as T

    cfg = _granite()
    return _tree_from(T.init_lm(cfg, seed=0, device=CPU),
                      _leaves(inputs, "granite"))


def moe_params(inputs):
    from repro_torch.models.moe import init_moe

    cfg = _llama4(False)
    gen = torch.Generator().manual_seed(0)
    return _tree_from(init_moe(gen, cfg), _leaves(inputs, "moe"))


def _flat(prefix, tree):
    from repro_torch.tree import tree_leaves

    def host(x):
        x = x.full_tensor() if hasattr(x, "full_tensor") else x
        return x.detach().cpu().numpy()

    return {f"{prefix}/{i}": host(x)
            for i, x in enumerate(tree_leaves(tree))}


def _step_cfgs(total_steps):
    from repro_torch.train.loop import TrainConfig
    from repro_torch.train.optimizer import OptConfig

    return TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=0,
                                     total_steps=total_steps))


# ---------------------------------------------------------------------------
# four ranks: the 2 x 2 mesh and the 4-stage pipeline
# ---------------------------------------------------------------------------


def rank4(rank, n, inputs_path, out):
    from repro_torch.core.distributed import (allgather_matmul_overlap,
                                              spmm_1p5d, spmm_2d)
    from repro_torch.core.formats import BlockELL
    from repro_torch.data.pipeline import DataConfig, make_lm_batch
    from repro_torch.models.moe import moe_ffn
    from repro_torch.sharding import ctx as shard_ctx
    from repro_torch.sharding.specs import NamedSharding, make_mesh
    from repro_torch.sharding.specs import PartitionSpec as P
    from repro_torch.sharding.step import (make_sharded_grad_fn,
                                           make_sharded_train_step,
                                           place_tree)
    from repro_torch.train.loop import (apply_gradients, init_train_state,
                                        make_train_step)
    from repro_torch.train.pipeline import pipeline_apply

    inputs = dict(np.load(inputs_path))
    res = {}
    mesh = make_mesh((2, 2), ("data", "model"), device=CPU)
    ell = BlockELL.from_dense(inputs["dense"], 32, 32, device=CPU)
    h = torch.from_numpy(inputs["h"])
    res["y15"] = spmm_1p5d(ell, h, mesh).full_tensor().numpy()
    res["y2"] = spmm_2d(ell, h, mesh).full_tensor().numpy()
    # operands already placed as the reference's in_specs
    h_dt = NamedSharding(mesh, P("data", None)).place(h)
    res["y15_dt"] = spmm_1p5d(ell, h_dt, mesh).full_tensor().numpy()
    res["ym"] = allgather_matmul_overlap(
        torch.from_numpy(inputs["x"]), torch.from_numpy(inputs["w"]),
        mesh, axis="model").full_tensor().numpy()

    # pipeline over 4 stages, forward and gradient
    pmesh = make_mesh((4,), ("pod",), device=CPU)
    ws = torch.from_numpy(inputs["ws"]).requires_grad_()
    xs = torch.from_numpy(inputs["xs"])
    pout = pipeline_apply(lambda w, x: torch.tanh(x @ w), ws, xs, pmesh,
                          axis="pod")
    pout.sum().backward()
    res["pipe_out"] = pout.detach().numpy()
    res["pipe_grad"] = ws.grad[rank].numpy()  # this rank's stage

    # the MoE's expert-parallel branch and its local branch
    p = moe_params(inputs)
    x = torch.from_numpy(inputs["moe_x"])
    for tag, no_drops in (("", False), ("_nodrop", True)):
        cfg = _llama4(no_drops)
        with shard_ctx.use_mesh(mesh):
            y, aux = moe_ffn(p, x, cfg)
        y_loc, aux_loc = moe_ffn(p, x, cfg)
        res[f"moe_y{tag}"], res[f"moe_aux{tag}"] = y.numpy(), aux.numpy()
        res[f"moe_y_local{tag}"] = y_loc.numpy()
        res[f"moe_aux_local{tag}"] = aux_loc.numpy()

    # one sharded train step: its averaged gradients, and its update
    # against AdamW applied on one rank to those gradients
    cfg, tcfg = _granite(), _step_cfgs(10)
    batch = make_lm_batch(cfg, 32, 8, 0, DataConfig(seed=0), device=CPU)
    params = granite_params(inputs)
    state = init_train_state(params, tcfg)
    p_sh, s_sh = place_tree(params, mesh), place_tree(state, mesh)
    g_loss, grads = make_sharded_grad_fn(cfg, tcfg, mesh)(p_sh, batch)
    res.update(_flat("sharded_grads", grads))
    res["sharded_grads_loss"] = g_loss.numpy()
    p_sh, s_sh, m = make_sharded_train_step(cfg, tcfg, mesh)(p_sh, s_sh,
                                                            batch)
    res.update(_flat("sharded", p_sh))
    res["sharded_loss"] = m["loss"].numpy()
    res["sharded_grad_norm"] = m["grad_norm"].numpy()
    res["sharded_step"] = s_sh["opt"]["step"].full_tensor().numpy()
    params = granite_params(inputs)
    p_app, s_app, _ = apply_gradients(params, init_train_state(params, tcfg),
                                      grads, tcfg)
    res.update(_flat("applied", p_app))
    res.update(_flat("applied_m", s_app["opt"]["m"]))
    res.update(_flat("sharded_m", s_sh["opt"]["m"]))
    params = granite_params(inputs)  # fresh, as the step writes in place
    p1, _, m1 = make_train_step(cfg, tcfg)(params,
                                           init_train_state(params, tcfg),
                                           batch)
    res.update(_flat("single", p1))
    res["single_loss"] = m1["loss"].numpy()
    _save(out, rank, **res)


# ---------------------------------------------------------------------------
# eight ranks: 2.5D, and the elastic 4 x 2 -> 2 x 2 restart
# ---------------------------------------------------------------------------


def _run_steps(cfg, tcfg, params, state, mesh, start, n):
    from repro_torch.data.pipeline import DataConfig, make_lm_batch
    from repro_torch.sharding.step import make_sharded_train_step

    step = make_sharded_train_step(cfg, tcfg, mesh)
    m = None
    for i in range(n):
        batch = make_lm_batch(cfg, 32, 8, start + i, DataConfig(seed=4),
                              device=CPU)
        params, state, m = step(params, state, batch)
    return params, state, float(m["loss"])


def rank8(rank, n, inputs_path, out):
    from repro_torch.core.distributed import spmm_2p5d
    from repro_torch.core.formats import BlockELL
    from repro_torch.ft.checkpoint import Checkpointer
    from repro_torch.ft.resharding import reshard
    from repro_torch.sharding.specs import (make_mesh, param_sharding_tree,
                                            param_spec)
    from repro_torch.sharding.step import place_tree
    from repro_torch.train.loop import init_train_state

    inputs = dict(np.load(inputs_path))
    res = {}
    mesh3 = make_mesh((2, 2, 2), ("pod", "data", "model"),
                      device=CPU)
    ell = BlockELL.from_dense(inputs["dense"], 32, 32, device=CPU)
    res["y25"] = spmm_2p5d(ell, torch.from_numpy(inputs["h"]),
                           mesh3).full_tensor().numpy()

    cfg, tcfg = _granite(), _step_cfgs(20)
    mesh_a = make_mesh((4, 2), ("data", "model"), device=CPU)
    mesh_b = make_mesh((2, 2), ("data", "model"), devices=[0, 1, 2, 3],
                       device=CPU)
    on_b = mesh_b.get_coordinate() is not None

    def fresh():
        params = granite_params(inputs)
        return params, init_train_state(params, tcfg)

    # every leaf re-placed from mesh A onto mesh B, the same values
    params, state = fresh()
    moved = reshard(place_tree(params, mesh_a), mesh_b,
                    lambda path, leaf: param_spec(path, leaf, mesh_b))
    if on_b:
        res.update(_flat("resharded", moved))

    # reference: 6 steps all on mesh A
    p, s = fresh()
    p_ref, _, loss_ref = _run_steps(cfg, tcfg, place_tree(p, mesh_a),
                                    place_tree(s, mesh_a), mesh_a, 0, 6)
    res.update(_flat("elastic_ref", p_ref))
    res["elastic_ref_loss"] = np.asarray(loss_ref)

    # elastic: 3 steps on A -> checkpoint -> restore on B -> 3 more
    p, s = fresh()
    p1, s1, _ = _run_steps(cfg, tcfg, place_tree(p, mesh_a),
                           place_tree(s, mesh_a), mesh_a, 0, 3)
    ck = Checkpointer(os.path.join(os.path.dirname(out), "elastic_ck"),
                      async_save=False)
    ck.save(3, {"params": p1, "state": s1}, meta={"mesh": "4x2"})
    dist.barrier()
    if on_b:
        target = dict(zip(("params", "state"), fresh()))
        shardings = {"params": param_sharding_tree(target["params"], mesh_b),
                     "state": param_sharding_tree(target["state"], mesh_b)}
        restored = ck.restore(target, sharding_tree=shardings)
        p2, _, loss_b = _run_steps(cfg, tcfg, restored["params"],
                                   restored["state"], mesh_b, 3, 3)
        res.update(_flat("elastic", p2))
        res["elastic_loss"] = np.asarray(loss_b)
        res["ckpt_step"] = np.asarray(ck.latest_step())
    _save(out, rank, **res)
