"""Multi-pod dry run: one step of every (arch x shape x mesh) cell, counted
on one rank of a fake world (the port of ``repro.launch.dryrun``).

For each cell:
  1. start a fake process group of 256 (16x16) or 512 (2x16x16) ranks
     (``torch.testing._internal.distributed.fake_pg``: collectives return
     at once and move nothing) and build the production mesh on it,
  2. shard the cell's ``input_specs`` with the port's
     ``param_sharding_tree`` / ``data_sharding_tree`` /
     ``cache_sharding_tree``: the per-device argument bytes are exact from
     the shard shapes,
  3. run the port's own step once on rank 0 under ``FakeTensorMode`` (no
     storage is made): ``train.loop.make_train_step`` through
     ``sharding.step.make_sharded_train_step``, or
     ``serve.engine.make_prefill_step`` / ``make_serve_step`` on this
     rank's batch slice with the params gathered whole.  The production
     step (microbatched where the batch allows) gives the peak of live
     fake-tensor bytes, the port's analog of XLA's ``temp_size_in_bytes``
     (not XLA's figure).  A second run, with one microbatch and under
     ``runtime.cost_mode`` with the reference's ``attn_chunk`` and
     ``causal_skip`` choices, is counted by ``roofline.CostCounter``
     (FLOPs, op bytes, collective bytes),
  4. write a JSON artifact to ``experiments/dryrun/`` with the reference's
     keys.

Eager PyTorch runs every layer of every period, so there are no
1-period / 2-period variants to extrapolate from: ``cost_1p`` and
``cost_2p`` are null, and ``raw_scan_costs`` holds the production run's
counts.  The port shards differently from the reference: its sharded
step gathers the params whole on every rank and splits only the batch
(FSDP storage, no tensor parallelism in the math), and ``shard_hint`` is
the identity (no sequence parallelism), so its per-chip FLOPs are the
whole model's on the rank's batch slice.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma3-4b --shape train_4k
  python -m repro_torch.launch.dryrun --arch all --shape all --multi-pod
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch import runtime
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.launch.inputs import input_specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import CostCounter, costs_of, terms_from
from repro_torch.serve.engine import make_prefill_step, make_serve_step
from repro_torch.sharding import ctx as shard_ctx
from repro_torch.sharding.specs import (axis_sizes, batch_axes,
                                        batch_divides, cache_sharding_tree,
                                        data_sharding_tree, make_mesh,
                                        param_sharding_tree, whole)
from repro_torch.train.loop import TrainConfig
from repro_torch.tree import tree_leaves, tree_map

ARTIFACT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))), "experiments", "dryrun")

TEMP_NOTE = ("temp_bytes_per_device is the peak of live fake-tensor op "
             "outputs in one eager run of the step on rank 0 (the port's "
             "analog of XLA's temp_size_in_bytes, not XLA's figure)")
COST_NOTE = ("eager PyTorch runs every period: the counts are of the whole "
             "step, with no 1-period / 2-period variants")


def cell_is_skipped(cfg, shape) -> str:
    if shape.name == "long_500k" and not cfg.long_context_ok:
        return ("skipped: pure full-attention arch; long_500k requires "
                "sub-quadratic attention (DESIGN.md §Arch-applicability)")
    return ""


def shape_rules(mesh, shape, *, seq_parallel: bool = True):
    """Logical-axis rule overrides per shape (activation sharding).  The
    port's ``shard_hint`` is the identity, so these only record the
    reference's choice."""
    rules = {}
    sizes = axis_sizes(mesh)
    nb = math.prod(sizes[a] for a in batch_axes(mesh))
    if shape.global_batch % nb != 0 or shape.global_batch < nb:
        rules["batch"] = None
    if shape.name == "long_500k":
        rules["kv_seq"] = tuple(sizes)
    if seq_parallel and shape.kind in ("train", "prefill") \
            and shape.seq_len % sizes["model"] == 0:
        rules["seq"] = "model"
    return rules


@contextlib.contextmanager
def fake_world(chips: int):
    """A fake process group of ``chips`` ranks with this process as rank
    0, destroyed on exit; an existing group is used as it is."""
    if dist.is_initialized():
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=chips)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _shard_bytes(tree, shardings) -> int:
    """Bytes of one device's shards of ``tree`` under ``shardings`` (each
    sharded dim divided by the product of its axes' sizes)."""
    total = 0
    for leaf, sh in zip(tree_leaves(tree), tree_leaves(
            shardings, is_leaf=lambda x: hasattr(x, "spec"))):
        sizes = axis_sizes(sh.mesh)
        n = 1
        for dim, entry in zip(leaf.shape, tuple(sh.spec) + (None,) * (
                leaf.dim() - len(sh.spec))):
            axes = () if entry is None else (
                (entry,) if isinstance(entry, str) else tuple(entry))
            n *= dim // math.prod(sizes[a] for a in axes)
        total += n * leaf.element_size()
    return total


def _fake(tree, fm):
    """Fake CPU tensors of ``tree``'s meta leaves (no storage)."""
    with fm:
        return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype),
                        tree)


def _local_batch(mesh, global_batch: int) -> int:
    """A rank's batch slice: the global batch split over the batch axes,
    or whole where they do not divide it (as the sharded step takes it)."""
    if not batch_divides(mesh, global_batch):
        return global_batch
    sizes = axis_sizes(mesh)
    return global_batch // math.prod(sizes[a] for a in batch_axes(mesh))


def _batch_slice(tree, mesh, global_batch: int):
    """Rank 0's slice of a whole batch."""
    return tree_map(lambda x: x[: _local_batch(mesh, global_batch)], tree)


def prepare_cell(cfg, shape, mesh, tcfg: TrainConfig, specs):
    """The cell's inputs on rank 0 as fake tensors (the params and state
    placed on the mesh) and its step: returns ``(fake_mode, run)``, where
    ``run()``, called under ``fake_mode``, runs the step once and returns
    its outputs."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.sharding.step import make_sharded_train_step, place_tree

    fm = FakeTensorMode(allow_non_fake_inputs=True)
    if shape.kind == "train":
        step = make_sharded_train_step(cfg, tcfg, mesh)
        params, state = _fake(specs["params"], fm), _fake(specs["state"], fm)
        batch = _fake(specs["batch"], fm)
        with fm:
            params, state = place_tree(params, mesh), place_tree(state, mesh)
        return fm, lambda: step(params, state, batch)
    with fm:
        params = place_tree(_fake(specs["params"], fm), mesh)
    if shape.kind == "prefill":
        step = make_prefill_step(cfg, max_len=shape.seq_len)
        batch = _batch_slice(_fake(specs["batch"], fm), mesh,
                             shape.global_batch)
        return fm, lambda: step(tree_map(whole, params), batch)
    step = make_serve_step(cfg)
    token = _batch_slice(_fake(specs["token"], fm), mesh, shape.global_batch)
    cache = _slice_cache_batch(
        {k: v for k, v in _fake(specs["cache"], fm).items() if k != "pos"},
        token.shape[0])
    with fm:  # a constant: the step reads the position on the host
        cache["pos"] = torch.tensor(0, dtype=torch.int32)
    return fm, lambda: step(tree_map(whole, params), token, cache)


def count_step(cfg, shape, mesh, tcfg: TrainConfig, specs) -> CostCounter:
    """One run of the cell's step on rank 0, counted (``CostCounter``)."""
    fm, run = prepare_cell(cfg, shape, mesh, tcfg, specs)
    with fm, CostCounter() as counted:
        out = run()
        del out
        gc.collect()
    return counted


def _slice_cache_batch(cache, b: int):
    """The cache's entries cut to the first ``b`` batch rows (period
    entries carry a leading ``n_periods`` axis)."""
    return {k: tree_map(lambda x, lead=k == "periods":
                        x[:, :b] if lead else x[:b], v)
            for k, v in cache.items()}


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               tcfg: TrainConfig = None, verbose: bool = True,
               causal_skip=None, skip_costs: bool = False,
               cfg_overrides: dict = None, tcfg_overrides: dict = None, *,
               config=None, shape_config=None, mesh_shape=None):
    """Count one cell.  For tests on a small fake world, ``config``
    replaces ``get_config(arch)`` (e.g. a smoke config), ``shape_config``
    ``SHAPES[shape_name]`` and ``mesh_shape`` the production mesh (e.g.
    (2, 2) over ("data", "model"))."""
    cfg = config or get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = shape_config or SHAPES[shape_name]
    if mesh_shape is not None:
        mesh_name = "x".join(str(s) for s in mesh_shape)
    else:
        mesh_name = "2x16x16" if multi_pod else "16x16"
    skip = cell_is_skipped(cfg, shape)
    if skip:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": skip}
    if causal_skip is None:
        causal_skip = shape.kind == "prefill"
    chips = math.prod(mesh_shape) if mesh_shape is not None \
        else (512 if multi_pod else 256)

    with fake_world(chips):
        if mesh_shape is not None:
            axes = ("data", "model") if len(mesh_shape) == 2 \
                else ("pod", "data", "model")
            mesh = make_mesh(mesh_shape, axes, devices=list(range(chips)),
                             device="cpu")
        else:
            mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        if tcfg is None:
            # the production step microbatches each rank's batch slice in
            # 8 where it divides (the reference: the global batch in 8)
            micro = 8 if shape.kind == "train" and _local_batch(
                mesh, shape.global_batch) % 8 == 0 else 1
            tcfg = TrainConfig(microbatches=micro, **(tcfg_overrides or {}))
        specs = input_specs(cfg, shape, tcfg)
        memory = _argument_bytes(cfg, shape, mesh, specs)
        shard_ctx.set_mesh(mesh, shape_rules(mesh, shape))
        try:
            t0 = time.time()
            prod = count_step(cfg, shape, mesh, tcfg, specs)
            t_full = time.time() - t0
            memory["temp_bytes_per_device"] = prod.peak_live_bytes
            result = {
                "arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "ok", "chips": chips,
                "compile_s": round(t_full, 1),
                "causal_skip": bool(causal_skip),
                "memory": memory,
                "memory_note": TEMP_NOTE,
                "raw_scan_costs": costs_of(prod),
            }
            if not skip_costs:
                attn_chunk = max(2048, shape.seq_len // 8) \
                    if shape.kind != "decode" else None
                cost_tcfg = dataclasses.replace(tcfg, microbatches=1)
                with runtime.cost_mode(causal_skip=causal_skip,
                                       attn_chunk=attn_chunk):
                    counted = count_step(cfg, shape, mesh, cost_tcfg, specs)
                costs = costs_of(counted)
                terms = terms_from(costs, cfg, shape, chips)
                result["roofline"] = terms.summary()
                result["cost_1p"] = None
                result["cost_2p"] = None
                result["cost_note"] = COST_NOTE
                if verbose:
                    print(f"[{arch} x {shape_name} x {mesh_name}] "
                          f"fake run {t_full:.0f}s")
                    print("  memory:", memory)
                    print("  terms: compute=%.4fs memory=%.4fs "
                          "collective=%.4fs -> %s (roofline frac %.3f)"
                          % (terms.t_compute, terms.t_memory,
                             terms.t_collective, terms.bottleneck,
                             terms.roofline_fraction))
            elif verbose:
                print(f"[{arch} x {shape_name} x {mesh_name}] fake run "
                      f"{t_full:.0f}s; memory:", memory)
        finally:
            shard_ctx.clear_mesh()
    return result


def _argument_bytes(cfg, shape, mesh, specs) -> dict:
    """Per-device bytes of the step's arguments and outputs, from the shard
    shapes of the reference's in/out shardings."""
    if shape.kind == "train":
        p_sh = param_sharding_tree(specs["params"], mesh)
        s_sh = param_sharding_tree(specs["state"], mesh)
        b_sh = data_sharding_tree(specs["batch"], mesh, shape.global_batch)
        args = (_shard_bytes(specs["params"], p_sh)
                + _shard_bytes(specs["state"], s_sh)
                + _shard_bytes(specs["batch"], b_sh))
        outs = (_shard_bytes(specs["params"], p_sh)
                + _shard_bytes(specs["state"], s_sh))
        alias = outs  # params and state are updated in place
    elif shape.kind == "prefill":
        from repro_torch.launch.inputs import abstract_cache

        p_sh = param_sharding_tree(specs["params"], mesh)
        b_sh = data_sharding_tree(specs["batch"], mesh, shape.global_batch)
        cache = abstract_cache(cfg, shape)
        args = (_shard_bytes(specs["params"], p_sh)
                + _shard_bytes(specs["batch"], b_sh))
        outs = _shard_bytes(cache, cache_sharding_tree(cache, mesh, cfg,
                                                       shape))
        alias = 0
    else:
        p_sh = param_sharding_tree(specs["params"], mesh)
        t_sh = data_sharding_tree(specs["token"], mesh, shape.global_batch)
        c_sh = cache_sharding_tree(specs["cache"], mesh, cfg, shape)
        cache_bytes = _shard_bytes(specs["cache"], c_sh)
        args = (_shard_bytes(specs["params"], p_sh)
                + _shard_bytes(specs["token"], t_sh) + cache_bytes)
        outs = alias = cache_bytes  # the cache is updated in place
    return {"argument_bytes_per_device": args,
            "output_bytes_per_device": outs,
            "temp_bytes_per_device": None,
            "alias_bytes_per_device": alias}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all",
                    help="arch id or 'all' (LM archs only)")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--skip-costs", action="store_true",
                    help="memory check only (no counted cost run)")
    ap.add_argument("--causal-skip", default=None,
                    choices=(None, "on", "off"),
                    help="override static causal block skipping in the "
                         "cost run")
    ap.add_argument("--tag", default="", help="artifact filename suffix")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    ap.add_argument("--cast-params", action="store_true",
                    help="cast f32 params to bf16 once per step")
    ap.add_argument("--remat-policy", default="nothing",
                    choices=("nothing", "dots"))
    ap.add_argument("--ssm-chunk", type=int, default=None,
                    help="override mamba2 SSD chunk length")
    ap.add_argument("--ssm-bf16", action="store_true",
                    help="bf16 intra-chunk SSD quadratic")
    args = ap.parse_args(argv)
    cfg_overrides = {}
    if args.ssm_chunk:
        cfg_overrides["ssm_chunk"] = args.ssm_chunk
    if args.ssm_bf16:
        cfg_overrides["ssm_bf16_intra"] = True
    tcfg_overrides = {}
    if args.cast_params:
        tcfg_overrides["cast_params_once"] = True
    if args.remat_policy != "nothing":
        tcfg_overrides["remat_policy"] = args.remat_policy

    archs = [a for a in ARCHS if a != "paper-gnn"] \
        if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    os.makedirs(args.out, exist_ok=True)
    causal_skip = None if args.causal_skip is None \
        else args.causal_skip == "on"

    failures = 0
    for arch in archs:
        for shape in shapes:
            mesh_name = "2x16x16" if args.multi_pod else "16x16"
            tag = f"{arch}_{shape}_{mesh_name}{args.tag}"
            path = os.path.join(args.out, tag + ".json")
            try:
                res = lower_cell(arch, shape, args.multi_pod,
                                 causal_skip=causal_skip,
                                 skip_costs=args.skip_costs,
                                 cfg_overrides=cfg_overrides or None,
                                 tcfg_overrides=tcfg_overrides or None)
            except Exception as e:  # a failure here is a bug in the system
                traceback.print_exc()
                res = {"arch": arch, "shape": shape, "mesh": mesh_name,
                       "status": "FAILED",
                       "error": f"{type(e).__name__}: {e}"}
                failures += 1
            with open(path, "w") as f:
                json.dump(res, f, indent=2)
            print(f"wrote {path} ({res['status']})", flush=True)
    if failures:
        raise SystemExit(f"{failures} cells FAILED")


if __name__ == "__main__":
    main()
