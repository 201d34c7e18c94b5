"""The train step on a mesh: the port's counterpart of the reference's
``jax.jit(train_step, in_shardings=(params, state, batch),
out_shardings=...)`` under ``set_mesh`` (``tests/test_distributed.py``,
``tests/test_elastic.py``).

The params and the optimizer state live as ``DTensor``s placed by
``param_sharding_tree`` (FSDP over ``data``, TP over ``model``, the
moments also over ``pod``; :func:`place_tree`).  Each step
  1. gathers the params whole on every rank,
  2. runs ``train.loop.make_grad_fn``'s loss and gradients on this rank's
     slice of the batch (split over ``pod`` / ``data`` when that divides
     it; the ranks of one batch slice hold the same slice),
  3. averages the gradients and the loss over the batch axes (steps
     1-3 are :func:`make_sharded_grad_fn`),
  4. compresses the whole gradients (``train.loop.compress_gradients``,
     the residual gathered whole and written back to its shards), takes
     their global norm, and updates this rank's own shards of the params
     and moments in place (``adamw_update`` with the whole gradients'
     norm).
The per-slice means average to the whole batch's mean when every slice
weighs the same (an equal mask count, as ``data.pipeline``'s batches
have).  The reference's partitioner sums in its own order, so the two
agree within reduction-order noise, not bit for bit.
"""
from __future__ import annotations

import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding.specs import (axis_group, axis_index, axis_sizes,
                                        batch_axes, batch_divides, local,
                                        local_shard, param_sharding_tree,
                                        whole)
from repro_torch.tree import tree_leaves, tree_map


def _shard_of(full, like):
    """This rank's part of ``full`` as ``like`` (a DTensor) holds it."""
    if hasattr(like, "placements"):
        return local_shard(full, like.device_mesh, like.placements)
    return full


def place_tree(tree, mesh):
    """``tree`` (whole tensors, the same on every rank) as ``DTensor``s
    placed by ``param_sharding_tree`` (params or optimizer state) on the
    mesh's device."""
    return tree_map(lambda x, s: s.place(x.to(mesh.device_type)), tree,
                    param_sharding_tree(tree, mesh))


def make_sharded_grad_fn(cfg: ModelConfig, tcfg, mesh):
    """Returns ``grads(params, batch) -> (loss, grads)`` for params placed
    by :func:`place_tree` and a whole batch (the same on every rank): steps
    1-3 above, the whole gradients and the loss averaged over the batch
    axes, the same on every rank.  Every rank of the mesh calls it."""
    from repro_torch.train.loop import make_grad_fn

    grad_fn = make_grad_fn(cfg, tcfg)
    bax = batch_axes(mesh)
    sizes = axis_sizes(mesh)
    nb = 1
    for a in bax:
        nb *= sizes[a]
    group = axis_group(mesh, bax) if nb > 1 else None

    def grads(params, batch):
        global_batch = tree_leaves(batch)[0].shape[0]
        if group is not None and batch_divides(mesh, global_batch):
            i = axis_index(mesh, bax)
            batch = tree_map(lambda x: x.reshape(
                (nb, global_batch // nb) + tuple(x.shape[1:]))[i], batch)
        loss, g = grad_fn(tree_map(whole, params), batch)
        if group is not None:  # the mean over the batch axes
            for t in tree_leaves(g) + [loss]:
                dist.all_reduce(t, group=group)
                t.div_(nb)
        return loss, g

    return grads


def make_sharded_train_step(cfg: ModelConfig, tcfg, mesh):
    """Returns ``step(params, state, batch) -> (params, state, metrics)``
    for params and state placed by :func:`place_tree` (updated in place
    and returned) and a whole batch (the same on every rank).  Every rank
    of the mesh calls it."""
    from repro_torch.train.loop import compress_gradients
    from repro_torch.train.optimizer import adamw_update, global_norm

    grad_fn = make_sharded_grad_fn(cfg, tcfg, mesh)

    def step(params, state, batch):
        loss, grads = grad_fn(params, batch)
        full = tree_map(whole, {k: v for k, v in state.items()
                                if k != "opt"})
        grads, full = compress_gradients(grads, full, tcfg)
        for k, tree in full.items():  # e.g. the residual: back to shards
            tree_map(lambda w, d: local(d).copy_(_shard_of(w, d)), tree,
                     state[k])
        gnorm = global_norm(grads)
        _, _, opt_metrics = adamw_update(
            tree_map(local, params), tree_map(_shard_of, grads, params),
            tree_map(local, state["opt"]), tcfg.opt, grad_norm=gnorm)
        return params, state, {"loss": loss, **opt_metrics}

    return step
