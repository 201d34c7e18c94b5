"""Training step + loop with microbatching, compression, checkpoints (the
port of ``repro.train.loop``).

The step runs eagerly: the microbatches are a Python loop (the
reference's ``jax.lax.scan``) accumulating f32 gradients in the same
order, and AdamW writes the params and moments in place (the reference's
jitted step donates them; ``train.optimizer``).  ``make_train_step`` is
the single-device step; ``repro_torch.sharding.step`` runs it on a mesh.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.transformer import compute_dtype, lm_loss
from repro_torch.resilience import chaos
from repro_torch.resilience.errors import FATAL, classify
from repro_torch.train.grad_compress import (compress_int8, compress_topk_ef,
                                             init_residual)
from repro_torch.train.optimizer import OptConfig, adamw_update, init_opt_state
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    microbatches: int = 1  # grad accumulation steps per optimizer step
    compression: str = "none"  # none | int8 | topk_ef
    topk_frac: float = 0.05
    aux_weight: float = 0.01
    remat: bool = True
    remat_policy: str = "nothing"  # nothing | dots (save dot outputs)
    # cast f32 master params to the compute dtype ONCE at step entry (inside
    # autograd, so the gradients reach the f32 masters)
    cast_params_once: bool = False
    compute_dtype: str = "bfloat16"


def init_train_state(params, tcfg: TrainConfig):
    state = {"opt": init_opt_state(params)}
    if tcfg.compression == "topk_ef":
        state["residual"] = init_residual(params)
    return state


def train_state_from_numpy(tree, device="cuda"):
    """The reference's train state (``init_train_state``'s tree, each leaf
    ``np.asarray``-ed) as the same tree of tensors on ``device``, dtypes
    kept (f32 moments and residual, the int32 step); the counterpart of
    ``models.transformer.lm_params_from_numpy``."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(dev), tree)


def make_grad_fn(cfg: ModelConfig, tcfg: TrainConfig,
                 loss_fn: Optional[Callable] = None):
    """Returns ``grads(params, batch) -> (loss, grads)``: the loss (a 0-d
    f32 tensor) and the gradients of every floating leaf, summed over the
    microbatches in f32 and divided by their count."""
    loss_fn = loss_fn or (
        lambda p, b: lm_loss(p, cfg, b, aux_weight=tcfg.aux_weight,
                             remat=tcfg.remat,
                             remat_policy=tcfg.remat_policy))
    if tcfg.cast_params_once:
        base_loss = loss_fn
        cdt = compute_dtype(tcfg.compute_dtype)

        def loss_fn(p, b):  # noqa: F811
            pc = tree_map(lambda x: x.to(cdt) if x.is_floating_point()
                          else x, p)
            return base_loss(pc, b)

    def value_and_grad(params, batch):
        leaves = tree_leaves(params)
        live = [x.is_floating_point() for x in leaves]
        with torch.enable_grad():
            it = iter(x.detach().requires_grad_(f)
                      for x, f in zip(leaves, live))
            p = tree_map(lambda _: next(it), params)
            loss = loss_fn(p, batch)
            wrt = [x for x, f in zip(tree_leaves(p), live) if f]
            gs = iter(torch.autograd.grad(loss, wrt))
        return loss.detach(), tree_map(
            lambda x: next(gs) if x.is_floating_point()
            else torch.zeros_like(x), params)

    def grads(params, batch):
        nm = tcfg.microbatches
        if nm == 1:
            return value_and_grad(params, batch)
        loss = torch.zeros((), dtype=torch.float32,
                           device=tree_leaves(params)[0].device)
        acc = tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                       params)
        for i in range(nm):
            mb = tree_map(lambda x: x.reshape(
                (nm, x.shape[0] // nm) + tuple(x.shape[1:]))[i], batch)
            loss_i, g = value_and_grad(params, mb)
            loss = loss + loss_i
            for a, gi in zip(tree_leaves(acc), tree_leaves(g)):
                a.add_(gi.float())
            del g
        for a in tree_leaves(acc):
            a.div_(nm)
        return loss / nm, acc

    return grads


def compress_gradients(grads, state, tcfg: TrainConfig):
    """The chosen compression: returns ``(grads, state)`` (a new state
    dict, its ``residual`` advanced under ``topk_ef``)."""
    state = dict(state)
    if tcfg.compression == "int8":
        grads = compress_int8(grads)
    elif tcfg.compression == "topk_ef":
        grads, state["residual"] = compress_topk_ef(
            grads, state["residual"], tcfg.topk_frac)
    return grads, state


def apply_gradients(params, state, grads, tcfg: TrainConfig):
    """The chosen compression, then AdamW in place; returns ``(params,
    state, {"lr", "grad_norm"})``."""
    grads, state = compress_gradients(grads, state, tcfg)
    params, state["opt"], opt_metrics = adamw_update(
        params, grads, state["opt"], tcfg.opt)
    return params, state, opt_metrics


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    loss_fn: Optional[Callable] = None):
    """Returns train_step(params, state, batch) -> (params, state, metrics).

    Microbatching: batch's leading dim is split into ``tcfg.microbatches``
    slices; grads are accumulated in f32 before the (single) optimizer
    update.  The params' and optimizer state's tensors are updated in
    place and returned.
    """
    grad_fn = make_grad_fn(cfg, tcfg, loss_fn)

    def train_step(params, state, batch):
        loss, grads = grad_fn(params, batch)
        params, state, opt_metrics = apply_gradients(params, state, grads,
                                                     tcfg)
        return params, state, {"loss": loss, **opt_metrics}

    return train_step


def _host_copy(tree):
    return tree_map(lambda x: x.detach().cpu().clone(), tree)


def train_loop(params, state, train_step, data_iter, n_steps: int, *,
               log_every: int = 10, checkpointer=None, ckpt_every: int = 0,
               health=None, callback=None, data_factory=None,
               max_recoveries: int = 0) -> Dict[str, Any]:
    """Host-side loop: timing, straggler detection, periodic checkpoints.

    Crash recovery: with a ``checkpointer``, ``data_factory`` and
    ``max_recoveries > 0``, an exception escaping a step restores
    params/state from the newest intact checkpoint, rewinds the data
    stream with ``data_factory(restored_step)`` (a fresh iterator
    positioned at that step), and replays: deterministic data plus a
    deterministic step function reconverge to the same final params.
    With no checkpoint published yet, recovery restarts from the initial
    params/state (step 0, host copies taken before the first step).  A
    ``FATAL`` error (a ``KernelError`` among them) is never retried.
    Each recovery counts in ``resilience_recoveries_total{site="train"}``;
    the total is returned under ``"recoveries"``.
    """
    can_recover = (checkpointer is not None and data_factory is not None
                   and max_recoveries > 0)
    if can_recover:
        # keep the step-0 state restorable before the first checkpoint
        # (the step writes the params and moments in place)
        init_snapshot = _host_copy((params, state))
        devices = tree_map(lambda x: x.device, (params, state))
    history = []
    recoveries = 0
    step = 0
    while step < n_steps:
        try:
            chaos.hook("train.step", step=step)
            batch = next(data_iter)
            t0 = time.perf_counter()
            with obs.span("train.step", step=step):
                params, state, metrics = train_step(params, state, batch)
                loss = float(metrics["loss"])  # blocks; keeps timing honest
        except Exception as exc:  # noqa: BLE001 — classified below
            if not can_recover or recoveries >= max_recoveries \
                    or classify(exc) == FATAL:
                raise
            recoveries += 1
            obs.counter("resilience_recoveries_total", site="train").inc()
            checkpointer.wait()  # let any in-flight save publish
            restored = checkpointer.latest_step()
            if restored is None:
                restored = 0
                params, state = tree_map(lambda x, d: x.to(d, copy=True),
                                         init_snapshot, devices)
            else:
                tree = checkpointer.restore(
                    {"params": params, "state": state})
                params, state = tree["params"], tree["state"]
            data_iter = data_factory(restored)
            history = [h for h in history if h["step"] < restored]
            step = restored
            continue
        dt = time.perf_counter() - t0
        obs.histogram("train_step_ms").observe(dt * 1e3)
        obs.gauge("train_loss").set(loss)
        if health is not None and health.record(step, dt):
            obs.counter("train_stragglers_total").inc()
        if step % log_every == 0:
            history.append({"step": step, "loss": loss, "time_s": dt})
        if checkpointer is not None and ckpt_every and \
                (step + 1) % ckpt_every == 0:
            checkpointer.save(step + 1, {"params": params, "state": state})
        if callback is not None:
            callback(step, params, state, metrics)
        step += 1
    return {"params": params, "state": state, "history": history,
            "recoveries": recoveries}
