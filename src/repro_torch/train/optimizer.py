"""AdamW + warmup-cosine schedule + global-norm clipping (the port of
``repro.train.optimizer``).

Optimizer state trees mirror the parameter tree, so whatever placement
the params carry (``repro_torch.sharding``: FSDP over ``data``, TP over
``model``) the moments inherit, ZeRO-style.

The update is the reference's formula, term for term
(``p - lr * (m̂ / (√v̂ + eps) + wd * p)``, bias corrections in f32), not
``torch.optim.AdamW`` (which places eps and the decay otherwise).  Where
the reference's train loop donates the params and moments to its jitted
step, :func:`adamw_update` writes the new values into their own storage:
at gemma3-4b's 3.88 B f32 parameters a second copy of the params or of a
moment does not fit on one 80 GB card beside the first.  Each leaf is
updated in slices of at most ``_CHUNK`` elements, so the temporaries stay
small; the update is elementwise, so the slices do not change its bits.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from repro_torch.tree import tree_leaves, tree_map

# elements a slice of one leaf's update (256 MiB of f32 temporaries each)
_CHUNK = 1 << 26


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    clip_norm: float = 1.0


def schedule(step, cfg: OptConfig):
    """The learning rate at ``step`` (a tensor), as an f32 tensor."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init_opt_state(params) -> Dict[str, Any]:
    """Zero f32 moments beside each leaf, and ``step`` an int32 0-d tensor
    on the params' device."""
    zeros = lambda t: tree_map(  # noqa: E731
        lambda x: torch.zeros_like(x, dtype=torch.float32), t)
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return {"m": zeros(params), "v": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree):
    """√(Σ over the leaves, in the reference's order, of Σ x²) in f32."""
    total = 0.0
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def _clip_scale(norm, max_norm: float):
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """``(grads * scale, norm)`` with ``scale = min(1, max_norm /
    max(norm, 1e-12))``; a new tree."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g * scale, grads), norm


def _update_(p, g, m, v, *, scale, lr, bc1, bc2, cfg: OptConfig):
    """One leaf's AdamW update, written into ``p``, ``m`` and ``v``."""
    b1, b2 = cfg.beta1, cfg.beta2
    # views, so the writes land in the leaves (raises if one is not
    # contiguous); the gradient is only read
    pf, mf, vf = (t.view(-1) for t in (p, m, v))
    gf = g.reshape(-1)
    for i in range(0, pf.numel(), _CHUNK):
        sl = slice(i, i + _CHUNK)
        gi = gf[sl].float() * scale  # the clip, as the reference's g * scale
        mi, vi = mf[sl], vf[sl]
        mi.mul_(b1).add_(gi * (1 - b1))  # b1 m + (1 - b1) g
        gi.mul_(1 - b2).mul_(gf[sl].float() * scale)  # (1 - b2) g g
        vi.mul_(b2).add_(gi)
        del gi
        upd = mi / bc1  # m̂
        upd.div_((vi / bc2).sqrt_().add_(cfg.eps))  # m̂ / (√v̂ + eps)
        pi = pf[sl]
        p32 = pi if pi.dtype == torch.float32 else pi.float()
        upd.add_(p32 * cfg.weight_decay).mul_(lr)
        if p32 is pi:
            pi.sub_(upd)
        else:
            pi.copy_(p32 - upd)


def adamw_update(params, grads, state, cfg: OptConfig, *, grad_norm=None):
    """AdamW step: returns ``(params, state, {"lr", "grad_norm"})``.

    The params' and moments' tensors are updated in place (the returned
    trees hold the same tensors; ``state["step"]`` is advanced in place
    too).  ``grad_norm``: the global norm of the whole gradients when
    ``grads`` are one rank's shards of them (the sharded step); computed
    from ``grads`` otherwise.
    """
    step = state["step"]
    step.add_(1)
    lr = schedule(step, cfg)
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = _clip_scale(gnorm, cfg.clip_norm)
    stepf = step.float()
    bc1 = 1 - torch.pow(cfg.beta1, stepf)
    bc2 = 1 - torch.pow(cfg.beta2, stepf)
    with torch.no_grad():
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state["m"]),
                              tree_leaves(state["v"])):
            _update_(p, g, m, v, scale=scale, lr=lr, bc1=bc1, bc2=bc2,
                     cfg=cfg)
    return params, {"m": state["m"], "v": state["v"], "step": step}, \
        {"lr": lr, "grad_norm": gnorm}
