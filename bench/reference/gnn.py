"""GCN and GAT (paper §4; Kipf & Welling, arXiv:1609.02907; Veličković et
al., arXiv:1710.10903), dense, from the raw 0/1 adjacency.

- Adjacency: ``Â = D^-1/2 (A + I) D^-1/2`` with ``D`` the row sums of
  ``A + I`` (an entry of A on the diagonal becomes 2).
- GCN layer: ``H' = act(Â (H W))``; no ``act`` after the last layer; no
  bias.
- GAT layer (one head, the paper's K = 2 scores): ``h = H W``, ``e_ij =
  leaky_relu(h_i · a_src + h_j · a_dst, slope)`` on the pattern of ``A +
  I``, a softmax over each row's edges, ``H' = act(α h)``; no ``act`` after
  the last layer.  GAT's own paper uses 8 heads in its hidden layers; the
  paper this repository follows uses one.
- Training: the mean cross-entropy of all nodes, ``p -= lr * g``.

``act`` is the configuration's ``activation`` and ``slope`` its
``leaky_relu_slope``; ``check_config`` refuses any value this module does
not implement.  GAT's attention is computed ``chunk`` rows at a time so
that it fits.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from bench.reference.precision import matmul

Params = Dict[str, List[torch.Tensor]]
ACTIVATIONS = {"relu": torch.relu, "elu": F.elu}
# what every configuration of this family must state as it is: the one
# precision, initialisation and (absent) bias this module implements
FIXED = {"dtype": "float32", "tf32": False, "init": "he", "bias": False}
GAT_FIXED = {"heads": 1, "score_k": 2}


def check_config(cfg: dict) -> None:
    """Raise ``ValueError`` for a configuration this reference does not
    implement as stated."""
    if cfg.get("model") not in ("gcn", "gat"):
        raise ValueError(f"model must be 'gcn' or 'gat', got "
                         f"{cfg.get('model')!r}")
    fixed = dict(FIXED, **(GAT_FIXED if cfg["model"] == "gat" else {}))
    for key, want in fixed.items():
        if cfg.get(key) != want:
            raise ValueError(f"{cfg.get('name')}: {key} must be {want!r}, "
                             f"got {cfg.get(key)!r}")
    if cfg.get("activation") not in ACTIVATIONS:
        raise ValueError(f"{cfg.get('name')}: activation must be one of "
                         f"{sorted(ACTIVATIONS)}, got "
                         f"{cfg.get('activation')!r}")
    if cfg["model"] == "gat" and not isinstance(
            cfg.get("leaky_relu_slope"), (int, float)):
        raise ValueError(f"{cfg.get('name')}: GAT needs a number "
                         f"leaky_relu_slope")


def layer_widths(cfg: dict) -> List[int]:
    return [cfg["in_features"]] + [cfg["hidden"]] * (cfg["n_layers"] - 1) \
        + [cfg["n_classes"]]


def make_params(cfg: dict, generator: torch.Generator,
                device) -> Params:
    """Seeded He weights, drawn in one call on ``device``: ``w[i]`` of
    shape [d_i, d_i+1] (and GAT's ``a_src[i]``, ``a_dst[i]`` of shape
    [d_i+1, 1]), each scaled by 1/sqrt(its fan-in).  Both sides start from
    them."""
    dims = layer_widths(cfg)
    shapes = {"w": [(dims[i], dims[i + 1]) for i in range(cfg["n_layers"])]}
    if cfg["model"] == "gat":
        shapes["a_src"] = [(d, 1) for d in dims[1:]]
        shapes["a_dst"] = [(d, 1) for d in dims[1:]]
    total = sum(a * b for v in shapes.values() for a, b in v)
    flat = torch.randn(total, generator=generator, device=device)
    params, at = {}, 0
    for key, v in shapes.items():
        params[key] = []
        for a, b in v:
            params[key].append(flat[at:at + a * b].view(a, b)
                               / math.sqrt(a))
            at += a * b
    return params


def leaf_names(params: Params) -> List[str]:
    """``"w[0]"``-style names, keys in sorted order."""
    return [f"{k}[{i}]" for k in sorted(params)
            for i in range(len(params[k]))]


def leaves(params: Params) -> List[torch.Tensor]:
    return [p for k in sorted(params) for p in params[k]]


def normalized_adjacency(adj01: torch.Tensor) -> torch.Tensor:
    """``Â`` as a dense float32 matrix, built in place from ``adj01``."""
    a = adj01.to(torch.float32)
    a.diagonal().add_(1.0)
    dinv = a.sum(1).clamp_min(1e-12).rsqrt()
    return a.mul_(dinv[:, None]).mul_(dinv[None, :])


def attention_pattern(adj01: torch.Tensor) -> torch.Tensor:
    """The pattern of ``A + I`` (bool)."""
    patt = adj01.to(torch.bool).clone()
    patt.diagonal().fill_(True)
    return patt


def gcn_logits(cfg: dict, a_hat: torch.Tensor, params: Params,
               x: torch.Tensor, precision: str = "float32") -> torch.Tensor:
    act = ACTIVATIONS[cfg["activation"]]
    h = x
    n_layers = len(params["w"])
    for i, w in enumerate(params["w"]):
        h = matmul(a_hat, matmul(h, w, precision), precision)
        if i < n_layers - 1:
            h = act(h)
    return h


def gat_logits(cfg: dict, pattern: torch.Tensor, params: Params,
               x: torch.Tensor, precision: str = "float32",
               chunk: int = 2048) -> torch.Tensor:
    act, slope = ACTIVATIONS[cfg["activation"]], cfg["leaky_relu_slope"]
    h = x
    n = x.shape[0]
    n_layers = len(params["w"])
    for i, w in enumerate(params["w"]):
        h = matmul(h, w, precision)
        s_src = matmul(h, params["a_src"][i], precision)[:, 0]
        s_dst = matmul(h, params["a_dst"][i], precision)[:, 0]
        rows = []
        for r0 in range(0, n, chunk):
            e = F.leaky_relu(s_src[r0:r0 + chunk, None] + s_dst[None, :],
                             slope)
            e = e.masked_fill(~pattern[r0:r0 + chunk], float("-inf"))
            rows.append(matmul(torch.softmax(e, dim=1), h, precision))
        out = torch.cat(rows)
        h = act(out) if i < n_layers - 1 else out
    return h


def logits(cfg: dict, graph: torch.Tensor, params: Params, x: torch.Tensor,
           precision: str = "float32") -> torch.Tensor:
    """``graph`` is ``Â`` for GCN and the pattern of ``A + I`` for GAT."""
    forward = gcn_logits if cfg["model"] == "gcn" else gat_logits
    return forward(cfg, graph, params, x, precision)


def graph_operand(cfg: dict, adj01: torch.Tensor) -> torch.Tensor:
    return normalized_adjacency(adj01) if cfg["model"] == "gcn" \
        else attention_pattern(adj01)


@dataclasses.dataclass
class TrainRun:
    losses: List[float]            # each step's loss, before its update
    after_first: Dict[str, torch.Tensor]  # the parameters after step 1
    after_last: Dict[str, torch.Tensor]   # ... and after the last step


def train_steps(cfg: dict, graph: torch.Tensor, params0: Params,
                x: torch.Tensor, labels: torch.Tensor, *, lr: float,
                steps: int, precision: str = "float32",
                loss_of: Optional[Callable] = None,
                grad_scale: Optional[Dict[str, float]] = None) -> TrainRun:
    """``steps`` full-batch SGD steps from a copy of ``params0``.
    ``loss_of`` and ``grad_scale`` (a leaf's gradient times a factor)
    plant the control's faults."""
    loss_of = loss_of or F.cross_entropy
    grad_scale = grad_scale or {}
    params = {k: [p.detach().clone().requires_grad_(True) for p in v]
              for k, v in params0.items()}
    names, ps = leaf_names(params), leaves(params)
    losses, after_first = [], None
    for step in range(steps):
        loss = loss_of(logits(cfg, graph, params, x, precision), labels)
        grads = torch.autograd.grad(loss, ps)
        with torch.no_grad():
            for name, p, g in zip(names, ps, grads):
                p.sub_(lr * grad_scale.get(name, 1.0) * g)
        losses.append(float(loss.detach()))
        del loss, grads
        if step == 0:
            after_first = {n: p.detach().clone() for n, p in zip(names, ps)}
    return TrainRun(losses, after_first,
                    {n: p.detach().clone() for n, p in zip(names, ps)})
