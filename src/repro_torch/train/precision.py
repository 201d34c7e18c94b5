"""How exact the first training step's gradients are, on one card: the
trainer's gradients and ``chip_smoke.py``'s dense f32 autograd oracle,
each against the same oracle in f64, on ``chip_smoke.py``'s graphs (a)
and (b) at the paper's width, for GCN and GAT.

    PYTHONPATH=src python -m repro_torch.train.precision

Run from the repository root: it takes the graphs, the seeds and the
dense oracles (``oracle_logits``, ``gat_oracle``) from ``chip_smoke.py``,
with TF32 off.  Per parameter it prints max|want| in f64 and both f32
results' largest distance from it; per GAT layer, the rows whose scores
mix signs (only there does leaky relu's slope vary within a row, so only
they give d a_src anything: a softmax does not depend on a row's shift)
and the spread of the layer's h about its mean (the smaller, the more
the rule's dα - rowdot cancels).  Exits 2 without a card.
"""
from __future__ import annotations

import sys

import numpy as np
import torch


def gat_layer_stats(pattern: torch.Tensor, params, x: torch.Tensor,
                    chunk: int = 2048) -> None:
    """Print, per layer of the dense GAT, its mixed-sign rows and the
    spread of h (the layer's forward in ``x``'s dtype, no grad)."""
    n, h = x.shape[0], x
    with torch.no_grad():
        for i, w in enumerate(params["w"]):
            h = h @ w
            s_src = (h @ params["a_src"][i])[:, 0]
            s_dst = (h @ params["a_dst"][i])[:, 0]
            out, mixed = torch.empty_like(h), 0
            for r0 in range(0, n, chunk):
                mask = pattern[r0:r0 + chunk]
                raw = s_src[r0:r0 + chunk, None] + s_dst[None, :]
                lo = torch.where(mask, raw, float("inf")).amin(1)
                hi = torch.where(mask, raw, -float("inf")).amax(1)
                mixed += int(((lo < 0) & (hi >= 0)).sum())
                e = torch.where(mask, torch.nn.functional.leaky_relu(
                    raw, 0.2), -1e30)
                p = torch.where(mask, torch.exp(e - e.amax(1, keepdim=True)),
                                0.0)
                out[r0:r0 + chunk] = (p / p.sum(1, keepdim=True)) @ h
            mean = h.mean(0)
            spread = float((h - mean).pow(2).mean().sqrt()
                           / mean.abs().mean())
            print(f"  layer {i}: rows whose scores mix signs {mixed} of {n}; "
                  f"rms(h - mean) / mean|h| {spread:.3e}")
            h = torch.nn.functional.elu(out) \
                if i < len(params["w"]) - 1 else out


def probe_graph(cs, port, label: str, adj: np.ndarray) -> None:
    """Both models' first-step gradients on one graph."""
    from repro_torch.train import gnn as train

    n = adj.shape[0]
    graph = port.gnn.build_graph(adj, port.cfg, device="cuda")
    x = torch.from_numpy(np.random.default_rng(cs.SEED).standard_normal(
        (n, port.cfg.in_features)).astype(np.float32)).cuda()
    labels = torch.from_numpy(train.planted_labels(
        n, port.cfg.n_classes)).cuda()
    a_dense = torch.from_numpy(cs.normalized_dense(np, adj)).cuda()
    pattern = a_dense != 0
    for kind in ("gcn", "gat"):
        params = train.init_params(kind, port.cfg, seed=cs.SEED)
        loss, _, grads = train.loss_and_grads(params, graph, x, labels,
                                              kind=kind)
        loss32, grads32, _ = cs.oracle_grads(torch, port, kind, a_dense,
                                             pattern, params, x, labels)
        own = {k: [p.detach().double().requires_grad_(True) for p in v]
               for k, v in params.items()}
        logits = cs.oracle_logits(torch, a_dense.double(), own, x.double()) \
            if kind == "gcn" else cs.gat_oracle(torch, pattern, own,
                                                x.double())
        loss64 = torch.nn.functional.cross_entropy(logits, labels)
        grads64 = torch.autograd.grad(
            loss64, [p for _, p in train.named_parameters(own)])
        del logits
        print(f"({label}) {kind.upper()}: loss {float(loss):.10f}, f32 oracle "
              f"{loss32:.10f}, f64 oracle {loss64.item():.12f}")
        for (name, got), want32, want in zip(
                train.named_parameters(grads), grads32, grads64):
            scale = float(want.abs().max())
            e32 = float((want32.double() - want).abs().max())
            e_port = float((got.double() - want).abs().max())
            print(f"  {name}: max|want| {scale:.3e}; f32 oracle off by "
                  f"{e32:.3e}, the trainer by {e_port:.3e}")
        if kind == "gat":
            gat_layer_stats(pattern, {k: [p.detach() for p in v]
                                      for k, v in own.items()}, x.double())
        del params, grads, grads32, grads64, own
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("precision: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ".")
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    port = cs.Port()
    port.build.build()
    print(cs.card_line())
    n = cs.N_NODES
    rng = np.random.default_rng(cs.SEED)
    probe_graph(cs, port, "a: uniform density 0.1",
                (rng.random((n, n), dtype=np.float32) < 0.1)
                .astype(np.float32))
    probe_graph(cs, port, f"b: random_graph({n}, 16, seed=1)",
                port.random_graph(n, 16, seed=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
