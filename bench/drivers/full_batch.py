"""``full_batch``: full-batch training steps of a node classifier
(``optimizer``: ``sgd``, at ``lr``) on seeded features and labels resident
on the card.

Set-up builds the one trainer (the program's parameters, graph and data)
and runs its first ``checked_steps`` steps through the window's own call:
they warm every shape, and they are the steps the check follows.  The
window then drives that same trainer, steps dispatched back to back and
one synchronisation at its end.  ``graph`` names the graph generator and
its parameters.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from bench.harness.check import train_readings
from bench.harness.loop import (Context, Window, clone_params, graph_inputs,
                                snapshot)
from bench.harness.trace import WINDOW_SPAN, Tracer

CALL_SPAN = "bench.train_step"
# the control, and faults planted in the reference put in the program's
# place: the loss's mean over half of the nodes, the first layer's
# gradient doubled where it is produced
VARIANTS = ("control", "half_batch", "leaf_doubled")


def check_traffic(t: dict) -> None:
    for key in ("lr", "checked_steps", "graph"):
        if key not in t:
            raise ValueError(f"full_batch: the mix gives no {key!r}")
    if t.get("optimizer", "sgd") != "sgd":
        raise ValueError("full_batch runs the program's SGD step only, got "
                         f"optimizer={t['optimizer']!r}")
    if int(t["checked_steps"]) < 1:
        raise ValueError("full_batch: checked_steps must be 1 or more")


def train_data(ctx: Context, n: int):
    """The trainer's features [n, in_features] and labels [n]."""
    dev = ctx.dev.device
    x = torch.randn((n, ctx.cfg["in_features"]),
                    generator=ctx.generator("features"), device=dev)
    labels = torch.randint(0, ctx.cfg["n_classes"], (n,),
                           generator=ctx.generator("labels"), device=dev)
    return x, labels


class Loop:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.inputs = graph_inputs(ctx)
        self.shape = self.inputs.shape
        self.x, self.labels = train_data(ctx, self.inputs.n)
        self.lr = float(ctx.traffic["lr"])
        self.params = ctx.program.trainable(
            clone_params(self.inputs.params))
        self.losses: List[float] = []
        self.first: Optional[Dict[str, torch.Tensor]] = None
        self.last: Optional[Dict[str, torch.Tensor]] = None

    def step(self):
        return self.ctx.program.train_step(
            self.params, self.inputs.graph, self.x, self.labels,
            self.ctx.cfg, self.lr)

    def warm_up(self) -> None:
        for s in range(int(self.ctx.traffic["checked_steps"])):
            self.losses.append(float(self.step()))
            if s == 0:
                self.first = snapshot(self.params)
        self.last = snapshot(self.params)
        self.ctx.dev.sync()

    def window(self, seconds: float, tracer: Tracer) -> Window:
        steps = 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        with tracer.span(WINDOW_SPAN):
            while True:
                with tracer.span(CALL_SPAN):
                    self.step()
                steps += 1
                if time.perf_counter() >= deadline:
                    break
            with tracer.span("bench.sync"):
                self.ctx.dev.sync()
        return Window("train", steps, time.perf_counter() - t0,
                      call_span=CALL_SPAN)

    def free_program(self) -> None:
        self.params = self.inputs.graph = None

    def readings(self) -> Dict[str, float]:
        ctx = self.ctx
        ref = ctx.model.reference.train_steps(
            ctx.cfg, self.inputs.reference_graph(ctx), self.inputs.params,
            self.x, self.labels, lr=self.lr,
            steps=int(ctx.traffic["checked_steps"]))
        return train_readings(snapshot(self.inputs.params), self.first,
                              self.last, self.losses, ref.after_first,
                              ref.after_last, ref.losses, self.lr)


def control(ctx: Context, variant: str) -> Dict[str, float]:
    """A variant of the reference in the program's place, against the
    reference in float32."""
    if variant not in VARIANTS:
        raise ValueError(f"full_batch: no variant {variant!r}")
    inputs = graph_inputs(ctx)
    graph = inputs.reference_graph(ctx)
    x, labels = train_data(ctx, inputs.n)
    lr = float(ctx.traffic["lr"])
    steps = int(ctx.traffic["checked_steps"])
    train_steps = ctx.model.reference.train_steps
    kw = dict(lr=lr, steps=steps)
    ref = train_steps(ctx.cfg, graph, inputs.params, x, labels, **kw)
    if variant == "control":
        kw["precision"] = "tf32"
    elif variant == "half_batch":
        half = inputs.n // 2
        kw["loss_of"] = lambda lg, lb: F.cross_entropy(lg[:half], lb[:half])
    else:
        kw["grad_scale"] = {"w[0]": 2.0}
    got = train_steps(ctx.cfg, graph, inputs.params, x, labels, **kw)
    return train_readings(snapshot(inputs.params), got.after_first,
                          got.after_last, got.losses, ref.after_first,
                          ref.after_last, ref.losses, lr)
