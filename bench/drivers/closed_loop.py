"""``closed_loop``: one client of a served node classifier, which sends its
next request when the last one has returned.

Each request is the program's ``engine.infer(x)`` followed by a
synchronisation; its latency runs on the host's clock from the call to the
synchronisation's return.  ``x`` comes in turn from a pool of ``pool``
seeded feature matrices (n × ``in_features``) made in set-up, where
``features`` says: ``device``, resident in device memory, or ``host``, in
pageable host memory, so that each request copies its features to the
card.  ``warmup`` requests run in set-up.  A seeded reservoir keeps the
outputs of ``sample`` requests drawn evenly from the whole window; the
reference recomputes each from the same features once the window has
closed (``logit_gap``).  ``graph`` names the graph generator and its
parameters.
"""
from __future__ import annotations

import random
import time
from typing import Dict, List

import torch

from bench.harness.check import logit_gap
from bench.harness.device import sub_seed
from bench.harness.loop import Context, Window, clone_params, graph_inputs
from bench.harness.trace import WINDOW_SPAN, Tracer

FEATURES = ("device", "host")
CALL_SPAN = "bench.infer"
VARIANTS = ("control",)


def check_traffic(t: dict) -> None:
    for key in ("pool", "warmup", "sample", "graph"):
        if key not in t:
            raise ValueError(f"closed_loop: the mix gives no {key!r}")
    if t.get("clients", 1) != 1:
        raise ValueError("closed_loop drives one client, got "
                         f"clients={t['clients']!r}")
    if t.get("features", "device") not in FEATURES:
        raise ValueError(f"closed_loop: features must be one of "
                         f"{FEATURES}, got {t['features']!r}")


def feature_pool(ctx: Context, n: int) -> torch.Tensor:
    """The requests' feature matrices, [pool, n, in_features], drawn on
    the device in one call (and moved to the host where the mix says)."""
    pool = torch.randn((ctx.traffic["pool"], n, ctx.cfg["in_features"]),
                       generator=ctx.generator("features"),
                       device=ctx.dev.device)
    if ctx.traffic.get("features", "device") == "host":
        pool = pool.cpu()
    return pool


class Loop:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.inputs = graph_inputs(ctx)
        self.shape = self.inputs.shape
        self.pool = feature_pool(ctx, self.inputs.n)
        self.engine = ctx.program.engine(clone_params(self.inputs.params),
                                         self.inputs.graph, ctx.cfg)
        self.inputs.graph = None
        self.sample_size = int(ctx.traffic["sample"])
        self.rng = random.Random(sub_seed(ctx.seed, "sample"))
        self.kept: List[tuple] = []  # (request, pool index, logits)

    def warm_up(self) -> None:
        """``warmup`` requests, their outputs held as the reservoir will
        hold the window's, so the allocator has cached the blocks."""
        n = max(int(self.ctx.traffic["warmup"]), self.sample_size + 1)
        outs = [self.engine.infer(self.pool[i % len(self.pool)])
                for i in range(n)]
        self.ctx.dev.sync()
        del outs

    def _keep(self, i: int, k: int, out: torch.Tensor) -> None:
        if len(self.kept) < self.sample_size:
            self.kept.append((i, k, out))
        else:
            j = self.rng.randrange(i + 1)
            if j < self.sample_size:
                self.kept[j] = (i, k, out)

    def window(self, seconds: float, tracer: Tracer) -> Window:
        dev, pool = self.ctx.dev, self.pool
        lat: List[float] = []
        i = 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        with tracer.span(WINDOW_SPAN):
            while True:
                k = i % len(pool)
                with tracer.span("bench.request"):
                    a = time.perf_counter()
                    with tracer.span(CALL_SPAN):
                        out = self.engine.infer(pool[k])
                    with tracer.span("bench.sync"):
                        dev.sync()
                    b = time.perf_counter()
                lat.append((b - a) * 1e3)
                self._keep(i, k, out)
                i += 1
                if b >= deadline:
                    break
        return Window("infer", i, time.perf_counter() - t0,
                      items=i * self.inputs.n, latencies_ms=lat,
                      call_span=CALL_SPAN)

    def free_program(self) -> None:
        self.engine = None

    def readings(self) -> Dict[str, float]:
        ctx = self.ctx
        graph = self.inputs.reference_graph(ctx)
        want: Dict[int, torch.Tensor] = {}
        worst = 0.0
        for _, k, out in sorted(self.kept, key=lambda r: r[1]):
            if k not in want:
                with torch.no_grad():
                    want[k] = ctx.model.reference.logits(
                        ctx.cfg, graph, self.inputs.params,
                        self.pool[k].to(ctx.dev.device))
            worst = max(worst, logit_gap(out, want[k]))
        return {"logit_gap": worst}


def control(ctx: Context, variant: str) -> Dict[str, float]:
    """The reference in TF32 in the program's place, over every matrix of
    the pool, against the reference in float32."""
    if variant not in VARIANTS:
        raise ValueError(f"closed_loop: no variant {variant!r}")
    inputs = graph_inputs(ctx)
    graph = inputs.reference_graph(ctx)
    logits = ctx.model.reference.logits
    worst = 0.0
    with torch.no_grad():
        for x in feature_pool(ctx, inputs.n):
            x = x.to(ctx.dev.device)
            want = logits(ctx.cfg, graph, inputs.params, x)
            got = logits(ctx.cfg, graph, inputs.params, x, "tf32")
            worst = max(worst, logit_gap(got, want))
    return {"logit_gap": worst}
