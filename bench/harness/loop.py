"""What every window driver (``drivers/<driver>.py``) is handed and hands
back, and the set-up that the graph drivers share.

A driver module has:

- ``check_traffic(traffic)``: raise ``ValueError`` for a parameter it does
  not implement;
- ``Loop(ctx)``: set-up (inputs from the seed, the program's object, the
  warm-up in ``warm_up()``), then ``window(seconds, tracer) -> Window``,
  ``free_program()``, ``readings()`` (the numbers that decide ``correct``,
  once the window has closed) and ``shape`` (the run's size, as the
  configuration's ``work`` module counts it);
- ``VARIANTS`` and ``control(ctx, variant)``: the control's and the planted
  faults' readings (``bench/control.py``), with no program.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from bench.harness.device import Device, generator
from bench.harness.spec import Cell, Model


@dataclasses.dataclass
class Context:
    cell: Cell
    seed: int
    dev: Device
    model: Model
    program: Optional[Any] = None  # ``model.program.Program()``; None in
    #                                the control, which runs no program

    @property
    def cfg(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    def generator(self, stream: str) -> torch.Generator:
        return generator(self.seed, stream, self.dev.device)


@dataclasses.dataclass
class Window:
    op: str                   # what a unit is, as ``work`` counts it:
    #                           "infer" (a request) or "train" (a step)
    units: int                # requests or steps completed
    window_s: float
    items: int = 0            # nodes classified (served requests)
    latencies_ms: List[float] = dataclasses.field(default_factory=list)
    call_span: str = ""       # the span around each call into the program


@dataclasses.dataclass
class GraphInputs:
    """What the benchmark drew from the seed, handed to both sides."""

    adj01_host: Any           # the raw 0/1 adjacency (numpy bool, host)
    n: int
    nnz: int                  # nonzeros of A + I
    params: Dict[str, List[torch.Tensor]]  # the weights as made
    graph: Any = None         # the program's packed graph

    @property
    def shape(self) -> dict:
        return {"n": self.n, "nnz": self.nnz}

    def reference_graph(self, ctx: Context) -> torch.Tensor:
        adj01 = torch.from_numpy(self.adj01_host).to(ctx.dev.device)
        return ctx.model.reference.graph_operand(ctx.cfg, adj01)


def graph_inputs(ctx: Context) -> GraphInputs:
    """The mix's graph drawn on the device from the seed (its generator is
    ``graphs/<kind>.py``), packed by the program where there is one
    (set-up), and the weights made by the reference's ``make_params``."""
    dev = ctx.dev.device
    adj01 = ctx.cell.graph_module().draw(
        ctx.traffic["graph"], generator=ctx.generator("graph"), device=dev)
    n = adj01.shape[0]
    nnz = int(adj01.sum()) + n - int(adj01.diagonal().sum())
    adj01_host = adj01.cpu().numpy()
    del adj01
    graph = None if ctx.program is None else \
        ctx.program.build_graph(adj01_host, ctx.cfg, dev)
    params = ctx.model.reference.make_params(
        ctx.cfg, ctx.generator("weights"), dev)
    return GraphInputs(adj01_host, n, nnz, params, graph)


def clone_params(params):
    return {k: [p.detach().clone() for p in v] for k, v in params.items()}


def snapshot(params) -> Dict[str, torch.Tensor]:
    return {f"{k}[{i}]": p.detach().clone() for k in sorted(params)
            for i, p in enumerate(params[k])}
