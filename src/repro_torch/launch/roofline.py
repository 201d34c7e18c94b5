"""Roofline terms of one step, from what a counting run recorded (the port
of ``repro.launch.roofline``).

Three terms per (arch x shape x mesh) cell, all in seconds, for one
NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet):

  compute    = FLOPs_per_chip / PEAK_FLOPS    (989 TFLOP/s bf16 dense, H100 SXM)
  memory     = bytes_per_chip / HBM_BW        (3.35 TB/s, H100 SXM)
  collective = collective_bytes_per_chip / ICI_BW
                                              (450 GB/s each way over NVLink)

The reference reads XLA's ``cost_analysis()`` and the optimized HLO of a
compiled executable.  The port runs eagerly and has no HLO: a
:class:`CostCounter` records one step as it runs (under
``FakeTensorMode`` in ``launch.dryrun``, so nothing is allocated):

  * FLOPs from ``torch.utils.flop_counter.FlopCounterMode`` (the matmuls,
    convolutions and attention products PyTorch counts);
  * bytes as the input and output bytes of every dispatched op (views
    and in-place aliases move nothing and are not counted);
  * collectives as the result bytes of every ``_c10d_functional`` /
    ``c10d`` collective, by op, under the reference's names
    (``all-gather``, ``all-reduce``, ...); all-reduce is weighted 2x
    (ring reduce-scatter + all-gather traffic), as the reference does.

Every op runs as often as the step runs it (Python loops, no loop bodies
counted once), so no 1-period / 2-period extrapolation is needed;
``extrapolate`` is kept for the reference's formula.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, Iterable, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

PEAK_FLOPS = 989e12  # bf16 dense / chip (NVIDIA H100 SXM, 700 W)
HBM_BW = 3.35e12  # B/s / chip (NVIDIA H100 SXM)
# the reference's name (a TPU's ICI link); here NVLink's rate each way
ICI_BW = 450e9  # B/s each way over NVLink (NVIDIA H100 SXM)

# c10d op name (either namespace) -> the reference's HLO collective name
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "_allgather_base_": "all-gather",
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "send_": "collective-permute",
}


def _tensors(tree):
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _nbytes(x: torch.Tensor) -> int:
    x = getattr(x, "_local_tensor", x)  # a DTensor: this rank's part
    return x.numel() * x.element_size()


def _collective(func) -> str:
    """The reference's name of a c10d collective op, or ''."""
    ns = func.namespace
    if ns not in ("_c10d_functional", "c10d", "c10d_functional"):
        return ""
    return _COLLECTIVES.get(func._schema.name.split("::")[-1], "")


class CostCounter:
    """Records a run's FLOPs, op bytes, collective results and the peak of
    live op-output bytes; a context manager (``with CostCounter() as c``).

    ``records`` lists ``(collective, result bytes)`` in call order;
    ``peak_live_bytes`` is the most bytes that op outputs (not views, not
    in-place aliases) held alive at once, with the arguments not counted:
    the port's analog of XLA's ``temp_size_in_bytes``."""

    def __init__(self):
        from torch.utils.flop_counter import FlopCounterMode

        self.flop_mode = FlopCounterMode(display=False)
        self.bytes = 0
        self.records = []
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self._ops = _OpCounter(self)

    def __enter__(self):
        self.flop_mode.__enter__()
        self._ops.__enter__()
        return self

    def __exit__(self, *exc):
        self._ops.__exit__(*exc)
        self.flop_mode.__exit__(*exc)
        return False

    @property
    def flops(self) -> int:
        return self.flop_mode.get_total_flops()

    def _freed(self, n: int) -> None:
        self.live_bytes -= n


class _OpCounter(TorchDispatchMode):
    def __init__(self, owner: CostCounter):
        super().__init__()
        self.owner = owner

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        c = self.owner
        name = _collective(func)
        outs = _tensors(out)
        if name:
            c.records.append((name, sum(_nbytes(t) for t in outs)))
        aliased = func.is_view or any(
            r.alias_info is not None for r in func._schema.returns)
        if aliased:
            return out
        c.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs))) \
            + sum(_nbytes(t) for t in outs)
        for t in outs:
            n = _nbytes(t)
            c.live_bytes += n
            weakref.finalize(t, c._freed, n)
        c.peak_live_bytes = max(c.peak_live_bytes, c.live_bytes)
        return out


def collective_bytes(records: Iterable[Tuple[str, int]]) -> Dict[str, int]:
    """Per-op-type result bytes of the recorded collectives."""
    out: Dict[str, int] = {}
    for op, b in records:
        out[op] = out.get(op, 0) + b
    return out


def weighted_collective_bytes(per_op: Dict[str, float]) -> float:
    w = {"all-reduce": 2.0}
    return sum(b * w.get(op, 1.0) for op, b in per_op.items())


def costs_of(counter: CostCounter) -> Dict:
    """Raw per-device cost terms of one counted run."""
    return {
        "flops": float(counter.flops),
        "bytes": float(counter.bytes),
        "coll": {k: float(v)
                 for k, v in collective_bytes(counter.records).items()},
    }


def extrapolate(c1: Dict, c2: Dict, n_periods: int) -> Dict:
    """cost(n) = c1 + (n-1)*(c2-c1), per term (c1/c2 = 1/2-period costs)."""
    k = n_periods - 1
    ops = set(c1["coll"]) | set(c2["coll"])
    return {
        "flops": c1["flops"] + k * (c2["flops"] - c1["flops"]),
        "bytes": c1["bytes"] + k * (c2["bytes"] - c1["bytes"]),
        "coll": {op: c1["coll"].get(op, 0.0)
                 + k * (c2["coll"].get(op, 0.0) - c1["coll"].get(op, 0.0))
                 for op in ops},
    }


@dataclasses.dataclass
class RooflineTerms:
    flops_per_chip: float
    bytes_per_chip: float
    collective_bytes_per_chip: float
    per_op_collectives: Dict[str, float]
    chips: int
    model_flops: float  # 6·N_active·tokens (train) etc.

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_chip / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_chip / ICI_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flop_fraction(self) -> float:
        """MODEL_FLOPS / total counted flops (catches remat/redundancy
        waste)."""
        total = self.flops_per_chip * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute time / bound step time: how close the cell runs
        to the machine roofline if perfectly overlapped."""
        t_useful = self.model_flops / self.chips / PEAK_FLOPS
        t = self.roofline_time
        return t_useful / t if t else 0.0

    def summary(self) -> Dict:
        return {
            "flops_per_chip": self.flops_per_chip,
            "bytes_per_chip": self.bytes_per_chip,
            "collective_bytes_per_chip": self.collective_bytes_per_chip,
            "per_op_collectives": self.per_op_collectives,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_flop_fraction": self.useful_flop_fraction,
            "roofline_fraction": self.roofline_fraction,
            "chips": self.chips,
        }


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N_active per train token, 2·N_active per inference
    token (decode processes global_batch tokens per step)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch


def terms_from(costs: Dict, cfg, shape, chips: int) -> RooflineTerms:
    return RooflineTerms(
        flops_per_chip=costs["flops"],
        bytes_per_chip=costs["bytes"],
        collective_bytes_per_chip=weighted_collective_bytes(costs["coll"]),
        per_op_collectives=costs["coll"],
        chips=chips,
        model_flops=model_flops_for(cfg, shape),
    )


def analyze(counter: CostCounter, cfg, shape, chips: int) -> RooflineTerms:
    """The terms of one counted run."""
    return terms_from(costs_of(counter), cfg, shape, chips)
