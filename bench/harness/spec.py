"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration and a traffic mix.  The configuration
(``configs/<config>.json``) names the model's three modules by path: the
adapter to the program (``program``), the plain reference (``reference``)
and the operation counts (``work``).  The mix (``traffic/<mix>.json``)
names its window driver (``drivers/<driver>.py``) and, where it has one,
its graph generator (``graphs/<kind>.py``).  Every metric has a reader
(``metrics/<metric>.py``, or ``metrics/<base>.py`` for a metric named
``<base>.<suffix>``); every cell has its correctness limits
(``limits/<cell>.json``).  Adding any of them is adding a file.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SPEC_FILE = ROOT / "BENCHMARK.json"

NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT_RE = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
MODEL_MODULES = ("program", "reference", "work")


def valid_name(name) -> bool:
    return isinstance(name, str) and NAME_RE.fullmatch(name) is not None


def valid_unit(unit) -> bool:
    return isinstance(unit, str) and UNIT_RE.fullmatch(unit) is not None


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_module(path: Path, prefix: str) -> ModuleType:
    """Import one file of ``bench/`` by its path: by its module name where
    its path spells one (``bench/reference/gnn.py`` is
    ``bench.reference.gnn``), else under ``prefix`` and its stem (metric
    and graph files may carry dots and dashes in their names)."""
    path = path.resolve()
    if not path.is_file():
        raise FileNotFoundError(f"{path.relative_to(ROOT)} is missing")
    parts = path.relative_to(ROOT).with_suffix("").parts
    if all(p.isidentifier() for p in parts):
        return importlib.import_module(".".join(parts))
    mod_name = prefix + re.sub(r"\W", "_", path.stem)
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def bench_file(rel: str, what: str) -> Path:
    """A path that a configuration names, relative to the repository root
    and inside ``bench/``."""
    path = (ROOT / rel).resolve()
    if BENCH not in path.parents:
        raise ValueError(f"{what} {rel!r} is not a file under bench/")
    return path


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    end_to_end: bool
    bound: Optional[float] = None
    moves: Optional[str] = None
    layer: Optional[str] = None
    workloads: Optional[List[str]] = None

    def reader(self) -> ModuleType:
        """``metrics/<name>.py``; for ``<base>.<suffix>`` without a file
        of its own, the reader of its base name."""
        path = BENCH / "metrics" / f"{self.name}.py"
        if not path.is_file() and "." in self.name:
            path = BENCH / "metrics" / f"{self.name.split('.')[0]}.py"
        return load_module(path, "bench_metric_")


@dataclasses.dataclass
class Model:
    """The three modules a configuration names."""

    program: ModuleType    # the adapter to the system under test
    reference: ModuleType  # the plain reference, and the inputs it makes
    work: ModuleType       # the operation and byte counts


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]

    def model(self) -> Model:
        mods = {}
        for key in MODEL_MODULES:
            if key not in self.config:
                raise KeyError(f"configuration {self.config_name!r} names "
                               f"no {key!r} module")
            mods[key] = load_module(bench_file(self.config[key], key),
                                    f"bench_{key}_")
        return Model(**mods)

    def driver(self) -> ModuleType:
        return load_module(BENCH / "drivers"
                           / f"{self.traffic['driver']}.py", "bench_driver_")

    def graph_module(self) -> ModuleType:
        kind = self.traffic["graph"]["kind"]
        return load_module(BENCH / "graphs" / f"{kind}.py", "bench_graph_")

    def check(self) -> None:
        """Refuse a configuration or mix that a module does not implement
        (raises ``ValueError``), so that no value is taken and ignored."""
        model = self.model()
        for mod in (model.reference, model.program):
            mod.check_config(self.config)
        self.driver().check_traffic(self.traffic)


class Spec:
    """The parsed ``BENCHMARK.json``."""

    def __init__(self, data: dict):
        self.data = data
        self.configs = {c["name"]: c for c in data["configs"]}
        self.workloads = {w["name"]: w for w in data["workloads"]}
        self.end_to_end = [self._metric(m, True) for m in data["end_to_end"]]
        self.per_layer = [self._metric(m, False) for m in data["per_layer"]]

    @classmethod
    def load(cls, path: Path = SPEC_FILE) -> "Spec":
        return cls(load_json(path))

    @staticmethod
    def _metric(m: dict, e2e: bool) -> Metric:
        return Metric(name=m["name"], unit=m["unit"], better=m["better"],
                      source=m["source"], end_to_end=e2e,
                      bound=m.get("bound"), moves=m.get("moves"),
                      layer=m.get("layer"), workloads=m.get("workloads"))

    def cell_end_to_end(self, cell: str) -> List[Metric]:
        return [m for m in self.end_to_end
                if m.workloads is None or cell in m.workloads]

    def cell_per_layer(self, cell: str) -> List[Metric]:
        """Per-layer metrics read in ``cell``: those that list it, and
        those without a list whose end-to-end metric the cell reports."""
        reported = {m.name for m in self.cell_end_to_end(cell)}
        return [m for m in self.per_layer
                if (cell in m.workloads if m.workloads is not None
                    else m.moves in reported)]

    def cell(self, name: str, overrides: Optional[dict] = None) -> Cell:
        """The cell, its files read and checked; ``overrides`` (the tests'
        small sizes) are merged into its parts before the check."""
        if name not in self.workloads:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have: {', '.join(sorted(self.workloads))})")
        w = self.workloads[name]
        cfg_entry = self.configs[w["config"]]
        cell = Cell(
            name=name, config_name=w["config"], traffic_name=w["traffic"],
            chips=int(w["chips"]),
            config=load_json(ROOT / cfg_entry["file"]),
            traffic=load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
            limits=load_json(BENCH / "limits" / f"{name}.json"),
            end_to_end=self.cell_end_to_end(name),
            per_layer=self.cell_per_layer(name))
        for part, over in (overrides or {}).items():
            setattr(cell, part, merge(getattr(cell, part), over))
        cell.check()
        return cell


def merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and \
            isinstance(out.get(k), dict) else v
    return out
