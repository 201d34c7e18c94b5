"""``BENCHMARK.json`` against the contract's characters and limits, and
every file a cell names, found by name."""
import json
import re

import pytest

from bench.harness.spec import (BENCH, ROOT, SOURCES, Spec, load_json,
                                valid_name, valid_unit)

SPEC = load_json(ROOT / "BENCHMARK.json")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
LINE_RE = re.compile(r"[^\t\n\r]{1,200}")
PATH_RE = re.compile(r"[A-Za-z0-9_./-]{1,200}")
# a width may never be cut (the contract's list)
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "projection",
               "head", "expansion", "experts_per_token", "in_features",
               "n_classes")


def one_line(text) -> bool:
    return isinstance(text, str) and LINE_RE.fullmatch(text) is not None


def test_top_level_keys_and_command():
    assert set(SPEC) == TOP_KEYS
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH_RE.fullmatch(p) and not p.startswith("/") \
            and ".." not in p.split("/")
        assert not p.endswith("_torch")
    for word in SPEC["command"]:
        assert one_line(word)
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC).encode()) <= 64 * 1024


def test_run_seconds_fit_a_full_check_of_24_cells():
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    assert 1 <= len(SPEC["configs"]) <= 24
    used = {w["config"] for w in SPEC["workloads"]}
    files = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert valid_name(c["name"]) and c["name"] in used
        assert one_line(c["source"]) and one_line(c["why"])
        assert c["file"].startswith("bench/") and c["file"] not in files
        files.add(c["file"])
        assert (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert valid_name(key)
            assert not key.endswith(("_dim", "_rank"))
            assert not any(w in key for w in WIDTH_WORDS)


def test_workloads():
    assert 1 <= len(SPEC["workloads"]) <= 24
    pairs = set()
    four = 0
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for key in ("name", "config", "traffic"):
            assert valid_name(w[key])
        assert w["chips"] in (1, 4)
        four += w["chips"] == 4
        assert one_line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert four <= max(1, len(SPEC["workloads"]) // 4)


def test_metrics():
    names = set()
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    assert 1 <= len(SPEC["end_to_end"]) <= 16
    assert 1 <= len(SPEC["per_layer"]) <= 128
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and one_line(m["layer"])
        assert m["source"] in SOURCES
        for cell in m.get("workloads", []):
            moved = e2e[m["moves"]].get("workloads")
            assert moved is None or cell in moved
        layers.setdefault(m["layer"], []).append(m["name"])
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] \
                or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert valid_name(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert valid_unit(m["unit"])
        assert m["better"] in ("lower", "higher")
        for cell in m.get("workloads", []):
            assert cell in cells


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_reports_enough_and_finds_its_files(cell):
    spec = Spec.load()
    c = spec.cell(cell)  # config, traffic and limits files, by name
    e2e = {m.name for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(m.reader().read)
    assert callable(c.graph_module().draw)
    assert c.config["name"] == c.config_name
    assert (BENCH / "traffic" / f"{c.traffic_name}.json").is_file()
    assert c.limits["limits"]
    driver = c.driver()  # drivers/<driver>.py, named by the mix
    assert driver.__file__.endswith(f"/drivers/{c.traffic['driver']}.py")
    for attr in ("Loop", "check_traffic", "control", "VARIANTS"):
        assert hasattr(driver, attr), attr
    model = c.model()  # the modules the configuration names, by path
    for key in ("program", "reference", "work"):
        assert getattr(model, key).__file__.endswith(c.config[key])
    assert hasattr(model.program, "Program")
    for attr in ("make_params", "graph_operand", "logits", "train_steps"):
        assert hasattr(model.reference, attr), attr
    for attr in ("sparse_ops", "dense_ops"):
        assert hasattr(model.work, attr), attr


def _cell_of(config):
    return next(w["name"] for w in SPEC["workloads"]
                if w["config"] == config)


@pytest.mark.parametrize("config,key,value", [
    ("paper-gat", "heads", 8), ("paper-gat", "leaky_relu_slope", 0.1),
    ("paper-gat", "score_k", 4), ("paper-gat", "activation", "relu"),
    ("paper-gcn", "activation", "elu"), ("paper-gcn", "dtype", "bfloat16"),
    ("paper-gcn", "tf32", True), ("paper-gcn", "bias", True),
    ("paper-gcn", "init", "xavier"), ("paper-gcn", "model", "gin"),
    ("paper-gcn", "fuse", "yes")])
def test_a_configuration_the_harness_does_not_run_is_refused(config, key,
                                                             value):
    """No value of a configuration is taken and then ignored: what the
    reference or the port does not run as stated is refused."""
    with pytest.raises(ValueError):
        Spec.load().cell(_cell_of(config), {"config": {key: value}})


@pytest.mark.parametrize("traffic,key,value", [
    ("infer-s90", "clients", 2), ("infer-s90", "features", "pinned"),
    ("train-s90", "optimizer", "adam"), ("train-s90", "checked_steps", 0)])
def test_a_mix_the_driver_does_not_run_is_refused(traffic, key, value):
    cell = next(w["name"] for w in SPEC["workloads"]
                if w["traffic"] == traffic)
    with pytest.raises(ValueError):
        Spec.load().cell(cell, {"traffic": {key: value}})


def test_a_configuration_names_modules_under_bench_only():
    with pytest.raises(ValueError):
        Spec.load().cell(_cell_of("paper-gcn"),
                         {"config": {"reference": "src/repro/__init__.py"}})


def test_config_files_hold_the_paper_widths():
    from repro_torch.configs.paper_gnn import CONFIG

    for name in ("paper-gcn", "paper-gat"):
        cfg = load_json(BENCH / "configs" / f"{name}.json")
        for key in ("n_layers", "in_features", "hidden", "n_classes",
                    "block_m", "block_n"):
            assert cfg[key] == getattr(CONFIG, key), (name, key)
        assert cfg["dtype"] == "float32" and cfg["tf32"] is False


def test_bench_files_are_named_from_name_characters():
    for path in BENCH.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel
