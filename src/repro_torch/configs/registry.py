"""--arch <id> registry. One module per assigned architecture."""
from __future__ import annotations

import importlib

ARCHS = (
    "llama4-scout-17b-a16e",
    "llama4-maverick-400b-a17b",
    "nemotron-4-15b",
    "granite-20b",
    "qwen1.5-110b",
    "gemma3-4b",
    "mamba2-2.7b",
    "recurrentgemma-2b",
    "internvl2-26b",
    "whisper-small",
    "paper-gnn",  # the paper's own application (GCN/GAT)
)

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_")
            for a in ARCHS}


def _load(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCHS}")
    return importlib.import_module(_MODULES[arch])


def get_config(arch: str):
    return _load(arch).CONFIG


def get_smoke_config(arch: str):
    return _load(arch).SMOKE_CONFIG
