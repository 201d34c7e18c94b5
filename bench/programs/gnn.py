"""The system under test for the GCN and GAT configurations:
``repro_torch``'s graph packing, serving engine, training step and kernel
build.  ``programs/`` is the only folder of the benchmark that imports the
port, and takes from it nothing of its arithmetic.

``check_config`` refuses what the port does not run as stated: it has one
GAT head, the K = 2 scores, a LeakyReLU slope of 0.2, ELU between GAT
layers and ReLU between GCN layers (the fused epilogue), float32 with TF32
off, and no bias in these parameters.
"""
from __future__ import annotations

from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
# the port builds its kernels at a fixed path inside the checkout; the
# benchmark hands it that same path
BUILD_DIR = ROOT / "build" / "repro_torch"

PORT_RUNS = {
    "gcn": {"activation": "relu"},
    "gat": {"activation": "elu", "leaky_relu_slope": 0.2, "heads": 1,
            "score_k": 2},
}
PORT_RUNS_ALL = {"dtype": "float32", "tf32": False, "bias": False}


def check_config(cfg: dict) -> None:
    """Raise ``ValueError`` where the configuration states what the port
    does not run."""
    model = cfg.get("model")
    if model not in PORT_RUNS:
        raise ValueError(f"the port serves 'gcn' or 'gat', got {model!r}")
    for key, want in {**PORT_RUNS_ALL, **PORT_RUNS[model]}.items():
        if cfg.get(key) != want:
            raise ValueError(f"{cfg.get('name')}: the port's {model} runs "
                             f"{key} = {want!r}, the configuration states "
                             f"{cfg.get(key)!r}")
    if not isinstance(cfg.get("fuse"), bool):
        raise ValueError(f"{cfg.get('name')}: fuse must be true or false")


class Program:
    def __init__(self):
        from repro_torch.configs.paper_gnn import GNNConfig
        from repro_torch.kernels import _build
        from repro_torch.models import gnn
        from repro_torch.serve import engine
        from repro_torch.train import gnn as train

        _build.BUILD_DIR = BUILD_DIR
        self._build, self._gnn, self._engine, self._train = \
            _build, gnn, engine, train
        self.GNNConfig = GNNConfig

    def build_kernels(self) -> None:
        """Every kernel source at once (``nvcc`` in parallel); a no-op
        once the libraries are there."""
        self._build.build()

    def gnn_config(self, cfg: dict):
        return self.GNNConfig(
            name=cfg["name"], kind=cfg["model"], n_layers=cfg["n_layers"],
            in_features=cfg["in_features"], hidden=cfg["hidden"],
            n_classes=cfg["n_classes"], block_m=cfg["block_m"],
            block_n=cfg["block_n"])

    def build_graph(self, adj01_host, cfg: dict, device):
        """The port packs the raw 0/1 adjacency itself (normalisation,
        Block-ELL and CSR forms): that is part of set-up."""
        return self._gnn.build_graph(adj01_host, self.gnn_config(cfg),
                                     device=device)

    def engine(self, params, graph, cfg: dict):
        scfg = self._engine.GNNServeConfig(model=cfg["model"],
                                           fuse=cfg["fuse"])
        return self._engine.GNNServingEngine(params, graph, scfg)

    def trainable(self, params):
        return self._train.trainable(params)

    def train_step(self, params, graph, x, labels, cfg: dict, lr: float):
        """One SGD step; returns the loss before it (a device tensor)."""
        loss, _ = self._train.train_step(params, graph, x, labels,
                                         kind=cfg["model"], lr=lr,
                                         fuse=cfg["fuse"])
        return loss
