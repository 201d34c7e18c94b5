"""paper-gnn — the paper's own application: a 3-layer GCN/GAT with hidden
size 128 and feature dim d=256 (paper §4.1: D=256, Fig 2: hidden 128),
running on synthetic random graphs via the SpMM/SDDMM substrate.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str = "paper-gnn"
    kind: str = "gcn"  # gcn | gat
    n_layers: int = 3
    in_features: int = 256  # paper's D
    hidden: int = 128  # paper Fig. 2 hidden channel size
    n_classes: int = 16
    # sparse-format knobs (the paper's myc / mcpp analogs)
    block_m: int = 64
    block_n: int = 64


CONFIG = GNNConfig()
SMOKE_CONFIG = GNNConfig(name="paper-gnn-smoke", in_features=32, hidden=16,
                         n_classes=4, block_m=16, block_n=16)
