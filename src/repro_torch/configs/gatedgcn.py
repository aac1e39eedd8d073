"""GatedGCN [arXiv:2003.00982; paper]."""
from repro_torch.configs.base import GNNConfig

CONFIG = GNNConfig(
    name="gatedgcn", kind="gatedgcn",
    n_layers=16, d_hidden=70, aggregator="gated",
    n_classes=10,
)

SMOKE = GNNConfig(
    name="gatedgcn-smoke", kind="gatedgcn",
    n_layers=3, d_hidden=12, aggregator="gated",
    d_in=16, n_classes=4,
)
