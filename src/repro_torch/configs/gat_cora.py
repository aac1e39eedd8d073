"""GAT on Cora [arXiv:1710.10903; paper]."""
from repro_torch.configs.base import GNNConfig

CONFIG = GNNConfig(
    name="gat-cora", kind="gat",
    n_layers=2, d_hidden=8, n_heads=8, aggregator="attn",
    n_classes=7,
)

SMOKE = GNNConfig(
    name="gat-smoke", kind="gat",
    n_layers=2, d_hidden=4, n_heads=2, aggregator="attn",
    d_in=16, n_classes=3,
)
