"""MeshGraphNet [arXiv:2010.03409; unverified]."""
from repro_torch.configs.base import GNNConfig

CONFIG = GNNConfig(
    name="meshgraphnet", kind="meshgraphnet",
    n_layers=15, d_hidden=128, aggregator="sum", mlp_layers=2,
    d_out=3,
)

SMOKE = GNNConfig(
    name="meshgraphnet-smoke", kind="meshgraphnet",
    n_layers=2, d_hidden=16, aggregator="sum", mlp_layers=2,
    d_in=8, d_out=3,
)
