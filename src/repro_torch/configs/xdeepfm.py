"""xDeepFM (CIN) [arXiv:1803.05170; paper]. Criteo-scale embedding tables."""
from repro_torch.configs.base import RecsysConfig

CONFIG = RecsysConfig(
    name="xdeepfm",
    n_sparse=39, embed_dim=10,
    cin_layers=(200, 200, 200), mlp_layers=(400, 400),
    total_vocab=120_000_000,  # Criteo-scale; rows shard over `model`
)

SMOKE = RecsysConfig(
    name="xdeepfm-smoke",
    n_sparse=8, embed_dim=4,
    cin_layers=(8, 8), mlp_layers=(16, 16),
    total_vocab=2048,
)
