"""Mixtral 8x7B — 8 experts top-2, SWA [arXiv:2401.04088; hf]."""
from repro_torch.configs.base import LMConfig, MoEConfig

CONFIG = LMConfig(
    name="mixtral-8x7b",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=32000,
    sliding_window=4096,
    moe=MoEConfig(n_experts=8, top_k=2),
)

SMOKE = LMConfig(
    name="mixtral-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96, vocab=512,
    sliding_window=32, moe=MoEConfig(n_experts=4, top_k=2),
    attn_q_chunk=32, attn_kv_chunk=32,
)
