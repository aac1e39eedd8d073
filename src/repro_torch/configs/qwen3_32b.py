"""Qwen3-32B — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf]."""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="qwen3-32b",
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8,
    d_ff=25600, vocab=151936,
    head_dim=128, qk_norm=True,
)

SMOKE = LMConfig(
    name="qwen3-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    head_dim=32, qk_norm=True, attn_q_chunk=32, attn_kv_chunk=32,
)
