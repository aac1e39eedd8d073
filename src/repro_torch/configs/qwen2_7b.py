"""Qwen2-7B — GQA, QKV bias [arXiv:2407.10671; hf]."""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="qwen2-7b",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab=152064,
    qkv_bias=True,
)

SMOKE = LMConfig(
    name="qwen2-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    qkv_bias=True, attn_q_chunk=32, attn_kv_chunk=32,
)
