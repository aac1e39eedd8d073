"""Command-R 35B — GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01; unverified]."""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="command-r-35b",
    n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22528, vocab=256000,
)

SMOKE = LMConfig(
    name="command-r-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    attn_q_chunk=32, attn_kv_chunk=32,
)
