"""Kimi K2 — trillion-param MoE (paper-table) [arXiv:2501.kimi2; unverified]."""
from repro_torch.configs.base import LMConfig, MoEConfig

CONFIG = LMConfig(
    name="kimi-k2-1t-a32b",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=2048, vocab=163840,
    moe=MoEConfig(n_experts=384, top_k=8),
    fsdp=True,  # 1T params: weights/opt-state must shard over dp too
    grad_accum=4,  # divides the remat activation stack (EXPERIMENTS §Perf K.3)
)

SMOKE = LMConfig(
    name="kimi-k2-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=64, vocab=512,
    moe=MoEConfig(n_experts=8, top_k=2),
    attn_q_chunk=32, attn_kv_chunk=32,
)
