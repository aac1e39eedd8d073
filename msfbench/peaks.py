"""Published peaks of the card the benchmark runs on (NVIDIA's data sheet,
H100 SXM, dense rates, at the full 700 W power limit)."""

H100_SXM = dict(
    name="NVIDIA H100 80GB HBM3",
    power_limit_w=700.0,
    hbm_bytes_per_s=3.35e12,
    bf16_flops_per_s=989e12,
    fp32_flops_per_s=67e12,
    memory_bytes=80e9,
)
