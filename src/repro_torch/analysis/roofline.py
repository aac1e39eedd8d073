"""Two-term roofline of one NVIDIA H100 80GB HBM3 (SXM5) at its 700 W
power limit (counterpart of ``repro.analysis.roofline``).

    time = max(dot_flops / peak_bf16 + ew_ops / peak_int32, bytes / hbm_bw)

The reference derives its terms from compiled XLA HLO against TPU v5e
constants; the port keeps only the constants and the formula, and its
counts come from ``repro_torch.solve.cost``'s analytic model. One card
moves no collective bytes, so the reference's third (interconnect) term
is absent.

Sources, all for the SXM5 part at 700 W (a card set to a lower
``power.limit`` runs slower under load):

- ``hbm_bw``: 3.35 TB/s, NVIDIA's H100 data sheet (the constant
  ``chip_smoke.py`` divides every kernel's bytes by);
- ``peak_flops_bf16``: 989 TFLOP/s dense bf16 on the tensor cores, the
  same data sheet (without sparsity);
- ``peak_int32``: the data sheet lists no int32 rate. 132 SMs x 64 INT32
  lanes (the Hopper architecture whitepaper's per-SM count) x the
  1.98 GHz boost clock = 1.67e13 int32 operations per second. The MSF
  passes are integer compares, selects, shifts and casts, so their
  operations are charged here, not against the tensor cores.
"""
from __future__ import annotations

H100_SXM = dict(
    name="NVIDIA H100 80GB HBM3",
    power_limit_w=700.0,
    hbm_bw=3.35e12,  # B/s
    peak_flops_bf16=989e12,  # dense, tensor cores
    peak_int32=132 * 64 * 1.98e9,  # op/s, CUDA cores
)


def roofline_time_s(*, dot_flops: float, ew_ops: float, bytes_: float,
                    hw: dict = H100_SXM) -> float:
    """The least time the card could take for the work: the larger of the
    compute term and the memory term, in seconds."""
    compute = dot_flops / hw["peak_flops_bf16"] + ew_ops / hw["peak_int32"]
    return max(compute, bytes_ / hw["hbm_bw"])
