"""Roofline terms on NVIDIA H100 80GB HBM3 (SXM5) cards at their 700 W
power limit (counterpart of ``repro.analysis.roofline``).

One card (``roofline_time_s``, the plan cost model's):

    time = max(dot_flops / peak_bf16 + ew_ops / peak_int32, bytes / hbm_bw)

One rank of a mesh (``roofline``, the dry run's three terms):

    compute    = sum over dtypes of FLOPs / that dtype's peak, + ew_ops / peak_int32
    memory     = bytes / hbm_bw
    collective = sum over axis sets of collective bytes / the link that set crosses

The reference derives its terms from compiled XLA HLO against TPU v5e
constants. The port's counts come from ``repro_torch.solve.cost``'s
analytic model (the MSF) or from running one rank's program on meta
tensors (``repro_torch.launch.cells``).

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
- ``peak_flops``: the data sheet's dense rate per dtype of a matmul's
  inputs: 989 TFLOP/s for bf16 and fp16 on the tensor cores, 67 TFLOP/s
  for float32 outside them (PyTorch leaves TF32 off for float32 matmuls
  by default), 67 TFLOP/s for float64 on the tensor cores.
- ``nvlink_bw``: 450 GB/s each way between two cards of one 8-GPU HGX
  H100 node (NVLink 4: the data sheet's 900 GB/s counts both directions).
- ``nic_bw``: 50 GB/s each way for a card whose group leaves its node:
  one 400 Gb/s NDR InfiniBand adapter per card, the DGX H100 layout.
- ``gpus_per_node``: 8 (HGX/DGX H100). Ranks fill nodes in row-major
  order, so a 16-way ``model`` axis already spans two nodes.

A collective's time is charged as its bytes over the link of the slowest
hop its group makes, with no pipelining across axes: the reference's
model (one ``ici_bw`` for every collective), with the link chosen per
axis set.
"""
from __future__ import annotations

H100_SXM = dict(
    name="NVIDIA H100 80GB HBM3",
    power_limit_w=700.0,
    hbm_bw=3.35e12,  # B/s
    peak_flops_bf16=989e12,  # dense, tensor cores
    peak_int32=132 * 64 * 1.98e9,  # op/s, CUDA cores
    peak_flops={"bfloat16": 989e12, "float16": 989e12, "float32": 67e12, "float64": 67e12},
    nvlink_bw=450e9,  # B/s each way, inside one 8-GPU node
    nic_bw=50e9,  # B/s each way, 400 Gb/s NDR per card, across nodes
    gpus_per_node=8,
)


def roofline_time_s(*, dot_flops: float, ew_ops: float, bytes_: float,
                    hw: dict = H100_SXM) -> float:
    """The least time the card could take for the work: the larger of the
    compute term and the memory term, in seconds."""
    compute = dot_flops / hw["peak_flops_bf16"] + ew_ops / hw["peak_int32"]
    return max(compute, bytes_ / hw["hbm_bw"])


def link_of(mesh, axes) -> str:
    """``"nvlink"`` if this rank's group over ``axes`` (a tuple of names)
    lies in one node of ``H100_SXM["gpus_per_node"]`` row-major ranks,
    else ``"nic"``."""
    idx = {mesh.axis_names.index(a) for a in axes}
    group = mesh.devices[tuple(slice(None) if i in idx else c
                               for i, c in enumerate(mesh.coords))]
    nodes = {int(r) // H100_SXM["gpus_per_node"] for r in group.reshape(-1)}
    return "nvlink" if len(nodes) == 1 else "nic"


def collective_bytes(counts) -> float:
    """Bytes per device of the collectives a
    :meth:`repro_torch.launch.mesh.Mesh.count_collectives` counter (or any
    mapping of axis set to bytes) recorded: the reference's
    ``collective_bytes``, operand bytes of all-reduces and reduce-scatters
    and result bytes of all-gathers."""
    return float(sum(counts.values()))


def roofline(counts: dict, *, n_devices: int, model_flops: float | None = None,
             hw: dict = H100_SXM) -> dict:
    """The reference's roofline record of one rank from ``counts``:
    ``flops`` ({dtype: FLOPs}), ``ew_ops`` (int32 operations),
    ``bytes``, ``collective`` ({axis set: bytes}), ``links`` ({axis set:
    "nvlink" or "nic"}), ``dynamic_loops``, ``arg_bytes``,
    ``temp_bytes`` and ``output_bytes``. The reference's ``xla_*``
    fields cross-check its HLO parse against ``cost_analysis()``; the port
    reads no compiled program, so it has none."""
    flops = float(sum(counts["flops"].values()))
    t_compute = sum(f / hw["peak_flops"][dt] for dt, f in counts["flops"].items())
    t_compute += counts.get("ew_ops", 0) / hw["peak_int32"]
    t_memory = counts["bytes"] / hw["hbm_bw"]
    bw = {"nvlink": hw["nvlink_bw"], "nic": hw["nic_bw"]}
    t_collective = sum(b / bw[counts["links"][k]] for k, b in counts["collective"].items())
    terms = dict(compute=t_compute, memory=t_memory, collective=t_collective)
    dominant = max(terms, key=terms.get)
    out = dict(
        flops_per_device=flops + counts.get("ew_ops", 0),
        bytes_per_device=float(counts["bytes"]),
        collective_bytes_per_device=collective_bytes(counts["collective"]),
        t_compute_s=t_compute,
        t_memory_s=t_memory,
        t_collective_s=t_collective,
        dominant=dominant,
        bound_time_s=max(terms.values()),
        dynamic_loops=int(counts.get("dynamic_loops", 0)),
        arg_bytes_per_device=int(counts["arg_bytes"]),
        temp_bytes_per_device=int(counts["temp_bytes"]),
        output_bytes_per_device=int(counts["output_bytes"]),
    )
    if model_flops:
        out["model_flops"] = float(model_flops)
        out["useful_flops_ratio"] = float(model_flops) / max(out["flops_per_device"] * n_devices,
                                                             1.0)
        # the useful work's share of bf16 peak if the step ran at its bound
        out["roofline_fraction"] = (
            float(model_flops) / n_devices / hw["peak_flops_bf16"]
        ) / max(out["bound_time_s"], 1e-30)
    return out
