"""Static configuration of the contract-and-filter pipeline.

Leaf module, imported by the coarsening engine and the solve spec layer
alike, so it imports neither.
"""
from __future__ import annotations

import dataclasses

#: Every segment-min backend request the port understands, in its own
#: vocabulary ("torch" = the plain version, "cuda" = the hand-written
#: kernel). "sorted" selects the sorted-segment kernel at the dedupe and
#: degrades to "auto" at the flat sites (the hook reductions).
SEGMIN_BACKENDS = (None, "auto", "torch", "cuda", "sorted")

#: Edge-dedupe backends: "device" = the sort + pack32 segment-min
#: pipeline, "host" = the numpy lexsort twin, "auto" = "device" on a CUDA
#: graph and "host" elsewhere.
DEDUPE_BACKENDS = ("auto", "device", "host")


def resolve_dedupe(dedupe: str, backend: str) -> str:
    """``dedupe="auto"`` → the device pipeline on CUDA, the numpy lexsort
    twin elsewhere."""
    if dedupe != "auto":
        return dedupe
    return "device" if backend == "cuda" else "host"


@dataclasses.dataclass(frozen=True)
class CoarsenConfig:
    """Static knobs of the contract-and-filter pipeline (hashable)."""

    rounds_per_level: int = 2  # K hook+shortcut rounds per level
    cutoff: int = 2048  # hand off to the flat solve when n ≤ cutoff
    max_levels: int = 16
    pack: bool | None = None  # pack32 level kernels; None = auto-detect
    segmin: str | None = None  # packed segment-min backend request
    dedupe: str = "auto"
    fused: bool = False  # one call per level instead of separate stages

    def __post_init__(self):
        if self.rounds_per_level < 1:
            raise ValueError("rounds_per_level must be >= 1")
        if self.cutoff < 1:
            raise ValueError("cutoff must be >= 1")
        if self.max_levels < 1:
            raise ValueError("max_levels must be >= 1")
        if self.dedupe not in DEDUPE_BACKENDS:
            raise ValueError(f"unknown dedupe backend {self.dedupe!r}")
        if self.segmin not in SEGMIN_BACKENDS:
            raise ValueError(
                f"unknown segmin backend {self.segmin!r} "
                f"(expected one of {SEGMIN_BACKENDS})"
            )
