"""Declarative solver specification — the single front door.

``SolveSpec`` is a frozen, hashable description of *which* MSF engine to
run (``mode``) and *how* (backend knobs). It has the fields and static
validation of ``repro.solve.spec.SolveSpec``; every built-in mode has an
engine (``repro_torch.solve.engines``).

This module is also the single home of the backend auto-detect rules.
Where the JAX package keys on ``jax.default_backend() == "tpu"``, the
port keys on the target graph's device type being ``"cuda"``:

- :func:`auto_pack` / :func:`weights_packable` — the pack32 regime test
  (integral weights in [0, 255], 24-bit indices);
- :func:`resolve_dedupe` — ``dedupe="auto"`` → device on CUDA, host
  elsewhere;
- :func:`resolve_flat_segmin` — segment-min selection for flat
  (unsorted-segment) reductions, via ``repro_torch.kernels.ops``;
- :func:`resolve_level_segmins` — the coarsening levels' hook and dedupe
  segment-mins.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.coarsen.config import (
    DEDUPE_BACKENDS,
    SEGMIN_BACKENDS,
    CoarsenConfig,
)
from repro_torch.core.semiring import PACK_IDX_MASK

MODES = ("flat", "coarsen", "dist", "stream")
OBS_MODES = ("off", "metrics", "trace")
TUNING_MODES = ("off", "db", "measure")
#: Modes added by ``repro_torch.solve.register_engine`` beyond the built-ins.
EXTRA_MODES: set = set()
VARIANTS = ("complete", "paper", "pairwise")
FLAT_SHORTCUTS = (None, "complete", "csp", "os")
DIST_SHORTCUTS = (None, "csp", "os", "baseline")


# ---------------------------------------------------------------------------
# backend auto-detect rules
# ---------------------------------------------------------------------------

def weights_packable(w) -> bool:
    """The pack32 weight regime: integral values in [0, 255] (paper §VII)."""
    w = torch.as_tensor(w).to(torch.float64)
    if w.numel() == 0:
        return True
    ok = torch.all(w == torch.floor(w)) & (w.min() >= 0) & (w.max() <= 255)
    return bool(ok)


def auto_pack(w, eid, valid, e_capacity: int) -> bool:
    """pack32 applies when weights are integral in [0, 255] and both the
    global eids and the per-level position indices fit 24 bits strictly."""
    if e_capacity >= PACK_IDX_MASK:
        return False
    valid = torch.as_tensor(valid).to(torch.bool)
    wv = torch.as_tensor(w)[valid]
    if wv.numel() == 0:
        return True
    if not weights_packable(wv):
        return False
    return int(torch.as_tensor(eid)[valid].max()) < PACK_IDX_MASK


def resolve_dedupe(dedupe: str, backend: str) -> str:
    """``dedupe="auto"`` → the device pipeline on CUDA, the numpy lexsort
    twin elsewhere."""
    if dedupe != "auto":
        return dedupe
    return "device" if backend == "cuda" else "host"


def resolve_flat_segmin(segmin: str | None, pack: bool, device_type: str = "cuda"):
    """Packed segment-min callable for a *flat* reduction site (the MSF
    hook loop — unsorted segment ids), or ``None`` when ``pack`` is off.
    "sorted" degrades to "auto"; "auto" picks the CUDA kernel on a CUDA
    graph and the plain version elsewhere."""
    if not pack:
        return None
    from repro_torch.kernels.ops import flat_segmin_backend, make_packed_segmin

    return make_packed_segmin(flat_segmin_backend(segmin) or "auto", device_type)


def resolve_level_segmins(segmin: str | None, use_pack: bool, device_type: str = "cuda"):
    """(hook segmin, dedupe segmin) callables for the coarsening levels, or
    ``(None, None)`` when ``use_pack`` is off.

    The hook reduction (``coarsen.contract``) sees *unsorted* segment ids
    (roots of the current parent vector), so it resolves as a flat site:
    "sorted" degrades to "auto". The dedupe's ids are the boundary prefix
    sum over sorted pair keys: ``kernels.ops.dedupe_segmin_backend``.

    One deliberate difference from ``repro.solve.spec.resolve_level_segmins``:
    for ``segmin`` None the reference gives the hook plain XLA
    ``segment_min``, even on a TPU. Here None/"auto" gives the hook the flat
    CUDA kernel on a CUDA graph (the plain version elsewhere). Every edge
    that is not outgoing carries the identity key and is scattered into its
    root's slot; the plain ``scatter_reduce_`` serialises on those atomics,
    while the kernel skips identity keys. The reduction is the same, so the
    results are identical.
    """
    if not use_pack:
        return None, None
    from repro_torch.kernels.ops import dedupe_segmin_backend

    return (
        resolve_flat_segmin(segmin, True, device_type),
        dedupe_segmin_backend(segmin, device_type),
    )


# ---------------------------------------------------------------------------
# the spec
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SolveSpec:
    """Frozen, hashable description of one MSF solve configuration.

    ``None`` for a knob means "auto": concrete values are chosen by
    :meth:`resolve` against the target's data and device.
    """

    mode: str = "flat"
    # algorithm knobs
    variant: str = "complete"
    shortcut: str | None = None  # None = mode default (complete / csp)
    capacity: int = 1 << 16  # CSP/OS changed-map capacity
    max_iters: int | None = None
    unroll_guard: bool = True
    # backend knobs
    pack: bool | None = None  # pack32 inner loops; None = auto-detect
    segmin: str | None = None  # packed segment-min backend request
    dedupe: str = "auto"  # coarsen dedupe: "auto" | "device" | "host"
    fused: bool | None = None  # one-call device-resident levels
    # coarsening levels ("coarsen" mode; optional prelude for dist/stream)
    coarsen: CoarsenConfig | None = None
    # stream mode
    batch_capacity: int = 1024
    adaptive_capacity: bool = False
    min_capacity: int = 16
    compact_trigger: float = 0.25
    coarsen_threshold: int = 1 << 15
    reservoir_capacity: int = 4096
    reservoir_per_component: int = 256
    exact_deletes: bool = True
    # dist mode: the mesh axes of the grid's rows (a name, or a tuple of
    # names flattened row-major) and columns
    row_axis: str | tuple = "data"
    col_axis: str = "model"
    # observability: "off" | "metrics" | "trace"
    obs: str = "off"
    # tuning-database consultation: "off" | "db" | "measure"
    tuning: str = "off"

    def __post_init__(self):
        if self.mode not in MODES and self.mode not in EXTRA_MODES:
            raise ValueError(f"unknown mode {self.mode!r} (expected one of {MODES})")
        if self.obs not in OBS_MODES:
            raise ValueError(
                f"unknown obs mode {self.obs!r} (expected one of {OBS_MODES})"
            )
        if self.tuning not in TUNING_MODES:
            raise ValueError(
                f"unknown tuning mode {self.tuning!r} "
                f"(expected one of {TUNING_MODES})"
            )
        if self.coarsen is True:  # convenience: True → defaults
            object.__setattr__(self, "coarsen", CoarsenConfig())
        if self.coarsen is not None and not isinstance(self.coarsen, CoarsenConfig):
            raise ValueError(
                f"coarsen must be a CoarsenConfig, True, or None; "
                f"got {self.coarsen!r}"
            )
        if self.mode not in MODES:
            return  # registered engines own their mode-specific rules
        if self.variant not in VARIANTS:
            raise ValueError(
                f"unknown variant {self.variant!r} (expected one of {VARIANTS})"
            )
        allowed = DIST_SHORTCUTS if self.mode == "dist" else FLAT_SHORTCUTS
        if self.shortcut not in allowed:
            raise ValueError(
                f"unknown {self.mode} shortcut {self.shortcut!r} "
                f"(expected one of {allowed})"
            )
        if self.segmin not in SEGMIN_BACKENDS:
            raise ValueError(
                f"unknown segmin backend {self.segmin!r} "
                f"(expected one of {SEGMIN_BACKENDS})"
            )
        if self.dedupe not in DEDUPE_BACKENDS:
            raise ValueError(f"unknown dedupe backend {self.dedupe!r}")
        if self.mode == "flat":
            if self.coarsen is not None:
                raise ValueError(
                    "coarsen levels need mode='coarsen' (or 'dist'/'stream' "
                    "with a coarsen prelude), not mode='flat'"
                )
            if self.fused:
                raise ValueError(
                    "fused=True requires coarsen= (it fuses the levels)"
                )
            if self.segmin == "sorted":
                raise ValueError(
                    "segmin='sorted' needs sorted segment ids — only the "
                    "coarsen dedupe provides them; the flat hook loop's ids "
                    "are unsorted (use 'cuda'/'torch'/'auto' here)"
                )
            if self.pack is False and self.segmin not in (None, "auto"):
                raise ValueError(
                    "segmin= only applies to the pack=True inner loop"
                )
        if self.mode == "stream":
            if self.batch_capacity < 1:
                raise ValueError("batch_capacity must be >= 1")
            if self.min_capacity < 1:
                raise ValueError("min_capacity must be >= 1")
            if self.coarsen_threshold < 0:
                raise ValueError("coarsen_threshold must be >= 0")
            if self.reservoir_capacity < 0:
                raise ValueError("reservoir_capacity must be >= 0")
            if self.reservoir_per_component < 1:
                raise ValueError("reservoir_per_component must be >= 1")
        if self.capacity < 1:
            raise ValueError("capacity must be >= 1")

    # ------------------------------------------------------------------

    def resolve(self, target=None, *, backend: str | None = None, mesh=None) -> "ResolvedSpec":
        """Turn auto knobs into concrete backend choices for ``target``.

        ``backend`` is a device type; by default the target graph's
        (``"cuda"`` when the target carries no tensors). With ``tuning !=
        "off"`` the tuning database is consulted first
        (``repro_torch.solve.tune``): a compatible winner fills the knobs
        left on auto, and everything below resolves that *effective*
        spec; on any database failure the rules run untouched. ``mesh``
        only keys the tuning lookup.
        """
        backend = backend or _target_device_type(target)
        eff = self
        if self.tuning != "off":
            from repro_torch.solve.tune import resolve_overrides

            tuned = resolve_overrides(self, target, backend, mesh)
            if tuned is not None:
                eff = tuned
        pack = eff.pack
        if pack is None and self.mode != "stream":
            # Stream keeps None: its engine tracks packability per batch.
            arrays = _pack_probe_arrays(target)
            # No data to probe: the conservative float path.
            pack = auto_pack(*arrays) if arrays is not None else False
        if self.mode == "stream" and pack is True and target is not None:
            union = (_stream_n(target) - 1) + eff.batch_capacity
            if union >= PACK_IDX_MASK:
                raise ValueError(
                    f"pack=True needs union eids < 2^24 - 1; (n - 1) + "
                    f"batch_capacity = {union} overflows the pack32 index "
                    f"field"
                )
        shortcut = eff.shortcut or ("csp" if self.mode == "dist" else "complete")
        coarsen = eff.coarsen
        if coarsen is None and self.mode == "coarsen":
            coarsen = CoarsenConfig()
        if coarsen is not None:
            # Spec-level segmin/dedupe/fused override the embedded config.
            merged = {}
            if eff.segmin is not None:
                merged["segmin"] = eff.segmin
            if eff.dedupe != "auto":
                merged["dedupe"] = eff.dedupe
            if eff.fused is not None:
                merged["fused"] = eff.fused
            if merged:
                coarsen = dataclasses.replace(coarsen, **merged)
        # spec=eff: engines read knobs through rs.spec, and the plan-cache
        # key must carry the knobs in effect (eff keeps self.tuning, so
        # "db" and "off" never share a key).
        return ResolvedSpec(
            spec=eff,
            backend=backend,
            pack=pack,
            shortcut=shortcut,
            segmin_flat=resolve_flat_segmin(eff.segmin, bool(pack), backend),
            dedupe=resolve_dedupe(eff.dedupe, backend),
            coarsen=coarsen,
        )


class ResolvedSpec(NamedTuple):
    """Concrete backend choices for one (spec, target, device type)."""

    spec: SolveSpec
    backend: str  # device type the choices were made for: "cuda" | "cpu"
    pack: bool | None  # None only in stream mode (tracked per batch)
    shortcut: str
    segmin_flat: Any  # packed-segmin callable for flat hook loops, or None
    dedupe: str  # "device" | "host"
    coarsen: CoarsenConfig | None  # effective config, spec knobs folded in


def _target_device_type(target) -> str:
    src = getattr(target, "src", None)
    if isinstance(src, torch.Tensor):
        return src.device.type
    return "cuda"  # the port's default device


def _pack_probe_arrays(target):
    """(w, eid, valid, e_capacity) for :func:`auto_pack`, or ``None`` when
    the target carries no edge data (int n / None)."""
    if target is None or isinstance(target, (int, np.integer)):
        return None
    w = getattr(target, "w", None)
    eid = getattr(target, "eid", None)
    valid = getattr(target, "valid", None)
    if w is None or eid is None or valid is None:
        return None
    w, eid, valid = (torch.as_tensor(a).reshape(-1) for a in (w, eid, valid))
    return w, eid, valid, int(eid.shape[0])


def _stream_n(target) -> int:
    if isinstance(target, (int, np.integer)):
        return int(target)
    n = getattr(target, "n", None)
    if n is None:
        raise ValueError(
            "stream mode needs a vertex count: pass an int n or a Graph"
        )
    return int(n)
