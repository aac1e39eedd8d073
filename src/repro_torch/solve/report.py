"""`SolveReport` — the one result schema every engine maps onto.

Host-side: the forest weight, the chosen global eids, component labels
and counters come back as Python and numpy values; the engine-native
result (device tensors) stays under ``raw``.

A CUDA result comes to the host through page-locked buffers of torch's
caching host allocator: the scalars in one wait (``n_msf_edges`` sizes
the eid copy), then ``parent`` and ``msf_eids[:n_msf_edges]`` as
non-blocking copies on the result's stream and one wait. The arrays are
numpy views of those buffers; each view holds its buffer, so the cache
hands a block to a later report only once every view of it is dropped. A
CPU result's arrays are read in place (``msf_eids`` trimmed into a copy).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.graphs.structures import _canonicalize, host_array
from repro_torch.obs.trace import NOOP_SPAN, host_sync


class SolveReport(NamedTuple):
    """Uniform result of ``Plan.solve()``."""

    mode: str  # engine that produced this report
    weight: float  # total forest weight
    msf_eids: np.ndarray  # int32 [n_msf_edges] chosen edge ids, trimmed
    parent: np.ndarray  # int32 [n] component representative per vertex
    n_msf_edges: int
    iterations: int  # hook/shortcut rounds (levels + residual)
    levels: Tuple  # per-level LevelStats rows (coarsen); () when no levels ran
    host_roundtrips: int  # per-level host round-trips (0 = device-resident)
    recompiles: int  # distinct executables compiled (stream mode)
    raw: Any  # engine-native result (MSFResult)
    timings: Dict[str, float] = {}  # span name -> seconds; {} when obs off
    cost: Any = None  # PlanCost of the plan (solve.cost); None off-scope
    stale: bool = False  # stream mode: snapshot may diverge from true MSF
    n_unhealed: int = 0  # stream mode: deletions not certifiably healed

    @property
    def n_components(self) -> int:
        """Component count from *canonical roots* (``parent[v] == v`` after
        pointer-jumping the vector to its fixpoint)."""
        return int(np.count_nonzero(_canonicalize(self.parent)
                                    == np.arange(len(self.parent))))


def _pinned(t: torch.Tensor) -> torch.Tensor:
    """A page-locked host tensor that a non-blocking copy of ``t`` (on
    ``t``'s device's current stream) fills; read it after that stream's wait."""
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return h.copy_(t, non_blocking=True)


def _cuda_reads(r):
    """(weight, n_msf_edges, iterations, msf_eids, parent, bytes copied) of
    a CUDA result, in two waits on the result's stream."""
    stream = torch.cuda.current_stream(r.parent.device)
    scalars = [_pinned(t) for t in (r.weight, r.n_msf_edges, r.iterations)]
    stream.synchronize()
    weight, n_f, iterations = float(scalars[0]), int(scalars[1]), int(scalars[2])
    eids, parent = _pinned(r.msf_eids[:n_f]), _pinned(r.parent)
    stream.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in (*scalars, eids, parent))
    return weight, n_f, iterations, eids.numpy(), parent.numpy(), nbytes


def report_from_msf_result(
    mode: str,
    r,
    *,
    levels: Tuple = (),
    host_roundtrips: int = 0,
    recompiles: int = 0,
    span=NOOP_SPAN,
) -> SolveReport:
    """Adapt an ``MSFResult``-shaped record. ``span`` (the engine's
    ``solve.report``) gets ``pinned`` (1 when the page-locked route ran)
    and ``d2h_bytes`` (the bytes copied from the device)."""
    # the card's waits: the scalars, then both arrays (a CPU result waits for none)
    host_sync("report.scalars")
    host_sync("report.arrays")
    pinned = r.parent.is_cuda
    if pinned:
        weight, n_f, iterations, msf_eids, parent, nbytes = _cuda_reads(r)
    else:
        weight, n_f, iterations = float(r.weight), int(r.n_msf_edges), int(r.iterations)
        msf_eids = host_array(r.msf_eids)[:n_f].astype(np.int32)
        parent, nbytes = host_array(r.parent), 0
    span.set(pinned=int(pinned), d2h_bytes=nbytes)
    return SolveReport(
        mode=mode,
        weight=weight,
        msf_eids=msf_eids,
        parent=parent,
        n_msf_edges=n_f,
        iterations=iterations,
        levels=tuple(levels),
        host_roundtrips=int(host_roundtrips),
        recompiles=int(recompiles),
        raw=r,
    )
