"""Versioned, double-buffered forest snapshots (counterpart of
``repro.stream.snapshot``).

The streaming engine mutates its edge store between MSF runs; queries must
never observe that in-flight state. The protocol:

- a :class:`Snapshot` is an *immutable* value: version counter, canonical
  parent labels and per-vertex component sizes (tensors on the engine's
  device), component count, total forest weight, forest edge count, a
  ``stale`` bit (exact-delete mode: set only while deletions remain
  unhealed, see ``n_unhealed``; legacy defer mode: set between a tombstone
  batch and the compaction that makes its effect visible), and the
  ``n_unhealed`` count behind it;
- the :class:`SnapshotStore` keeps two slots. A publisher writes the fresh
  snapshot into the *inactive* slot and then flips the active index — a
  single reference swap, so a reader that ``acquire()``-d the old snapshot
  keeps a fully consistent view for as long as it holds the object, while
  new readers see the new version immediately.

Single writer (the engine), any number of readers (query services).
"""
from __future__ import annotations

import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.graphs.structures import resolve_device


class Snapshot(NamedTuple):
    version: int
    parent: torch.Tensor  # int32 [n]: canonical (star-root) component labels
    comp_size: torch.Tensor  # int32 [n]: size of the component containing i
    n_components: int
    weight: float  # total forest weight
    n_forest_edges: int
    stale: bool = False  # True ⇒ forest may diverge from the true MSF
    n_unhealed: int = 0  # deletions not certifiably healed (exact mode)


def make_snapshot(
    version: int,
    parent,
    weight: float,
    n_forest_edges: int,
    stale: bool = False,
    n_unhealed: int = 0,
    *,
    device=None,
) -> Snapshot:
    """Snapshot of canonical labels ``parent``: a tensor (kept on its
    device) or a host array (copied to ``device``, ``None`` = ``"cuda"``).
    Component sizes are one ``bincount`` on the device; the component
    count is read where the labels came from, so host labels cost no
    device sync."""
    if isinstance(parent, torch.Tensor):
        p = parent.to(torch.int32)
        ncc = int((p == torch.arange(p.shape[0], device=p.device, dtype=torch.int32)).sum())
    else:
        host = np.asarray(parent, np.int32)
        ncc = int(np.count_nonzero(host == np.arange(host.shape[0])))
        p = torch.as_tensor(host).to(resolve_device(device))
    idx = p.long()
    comp_size = torch.bincount(idx, minlength=p.shape[0])[idx].to(torch.int32)
    return Snapshot(
        version=int(version),
        parent=p,
        comp_size=comp_size,
        n_components=ncc,
        weight=float(weight),
        n_forest_edges=int(n_forest_edges),
        stale=bool(stale),
        n_unhealed=int(n_unhealed),
    )


class SnapshotStore:
    """Double-buffered single-writer snapshot publication."""

    def __init__(self):
        self._slots: list[Optional[Snapshot]] = [None, None]
        self._active = 0
        self._publish_lock = threading.Lock()

    def publish(self, snap: Snapshot) -> None:
        """Install ``snap`` as the current snapshot (writer side)."""
        with self._publish_lock:
            nxt = 1 - self._active
            self._slots[nxt] = snap
            self._active = nxt  # the flip: readers switch atomically

    def acquire(self) -> Snapshot:
        """Return the current snapshot (reader side, lock-free)."""
        snap = self._slots[self._active]
        if snap is None:
            raise RuntimeError("no snapshot published yet")
        return snap

    @property
    def version(self) -> int:
        snap = self._slots[self._active]
        return -1 if snap is None else snap.version
