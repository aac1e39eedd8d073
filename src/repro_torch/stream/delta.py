"""Batch ingestion for the streaming MSF engine (counterpart of
``repro.stream.delta``).

Responsibilities:

- **Canonicalize** an incoming undirected batch: drop self-loops, collapse
  in-batch duplicates keeping the minimum weight (host side, exact — same
  policy as ``graphs.structures.from_edges``).
- **Dedupe against the live edge set** (the current forest): live edges are
  kept as a *sorted* array of packed ``(min, max)`` endpoint keys; batch
  keys are binary-searched against it. When ``n ≤ 2^16`` the key packs
  into 32 bits (``lo << 16 | hi``) and the lookup runs on the engine's
  device (one ``torch.searchsorted``); larger ``n`` takes the host int64
  path of ``graphs.structures.edge_keys``. torch has no uint32
  ``searchsorted``, so the packed keys travel as int64 holding the uint32
  values, ``KEY_PAD`` included, as the pack32 keys of ``core.semiring`` do.
- **Classify** each batch edge as NEW (absent from the live set), DECREASE
  (present, strictly cheaper than the live weight) or DROP (present, not
  cheaper).
- **Stable global edge ids**: a NEW edge is assigned the next gid and keeps
  it for as long as it lives in the forest; a DECREASE keeps the live
  edge's gid.
- **Replacement-edge reservoir** (:class:`Reservoir`): the bounded
  per-component store of non-tree edges that lost an MSF race, capped
  cheapest-first per component (then globally), with its own sorted key
  index for membership probes on delete and re-insert.

Everything but the packed probe is numpy on the host, as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.graphs.structures import (
    canonical_edges,
    dedupe_canonical,
    edge_keys,
    resolve_device,
)

#: largest vertex count for which the packed 32-bit on-device lookup applies
PACK_LIMIT = 1 << 16
#: sorted-buffer padding sentinel; above every real key (lo < hi ≤ 2^16 - 1
#: ⇒ key ≤ 0xFFFEFFFF < 0xFFFFFFFF)
KEY_PAD = 0xFFFFFFFF


def pack_key_u32(lo, hi) -> np.ndarray:
    """Key ``lo << 16 | hi`` of canonical pairs for n ≤ 2^16: the uint32
    value, held as int64."""
    return (np.asarray(lo, np.int64) << 16) | np.asarray(hi, np.int64)


class PreparedBatch(NamedTuple):
    """A canonicalized, in-batch-deduped undirected edge batch (host arrays,
    sorted by (lo, hi) key)."""

    lo: np.ndarray  # int32 [count]
    hi: np.ndarray  # int32 [count]
    w: np.ndarray  # float32 [count]
    count: int
    dropped: int  # self-loops + in-batch duplicates removed


def prepare_batch(u, v, w, n: int) -> PreparedBatch:
    """Canonicalize one incoming batch. Exact host-side pass.

    Scalars / 0-d arrays are promoted to one-element batches
    (``np.atleast_1d``), so ``prepare_batch(3, 5, 1.0, n)`` is the
    single-edge batch rather than a ``TypeError`` on ``len``.
    """
    u = np.atleast_1d(np.asarray(u, np.int64))
    v = np.atleast_1d(np.asarray(v, np.int64))
    w = np.atleast_1d(np.asarray(w, np.float64))
    if not (u.shape == v.shape == w.shape):
        raise ValueError("u, v, w must have identical shapes")
    if u.size and (u.min() < 0 or v.min() < 0 or max(u.max(), v.max()) >= n):
        raise ValueError(f"edge endpoints out of range [0, {n})")
    raw = len(u)
    lo, hi, keep = canonical_edges(u, v)
    lo, hi, w = lo[keep], hi[keep], w[keep]
    lo, hi, w = dedupe_canonical(lo, hi, w, n)
    return PreparedBatch(
        lo=lo.astype(np.int32),
        hi=hi.astype(np.int32),
        w=w.astype(np.float32),
        count=len(lo),
        dropped=raw - len(lo),
    )


class BatchPlan(NamedTuple):
    """Classification of a prepared batch against the live edge set."""

    is_new: np.ndarray  # bool [count]
    is_decrease: np.ndarray  # bool [count]: present and strictly cheaper
    live_pos: np.ndarray  # int32 [count]: index into the *sorted* live order
    n_new: int
    n_decrease: int
    n_drop: int


def _match_device(batch_lo, batch_hi, live_keys_sorted, device):
    """Membership probe on ``device``: batch keys vs the sorted live key
    buffer (KEY_PAD beyond the live count). One ``searchsorted`` and one
    copy of (found, pos) back to the host."""
    dev = resolve_device(device)
    live = torch.as_tensor(live_keys_sorted).to(device=dev, dtype=torch.int64)
    keys = torch.as_tensor(pack_key_u32(batch_lo, batch_hi)).to(dev)
    j = torch.searchsorted(live, keys).clamp_(0, live.shape[0] - 1)
    found = live[j] == keys
    out = torch.stack([found.to(torch.int64), j]).cpu().numpy()
    return out[0].astype(bool), out[1].astype(np.int32)


def classify_batch(
    batch: PreparedBatch,
    live_keys_sorted,
    live_w_sorted: np.ndarray,
    n: int,
    *,
    device=None,
) -> BatchPlan:
    """Split a prepared batch into NEW / DECREASE / DROP vs the live set.

    ``live_keys_sorted``: sorted live keys from :func:`build_live_index` —
    packed 32-bit values as int64 (n ≤ PACK_LIMIT: a numpy array or a
    tensor, probed on ``device``, ``None`` = ``"cuda"``) or int64
    ``edge_keys`` (host path), padded with the respective sentinel.
    ``live_w_sorted``: float32 weights in the same order.
    """
    if batch.count == 0:
        z = np.zeros(0, bool)
        return BatchPlan(z, z, np.zeros(0, np.int32), 0, 0, 0)
    if n <= PACK_LIMIT:
        found, pos = _match_device(batch.lo, batch.hi, live_keys_sorted, device)
    else:
        keys = edge_keys(batch.lo, batch.hi, n)
        pos = np.searchsorted(live_keys_sorted, keys).astype(np.int32)
        pos = np.clip(pos, 0, max(len(live_keys_sorted) - 1, 0))
        found = (
            live_keys_sorted[pos] == keys
            if len(live_keys_sorted)
            else np.zeros(batch.count, bool)
        )
    cheaper = np.zeros(batch.count, bool)
    if len(live_w_sorted):
        # pos is only meaningful where found; clip so misses stay in bounds.
        safe = np.clip(pos, 0, len(live_w_sorted) - 1)
        cheaper = found & (batch.w < live_w_sorted[safe])
    is_new = ~found
    return BatchPlan(
        is_new=is_new,
        is_decrease=cheaper,
        live_pos=pos,
        n_new=int(is_new.sum()),
        n_decrease=int(cheaper.sum()),
        n_drop=int((found & ~cheaper).sum()),
    )


def build_live_index(lo, hi, w, n: int, capacity: int):
    """Sorted (keys, weights, rows) index over the live forest edges.

    Returns (keys_sorted padded to ``capacity``, w_sorted, rows_sorted)
    where ``rows_sorted`` maps a sorted position back to the store row.
    The keys are int64 numpy: packed 32-bit values padded with KEY_PAD for
    n ≤ PACK_LIMIT, ``edge_keys`` padded with the int64 maximum above it.
    """
    lo = np.asarray(lo, np.int64)
    hi = np.asarray(hi, np.int64)
    keys = edge_keys(lo, hi, n)
    order = np.argsort(keys, kind="stable")
    keys_sorted = keys[order]
    if n <= PACK_LIMIT:
        buf = np.full(capacity, KEY_PAD, np.int64)
        buf[: len(keys_sorted)] = pack_key_u32(lo[order], hi[order])
    else:
        buf = np.full(capacity, np.iinfo(np.int64).max, np.int64)
        buf[: len(keys_sorted)] = keys_sorted
    return buf, np.asarray(w, np.float32)[order], order.astype(np.int32)


class Reservoir:
    """Bounded per-component store of non-tree edges.

    Edges that lose an MSF race in the engine's union solve land here
    instead of being discarded, so a later forest-edge deletion can pull
    them back as replacement candidates. Entries carry their stable gid
    and the canonical component root of their endpoints (non-tree edges
    are always intra-component).

    Capacity policy: ``per_component`` entries per component, then
    ``capacity`` entries total, both retained **cheapest-first** under
    the strict ``(w, gid)`` order the MSF itself uses. Any entry evicted
    by either cap makes its component *lossy* — the engine tracks that
    and refuses to certify deletions inside lossy components
    (``DeleteStats.n_unhealed``).

    A sorted int64 ``edge_keys`` index over the stored pairs backs O(log
    count) membership probes (:meth:`lookup`) — the reservoir twin of
    :func:`build_live_index`.
    """

    def __init__(self, n: int, capacity: int, per_component: int):
        if capacity < 0:
            raise ValueError("reservoir capacity must be >= 0")
        if per_component < 1:
            raise ValueError("reservoir per-component cap must be >= 1")
        self.n = int(n)
        self.capacity = int(capacity)
        self.per_component = int(per_component)
        self._lo = np.zeros(capacity, np.int32)
        self._hi = np.zeros(capacity, np.int32)
        self._w = np.zeros(capacity, np.float32)
        self._gid = np.full(capacity, -1, np.int32)
        self._comp = np.zeros(capacity, np.int32)
        self._count = 0
        self._keys_sorted = np.zeros(0, np.int64)
        self._rows_sorted = np.zeros(0, np.int64)

    def __len__(self) -> int:
        return self._count

    def edges(self):
        """Copies of the stored rows: (lo, hi, w, gid, comp)."""
        c = self._count
        return (
            self._lo[:c].copy(),
            self._hi[:c].copy(),
            self._w[:c].copy(),
            self._gid[:c].copy(),
            self._comp[:c].copy(),
        )

    # ------------------------------------------------------------------

    def _reindex(self) -> None:
        c = self._count
        keys = edge_keys(self._lo[:c], self._hi[:c], self.n)
        order = np.argsort(keys, kind="stable")
        self._keys_sorted = keys[order]
        self._rows_sorted = order.astype(np.int64)

    def _set(self, lo, hi, w, gid, comp) -> None:
        c = len(lo)
        self._lo[:c] = lo
        self._hi[:c] = hi
        self._w[:c] = w
        self._gid[:c] = gid
        self._comp[:c] = comp
        self._count = c
        self._reindex()

    # ------------------------------------------------------------------

    def lookup(self, lo, hi) -> np.ndarray:
        """Row index of each canonical (lo, hi) query pair, −1 on miss."""
        lo = np.asarray(lo)
        hi = np.asarray(hi)
        out = np.full(len(lo), -1, np.int64)
        if self._count == 0 or len(lo) == 0:
            return out
        keys = edge_keys(lo, hi, self.n)
        j = np.searchsorted(self._keys_sorted, keys)
        j = np.clip(j, 0, len(self._keys_sorted) - 1)
        found = self._keys_sorted[j] == keys
        out[found] = self._rows_sorted[j[found]]
        return out

    def remove_rows(self, rows):
        """Remove ``rows`` and return their (lo, hi, w, gid) in row order."""
        rows = np.asarray(rows, np.int64)
        out = (
            self._lo[rows].copy(),
            self._hi[rows].copy(),
            self._w[rows].copy(),
            self._gid[rows].copy(),
        )
        if len(rows):
            keep = np.ones(self._count, bool)
            keep[rows] = False
            idx = np.flatnonzero(keep)
            self._set(
                self._lo[idx], self._hi[idx], self._w[idx],
                self._gid[idx], self._comp[idx],
            )
        return out

    def take_components(self, comps):
        """Remove and return every entry bucketed under one of ``comps``
        (canonical component roots) — the replacement-candidate pull of a
        forest-edge deletion."""
        comps = np.asarray(comps)
        if self._count == 0 or len(comps) == 0:
            z = np.zeros(0, np.int32)
            return z, z, np.zeros(0, np.float32), z
        rows = np.flatnonzero(np.isin(self._comp[: self._count], comps))
        return self.remove_rows(rows)

    def state_dict(self) -> dict:
        """Full-capacity column copies + live count — the durable state
        of :mod:`repro_torch.stream.persist` (fixed shapes, so a checkpoint
        restores into any reservoir of the same capacity)."""
        return {
            "lo": self._lo.copy(),
            "hi": self._hi.copy(),
            "w": self._w.copy(),
            "gid": self._gid.copy(),
            "comp": self._comp.copy(),
            "count": np.int64(self._count),
        }

    def restore_state(self, state: dict) -> None:
        """Inverse of :meth:`state_dict`; rebuilds the sorted key index."""
        lo = np.asarray(state["lo"], np.int32)
        if lo.shape != self._lo.shape:
            raise ValueError(
                f"reservoir state capacity {lo.shape[0]} does not match "
                f"this reservoir's capacity {self.capacity}"
            )
        count = int(state["count"])
        if not 0 <= count <= self.capacity:
            raise ValueError(f"reservoir state count {count} out of range")
        self._lo = lo.copy()
        self._hi = np.asarray(state["hi"], np.int32).copy()
        self._w = np.asarray(state["w"], np.float32).copy()
        self._gid = np.asarray(state["gid"], np.int32).copy()
        self._comp = np.asarray(state["comp"], np.int32).copy()
        self._count = count
        self._reindex()

    def rebucket(self, canon: np.ndarray) -> None:
        """Re-label every entry's component from canonical labels
        (entries are intra-component: ``canon[lo]`` is the bucket)."""
        c = self._count
        if c:
            self._comp[:c] = np.asarray(canon, np.int32)[self._lo[:c]]

    def clear(self) -> None:
        self._count = 0
        self._reindex()

    def absorb(self, lo, hi, w, gid, comp):
        """Merge a batch of race losers into the store, enforcing both
        caps cheapest-first. Returns ``(evicted_comps, n_evicted)`` —
        the unique component roots that lost at least one entry (the
        engine marks them lossy) and the total eviction count."""
        lo = np.asarray(lo, np.int32)
        hi = np.asarray(hi, np.int32)
        w = np.asarray(w, np.float32)
        gid = np.asarray(gid, np.int32)
        comp = np.asarray(comp, np.int32)
        if len(lo) == 0:
            return np.zeros(0, np.int32), 0
        if self.capacity == 0:
            return np.unique(comp), len(lo)
        c = self._count
        lo = np.concatenate([self._lo[:c], lo])
        hi = np.concatenate([self._hi[:c], hi])
        w = np.concatenate([self._w[:c], w])
        gid = np.concatenate([self._gid[:c], gid])
        comp = np.concatenate([self._comp[:c], comp])
        # Defensive key dedupe (losers are disjoint from the store by
        # construction): keep the (w, gid)-min copy of a pair.
        keys = edge_keys(lo, hi, self.n)
        order = np.lexsort((gid, w, keys))
        keys = keys[order]
        first = np.ones(len(keys), bool)
        first[1:] = keys[1:] != keys[:-1]
        idx = order[first]
        lo, hi, w, gid, comp = lo[idx], hi[idx], w[idx], gid[idx], comp[idx]
        m = len(lo)
        # Per-component cap: rank entries cheapest-first inside each
        # component, drop ranks past the cap.
        order = np.lexsort((gid, w, comp))
        comp_sorted = comp[order]
        pos = np.arange(m, dtype=np.int64)
        starts = np.ones(m, bool)
        starts[1:] = comp_sorted[1:] != comp_sorted[:-1]
        group_start = np.maximum.accumulate(np.where(starts, pos, 0))
        within = (pos - group_start) < self.per_component
        keep = np.zeros(m, bool)
        keep[order[within]] = True
        # Global cap: among survivors keep the (w, gid)-cheapest overall.
        n_keep = int(keep.sum())
        if n_keep > self.capacity:
            surv = np.flatnonzero(keep)
            cheap = surv[np.lexsort((gid[surv], w[surv]))[: self.capacity]]
            keep = np.zeros(m, bool)
            keep[cheap] = True
        n_evicted = m - int(keep.sum())
        evicted_comps = np.unique(comp[~keep])
        idx = np.flatnonzero(keep)
        self._set(lo[idx], hi[idx], w[idx], gid[idx], comp[idx])
        return evicted_comps.astype(np.int32), n_evicted
