"""Streaming minimum spanning forest engine (counterpart of
``repro.stream.engine``).

Maintains the MSF of an edge stream under **batch insertions** and **batch
deletions**, serving consistent snapshots to the query layer while updates
are in flight.

Insertions are *exact* via the sparsification identity

    MSF(G ∪ B) = MSF(MSF(G) ∪ B)

(Sanders & Schimek 2023, §2; Kopelowitz et al. 2018): an insert batch of
size |B| runs the port's flat AS solve (``repro_torch.core.msf``) on the
engine's device over a *fixed-capacity* union buffer of exactly

    forest_capacity + batch_capacity  =  (n − 1) + B_cap

undirected slots — O(n + |B|) instead of O(m) work. With
``adaptive_capacity`` the batch slots instead track observed batch sizes
by powers of two. The MSF inner loop runs the pack32 single-reduction path
whenever weights stay in the paper's integral [0, 255] regime, with the
packed segment-min on the hand-written CUDA kernel on a CUDA engine
(``segmin="auto"``).

Deletions are **exact** too: edges that lose an MSF race are retained in a
bounded per-component **replacement-edge reservoir**
(:class:`repro_torch.stream.delta.Reservoir`). Deleting a forest edge
triggers replacement-edge search: the reservoir entries bucketed under the
split component re-enter the union solve, so the republished snapshot is
the true MSF of the surviving edge multiset. A snapshot stays
``stale=True`` only while deletions remain *unhealed* — a deleted forest
edge lived in a component whose reservoir had evicted entries past its
caps (``DeleteStats.n_unhealed``); :meth:`StreamEngine.recertify` rebuilds
forest + reservoir exactly from a caller-supplied edge source
(coarsen-assisted past ``coarsen_threshold``) and clears the condition.
``exact_deletes=False`` restores the legacy forest-only tombstone
semantics (deferred splits, conservative forests).

The forest store, the reservoir and the classification bookkeeping stay
numpy on the host, as in the reference. The device holds the union graph
of each solve, the packed live-key index (n ≤ 2^16) and the snapshots;
each union solve's result crosses to the host in one copy.
"""
from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.coarsen.engine import CoarsenMSF
from repro_torch.coarsen.config import CoarsenConfig
from repro_torch.core.msf import flat_msf
from repro_torch.core.semiring import PACK_IDX_MASK, weights_packable
from repro_torch.graphs.structures import (
    Graph,
    _canonicalize,
    edge_keys,
    from_arrays,
    resolve_device,
)
from repro_torch.stream import delta
from repro_torch.stream.service import next_pow2
from repro_torch.stream.snapshot import SnapshotStore, make_snapshot


def _spanned(name):
    """Wrap a method in an ``obs.span(name)`` — the per-op latency surface
    (span durations land in the ``span.<name>`` histogram of the default
    registry when metrics are on; one extra frame and one branch when obs
    is off)."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            with obs.span(name):
                return fn(*a, **kw)
        return wrapper
    return deco


class _HostResult(NamedTuple):
    """The fields of one union solve's ``MSFResult`` that the commit reads,
    on the host."""

    msf_eids: np.ndarray  # int32 [n]: local union slots, IMAX padded
    parent: np.ndarray  # int32 [n]
    n_msf_edges: int
    iterations: int


def _to_host(r) -> _HostResult:
    """One device→host copy of a solve's eids, parent and counters."""
    n = r.parent.shape[0]
    flat = torch.cat([
        r.msf_eids.to(torch.int32), r.parent.to(torch.int32),
        r.n_msf_edges.reshape(1).to(torch.int32), r.iterations.reshape(1).to(torch.int32),
    ]).cpu().numpy()
    return _HostResult(flat[:n], flat[n: 2 * n], int(flat[2 * n]), int(flat[2 * n + 1]))


class UpdateStats(NamedTuple):
    version: int
    weight: float
    n_components: int
    n_forest_edges: int
    n_new: int  # batch edges absent from the live forest
    n_decrease: int  # batch edges that lowered a live weight
    n_drop: int  # batch duplicates that changed nothing
    iterations: int  # MSF hook/shortcut iterations for this update
    union_directed_edges: int  # edge-buffer size of the update
    batch_capacity: int = 0  # padded batch slots used for this update
    recompiles: int = 0  # distinct (union shape, pack) keys so far
    n_revived: int = 0  # n_new edges matched in the reservoir (gid kept)
    reservoir_size: int = 0  # non-tree edges retained after this update


class DeleteStats(NamedTuple):
    version: int
    n_deleted: int  # forest edges removed
    n_missing: int  # requested pairs never present (forest or reservoir)
    compacted: bool  # a union solve ran (replacement search / trigger)
    n_reservoir_deleted: int = 0  # non-tree reservoir entries removed
    n_already_dead: int = 0  # pairs already tombstoned (legacy defer mode)
    n_dropped: int = 0  # self-loops / in-batch duplicates of the request
    n_unhealed: int = 0  # forest deletions not certifiably healed
    n_replacements: int = 0  # reservoir edges promoted into the forest


class StreamEngine:
    """Incremental MSF over an undirected edge stream.

    This is the engine behind the solve package's ``mode="stream"``
    plans (``plan(n, SolveSpec(mode="stream")).update/query/...``); the
    :class:`StreamingMSF` name below is its deprecated direct-construction
    shim.

    Parameters
    ----------
    n: vertex count (static — defines every buffer shape).
    batch_capacity: max undirected edges per insert batch; without
        ``adaptive_capacity`` also the pad target of the union buffer.
    adaptive_capacity: grow/shrink the padded batch slots by powers of two
        tracking observed batch sizes (floor ``min_capacity``, ceiling
        ``batch_capacity``), so small batches pay for a small union buffer.
    compact_trigger: tombstoned-fraction threshold that forces compaction
        (legacy ``exact_deletes=False`` mode only; exact deletions compact
        as part of every replacement search).
    pack: use the pack32 single-reduction MSF inner loop. ``None`` (auto)
        enables it while every inserted weight has been integral in
        [0, 255] (tracked incrementally, so one fractional batch
        permanently falls back to the 3-pass float reduction); ``True``
        asserts it and rejects unpackable batches.
    segmin: packed segment-min backend for the inner loop — "torch" (the
        plain version), "cuda" (the flat kernel), "sorted" (the sorted
        kernel; only meaningful for the coarsen recompute's dedupe — the
        flat hook loop falls back to "auto") or "auto" (the CUDA kernels
        on a CUDA engine, the plain versions elsewhere).
    coarsen: ``None`` (always the flat union recompute), ``True`` or a
        ``repro_torch.coarsen.CoarsenConfig`` — rebuild via **fused**
        contract-and-filter levels whenever the union holds at least
        ``coarsen_threshold`` live edges. The level dedupe is where the
        sorted kernel applies.
    coarsen_threshold: live undirected union edges (forest + batch) at
        which the coarsen recompute kicks in. :meth:`recertify` applies
        the same threshold to the supplied edge count.
    reservoir_capacity: total non-tree edges retained across components
        (0 disables retention — every loser eviction immediately marks
        its component lossy, so forest deletions there are unhealed).
    reservoir_per_component: retained-entry cap per component
        (cheapest-first under the MSF's own (w, gid) order).
    exact_deletes: ``True`` (default) runs replacement-edge search on
        every forest-edge deletion, publishing the true MSF; ``False``
        restores the legacy tombstone semantics.
    variant / shortcut / capacity: forwarded to ``repro_torch.core.msf``.
    device: where the union solves, the live-key probe and the snapshots
        run; ``None`` means ``"cuda"``, which raises without a card.
    """

    def __init__(
        self,
        n: int,
        batch_capacity: int = 1024,
        *,
        adaptive_capacity: bool = False,
        min_capacity: int = 16,
        compact_trigger: float = 0.25,
        pack: bool | None = None,
        segmin: str = "auto",
        coarsen=None,
        coarsen_threshold: int = 1 << 15,
        reservoir_capacity: int = 4096,
        reservoir_per_component: int = 256,
        exact_deletes: bool = True,
        variant: str = "complete",
        shortcut: str = "complete",
        capacity: int = 1 << 16,
        device=None,
    ):
        if n < 2:
            raise ValueError("the streaming MSF engine needs n >= 2")
        if batch_capacity < 1:
            raise ValueError("batch_capacity must be >= 1")
        self.device = resolve_device(device)
        self.n = int(n)
        self.batch_capacity = int(batch_capacity)
        self.forest_capacity = self.n - 1
        self.compact_trigger = float(compact_trigger)
        self._msf_opts = dict(variant=variant, shortcut=shortcut, capacity=capacity)
        self._pack = pack
        self._segmin = segmin
        self._coarsen_cfg = None
        if coarsen is not None and coarsen is not False:
            cfg = CoarsenConfig() if coarsen is True else coarsen
            # The union rebuild always takes the fused device-resident
            # levels; the sorted-dedupe backend follows ``segmin``.
            self._coarsen_cfg = dataclasses.replace(cfg, fused=True, segmin=segmin)
        self.coarsen_threshold = int(coarsen_threshold)
        #: CoarsenStats of the latest update when the coarsen rebuild ran,
        #: None when the flat recompute was taken (or never enabled).
        self.last_coarsen_stats = None
        self._packable = True  # conjunction over every inserted batch
        self.adaptive_capacity = bool(adaptive_capacity)
        self._min_capacity = min(next_pow2(min_capacity, 1), self.batch_capacity)
        self._cap_cur = (
            self._min_capacity if adaptive_capacity else self.batch_capacity
        )
        self._recent: list[int] = []  # last few observed batch sizes
        self._union_shapes: set = set()  # distinct (union shape, pack) keys
        if pack is True and self.forest_capacity + self.batch_capacity >= PACK_IDX_MASK:
            raise ValueError(
                f"pack=True needs union eids < 2^24 - 1; (n - 1) + "
                f"batch_capacity = {self.forest_capacity + self.batch_capacity} "
                f"overflows the pack32 index field"
            )

        fc = self.forest_capacity
        # Host-side forest store (compact: rows [0, _count) are live-or-dead).
        self._lo = np.zeros(fc, np.int32)
        self._hi = np.zeros(fc, np.int32)
        self._w = np.zeros(fc, np.float32)
        self._gid = np.full(fc, -1, np.int32)
        self._dead = np.zeros(fc, bool)
        self._count = 0
        self._n_dead = 0
        self._weight = 0.0
        self._next_gid = 0
        self._version = 0

        # Replacement-edge reservoir: race losers stay available as
        # deletion replacements; ``_lossy`` marks vertices of components
        # whose reservoir evicted entries (deletions there are not
        # certifiable); ``_unhealed`` counts uncertified deletions since
        # the last recertification.
        self.exact_deletes = bool(exact_deletes)
        self._reservoir = delta.Reservoir(
            self.n, reservoir_capacity, reservoir_per_component
        )
        self._lossy = np.zeros(self.n, bool)
        self._canon = np.arange(self.n, dtype=np.int32)
        self._unhealed = 0

        self.snapshots = SnapshotStore()
        self.last_union_shape: tuple | None = None
        self._publish(stale=False, parent=np.arange(self.n, dtype=np.int32))
        self._refresh_live_index()

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    @property
    def union_edge_capacity(self) -> int:
        """Undirected slots per update — the (n − 1) + B_cur bound (B_cur
        follows observed batch sizes under ``adaptive_capacity``)."""
        return self.forest_capacity + self._cap_cur

    @property
    def recompiles(self) -> int:
        """Distinct (union-buffer shape, pack mode) keys met so far. The
        port compiles nothing per shape; the count is the reference's
        executable count (1 at fixed capacity and stable pack mode; the
        auto-pack flip after a fractional batch adds one, and adaptive
        capacity one per newly visited pow2 size), kept so that
        ``UpdateStats.recompiles`` and ``SolveReport.recompiles`` mean the
        same in both packages."""
        return len(self._union_shapes)

    @property
    def version(self) -> int:
        return self._version

    @property
    def weight(self) -> float:
        return self._weight

    @property
    def n_forest_edges(self) -> int:
        return self._count - self._n_dead

    @property
    def unhealed(self) -> int:
        """Forest deletions not certifiably healed since the last
        recertification — snapshots stay ``stale`` while this is > 0."""
        return self._unhealed

    @property
    def reservoir_size(self) -> int:
        """Non-tree edges currently retained as replacement candidates."""
        return len(self._reservoir)

    def forest_edges(self):
        """Copies of the live forest rows: (lo, hi, w, gid)."""
        live = ~self._dead[: self._count]
        idx = np.flatnonzero(live)
        return (
            self._lo[idx].copy(),
            self._hi[idx].copy(),
            self._w[idx].copy(),
            self._gid[idx].copy(),
        )

    def forest_gids(self) -> np.ndarray:
        """Stable gids of the live forest edges only — the cheap column
        for per-update reporting."""
        return self._gid[np.flatnonzero(~self._dead[: self._count])]

    @_spanned("stream.update")
    def insert_batch(self, u, v, w) -> UpdateStats:
        """Apply one batch of undirected weighted edge insertions.

        Exact MSF maintenance: duplicates of live forest edges are
        dropped (or treated as weight decreases, keeping the stable gid),
        duplicates of reservoir entries are *revived* — pulled back into
        the union solve at the minimum of the two weights, keeping the
        reservoir gid — new edges get fresh gids, and the forest is
        recomputed over forest ∪ batch.
        """
        pb = delta.prepare_batch(u, v, w, self.n)
        if pb.count > self.batch_capacity:
            raise ValueError(
                f"batch of {pb.count} unique edges exceeds batch_capacity="
                f"{self.batch_capacity}; split the batch or raise the capacity"
            )
        self._note_batch(pb)
        plan = self._classify(pb)
        # Weight decreases: update the live row in place; gid is unchanged.
        if plan.n_decrease:
            rows = self._live_rows[plan.live_pos[plan.is_decrease]]
            self._w[rows] = np.minimum(self._w[rows], pb.w[plan.is_decrease])
        # Edges absent from the forest: revive reservoir duplicates
        # (stable gid, min weight — a cheaper re-insert may displace a
        # forest edge, so it must re-enter the race), fresh gids for the
        # truly new.
        new_lo = pb.lo[plan.is_new]
        new_hi = pb.hi[plan.is_new]
        new_w = pb.w[plan.is_new].copy()
        new_gid = np.empty(plan.n_new, np.int32)
        res_rows = self._reservoir.lookup(new_lo, new_hi)
        revived = res_rows >= 0
        n_revived = int(revived.sum())
        if n_revived:
            _, _, r_w, r_gid = self._reservoir.remove_rows(res_rows[revived])
            new_w[revived] = np.minimum(new_w[revived], r_w)
            new_gid[revived] = r_gid
        n_fresh = plan.n_new - n_revived
        new_gid[~revived] = np.arange(
            self._next_gid, self._next_gid + n_fresh, dtype=np.int32
        )
        self._next_gid += n_fresh
        r = self._run_union(new_lo, new_hi, new_w, new_gid)
        return UpdateStats(
            version=self._version,
            weight=self._weight,
            n_components=self.snapshots.acquire().n_components,
            n_forest_edges=self._count,
            n_new=plan.n_new,
            n_decrease=plan.n_decrease,
            n_drop=plan.n_drop + pb.dropped,
            iterations=r.iterations,
            union_directed_edges=self.last_union_shape[0],
            batch_capacity=self._cap_cur,
            recompiles=self.recompiles,
            n_revived=n_revived,
            reservoir_size=len(self._reservoir),
        )

    @_spanned("stream.delete")
    def delete_batch(self, u, v) -> DeleteStats:
        """Delete a batch of undirected edges (by endpoints) — exactly.

        Forest edges are tombstoned and immediately *healed*: the
        reservoir entries bucketed under each split component re-enter a
        union solve (chunked to the padded batch capacity), and the
        republished snapshot is the true MSF of the surviving edge
        multiset. Reservoir entries named by the batch are removed in
        place (non-tree removals never change the forest). A deletion is
        **unhealed** — and the snapshot stays ``stale`` — only when the
        split component's reservoir had evicted entries (``n_unhealed``;
        recover via :meth:`recertify`). With ``exact_deletes=False`` the
        legacy semantics apply: tombstone, republish ``stale=True``,
        splits land at compaction.
        """
        u_arr = np.atleast_1d(np.asarray(u))
        pb = delta.prepare_batch(
            u_arr, v, np.zeros(u_arr.shape[0]), self.n
        )
        n_forest_deleted = 0
        n_already_dead = 0
        n_reservoir_deleted = 0
        n_missing = 0
        dead_comps: list[np.ndarray] = []  # one comp root per deleted edge
        # Deletions are not bounded by batch_capacity (nothing enters the
        # union buffer); the live index is probed in capacity-sized
        # chunks, as in the reference.
        for k in range(0, pb.count, self.batch_capacity):
            chunk = delta.PreparedBatch(
                lo=pb.lo[k : k + self.batch_capacity],
                hi=pb.hi[k : k + self.batch_capacity],
                w=pb.w[k : k + self.batch_capacity],
                count=min(self.batch_capacity, pb.count - k),
                dropped=0,
            )
            plan = self._classify(chunk)
            found = ~plan.is_new
            rows = self._live_rows[plan.live_pos[found]]
            alive = ~self._dead[rows]
            newly_dead = rows[alive]
            n_already_dead += int((~alive).sum())
            self._dead[newly_dead] = True
            self._n_dead += len(newly_dead)
            n_forest_deleted += len(newly_dead)
            if len(newly_dead):
                dead_comps.append(self._canon[self._lo[newly_dead]])
            # Misses against the live forest: already-tombstoned rows
            # (legacy defer mode), then the reservoir, else truly missing.
            miss_lo = chunk.lo[plan.is_new]
            miss_hi = chunk.hi[plan.is_new]
            if len(miss_lo):
                in_dead = np.zeros(len(miss_lo), bool)
                dead_rows = np.flatnonzero(self._dead[: self._count])
                if len(dead_rows):
                    dk = edge_keys(
                        self._lo[dead_rows], self._hi[dead_rows], self.n
                    )
                    in_dead = np.isin(
                        edge_keys(miss_lo, miss_hi, self.n), dk
                    )
                    # rows tombstoned by *this* call were still in the
                    # live index above, so matches here are prior dead
                    n_already_dead += int(in_dead.sum())
                rem = np.flatnonzero(~in_dead)
                res_rows = self._reservoir.lookup(
                    miss_lo[rem], miss_hi[rem]
                )
                hit = res_rows >= 0
                if hit.any():
                    self._reservoir.remove_rows(res_rows[hit])
                n_reservoir_deleted += int(hit.sum())
                n_missing += int((~hit).sum())
        if n_forest_deleted:
            # Keep the reported weight equal to the *live* edge sum —
            # recomputed from the rows, never decremented (float32
            # decrements drift over long delete/insert cycles).
            self._weight = self._live_weight()
        n_unhealed_new = 0
        n_replacements = 0
        compacted = False
        if n_forest_deleted and self.exact_deletes:
            per_edge = np.concatenate(dead_comps)
            if self._lossy.any():
                lossy_comp = np.zeros(self.n, bool)
                lossy_comp[np.unique(self._canon[self._lossy])] = True
                n_unhealed_new = int(lossy_comp[per_edge].sum())
            self._unhealed += n_unhealed_new
            if n_unhealed_new:
                obs.counter("stream.reservoir.exhausted").inc(n_unhealed_new)
            # Replacement-edge search: every reservoir entry of a split
            # component re-enters the union solve (cheapest-first across
            # capacity-sized chunks — the sparsification identity makes
            # the chunked result identical to one big solve).
            cl, ch, cw, cg = self._reservoir.take_components(
                np.unique(per_edge)
            )
            if len(cl):
                obs.counter("stream.reservoir.hits").inc(len(cl))
                order = np.argsort(cw, kind="stable")
                for k in range(0, len(cl), self._cap_cur):
                    sl = order[k : k + self._cap_cur]
                    self._run_union(cl[sl], ch[sl], cw[sl], cg[sl])
                live_gids = self._gid[: self._count][
                    ~self._dead[: self._count]
                ]
                n_replacements = int(np.isin(cg, live_gids).sum())
            else:
                empty = np.zeros(0, np.int32)
                self._run_union(empty, empty, np.zeros(0, np.float32), empty)
            compacted = True
        elif (
            n_forest_deleted
            and self._n_dead
            and self._n_dead >= self.compact_trigger * max(1, self._count)
        ):
            self.compact()
            compacted = True
        else:
            self._version += 1
            self._publish(stale=self._n_dead > 0 or self._unhealed > 0)
            self._refresh_live_index()
        return DeleteStats(
            version=self._version,
            n_deleted=n_forest_deleted,
            n_missing=n_missing,
            compacted=compacted,
            n_reservoir_deleted=n_reservoir_deleted,
            n_already_dead=n_already_dead,
            n_dropped=pb.dropped,
            n_unhealed=n_unhealed_new,
            n_replacements=n_replacements,
        )

    @_spanned("stream.compact")
    def compact(self) -> UpdateStats:
        """Drop tombstoned rows and rebuild labels/weight from the retained
        forest edges (the rebuild-from-retained compaction path)."""
        empty = np.zeros(0, np.int32)
        r = self._run_union(empty, empty, np.zeros(0, np.float32), empty)
        return UpdateStats(
            version=self._version,
            weight=self._weight,
            n_components=self.snapshots.acquire().n_components,
            n_forest_edges=self._count,
            n_new=0,
            n_decrease=0,
            n_drop=0,
            iterations=r.iterations,
            union_directed_edges=self.last_union_shape[0],
            batch_capacity=self._cap_cur,
            recompiles=self.recompiles,
            n_revived=0,
            reservoir_size=len(self._reservoir),
        )

    @_spanned("stream.recertify")
    def recertify(self, u, v, w) -> UpdateStats:
        """Rebuild forest + reservoir exactly from a caller-supplied edge
        source — the recovery path after unhealed deletions.

        ``(u, v, w)`` is the full surviving edge multiset (e.g. replayed
        from the system of record). Gids stay stable: supplied pairs that
        match a live forest or reservoir entry keep that entry's gid;
        unmatched pairs — exactly the edges the bounded reservoir had
        evicted — get fresh ones. The solve is coarsen-assisted past
        ``coarsen_threshold`` edges (the fused contract-and-filter
        levels) and flat below it; the buffer pads to the next power of
        two, as in the reference. Afterwards the reservoir is refilled
        from the race losers, lossy marks are reset (modulo refill
        evictions), ``unhealed`` drops to 0 and the published snapshot is
        exact (``stale=False``).
        """
        pb = delta.prepare_batch(u, v, w, self.n)
        # Thread stable gids through by canonical pair key.
        live = np.flatnonzero(~self._dead[: self._count])
        r_lo, r_hi, _, r_gid, _ = self._reservoir.edges()
        known_keys = np.concatenate(
            [
                edge_keys(self._lo[live], self._hi[live], self.n),
                edge_keys(r_lo, r_hi, self.n),
            ]
        )
        known_gids = np.concatenate([self._gid[live], r_gid])
        order = np.argsort(known_keys, kind="stable")
        known_keys, known_gids = known_keys[order], known_gids[order]
        kq = edge_keys(pb.lo, pb.hi, self.n)
        gid = np.empty(pb.count, np.int32)
        match = np.zeros(pb.count, bool)
        if len(known_keys) and pb.count:
            j = np.clip(np.searchsorted(known_keys, kq), 0, len(known_keys) - 1)
            match = known_keys[j] == kq
            gid[match] = known_gids[j[match]]
        n_fresh = int((~match).sum())
        gid[~match] = np.arange(
            self._next_gid, self._next_gid + n_fresh, dtype=np.int32
        )
        self._next_gid += n_fresh
        # The supplied multiset replaces the engine's history, so
        # packability restarts from it instead of the running conjunction.
        ok = weights_packable(pb.w)
        if not ok and self._pack is True:
            raise ValueError(
                "pack=True requires integral weights in [0, 255]; "
                "construct with pack=None/False for general weights"
            )
        self._packable = ok
        cap = next_pow2(max(pb.count, 1), 1)
        use_pack = (
            self._pack
            if self._pack is not None
            else self._packable and cap < PACK_IDX_MASK
        )
        if use_pack and cap >= PACK_IDX_MASK:
            raise ValueError(
                f"pack=True needs local eids < 2^24 - 1; recertify over "
                f"{pb.count} edges overflows the pack32 index field"
            )
        lo_u = np.zeros(cap, np.int32)
        hi_u = np.zeros(cap, np.int32)
        w_u = np.full(cap, np.inf, np.float32)
        gid_u = np.full(cap, -1, np.int32)
        valid_u = np.zeros(cap, bool)
        # gid-ordered slots, as in _run_union: ties resolve to the
        # strict (w, gid) order, so the rebuilt forest is the same one
        # incremental maintenance over this multiset would have produced
        order = np.argsort(gid, kind="stable")
        lo_u[: pb.count], hi_u[: pb.count] = pb.lo[order], pb.hi[order]
        w_u[: pb.count], gid_u[: pb.count] = pb.w[order], gid[order]
        valid_u[: pb.count] = True
        g = self._union_graph(lo_u, hi_u, w_u, valid_u)
        self._union_shapes.add((tuple(g.src.shape), bool(use_pack)))
        self.last_union_shape = tuple(g.src.shape)
        r = self._solve_graph(g, pb.count, bool(use_pack))
        self._unhealed = 0
        self._commit(r, lo_u, hi_u, w_u, gid_u, valid_u, reset_reservoir=True)
        return UpdateStats(
            version=self._version,
            weight=self._weight,
            n_components=self.snapshots.acquire().n_components,
            n_forest_edges=self._count,
            n_new=n_fresh,
            n_decrease=0,
            n_drop=pb.dropped,
            iterations=r.iterations,
            union_directed_edges=self.last_union_shape[0],
            batch_capacity=self._cap_cur,
            recompiles=self.recompiles,
            n_revived=int(match.sum()),
            reservoir_size=len(self._reservoir),
        )

    # ------------------------------------------------------------------
    # durable state (repro_torch.stream.persist)
    # ------------------------------------------------------------------

    def state_dict(self) -> dict:
        """The engine's complete durable state as a flat dict of numpy
        arrays, key for key the reference's.

        Everything incremental correctness depends on is here: the forest
        store (full-capacity columns + live count/tombstones), the
        replacement-edge reservoir, the gid counter, the canonical labels
        behind the published snapshot, lossy/unhealed certification
        state, the packability conjunction and the adaptive-capacity
        position. Shapes are fixed by the engine configuration, so the
        tree restores into any engine constructed with the same
        ``(n, batch_capacity, reservoir_*)`` — ``config`` fingerprints
        that and :meth:`restore_state` rejects mismatches loudly.
        """
        recent = np.full(8, -1, np.int64)
        recent[: len(self._recent)] = self._recent[-8:]
        snap = self.snapshots.acquire()
        state = {
            "config": np.asarray(self._config(), np.int64),
            "lo": self._lo.copy(),
            "hi": self._hi.copy(),
            "w": self._w.copy(),
            "gid": self._gid.copy(),
            "dead": self._dead.copy(),
            "count": np.int64(self._count),
            "n_dead": np.int64(self._n_dead),
            "weight": np.float64(self._weight),
            "next_gid": np.int64(self._next_gid),
            "version": np.int64(self._version),
            "packable": np.bool_(self._packable),
            "cap_cur": np.int64(self._cap_cur),
            "recent": recent,
            "lossy": self._lossy.copy(),
            "canon": self._canon.copy(),
            "unhealed": np.int64(self._unhealed),
            "stale": np.bool_(snap.stale),
        }
        for k, v in self._reservoir.state_dict().items():
            state[f"reservoir/{k}"] = v
        return state

    def restore_state(self, state: dict) -> None:
        """Inverse of :meth:`state_dict`: adopt a saved engine state.

        Rebuilds the live index and the reservoir's key index, then
        publishes a snapshot at the saved version — queries resume
        against exactly the forest the saved engine was serving
        (bit-identical weight, gid set and canonical labels).
        """
        cfg = np.asarray(state["config"], np.int64)
        want = self._config()
        if list(cfg) != want:
            raise ValueError(
                f"checkpoint config {list(map(int, cfg))} does not match "
                f"this engine's config {want}; construct the engine with "
                "the same (n, batch_capacity, exact_deletes, reservoir_*)"
            )
        self._lo = np.asarray(state["lo"], np.int32).copy()
        self._hi = np.asarray(state["hi"], np.int32).copy()
        self._w = np.asarray(state["w"], np.float32).copy()
        self._gid = np.asarray(state["gid"], np.int32).copy()
        self._dead = np.asarray(state["dead"], bool).copy()
        self._count = int(state["count"])
        self._n_dead = int(state["n_dead"])
        self._weight = float(state["weight"])
        self._next_gid = int(state["next_gid"])
        self._version = int(state["version"])
        self._packable = bool(state["packable"])
        self._cap_cur = int(state["cap_cur"])
        recent = np.asarray(state["recent"], np.int64)
        self._recent = [int(x) for x in recent if x >= 0]
        self._lossy = np.asarray(state["lossy"], bool).copy()
        self._canon = np.asarray(state["canon"], np.int32).copy()
        self._unhealed = int(state["unhealed"])
        self._reservoir.restore_state(
            {
                k.split("/", 1)[1]: v
                for k, v in state.items()
                if k.startswith("reservoir/")
            }
        )
        self._publish(stale=bool(state["stale"]), parent=self._canon)
        self._refresh_live_index()

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------

    def _config(self) -> list:
        return [
            self.n,
            self.batch_capacity,
            self.forest_capacity,
            int(self.exact_deletes),
            self._reservoir.capacity,
            self._reservoir.per_component,
        ]

    def _classify(self, pb) -> delta.BatchPlan:
        return delta.classify_batch(
            pb, self._live_keys, self._live_w, self.n, device=self.device
        )

    def _note_batch(self, pb) -> None:
        """Track packability and (if adaptive) resize the padded batch
        slots by powers of two off the observed batch sizes."""
        if pb.count:
            # The pack32 regime test of the planner (core.semiring); here
            # it is a running conjunction over the insert stream.
            ok = weights_packable(pb.w)
            if not ok and self._pack is True:
                raise ValueError(
                    "pack=True requires integral weights in [0, 255]; "
                    "construct with pack=None/False for general weights"
                )
            self._packable = self._packable and ok
        if not self.adaptive_capacity:
            return
        self._recent.append(pb.count)
        del self._recent[:-8]  # sliding window
        need = min(next_pow2(pb.count, self._min_capacity), self.batch_capacity)
        if need > self._cap_cur:
            self._cap_cur = need  # grow immediately: the batch must fit
        elif (
            self._cap_cur > self._min_capacity
            and max(self._recent) <= self._cap_cur // 4
        ):
            # Shrink one step with 4x hysteresis so an oscillating load
            # doesn't thrash the buffer size.
            self._cap_cur = max(self._min_capacity, self._cap_cur // 2)

    def _use_pack(self) -> bool:
        if self._pack is not None:
            return self._pack
        # Local union eids stay < U; strict 24-bit bound avoids the
        # pack32(255, 2^24−1) == identity collision.
        return self._packable and self.union_edge_capacity < PACK_IDX_MASK

    def _live_weight(self) -> float:
        """Exact live-row weight sum (float64 accumulate — the published
        weight is always recomputed from the rows, never decremented)."""
        live = ~self._dead[: self._count]
        return float(self._w[: self._count][live].sum(dtype=np.float64))

    def _union_graph(self, lo_u, hi_u, w_u, valid_u) -> Graph:
        local_eid = np.arange(len(lo_u), dtype=np.int32)
        return from_arrays(
            np.concatenate([lo_u, hi_u]),
            np.concatenate([hi_u, lo_u]),
            np.concatenate([w_u, w_u]),
            np.concatenate([local_eid, local_eid]),
            np.concatenate([valid_u, valid_u]),
            self.n,
            device=self.device,
        )

    def _solve_graph(self, g: Graph, live_edges: int, use_pack: bool) -> _HostResult:
        """MSF over one padded union graph — fused coarsen levels past the
        live-edge threshold, the flat solve below it — read back to the
        host in one copy."""
        segmin = self._segmin if use_pack else None
        if self._coarsen_cfg is not None and live_edges >= self.coarsen_threshold:
            eng = CoarsenMSF(self._coarsen_cfg, pack=use_pack, segmin=segmin,
                             **self._msf_opts)
            r = eng(g)
            self.last_coarsen_stats = eng.last_stats
        else:
            # flat_msf's backend resolution degrades "sorted" — a
            # dedupe-only backend — to "auto" for the flat hook loop's
            # unsorted segment ids.
            self.last_coarsen_stats = None
            r = flat_msf(g, pack=use_pack, segmin=segmin, **self._msf_opts)
        return _to_host(r)

    @_spanned("stream.union_solve")
    def _run_union(self, b_lo, b_hi, b_w, b_gid) -> _HostResult:
        """MSF over (live forest ∪ batch) in the fixed-capacity union
        buffer; rewrite the store from the result and publish a snapshot."""
        U = self.union_edge_capacity
        lo_u = np.zeros(U, np.int32)
        hi_u = np.zeros(U, np.int32)
        w_u = np.full(U, np.inf, np.float32)
        gid_u = np.full(U, -1, np.int32)
        valid_u = np.zeros(U, bool)

        live = np.flatnonzero(~self._dead[: self._count])
        f = len(live)
        b = len(b_lo)
        m = f + b
        # Fill slots [0, m) in gid order: the MSF breaks weight ties by
        # minimum local eid, so gid-ordered slots make the solve implement
        # the strict (w, gid) total order — the MSF is then *unique*,
        # which is what keeps reservoir entries non-tree under insertions
        # and makes chunked heals order-independent.
        lo_m = np.concatenate([self._lo[live], b_lo])
        hi_m = np.concatenate([self._hi[live], b_hi])
        w_m = np.concatenate([self._w[live], b_w])
        gid_m = np.concatenate([self._gid[live], b_gid])
        order = np.argsort(gid_m, kind="stable")
        lo_u[:m], hi_u[:m] = lo_m[order], hi_m[order]
        w_u[:m], gid_u[:m] = w_m[order], gid_m[order]
        valid_u[:m] = True

        g = self._union_graph(lo_u, hi_u, w_u, valid_u)
        use_pack = self._use_pack()
        # The reference's executable key: the buffer shape and pack mode.
        self._union_shapes.add((tuple(g.src.shape), use_pack))
        self.last_union_shape = tuple(g.src.shape)
        r = self._solve_graph(g, f + b, use_pack)
        self._commit(r, lo_u, hi_u, w_u, gid_u, valid_u)
        return r

    def _commit(
        self, r: _HostResult, lo_u, hi_u, w_u, gid_u, valid_u, *, reset_reservoir=False
    ):
        """Rewrite the store from one MSF result over a padded union
        buffer, retain the race losers in the reservoir, and publish."""
        n_f = r.n_msf_edges
        sel = r.msf_eids[:n_f]  # local union indices → rows
        canon = _canonicalize(r.parent)
        self._canon = canon
        # Non-tree retention: every valid union slot that lost the race
        # goes to the reservoir under its (intra-)component bucket.
        win = np.zeros(len(valid_u), bool)
        win[sel] = True
        lose = np.flatnonzero(valid_u & ~win)
        if reset_reservoir:
            self._reservoir.clear()
            self._lossy[:] = False
        else:
            # existing entries move to their merged components first, so
            # the per-component caps see the post-solve partition
            self._reservoir.rebucket(canon)
        evicted, n_evicted = self._reservoir.absorb(
            lo_u[lose], hi_u[lose], w_u[lose], gid_u[lose], canon[lo_u[lose]]
        )
        if n_evicted:
            obs.counter("stream.reservoir.evictions").inc(n_evicted)
            self._lossy |= np.isin(canon, evicted)
        if self._lossy.any():
            # Lossiness is a component property: normalize per-vertex
            # marks so merges inherit it and later splits keep both sides
            # conservatively flagged.
            comp_lossy = np.zeros(self.n, bool)
            comp_lossy[np.unique(canon[self._lossy])] = True
            self._lossy = comp_lossy[canon]
        self._lo[:n_f], self._hi[:n_f] = lo_u[sel], hi_u[sel]
        self._w[:n_f], self._gid[:n_f] = w_u[sel], gid_u[sel]
        self._dead[:] = False
        self._count = n_f
        self._n_dead = 0
        self._weight = self._live_weight()
        self._version += 1
        self._publish(stale=self._unhealed > 0, parent=canon)
        self._refresh_live_index()

    def _publish(self, *, stale: bool, parent=None):
        if parent is None:
            parent = self.snapshots.acquire().parent
        self.snapshots.publish(
            make_snapshot(
                self._version,
                parent,
                self._weight,
                self.n_forest_edges,
                stale=stale,
                n_unhealed=self._unhealed,
                device=self.device,
            )
        )

    def _refresh_live_index(self):
        live = np.flatnonzero(~self._dead[: self._count])
        keys, w_sorted, order = delta.build_live_index(
            self._lo[live],
            self._hi[live],
            self._w[live],
            self.n,
            self.forest_capacity,
        )
        if self.n <= delta.PACK_LIMIT:
            # the packed probe runs on the device: copy the keys once per
            # refresh, not once per probed chunk
            keys = torch.as_tensor(keys).to(self.device)
        self._live_keys = keys
        self._live_w = w_sorted
        self._live_rows = live[order] if len(live) else np.zeros(0, np.int64)


class StreamingMSF(StreamEngine):
    """Deprecated direct-construction shim over :class:`StreamEngine`.

    .. deprecated::
        Use the declarative API of the solve package instead::

            p = plan(n, SolveSpec(mode="stream", batch_capacity=1024))
            p.update(u, v, w)       # -> SolveReport
            p.query(qu, qv)         # -> bool [k]

        The shim is the same engine (same state layout, same snapshots,
        bit-identical forests); it only adds this warning.
    """

    def __init__(self, *args, **kwargs):
        warnings.warn(
            "StreamingMSF is deprecated; use the solve package's plan(n, "
            "SolveSpec(mode='stream', ...)) and its update()/query() "
            "surfaces instead",
            DeprecationWarning,
            stacklevel=2,
        )
        super().__init__(*args, **kwargs)
