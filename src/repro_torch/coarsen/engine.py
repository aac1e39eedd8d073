"""Coarsening engine: alternate contract and filter levels, then hand the
residual graph to the flat AS solver (counterpart of
``repro.coarsen.engine``).

Each level runs K hook+shortcut rounds (``contract.contract_level_und``),
the rank/relabel pass, and the sort-dedupe edge filter
(``filter.filter_level``). Both n and m shrink geometrically, so the
O(n) vector work and the O(m) sweeps only ever touch the *current*
level's padded arrays. When the supervertex count drops to ``cutoff`` (or
edges run out, or a level makes no progress), the residual graph goes to
the flat solve.

n and E are padded to powers of two between levels, as in the reference,
so that every per-level array compares one to one with it. Where the
reference builds the undirected edge set on the host and copies the level
arrays back to numpy between levels, the port keeps every array on the
graph's device, from the canonical edge set to the final labels: only
per-level scalars (n_next, m_new, the hooked count) cross to the host,
plus the edges themselves when ``dedupe="host"`` runs the numpy twin.

Invariants:
- every hooked edge is an MSF edge of the *original* graph (cut property
  under the distinct (w, eid) total order), recorded by global eid;
- filtering is exact: a dropped parallel edge closes a cycle on which it
  is not the (w, eid)-minimum (cycle property);
- ``label_map`` composes the per-level relabelings, so original-vertex
  component labels are one gather at the end.

Observability, as in the reference: ``coarsen.levels`` and
``coarsen.residual`` spans around the two halves of a solve, a
``coarsen.level`` span per level and (unfused) a ``coarsen.filter`` span
per progressing level; in trace mode only, ``coarsen.contract`` and
``coarsen.relabel`` spans inside each level (fused: and
``coarsen.filter``). One code path serves every mode: the trace-only
spans are no-ops otherwise.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch import obs
from repro_torch.coarsen.config import CoarsenConfig, resolve_dedupe
from repro_torch.coarsen.contract import ContractResult, hook_rounds, make_und_reduce
from repro_torch.coarsen.filter import (
    filter_level,
    filter_level_callback,
    filter_level_host,
    front_packed,
)
from repro_torch.coarsen.relabel import canonical_minvertex_labels, rank_relabel
from repro_torch.core.msf import MSFResult, flat_msf
from repro_torch.core.semiring import auto_pack
from repro_torch.graphs.partition import Partition2D, partition_edges_2d
from repro_torch.graphs.structures import IMAX, Graph
from repro_torch.kernels import ops
from repro_torch.obs.trace import host_sync, trace_span


def next_pow2(k: int, floor: int = 16) -> int:
    """Smallest power of two ≥ max(k, floor)."""
    return max(floor, 1 << (max(int(k), 1) - 1).bit_length())


class LevelStats(NamedTuple):
    n: int  # vertices entering the level
    m: int  # undirected edges entering the level
    n_next: int  # supervertices after contraction
    m_next: int  # unique live pairs after filtering
    hooked: int  # MSF edges recorded this level


class CoarsenStats(NamedTuple):
    levels: Tuple[LevelStats, ...]
    residual_n: int
    residual_m: int


class LevelBackends(NamedTuple):
    """What the level loop resolved for one run."""

    pack: bool  # pack32 level kernels
    dedupe: str  # "device" | "host"
    hook: Any  # packed segment-min of the hook reduction, or None
    dedupe_segmin: Any  # packed segment-min of the dedupe, or None


class CoarsenPrelude(NamedTuple):
    """Everything the contraction levels decided, residual not yet solved."""

    weight: float  # MSF weight hooked across all levels
    msf_eids: torch.Tensor  # int32: global eids of level-hooked MSF edges
    label_map: torch.Tensor  # int32 [n0]: original vertex → residual vertex id
    residual: Graph  # canonical symmetric residual graph
    stats: CoarsenStats
    level_iters: int = 0  # hook+shortcut rounds the levels ran
    backends: LevelBackends | None = None


def _next_pow2(k: int) -> int:
    return next_pow2(k, floor=8)  # edge buffers tolerate a smaller floor


def _eid_capacity(eid: torch.Tensor, m0: int) -> int:
    """Pow2 bound on the global eids carried by the levels: sizes the
    eid → position hook-payload table of ``make_und_reduce``'s pack32
    route."""
    if m0 == 0:
        return 8
    host_sync("coarsen.eid_capacity")
    return _next_pow2(int(eid[:m0].max()) + 1)


def _canonical(graph: Graph):
    """The undirected (lo < hi) edge set, pow2-padded, on the graph's
    device: the reference's ``_canonical_host`` without the host copy."""
    host_sync("coarsen.canonical")
    idx = (graph.valid & (graph.src < graph.dst)).nonzero().squeeze(1)
    m0 = int(idx.numel())
    pad = _next_pow2(m0)
    arrays = (graph.src, graph.dst, graph.w, graph.eid, graph.valid)
    fills = (0, 0, float("inf"), IMAX, False)
    return (*(front_packed(a[idx], pad, f, graph.device) for a, f in zip(arrays, fills)), m0)


def _residual_graph(lo, hi, w, eid, valid, n: int) -> Graph:
    """Symmetric residual ``Graph`` from the canonical level arrays, on
    their device (``graphs.structures.graph_from_canonical`` without the
    host round trip)."""
    return Graph(
        src=torch.cat([lo, hi]), dst=torch.cat([hi, lo]), w=torch.cat([w, w]),
        eid=torch.cat([eid, eid]), valid=torch.cat([valid, valid]), n=int(n),
    )


class FusedLevel(NamedTuple):
    """One coarsening level's outputs, edge arrays at the input capacity
    with live entries front-packed."""

    lo: torch.Tensor  # int32 [E] — supervertex pairs, lo < hi
    hi: torch.Tensor  # int32 [E]
    w: torch.Tensor  # float32 [E]; +inf beyond m_new
    eid: torch.Tensor  # int32 [E] — original global eids; IMAX beyond m_new
    valid: torch.Tensor  # bool [E]
    m_new: torch.Tensor  # int32 scalar: unique live pairs
    new_ids: torch.Tensor  # int32 [n]: vertex → supervertex rank
    n_next: torch.Tensor  # int32 scalar: supervertex count (incl. padding roots)
    weight: torch.Tensor  # float32 scalar: weight hooked this level
    msf_eids: torch.Tensor  # int32 [n]: global eids hooked (front-packed)
    n_msf_edges: torch.Tensor  # int32 scalar
    label_map: torch.Tensor  # int32 [n0]: original vertex → supervertex id


def _contract(lo, hi, w, eid, valid, *, n: int, eid_capacity: int, rounds: int,
              pack: bool, segmin) -> ContractResult:
    """:func:`~repro_torch.coarsen.contract.contract_level_und` with its
    two phases, contract and relabel, under trace-mode spans (the
    reference's ``_traced_contract``): the same outputs in every mode."""
    with trace_span("coarsen.contract", n=n, rounds=rounds) as sp:
        reduce_fn = make_und_reduce(lo, hi, w, eid, valid, n=n, eid_capacity=eid_capacity,
                                    pack=pack, segmin=segmin)
        p, weight, msf_eids, n_f = sp.attach(hook_rounds(reduce_fn, n, rounds, lo.device))
    with trace_span("coarsen.relabel", n=n) as sp:
        new_ids, n_next = sp.attach(rank_relabel(p))
    return ContractResult(parent=p, new_ids=new_ids, n_next=n_next, weight=weight,
                          msf_eids=msf_eids, n_msf_edges=n_f)


def fused_level(lo, hi, w, eid, valid, label_map, *, n: int, eid_capacity: int,
                rounds: int = 2, pack: bool = False, segmin=None, segmin_dedupe=None,
                dedupe_host: bool = False) -> FusedLevel:
    """One whole coarsening level: contract (K hook+shortcut rounds) →
    rank_relabel → sort → sorted-segment dedupe → compaction, with
    ``label_map`` composed on the device. Dead tail slots are the sort
    sentinels (w = +inf, eid = IMAX). ``dedupe_host=True`` runs the dedupe
    on the host (:func:`filter_level_callback`).

    The reference compiles this as one executable; the port runs it
    eagerly, so it differs from the unfused loop only in that the edge
    tensors are sliced, not re-padded, between levels, and the filter runs
    even on a level that makes no progress. In trace mode its contract,
    relabel and filter phases are spans (the reference's
    ``_traced_fused_level``).
    """
    res = _contract(lo, hi, w, eid, valid, n=n, eid_capacity=eid_capacity, rounds=rounds,
                    pack=pack, segmin=segmin)
    with trace_span("coarsen.filter", n=n, host=dedupe_host) as sp:
        if dedupe_host:
            fr = filter_level_callback(lo, hi, w, eid, valid, res.new_ids, n=n)
        else:
            fr = filter_level(lo, hi, w, eid, valid, res.new_ids, n=n, pack=pack,
                              segmin=segmin_dedupe)
        fr = sp.attach(fr)
    return FusedLevel(
        lo=fr.lo, hi=fr.hi, w=fr.w, eid=fr.eid, valid=fr.valid, m_new=fr.m_new,
        new_ids=res.new_ids, n_next=res.n_next, weight=res.weight,
        msf_eids=res.msf_eids, n_msf_edges=res.n_msf_edges,
        label_map=res.new_ids[label_map.long()],
    )


def _level_setup(graph: Graph, cfg: CoarsenConfig, segmins):
    """The canonical edge arrays, their count, the eid capacity, and what
    the levels resolve: pack32 and the backends."""
    canon = _canonical(graph)
    use_pack = (
        auto_pack(graph.w, graph.eid, graph.valid, 2 * len(canon[0]))
        if cfg.pack is None else cfg.pack
    )
    if segmins is None:
        segmins = tuple(ops.packed_segmin(cfg.segmin, site) if use_pack else None
                        for site in ("flat", "dedupe"))
    backends = LevelBackends(
        pack=bool(use_pack), dedupe=resolve_dedupe(cfg.dedupe, graph.device.type),
        hook=segmins[0], dedupe_segmin=segmins[1],
    )
    return canon[:5], canon[5], _eid_capacity(canon[3], canon[5]), backends


def _prelude(graph, cfg, lo, hi, w, eid, valid, label_map, weight, eids_acc, stats,
             n_cur, m_cur, backends) -> CoarsenPrelude:
    # Residual n is pow2-padded too (padding vertices are isolated
    # singletons, never referenced by label_map).
    residual = _residual_graph(lo, hi, w, eid, valid, next_pow2(n_cur, floor=8))
    return CoarsenPrelude(
        weight=weight,
        msf_eids=torch.cat(eids_acc) if eids_acc else lo.new_zeros(0),
        label_map=label_map,
        residual=residual,
        stats=CoarsenStats(levels=tuple(stats), residual_n=n_cur, residual_m=m_cur),
        level_iters=len(stats) * cfg.rounds_per_level,
        backends=backends,
    )


def _run_levels_fused(graph: Graph, cfg: CoarsenConfig, segmins) -> CoarsenPrelude:
    """Level loop over :func:`fused_level`: the edge arrays and
    ``label_map`` stay on the device across levels and are sliced, not
    re-padded; per-level scalars and the hooked eids cross to the host."""
    (lo, hi, w, eid, valid), m_cur, eid_cap, be = _level_setup(graph, cfg, segmins)
    label_map = torch.arange(graph.n, dtype=torch.int32, device=graph.device)
    weight = 0.0
    eids_acc: list = []
    stats: list = []
    n_cur = graph.n
    while len(stats) < cfg.max_levels and n_cur > cfg.cutoff and m_cur > 0:
        n_pad = next_pow2(n_cur, floor=8)
        with obs.span("coarsen.level", level=len(stats), n=n_cur, m=m_cur) as lsp:
            res = lsp.attach(fused_level(
                lo, hi, w, eid, valid, label_map,
                n=n_pad, eid_capacity=eid_cap, rounds=cfg.rounds_per_level, pack=be.pack,
                segmin=be.hook, segmin_dedupe=be.dedupe_segmin,
                dedupe_host=be.dedupe == "host",
            ))
        host_sync("coarsen.level_scalars")
        n_next = int(res.n_next) - (n_pad - n_cur)  # drop padding roots
        if n_next == n_cur:  # every component already complete
            break
        host_sync("coarsen.level_scalars", 3)
        n_f = int(res.n_msf_edges)
        eids_acc.append(res.msf_eids[:n_f])
        weight += float(res.weight)
        m_next = int(res.m_new)
        pad = _next_pow2(m_next)
        lo, hi, w, eid, valid = (
            res.lo[:pad], res.hi[:pad], res.w[:pad], res.eid[:pad], res.valid[:pad],
        )
        label_map = res.label_map
        stats.append(LevelStats(n=n_cur, m=m_cur, n_next=n_next, m_next=m_next, hooked=n_f))
        n_cur, m_cur = n_next, m_next
    return _prelude(graph, cfg, lo, hi, w, eid, valid, label_map, weight, eids_acc,
                    stats, n_cur, m_cur, be)


def run_levels(graph: Graph, config: CoarsenConfig | None = None, *,
               segmins=None) -> CoarsenPrelude:
    """Contract-and-filter until the cutoff; return the residual + prelude.

    ``segmins`` is a resolved ``(hook, dedupe)`` pair of packed
    segment-min callables; ``None`` selects ``config.segmin`` at the flat
    and dedupe sites (:func:`~repro_torch.kernels.ops.packed_segmin`).
    """
    cfg = config or CoarsenConfig()
    if cfg.fused:
        return _run_levels_fused(graph, cfg, segmins)
    (lo, hi, w, eid, valid), m_cur, eid_cap, be = _level_setup(graph, cfg, segmins)
    dev = graph.device
    label_map = torch.arange(graph.n, dtype=torch.int32, device=dev)
    weight = 0.0
    eids_acc: list = []
    stats: list = []
    n_cur = graph.n

    while len(stats) < cfg.max_levels and n_cur > cfg.cutoff and m_cur > 0:
        # Vertex count padded to pow2, as in the reference. Padding
        # vertices are isolated, so they stay roots and their ranks trail
        # the real ones: real supervertex ids remain contiguous in [0, R).
        n_pad = next_pow2(n_cur, floor=8)
        with obs.span("coarsen.level", level=len(stats), n=n_cur, m=m_cur):
            res = _contract(
                lo, hi, w, eid, valid,
                n=n_pad, eid_capacity=eid_cap, rounds=cfg.rounds_per_level,
                pack=be.pack, segmin=be.hook,
            )
            host_sync("coarsen.level_scalars")
            n_next = int(res.n_next) - (n_pad - n_cur)  # drop padding roots
            if n_next == n_cur:  # every component already complete
                break
            host_sync("coarsen.level_scalars", 2)
            n_f = int(res.n_msf_edges)
            eids_acc.append(res.msf_eids[:n_f])
            weight += float(res.weight)
            with obs.span("coarsen.filter", n=n_pad, host=be.dedupe == "host") as fsp:
                if be.dedupe == "host":
                    l2, h2, w2, e2 = filter_level_host(lo, hi, w, eid, valid, res.new_ids,
                                                       n_cur)
                    m_next = len(l2)
                    pad = _next_pow2(m_next)
                    lo, hi, w, eid = (
                        front_packed(a, pad, f, dev)
                        for a, f in zip((l2, h2, w2, e2), (0, 0, float("inf"), IMAX)))
                else:
                    fr = fsp.attach(filter_level(lo, hi, w, eid, valid, res.new_ids,
                                                 n=n_pad, pack=be.pack,
                                                 segmin=be.dedupe_segmin))
                    host_sync("coarsen.level_scalars")
                    m_next = int(fr.m_new)
                    pad = _next_pow2(m_next)
                    lo, hi, w, eid = fr.lo[:pad], fr.hi[:pad], fr.w[:pad], fr.eid[:pad]
            label_map = res.new_ids[label_map.long()]
            stats.append(LevelStats(n=n_cur, m=m_cur, n_next=n_next, m_next=m_next,
                                    hooked=n_f))
            valid = torch.arange(pad, device=dev) < m_next  # the filter front-packs
            n_cur, m_cur = n_next, m_next

    return _prelude(graph, cfg, lo, hi, w, eid, valid, label_map, weight, eids_acc,
                    stats, n_cur, m_cur, be)


def _finalize(prelude: CoarsenPrelude, residual_parent: torch.Tensor,
              residual_eids: torch.Tensor, residual_weight: float, residual_iters: int,
              n0: int) -> MSFResult:
    """Merge level picks with the residual solve into one MSFResult in
    original-graph vertex/edge ids, on the residual's device."""
    dev = residual_parent.device
    all_eids = torch.cat([prelude.msf_eids, residual_eids])
    msf_eids = torch.full((n0,), IMAX, dtype=torch.int32, device=dev)
    msf_eids[: all_eids.numel()] = all_eids
    comp = residual_parent[prelude.label_map.long()]  # [n0] residual-space labels

    def _t(x, dtype):
        host_sync("coarsen.finalize")  # a synchronous copy to the device
        return torch.tensor(x, dtype=dtype, device=dev)

    return MSFResult(
        weight=_t(prelude.weight + residual_weight, torch.float32),
        parent=canonical_minvertex_labels(comp, residual_parent.numel()),
        msf_eids=msf_eids,
        n_msf_edges=_t(all_eids.numel(), torch.int32),
        iterations=_t(prelude.level_iters + residual_iters, torch.int32),
    )


class CoarsenMSF:
    """Reusable engine front-end: holds a config, records per-run stats.

    ``msf_kw`` (variant/shortcut/capacity/pack/segmin/...) is forwarded to
    the residual flat solve; ``config`` controls the levels. The result is
    in input-graph ids: ``msf_eids`` are global eids, and ``parent`` labels
    components by their minimum original vertex.
    """

    def __init__(self, config: CoarsenConfig | None = None, **msf_kw):
        self.config = config or CoarsenConfig()
        # segmin only parameterizes the pack=True inner loop of the flat
        # solve: keep it for the levels (via config), forward it only
        # alongside pack=True.
        if not msf_kw.get("pack"):
            msf_kw.pop("segmin", None)
        self.msf_kw = msf_kw
        self.last_stats: CoarsenStats | None = None
        self.last_backends: LevelBackends | None = None

    def __call__(self, graph: Graph) -> MSFResult:
        with obs.span("coarsen.levels", n=graph.n):
            prelude = run_levels(graph, self.config)
        with obs.span("coarsen.residual", n=prelude.residual.n,
                      m=prelude.stats.residual_m) as sp:
            r = sp.attach(flat_msf(prelude.residual, **self.msf_kw))
        self.last_stats = prelude.stats
        self.last_backends = prelude.backends
        host_sync("coarsen.residual_scalars", 3)
        return _finalize(
            prelude,
            r.parent,
            r.msf_eids[: int(r.n_msf_edges)],
            float(r.weight),
            int(r.iterations),
            graph.n,
        )


def coarsen_msf(graph: Graph, *, config: CoarsenConfig | None = None,
                segmin: str | None = None, fused: bool | None = None,
                **msf_kw) -> MSFResult:
    """One-shot form of :class:`CoarsenMSF`; ``segmin`` (when given)
    applies to the level kernels, overriding ``config.segmin``, and, with
    ``pack=True``, to the residual; ``fused`` (when given) overrides
    ``config.fused``."""
    cfg = config or CoarsenConfig()
    if segmin is not None:
        cfg = dataclasses.replace(cfg, segmin=segmin)
    if fused is not None:
        cfg = dataclasses.replace(cfg, fused=fused)
    return CoarsenMSF(cfg, segmin=segmin, **msf_kw)(graph)


# ---------------------------------------------------------------------------
# Partition2D-aware pre-contraction for the distributed engine
# ---------------------------------------------------------------------------

def precontract_partition(graph: Graph, rows: int, cols: int, *,
                          config: CoarsenConfig | None = None
                          ) -> Tuple[Partition2D, CoarsenPrelude]:
    """Coarsen on one device first, then 2D-partition only the residual.

    The Fig-2 schedule pays all-gathers proportional to n and local work
    proportional to a rank's edge block; both shrink with the contracted
    residual. Fold the distributed result back into original-graph ids
    with :func:`merge_distributed`. The in-mesh levels
    (``repro_torch.coarsen.dist.DistCoarsenMSF``) run the same levels on
    the grid instead; this host-prelude pipeline is their baseline.
    """
    prelude = run_levels(graph, config)
    return partition_edges_2d(prelude.residual, rows, cols), prelude


def merge_distributed(prelude: CoarsenPrelude, dist_result) -> MSFResult:
    """Combine a ``DistMSFResult`` over the residual with the prelude;
    ``iterations`` adds the rounds the levels ran to the distributed
    solve's."""
    dev = prelude.label_map.device
    n_f = int(dist_result.n_msf_edges)
    return _finalize(
        prelude,
        torch.as_tensor(dist_result.parent).to(dev),
        torch.as_tensor(dist_result.msf_eids)[:n_f].to(dev),
        float(dist_result.weight),
        int(dist_result.iterations),
        prelude.label_map.numel(),
    )
