"""Distributed coarsening levels on a grid of ``torch.distributed`` ranks
(counterpart of ``repro.coarsen.dist``).

The contract → relabel → filter level of the single-device engine runs
on the ``Partition2D`` [R, C, Emax] edge blocks, each rank on its own
block, so nothing but control scalars and the hooked eids leaves the
devices:

- edges are re-keyed once from block-local offsets to **global** vertex
  ids (``graphs.partition.block_global_ids``): after the first relabel
  the (row_of, col_of) block alignment is gone, so each round instead
  reduces local per-root partials into a dense [n] accumulator combined
  across the grid by the MINWEIGHT semiring (``make_und_reduce`` with an
  all-reduce(min) ``combine``);
- the supervertex rank vector (``rank_relabel`` of the replicated parent)
  is computed alike on every rank and each rank re-keys its block
  locally, then sort-dedupes it in place (``filter_level`` on the local
  block: the sorted segment-min, the CUDA kernel on the card).
  Cross-rank parallels survive the local dedupe; that is exact (they are
  non-minimal on a cycle, and the hook combine never selects them while
  the lighter copy lives). Between levels the blocks are sliced to the
  largest block's pow2 count: no re-partition;
- after the levels stop (cutoff, no progress, max_levels) the residual
  solve runs on the grid too: hook+shortcut rounds over the same blocks
  until no root hooks, with the parent vector replicated (n has shrunk
  by then), so shortcutting is local pointer jumping.

``dedupe="host"`` keeps a per-level host fallback: contraction runs on
the grid, but each rank's block hops to the host for the numpy lexsort
dedupe (``filter_level_host``): L round trips, counted in
``DistCoarsenStats.host_roundtrips`` (0 on the device path).

Each level is a ``dist.level`` obs span and the residual a
``dist.residual`` span; with metrics on, ``dist.allreduce.passes`` and
``dist.allreduce.elements`` count the combine's all-reduce volume, as
in the reference.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.coarsen.config import CoarsenConfig, resolve_dedupe
from repro_torch.coarsen.contract import contract_rounds, make_und_reduce
from repro_torch.coarsen.engine import LevelStats, _next_pow2
from repro_torch.coarsen.filter import filter_level, filter_level_host, front_packed
from repro_torch.coarsen.relabel import canonical_minvertex_labels
from repro_torch.core.msf import MSFResult, hook_and_tiebreak, record_edges
from repro_torch.core.msf_dist import _BlockMemo, _flat_axes, check_mesh, local_blocks
from repro_torch.core.semiring import IMAX, auto_pack
from repro_torch.core.shortcut import complete_shortcut
from repro_torch.graphs.partition import Partition2D, block_global_ids
from repro_torch.graphs.structures import host_array
from repro_torch.kernels import ops


def _account_allreduce(rounds: int, n_pad: int, pack: bool) -> None:
    """Analytic all-reduce volume of ``rounds`` cross-rank contract rounds
    over a dense [n_pad] accumulator: two dense passes per round on the
    pack path (packed minkey + payload), three on the float path (minw,
    mineid, payload), the ``combine`` call sites of ``make_und_reduce``."""
    if not obs.metrics_active():
        return
    passes = (2 if pack else 3) * rounds
    obs.counter("dist.allreduce.passes").inc(passes)
    obs.counter("dist.allreduce.elements").inc(passes * n_pad)


class DistCoarsenStats(NamedTuple):
    """Per-run surface of the distributed level pipeline.

    ``m`` counts are *block entries*: directed copies at level 0, then
    per-block-unique canonical pairs; a pair duplicated across ranks
    counts once per rank (local dedupe only).
    """

    levels: Tuple[LevelStats, ...]
    residual_n: int
    residual_m: int  # block entries handed to the residual solve
    residual_iters: int  # hook+shortcut rounds the residual solve ran
    host_roundtrips: int  # per-level block round trips (0 = on the grid)


class _Level(NamedTuple):
    blocks: tuple  # this rank's (lo, hi, w, eid, valid), deduped unless host
    new_ids: torch.Tensor
    label_map: torch.Tensor
    n_next: torch.Tensor
    weight: torch.Tensor
    msf_eids: torch.Tensor
    n_msf_edges: torch.Tensor
    m_counts: torch.Tensor | None  # every rank's deduped block count


def _mesh_min(mesh, axes):
    """All-reduce(min) over the whole grid: one masked MINWEIGHT pass."""
    return lambda x: mesh.all_reduce(x, "min", axes)


def _run_level(mesh, axes, blocks, label_map, *, n, eid_capacity, rounds, pack,
               segmin_hook, segmin_dedupe, with_filter) -> _Level:
    """K cross-rank contract rounds, rank/relabel (replicated), and the
    local re-key and sort-dedupe of this rank's block."""
    lo, hi, w, eid, valid = blocks
    reduce_fn = make_und_reduce(lo, hi, w, eid, valid, n=n, eid_capacity=eid_capacity,
                                pack=pack, segmin=segmin_hook, combine=_mesh_min(mesh, axes))
    res = contract_rounds(reduce_fn, n, rounds, lo.device)
    m_counts = None
    if with_filter:
        fr = filter_level(lo, hi, w, eid, valid, res.new_ids, n=n, pack=pack,
                          segmin=segmin_dedupe)
        blocks = (fr.lo, fr.hi, fr.w, fr.eid, fr.valid)
        m_counts = mesh.all_gather(fr.m_new.reshape(1), axes)
    return _Level(blocks=blocks, new_ids=res.new_ids, label_map=res.new_ids[label_map.long()],
                  n_next=res.n_next, weight=res.weight, msf_eids=res.msf_eids,
                  n_msf_edges=res.n_msf_edges, m_counts=m_counts)


def _run_residual(mesh, axes, blocks, *, n, eid_capacity, pack, segmin_hook, limit):
    """Hook+shortcut rounds over the globally keyed blocks until no root
    hooks (or ``limit``): (parent, weight, msf_eids, n_msf_edges, rounds)."""
    lo = blocks[0]
    dev = lo.device
    reduce_fn = make_und_reduce(*blocks, n=n, eid_capacity=eid_capacity, pack=pack,
                                segmin=segmin_hook, combine=_mesh_min(mesh, axes))
    p = torch.arange(n, dtype=torch.int32, device=dev)
    total = torch.zeros((), dtype=torch.float32, device=dev)
    msf_eids = torch.full((n,), IMAX, dtype=torch.int32, device=dev)
    n_f = torch.zeros((), dtype=torch.int32, device=dev)
    it = 0
    while it < limit:
        r = reduce_fn(p)
        p_h, keep, _ = hook_and_tiebreak(p, r.w, r.eid, r.payload[0])
        total = total + torch.where(keep, r.w, 0.0).sum()
        msf_eids, n_f = record_edges(msf_eids, n_f, keep, r.eid)
        p = complete_shortcut(p_h)
        it += 1
        if not bool(keep.any()):
            break
    return p, total, msf_eids, int(n_f), it


def _host_filter_blocks(blocks, new_ids, n_pad, mesh, axes):
    """dedupe="host" level tail: the numpy lexsort dedupe of this rank's
    block, repacked to the pow2 capacity of the largest block on the grid
    (the explicit round-trip path). Returns (blocks, total block entries)."""
    lo, hi, w, eid = filter_level_host(*blocks, new_ids, n_pad)
    dev = mesh.device
    m = len(lo)
    counts = mesh.all_gather(torch.tensor([m], dtype=torch.int64, device=dev), axes)
    cap = _next_pow2(int(counts.max()))
    out = tuple(front_packed(a, cap, f, dev)
                for a, f in zip((lo, hi, w, eid), (0, 0, float("inf"), IMAX)))
    return out + (torch.arange(cap, device=dev) < m,), int(counts.sum())


class DistCoarsenMSF:
    """Distributed coarsen-and-solve driver over a 2D partition.

    Call it with the partition's [R, C, Emax] block arrays (the flat
    distributed driver's signature) on every rank of the mesh; each rank
    takes its own block. Returns an :class:`~repro_torch.core.msf.MSFResult`
    in original-graph ids, alike on every rank; per-run
    :class:`DistCoarsenStats` land on ``last_stats``.

    Config knobs follow the single-device engine: ``dedupe`` "auto"
    resolves to the device pipeline on CUDA and the host fallback on the
    CPU ("device"/"host" force either); ``pack`` None auto-detects the
    pack32 regime; ``segmin`` picks the packed segment-mins (the hook the
    flat kernel, the dedupe the sorted kernel on the card).
    ``max_iters`` bounds the residual solve's rounds.
    """

    def __init__(self, part: Partition2D, mesh, config: CoarsenConfig | None = None, *,
                 row_axis="data", col_axis: str = "model",
                 max_iters: int | None = None):
        check_mesh(part, mesh, row_axis, col_axis)
        self.part = part
        self.mesh = mesh
        self.config = config or CoarsenConfig()
        self.row_axis = row_axis
        self.col_axis = col_axis
        self.max_iters = max_iters
        self.last_stats: DistCoarsenStats | None = None
        self._prep = _BlockMemo()

    def _prepare(self, src_row, dst_col, w, eid, valid):
        """Re-key the blocks to global ids and derive eid_cap, pack and the
        live entry count, all deterministic functions of the inputs, alike
        on every rank; this rank's block goes to its device. Memoized on
        the exact input objects, as in the reference, so that repeated
        solves of one partition skip the O(E) host scans and the upload."""
        def prepare():
            src_g, dst_g = block_global_ids(host_array(src_row), host_array(dst_col),
                                            self.part.shard_size)
            w_np = host_array(w).astype(np.float32)
            eid_np = host_array(eid).astype(np.int32)
            valid_np = host_array(valid).astype(bool)
            eids_live = eid_np[valid_np]
            eid_cap = _next_pow2(int(eids_live.max()) + 1) if eids_live.size else 8
            if self.config.pack is None:
                use_pack = auto_pack(w_np, eid_np, valid_np, eid_cap)
            else:
                use_pack = self.config.pack
            blocks = local_blocks((src_g, dst_g, w_np, eid_np, valid_np), self.mesh,
                                  self.row_axis, self.col_axis)
            return blocks, eid_cap, bool(use_pack), int(valid_np.sum())

        return self._prep.get((src_row, dst_col, w, eid, valid), prepare)

    def __call__(self, src_row, dst_col, w, eid, valid) -> MSFResult:
        part, cfg, mesh = self.part, self.config, self.mesh
        n0 = part.n
        blocks, eid_cap, use_pack, m_cur = self._prepare(src_row, dst_col, w, eid, valid)
        dev = mesh.device
        segmin_hook, segmin_dedupe = (ops.packed_segmin(cfg.segmin, site) if use_pack else None
                                      for site in ("flat", "dedupe"))
        in_mesh = resolve_dedupe(cfg.dedupe, dev.type) != "host"
        axes = _flat_axes(self.row_axis, self.col_axis)

        label_map = torch.arange(n0, dtype=torch.int32, device=dev)
        n_cur = n0
        weight = 0.0
        eids_acc: list = []
        stats: list = []
        roundtrips = 0

        while len(stats) < cfg.max_levels and n_cur > cfg.cutoff and m_cur > 0:
            n_pad = _next_pow2(n_cur)
            with obs.span("dist.level", level=len(stats), n=n_cur, m=m_cur) as lsp:
                lv = lsp.attach(_run_level(
                    mesh, axes, blocks, label_map, n=n_pad, eid_capacity=eid_cap,
                    rounds=cfg.rounds_per_level, pack=use_pack, segmin_hook=segmin_hook,
                    segmin_dedupe=segmin_dedupe, with_filter=in_mesh))
            _account_allreduce(cfg.rounds_per_level, n_pad, use_pack)
            n_next = int(lv.n_next) - (n_pad - n_cur)  # drop padding roots
            if n_next == n_cur:  # every component already complete
                break
            n_f = int(lv.n_msf_edges)
            eids_acc.append(lv.msf_eids[:n_f])
            weight += float(lv.weight)
            if in_mesh:
                m_total = int(lv.m_counts.sum())
                cap = _next_pow2(int(lv.m_counts.max()))
                blocks = tuple(a[:cap] for a in lv.blocks)
            else:
                blocks, m_total = _host_filter_blocks(blocks, lv.new_ids, n_pad, mesh, axes)
                roundtrips += 1
            label_map = lv.label_map
            stats.append(LevelStats(n=n_cur, m=m_cur, n_next=n_next, m_next=m_total,
                                    hooked=n_f))
            n_cur, m_cur = n_next, m_total

        n_res_pad = _next_pow2(n_cur)
        limit = int(self.max_iters if self.max_iters is not None
                    else 2 * int(n_res_pad).bit_length() + 8)
        with obs.span("dist.residual", n=n_cur, m=m_cur) as rsp:
            p_res, r_weight, r_eids, r_nf, r_it = rsp.attach(_run_residual(
                mesh, axes, blocks, n=n_res_pad, eid_capacity=eid_cap, pack=use_pack,
                segmin_hook=segmin_hook, limit=limit))
        # Residual rounds run the same per-round combine schedule.
        _account_allreduce(r_it, n_res_pad, use_pack)

        all_eids = torch.cat(eids_acc + [r_eids[:r_nf]])
        msf_eids = torch.full((n0,), IMAX, dtype=torch.int32, device=dev)
        msf_eids[: all_eids.numel()] = all_eids
        comp = p_res[label_map.long()]
        self.last_stats = DistCoarsenStats(
            levels=tuple(stats), residual_n=n_cur, residual_m=m_cur,
            residual_iters=r_it, host_roundtrips=roundtrips,
        )
        return MSFResult(
            weight=torch.tensor(weight + float(r_weight), dtype=torch.float32, device=dev),
            parent=canonical_minvertex_labels(comp, n_res_pad),
            msf_eids=msf_eids,
            n_msf_edges=torch.tensor(all_eids.numel(), dtype=torch.int32, device=dev),
            iterations=torch.tensor(len(stats) * cfg.rounds_per_level + r_it,
                                    dtype=torch.int32, device=dev),
        )
