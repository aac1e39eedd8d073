"""Built-in engines behind ``repro_torch.solve.plan``, one per mode:
``"flat"``, ``"coarsen"``, ``"dist"`` and ``"stream"``. Builders
receive a *resolved* spec — every backend choice is already concrete;
engines never auto-detect (the coarsen levels resolve their pack32 regime
per run, and the stream engine tracks it per batch, as in the
reference)."""
from __future__ import annotations

import numpy as np

from repro_torch.coarsen.dist import DistCoarsenMSF
from repro_torch.coarsen.engine import CoarsenMSF
from repro_torch.core.msf import run_flat
from repro_torch.core.msf_dist import build_dist_driver
from repro_torch.graphs.structures import host_array
from repro_torch.obs.trace import trace_span
from repro_torch.solve.planner import register_engine
from repro_torch.solve.report import SolveReport, report_from_msf_result
from repro_torch.solve.spec import ResolvedSpec, _stream_n
from repro_torch.stream.engine import StreamEngine
from repro_torch.stream.service import QueryService


class _FlatEngine:
    def __init__(self, rs: ResolvedSpec):
        self._rs = rs

    def solve(self, graph, parent0=None) -> SolveReport:
        rs, s = self._rs, self._rs.spec
        r = run_flat(
            graph,
            parent0=parent0,
            variant=s.variant,
            shortcut=rs.shortcut,
            capacity=s.capacity,
            max_iters=s.max_iters,
            unroll_guard=s.unroll_guard,
            pack=bool(rs.pack),
            segmin=rs.segmin_flat,
        )
        with trace_span("solve.report") as sp:  # trace mode: the report's host copies
            return report_from_msf_result("flat", r, span=sp)


def _build_flat(target, rs: ResolvedSpec, mesh):
    return _FlatEngine(rs)


register_engine("flat", _build_flat, cacheable=True)


class _CoarsenEngine:
    def __init__(self, rs: ResolvedSpec):
        s = rs.spec
        msf_kw = dict(variant=s.variant, shortcut=rs.shortcut, capacity=s.capacity,
                      pack=bool(rs.pack))
        if s.max_iters is not None:
            msf_kw["max_iters"] = s.max_iters
        if rs.pack:
            msf_kw["segmin"] = s.segmin
        self._eng = CoarsenMSF(rs.coarsen, **msf_kw)

    @property
    def last_backends(self):
        """What the level loop of the last solve resolved (``LevelBackends``)."""
        return self._eng.last_backends

    def solve(self, graph) -> SolveReport:
        r = self._eng(graph)
        st = self._eng.last_stats
        with trace_span("solve.report") as sp:
            return report_from_msf_result("coarsen", r,
                                          levels=st.levels if st is not None else (), span=sp)


def _build_coarsen(target, rs: ResolvedSpec, mesh):
    return _CoarsenEngine(rs)


register_engine("coarsen", _build_coarsen, cacheable=True)


class _DistEngine:
    """The flat Fig-2 driver, or with ``coarsen=`` the distributed levels,
    on the plan's mesh. Both read only the partition's static fields
    outside a call, so same-shape partitions share the engine."""

    def __init__(self, part, rs: ResolvedSpec, mesh):
        s = rs.spec
        self._coarsen = rs.coarsen is not None
        if self._coarsen:
            self.driver = DistCoarsenMSF(part, mesh, rs.coarsen, row_axis=s.row_axis,
                                         col_axis=s.col_axis, max_iters=s.max_iters)
        else:
            self.driver = build_dist_driver(
                part, mesh, row_axis=s.row_axis, col_axis=s.col_axis, shortcut=rs.shortcut,
                capacity=s.capacity, max_iters=s.max_iters, pack=bool(rs.pack),
                segmin=rs.segmin_flat,
            )

    def solve(self, part, src_row=None, dst_col=None, w=None, eid=None,
              valid=None) -> SolveReport:
        if src_row is None:
            args = (part.src_row, part.dst_col, part.w, part.eid, part.valid)
        else:
            args = (src_row, dst_col, w, eid, valid)
        r = self.driver(*args)
        if self._coarsen:
            st = self.driver.last_stats
            return report_from_msf_result("dist", r, levels=st.levels,
                                          host_roundtrips=st.host_roundtrips)
        return report_from_msf_result("dist", r)


def _build_dist(target, rs: ResolvedSpec, mesh):
    return _DistEngine(target, rs, mesh)


register_engine("dist", _build_dist, cacheable=True)


class _StreamPlanEngine:
    def __init__(self, n: int, rs: ResolvedSpec):
        s = rs.spec
        self.engine = StreamEngine(
            n,
            batch_capacity=s.batch_capacity,
            adaptive_capacity=s.adaptive_capacity,
            min_capacity=s.min_capacity,
            compact_trigger=s.compact_trigger,
            pack=s.pack,  # None = per-batch auto, tracked by the engine
            segmin=s.segmin or "auto",
            coarsen=rs.coarsen,
            coarsen_threshold=s.coarsen_threshold,
            reservoir_capacity=s.reservoir_capacity,
            reservoir_per_component=s.reservoir_per_component,
            exact_deletes=s.exact_deletes,
            variant=s.variant,
            shortcut=rs.shortcut,
            capacity=s.capacity,
            device=rs.backend,
        )
        self._service = None
        self._last = None  # most recent UpdateStats/DeleteStats

    # -- reports --------------------------------------------------------

    def _report(self, iterations: int = 0) -> SolveReport:
        eng = self.engine
        snap = eng.snapshots.acquire()
        st = eng.last_coarsen_stats
        gid = eng.forest_gids()
        return SolveReport(
            mode="stream",
            weight=float(eng.weight),
            msf_eids=np.asarray(gid, np.int32),
            parent=host_array(snap.parent),
            n_msf_edges=int(len(gid)),
            iterations=int(iterations),
            levels=tuple(st.levels) if st is not None else (),
            host_roundtrips=0,
            recompiles=int(eng.recompiles),
            raw=self._last,
            stale=bool(snap.stale),
            n_unhealed=int(eng.unhealed),
        )

    # -- engine protocol ------------------------------------------------

    def solve(self, target) -> SolveReport:
        """Report the current forest state (no recompute)."""
        return self._report()

    def update(self, u, v, w) -> SolveReport:
        stats = self.engine.insert_batch(u, v, w)
        self._last = stats
        return self._report(iterations=stats.iterations)

    def delete(self, u, v) -> SolveReport:
        self._last = self.engine.delete_batch(u, v)
        return self._report()

    def compact(self) -> SolveReport:
        stats = self.engine.compact()
        self._last = stats
        return self._report(iterations=stats.iterations)

    def recertify(self, u, v, w) -> SolveReport:
        stats = self.engine.recertify(u, v, w)
        self._last = stats
        return self._report(iterations=stats.iterations)

    @property
    def service(self):
        """The shared :class:`~repro_torch.stream.service.QueryService` over
        this engine's snapshot store — the read seam a serving tier
        batches through."""
        if self._service is None:
            self._service = QueryService(self.engine.snapshots)
        return self._service

    def query(self, u, v):
        return self.service.connected(u, v)


def _build_stream(target, rs: ResolvedSpec, mesh):
    return _StreamPlanEngine(_stream_n(target), rs)


register_engine("stream", _build_stream, cacheable=False)
