"""Built-in engines behind ``repro_torch.solve.plan``: ``mode="flat"`` and
``mode="coarsen"`` are ported so far. Builders receive a *resolved* spec
— every backend choice is already concrete; engines never auto-detect
(the coarsen levels resolve their pack32 regime per run, as in the
reference)."""
from __future__ import annotations

from repro_torch.coarsen.engine import CoarsenMSF
from repro_torch.core.msf import run_flat
from repro_torch.solve.planner import register_engine
from repro_torch.solve.report import SolveReport, report_from_msf_result
from repro_torch.solve.spec import ResolvedSpec


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
        return report_from_msf_result("flat", r)


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
        return report_from_msf_result("coarsen", r, levels=st.levels if st is not None else ())


def _build_coarsen(target, rs: ResolvedSpec, mesh):
    return _CoarsenEngine(rs)


register_engine("coarsen", _build_coarsen, cacheable=True)
