"""Built-in engines behind ``repro_torch.solve.plan``: only ``mode="flat"``
is ported so far. Builders receive a *resolved* spec — every backend
choice is already concrete; engines never auto-detect."""
from __future__ import annotations

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
