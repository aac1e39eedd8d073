# Solver API of the port: declarative SolveSpec → resolve → plan →
# SolveReport. The flat, coarsen, dist and stream engines are registered.
#
#     from repro_torch.solve import SolveSpec, plan
#     report = plan(graph, SolveSpec()).solve()
#     report = plan(part, SolveSpec(mode="dist"), mesh=mesh).solve()  # every rank
#     p = plan(n, SolveSpec(mode="stream"), device="cpu"); p.update(u, v, w)
#
# The autotuner's database surface is re-exported; ``tune()`` itself lives
# on the submodule (``repro_torch.solve.tune.tune``), which a re-export of
# the same name would shadow.
from repro_torch.solve.report import SolveReport, report_from_msf_result
from repro_torch.solve.spec import ResolvedSpec, SolveSpec
from repro_torch.solve.planner import (
    PLAN_CACHE_MAXSIZE,
    Plan,
    clear_plan_cache,
    plan,
    plan_cache_info,
    register_engine,
    registered_modes,
)
from repro_torch.solve import engines as _engines  # noqa: F401 — registers built-ins
from repro_torch.solve.tune import (
    TuneKey,
    TuningDB,
    TuningDBError,
    get_tuning_db,
    set_tuning_db,
)
