"""The flat solve's option grid, port against reference on the CPU:
variant (complete/paper/pairwise) × shortcut (complete/csp/os) × pack
(on/off) on two property-suite classes, with a CSP capacity small enough
that some rounds overflow into the complete-shortcut fallback."""
import pytest

torch = pytest.importorskip("torch")

from _torch_util import assert_same_msf, cpu_graph  # noqa: E402
from repro import solve as jsolve  # noqa: E402
from repro_torch import solve as tsolve  # noqa: E402
from test_msf_properties import _FIXED_CASES, _fixed_graph  # noqa: E402

_CLASSES = {c[0]: c for c in _FIXED_CASES if c[0] in ("dense_ties", "multigraph")}


@pytest.mark.parametrize("pack", [True, False], ids=["pack", "nopack"])
@pytest.mark.parametrize("shortcut", ["complete", "csp", "os"])
@pytest.mark.parametrize("variant", ["complete", "paper", "pairwise"])
@pytest.mark.parametrize("cls", sorted(_CLASSES))
def test_option_grid_matches_reference(cls, variant, shortcut, pack):
    g = _fixed_graph(*_CLASSES[cls])
    kw = dict(variant=variant, shortcut=shortcut, pack=pack, capacity=4)
    want = jsolve.plan(g, jsolve.SolveSpec(**kw)).solve()
    got = tsolve.plan(cpu_graph(g), tsolve.SolveSpec(**kw)).solve()
    assert_same_msf(want, got)
