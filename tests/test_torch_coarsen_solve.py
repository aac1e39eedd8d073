"""``repro_torch.solve.plan(g, SolveSpec(mode="coarsen")).solve()`` against
``repro.solve.plan(g, SolveSpec(mode="coarsen")).solve()`` on the CPU: the
graph classes of ``tests/test_coarsen.py`` under every dedupe, fused and
segmin option, float weights and the n > 2^16 pair-key path. Eid sequence,
parent, edge count, rounds and per-level stats are identical; the weight
exactly in the pack32 regime, else as float64 sums over the eid set."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_util import assert_same_msf, cpu_graph, float64_weight  # noqa: E402
from repro import coarsen as jco  # noqa: E402
from repro import solve as jsolve  # noqa: E402
from repro.graphs import from_edges  # noqa: E402
from repro_torch import coarsen as tco  # noqa: E402
from repro_torch import solve as tsolve  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from test_coarsen import GRAPHS  # noqa: E402

#: the port's segmin requests and the reference's counterparts
JAX_SEGMIN = {None: None, "torch": "jnp", "cuda": "pallas", "sorted": "sorted"}

_SOLVE_CASES = [
    (gname, dedupe, fused, segmin)
    for gname in GRAPHS for dedupe in ("host", "device") for fused in (False, True)
    for segmin in (None, "torch", "cuda", "sorted")
]


@pytest.mark.parametrize("gname,dedupe,fused,segmin", _SOLVE_CASES,
                         ids=[f"{c[0]}-{c[1]}-{'fused' if c[2] else 'unfused'}-{c[3]}"
                              for c in _SOLVE_CASES])
def test_coarsen_solve_matches_reference(gname, dedupe, fused, segmin):
    g = GRAPHS[gname]
    kw = dict(mode="coarsen", coarsen=jco.CoarsenConfig(cutoff=16), dedupe=dedupe, fused=fused)
    want = jsolve.plan(g, jsolve.SolveSpec(segmin=JAX_SEGMIN[segmin], **kw)).solve()
    kw["coarsen"] = tco.CoarsenConfig(cutoff=16)
    p = tsolve.plan(cpu_graph(g), tsolve.SolveSpec(segmin=segmin, **kw))
    ops.segment_min_flat.launches = ops.segment_min_sorted.launches = 0
    got = p.solve()
    assert ops.segment_min_flat.launches == ops.segment_min_sorted.launches == 0
    assert_same_msf(want, got)
    assert got.mode == "coarsen" and len(got.levels) >= 1
    assert tuple(got.levels) == tuple(want.levels)
    assert got.n_components == want.n_components
    assert p.engine.last_backends.dedupe == dedupe


def test_float_weights_match_as_float64_sums():
    rng = np.random.default_rng(12)
    u, v = rng.integers(0, 200, 800), rng.integers(0, 200, 800)
    g = from_edges(u, v, rng.random(800) * 10.0, 200)
    want = jsolve.plan(g, jsolve.SolveSpec(mode="coarsen",
                                           coarsen=jco.CoarsenConfig(cutoff=16))).solve()
    p = tsolve.plan(cpu_graph(g), tsolve.SolveSpec(mode="coarsen",
                                                   coarsen=tco.CoarsenConfig(cutoff=16)))
    got = p.solve()
    assert p.engine.last_backends.pack is False and p.engine.last_backends.hook is None
    assert_same_msf(want, got, exact_weight=False)
    assert tuple(got.levels) == tuple(want.levels) and len(got.levels) >= 1
    assert float64_weight(g, got.msf_eids) == float64_weight(g, want.msf_eids)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dedupe", ["host", "device"])
def test_large_n_pair_key_path(dedupe, fused):
    """n > 2^16: the filter's 64-bit pair key against the reference's
    two-key sort."""
    n = (1 << 16) + 512
    rng = np.random.default_rng(37)
    g = from_edges(rng.integers(0, n, 3000), rng.integers(0, n, 3000),
                   rng.integers(1, 256, 3000).astype(np.float64), n)
    kw = dict(mode="coarsen", dedupe=dedupe, fused=fused)
    want = jsolve.plan(g, jsolve.SolveSpec(coarsen=jco.CoarsenConfig(cutoff=1024), **kw)).solve()
    got = tsolve.plan(cpu_graph(g),
                      tsolve.SolveSpec(coarsen=tco.CoarsenConfig(cutoff=1024), **kw)).solve()
    assert_same_msf(want, got)
    assert tuple(got.levels) == tuple(want.levels) and len(got.levels) >= 1
