"""The 64-bit-key min-outgoing kernel of the unpacked flat round
(``kernels.ops.min_outgoing_flat64``, ``csrc/min_outgoing_flat64.cu``) and
its undirected mode, the coarsen levels' hook reduction
(``kernels.ops.min_outgoing_und64``).

On the CPU: the plain twins (``kernels.ref.min_outgoing_flat64_ref``,
``min_outgoing_und64_ref``) against ``semiring.segment_argmin``,
``min_outgoing_coo``'s root form running the twin through the wrapper, as
it runs the kernel on the card, and which routes of
``coarsen.contract.make_und_reduce`` call the undirected wrapper. On a
card (marker ``gpu``; skipped without one or without ``nvcc``): the kernel
against the twins, and whole solves on the card against the same solves
on the CPU or on the scatter route the undirected mode replaced.
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_util import one_torch_thread  # noqa: E402,F401
from chip_smoke import same_und_minima, und_scatter_route  # noqa: E402
from repro_torch.coarsen import contract  # noqa: E402
from repro_torch.core.msf import count_true  # noqa: E402
from repro_torch.core.multilinear import min_outgoing_coo  # noqa: E402
from repro_torch.core.semiring import IMAX, EdgeMin, segment_argmin  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

INF = float("inf")


def _same(got: EdgeMin, want: EdgeMin) -> None:
    """Bit-identical fields, but for the sign of a zero weight."""
    assert torch.equal((got.w + 0.0).view(torch.int32), (want.w + 0.0).view(torch.int32))
    assert torch.equal(got.eid, want.eid)
    assert len(got.payload) == len(want.payload) == 1
    assert torch.equal(got.payload[0], want.payload[0])


def _symmetric(u, v, w, n, gen, *, pad=0, invalid=0, eid_perm=True):
    """Both directions of each undirected edge (u, v, w), one eid each, in
    a shuffled edge order; then ``invalid`` edges with finite weights and
    ``valid`` False, and ``pad`` padding edges as ``Graph.pad_to`` makes."""
    m = u.numel()
    eid = torch.randperm(m, generator=gen).to(torch.int32) if eid_perm else \
        torch.arange(m, dtype=torch.int32)
    src = torch.cat([u, v]).to(torch.int32)
    dst = torch.cat([v, u]).to(torch.int32)
    ww = torch.cat([w, w]).to(torch.float32)
    ee = torch.cat([eid, eid])
    valid = torch.ones(2 * m, dtype=torch.bool)
    if invalid:
        src = torch.cat([src, torch.randint(0, n, (invalid,), generator=gen, dtype=torch.int32)])
        dst = torch.cat([dst, torch.randint(0, n, (invalid,), generator=gen, dtype=torch.int32)])
        ww = torch.cat([ww, torch.zeros(invalid)])  # would win were they valid
        ee = torch.cat([ee, torch.zeros(invalid, dtype=torch.int32)])
        valid = torch.cat([valid, torch.zeros(invalid, dtype=torch.bool)])
    order = torch.randperm(src.numel(), generator=gen)
    src, dst, ww, ee, valid = (a[order] for a in (src, dst, ww, ee, valid))
    if pad:
        src = torch.cat([src, torch.zeros(pad, dtype=torch.int32)])
        dst = torch.cat([dst, torch.zeros(pad, dtype=torch.int32)])
        ww = torch.cat([ww, torch.full((pad,), INF)])
        ee = torch.cat([ee, torch.full((pad,), IMAX, dtype=torch.int32)])
        valid = torch.cat([valid, torch.zeros(pad, dtype=torch.bool)])
    return src, dst, ww, ee, valid


def _stars(n, k, gen):
    """A parent vector whose every tree is a star: k random components,
    each rooted at one of its members."""
    comp = torch.randint(0, k, (n,), generator=gen)
    root = torch.full((k,), n, dtype=torch.int64).scatter_reduce_(
        0, comp, torch.arange(n), "amin", include_self=True)
    return root[comp].to(torch.int32)


def _case(name, seed=0):
    """(p, src, dst, w, eid, valid, n) of one named case."""
    gen = torch.Generator().manual_seed(seed)
    n, m = 600, 2400
    u = torch.randint(0, n, (m,), generator=gen)
    v = torch.randint(0, n, (m,), generator=gen)
    w = torch.randint(1, 256, (m,), generator=gen).float()  # integer ties in 1..255
    extra = {}
    p = _stars(n, 40, gen)
    if name == "two_decimal_floats":
        w = torch.randint(0, 1000, (m,), generator=gen).float() / 100
    elif name == "signed_zeros":
        w = torch.randint(0, 4, (m,), generator=gen).float() - 2
        w[torch.rand(m, generator=gen) < 0.5] = -0.0
        w[torch.rand(m, generator=gen) < 0.3] = 0.0
    elif name == "valid_inf":
        p = _stars(n, 500, gen)
        w[torch.rand(m, generator=gen) < 0.9] = INF  # some roots only have +inf edges
        w[:5] = -INF
    elif name == "padding":
        extra = dict(pad=37, invalid=200)
    elif name == "empty_segments":
        n = 5000  # most vertices isolated: their roots have no outgoing edge
        p = _stars(n, 900, gen)
    elif name == "hot_star":
        leaves = 1 << 12
        n = leaves + 1 + 256
        hub = torch.arange(1, leaves + 1)
        outside = torch.randint(leaves + 1, n, (leaves,), generator=gen)
        u = torch.cat([torch.zeros(leaves, dtype=torch.int64), hub])
        v = torch.cat([hub, outside])
        w = torch.randint(1, 256, (u.numel(),), generator=gen).float()
        p = torch.arange(n, dtype=torch.int32)
        p[: leaves + 1] = 0  # the star's leaves all hang on root 0
    elif name == "no_outgoing":
        p = torch.zeros(n, dtype=torch.int32)  # one component: nothing leaves it
    src, dst, ww, ee, valid = _symmetric(u, v, w, n, gen, **extra)
    return p, src, dst, ww, ee, valid, n


CASES = ["integer_ties", "two_decimal_floats", "signed_zeros", "valid_inf", "padding",
         "empty_segments", "hot_star", "no_outgoing"]


def _argmin_route(p, src, dst, w, eid, valid, n):
    """``segment_argmin`` over the root segments, as the CPU route runs it."""
    ps, pd = p[src], p[dst]
    outgoing = (ps != pd) & valid
    return segment_argmin(w, eid, (pd,), ps, n, valid=outgoing), outgoing


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("seed", [0, 1])
def test_twin_matches_segment_argmin(case, seed):
    p, src, dst, w, eid, valid, n = _case(case, seed)
    want, outgoing = _argmin_route(p, src, dst, w, eid, valid, n)
    got, count = ref.min_outgoing_flat64_ref(p, src, dst, w, eid, valid, n)
    _same(got, want)
    assert int(count) == int(count_true(outgoing))
    assert not torch.signbit(got.w[got.w == 0]).any()  # zero weights come out as +0.0
    if case == "no_outgoing":
        assert int(count) == 0 and bool((got.w == INF).all()) and bool((got.eid == IMAX).all())
    if case == "hot_star":
        assert int(count_true(outgoing & (p[src] == 0))) >= 1 << 12
    if case == "valid_inf":
        assert bool(((want.w == INF) & (want.eid != IMAX)).any())  # inf winners exist
    # the wrapper on CPU tensors runs the twin
    r, c = ops.min_outgoing_flat64(p, src, dst, w, eid, valid, n, count=True)
    _same(r, got)
    assert int(c) == int(count)
    assert ops.min_outgoing_flat64(p, src, dst, w, eid, valid, n)[1] is None


@pytest.mark.parametrize("case", CASES)
def test_cpu_route_is_segment_argmin(case, monkeypatch):
    """On the CPU ``min_outgoing_coo``'s root form calls the wrapper, which
    runs the twin: ``segment_argmin``'s answer but for a zero weight's
    sign, which comes out +0.0, and the 0-d count of the outgoing edges in
    place of their mask."""
    calls = []

    def spy(*args, **kw):
        calls.append(kw)
        return wrapper(*args, **kw)

    wrapper = ops.min_outgoing_flat64
    monkeypatch.setattr(ops, "min_outgoing_flat64", spy)
    p, src, dst, w, eid, valid, n = _case(case, 3)
    want, outgoing = _argmin_route(p, src, dst, w, eid, valid, n)
    twin, twin_count = ref.min_outgoing_flat64_ref(p, src, dst, w, eid, valid, n)
    got, count = min_outgoing_coo(p, src, dst, w, eid, valid, n, segment="root",
                                  return_outgoing=True)
    for a, b in zip((got.w, got.eid, got.payload[0]), (twin.w, twin.eid, twin.payload[0])):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))  # bit for bit
    _same(got, want)
    assert not torch.signbit(got.w[got.w == 0]).any()
    assert count.dim() == 0 and count.dtype == torch.int64
    assert int(count) == int(twin_count) == int(count_true(outgoing))
    plain = min_outgoing_coo(p, src, dst, w, eid, valid, n)
    assert torch.equal(plain.w.view(torch.int32), twin.w.view(torch.int32))
    assert calls == [{"count": True}, {"count": False}]


def test_keys_order_as_weight_then_eid():
    w = torch.tensor([-INF, -2.5, -0.0, 0.0, 1e-30, 3.0, 3.0, INF, INF])
    eid = torch.tensor([5, 5, 8, 9, 0, -7, 2, 0, IMAX], dtype=torch.int32)
    k = ref.key64(w, eid)
    assert bool((k[1:] > k[:-1]).all())
    assert int(k[2]) == int(ref.key64(torch.tensor([0.0]), torch.tensor([8], dtype=torch.int32))[0])
    assert bool((k < ref.KEY64_IDENTITY).all())
    back_w, back_eid = ref.unkey64(k)
    assert torch.equal(back_eid, eid)
    assert torch.equal((back_w + 0.0).view(torch.int32), (w + 0.0).view(torch.int32))


@pytest.mark.parametrize("ints,valid,e,want", [
    ((0, 0, 0, 0), 0, 100, (0, True)),
    ((4, 4, 4, 4), 1, 100, (3, True)),
    ((4, 8, 4, 4), 1, 100, (0, False)),  # src[1:] beside w[0:]
    ((12, 12, 12, 12), 3, 2, (1, True)),  # head capped at E
    ((0, 0, 0, 0), 1, 100, (0, False)),
])
def test_flat64_layout(ints, valid, e, want):
    assert ops.flat64_layout([0x1000 + a for a in ints], 0x2000 + valid, e) == want


def test_wrapper_rejects_bad_inputs():
    p, src, dst, w, eid, valid, n = _case("integer_ties")
    with pytest.raises(ValueError):
        ops.min_outgoing_flat64(p, src.long(), dst, w, eid, valid, n)
    with pytest.raises(ValueError):
        ops.min_outgoing_flat64(p, src, dst[1:], w, eid, valid, n)
    with pytest.raises(ValueError):
        ops.min_outgoing_flat64(p, src, dst, w, eid, valid, n + 1)


def test_cost_counts_the_kernel_passes_on_the_card():
    """``flat_round_terms`` of an unpacked plan resolved for the card counts
    the kernel's fill, reduce, payload and decode, not the three scatters
    of ``segment_argmin`` that a plan resolved for the CPU is charged; both
    read shapes only."""
    from repro_torch.graphs.generators import random_graph
    from repro_torch.solve import SolveSpec
    from repro_torch.solve import cost as tcost

    g = random_graph(300, 1200, seed=2, device="cpu")
    e, n = g.src.numel(), g.n
    card = tcost.flat_round_terms(n, e, SolveSpec(pack=False).resolve(g, backend="cuda"))
    cpu = tcost.flat_round_terms(n, e, SolveSpec(pack=False).resolve(g))
    assert card["segment_min"] == (17 * e + 16 * n, e)
    assert card["payload"] == (25 * e + 24 * n, e)
    assert card["gathers"] == (16 * e, 0.0)
    assert "key_build" not in card and "key_build" in cpu
    assert cpu["segment_min"][1] == 3 * e  # segment_argmin's three scatters
    assert sum(b for b, _ in card.values()) < sum(b for b, _ in cpu.values())
    packed = SolveSpec(pack=True).resolve(g, backend="cuda")
    assert tcost.flat_round_terms(n, e, packed) == tcost.flat_round_terms(
        n, e, SolveSpec(pack=True).resolve(g))


# ---------------------------------------------------------------------------
# the undirected mode
# ---------------------------------------------------------------------------


def _und_case(name, seed=0):
    """(p, lo, hi, w, eid, valid, n) of one named undirected case: each
    edge held once with lo <= hi, sorted by lo as the coarsen levels hold
    them, under a star-canonical parent vector."""
    gen = torch.Generator().manual_seed(seed)
    n, m = 600, 2400
    u = torch.randint(0, n, (m,), generator=gen)
    v = torch.randint(0, n, (m,), generator=gen)
    w = torch.randint(1, 256, (m,), generator=gen).float()
    valid = torch.ones(m, dtype=torch.bool)
    p = _stars(n, 40, gen)
    if name == "empty":
        u, v, w, valid = u[:0], v[:0], w[:0], valid[:0]
    elif name == "n_zero":
        n, p = 0, p[:0]
        u, v, w, valid = u[:0], v[:0], w[:0], valid[:0]
    elif name == "invalid":
        valid = torch.rand(m, generator=gen) < 0.7
        w[~valid] = 0.0  # would win were they valid
    elif name == "self_loops":
        v[:600] = u[:600]  # lo == hi: never outgoing
    elif name == "signed_zeros":
        w = torch.randint(0, 4, (m,), generator=gen).float() - 2
        w[torch.rand(m, generator=gen) < 0.5] = -0.0
        w[torch.rand(m, generator=gen) < 0.3] = 0.0
    elif name == "valid_inf":
        p = _stars(n, 500, gen)
        w[torch.rand(m, generator=gen) < 0.9] = INF  # some roots only have +inf edges
    elif name == "out_of_range_roots":
        bad = torch.rand(n, generator=gen) < 0.1
        p[bad] = torch.where(torch.rand(n, generator=gen)[bad] < 0.5, -1, n + 3).to(torch.int32)
    elif name == "repeated_pair":
        k = 300  # the same pair again under its own eid, and a few under the same eid
        u, v = torch.cat([u, u[:k]]), torch.cat([v, v[:k]])
        w = torch.cat([w, torch.randint(1, 256, (k,), generator=gen).float()])
        valid = torch.ones(u.numel(), dtype=torch.bool)
    elif name == "hub_star":
        leaves = 1 << 12
        n = leaves + 1 + 256
        hub = n - 1  # the hub is every leaf edge's hi
        leaf = torch.arange(leaves)
        outside = torch.randint(leaves, n - 1, (leaves,), generator=gen)
        u = torch.cat([leaf, leaf])
        v = torch.cat([torch.full((leaves,), hub), outside])
        w = torch.randint(1, 256, (u.numel(),), generator=gen).float()
        valid = torch.ones(u.numel(), dtype=torch.bool)
        p = torch.arange(n, dtype=torch.int32)
        p[leaf] = hub  # the leaves hang on the hub: their outside edges all reach it
    elif name == "no_outgoing":
        p = torch.zeros(n, dtype=torch.int32)
    lo, hi = torch.minimum(u, v), torch.maximum(u, v)
    eid = torch.randperm(lo.numel(), generator=gen).to(torch.int32)
    if name == "repeated_pair":
        eid[-20:] = eid[:20]  # a multigraph repeat: the same pair and eid twice
        w[-20:] = w[:20]
    order = torch.sort(lo, stable=True).indices
    lo, hi, w, eid, valid = (a[order] for a in (lo.to(torch.int32), hi.to(torch.int32), w,
                                                 eid, valid))
    return p, lo, hi, w, eid, valid, n


UND_CASES = ["integer_ties", "empty", "n_zero", "invalid", "self_loops", "signed_zeros",
             "valid_inf", "out_of_range_roots", "repeated_pair", "hub_star", "no_outgoing"]


def _und_argmin(p, lo, hi, w, eid, valid, n):
    """``segment_argmin`` over both directions of every undirected edge,
    segments ``p[src]``, payload ``p[dst]``, a root out of range dropped;
    and the count of the outgoing undirected edges."""
    src, dst = torch.cat([lo, hi]), torch.cat([hi, lo])
    ps, pd = p[src], p[dst]
    live = torch.cat([valid, valid]) & (ps != pd) & (ps >= 0) & (ps < n)
    seg = torch.where(live, ps, 0)
    want = segment_argmin(torch.cat([w, w]), torch.cat([eid, eid]), (pd,), seg, n, valid=live)
    return want, int(count_true(valid & (p[lo] != p[hi])))


@pytest.mark.parametrize("case", UND_CASES)
@pytest.mark.parametrize("seed", [0, 1])
def test_und_twin_matches_segment_argmin(case, seed):
    p, lo, hi, w, eid, valid, n = _und_case(case, seed)
    want, outgoing = _und_argmin(p, lo, hi, w, eid, valid, n)
    got, count = ref.min_outgoing_und64_ref(p, lo, hi, w, eid, valid, n)
    _same(got, want)
    assert int(count) == outgoing
    assert not torch.signbit(got.w[got.w == 0]).any()
    # the twin is the directed twin over the concatenated form
    flat, _ = ref.min_outgoing_flat64_ref(p, torch.cat([lo, hi]), torch.cat([hi, lo]),
                                          torch.cat([w, w]), torch.cat([eid, eid]),
                                          torch.cat([valid, valid]), n)
    _same(got, flat)
    if case in ("empty", "no_outgoing", "n_zero"):
        assert outgoing == 0 and bool((got.w == INF).all()) and bool((got.eid == IMAX).all())
        assert bool((got.payload[0] == IMAX).all())
    if case == "valid_inf":
        assert bool(((want.w == INF) & (want.eid != IMAX)).any())  # inf winners exist
    if case == "hub_star":
        assert int(count_true((p[hi] == n - 1) & (p[lo] != p[hi]))) == 0  # hub-leaf edges dead
        assert int(got.eid[n - 1]) != IMAX  # the hub's root wins through its leaves' edges
    # the wrapper on CPU tensors runs the twin
    r, c = ops.min_outgoing_und64(p, lo, hi, w, eid, valid, n, count=True)
    _same(r, got)
    assert int(c) == outgoing
    assert ops.min_outgoing_und64(p, lo, hi, w, eid, valid, n)[1] is None


@pytest.mark.parametrize("case", ["integer_ties", "invalid", "self_loops", "signed_zeros",
                                  "valid_inf", "repeated_pair", "hub_star", "no_outgoing"])
def test_und_twin_matches_the_scatter_route(case):
    """The four scatter-mins the undirected mode replaced give the same
    minima, but for the sign of a zero weight and the payload at a root
    whose least weight is +inf (IMAX there; the hook reads neither)."""
    p, lo, hi, w, eid, valid, n = _und_case(case, 4)
    got, _ = ref.min_outgoing_und64_ref(p, lo, hi, w, eid, valid, n)
    want, _ = und_scatter_route(p, lo, hi, w, eid, valid, n)
    assert same_und_minima(got, want)


def test_und_wrapper_rejects_bad_inputs():
    p, lo, hi, w, eid, valid, n = _und_case("integer_ties")
    with pytest.raises(ValueError, match="lo must be"):
        ops.min_outgoing_und64(p, lo.long(), hi, w, eid, valid, n)
    with pytest.raises(ValueError, match="lo, hi, w, eid and valid"):
        ops.min_outgoing_und64(p, lo, hi[1:], w, eid, valid, n)
    with pytest.raises(ValueError):
        ops.min_outgoing_und64(p, lo, hi, w, eid, valid, n + 1)
    with pytest.raises(ValueError, match="hi must be 1-D and contiguous"):
        ops.min_outgoing_und64(p, lo, torch.stack([hi, hi], 1)[:, 0], w, eid, valid, n)


def _spy(monkeypatch):
    calls = []
    wrapper = ops.min_outgoing_und64

    def spy(*args, **kw):
        calls.append(args[-1])
        return wrapper(*args, **kw)

    monkeypatch.setattr(ops, "min_outgoing_und64", spy)
    return calls


@pytest.mark.parametrize("rounds", [1, 2, 3])
def test_contract_level_und_unpacked_calls_the_wrapper_once_a_round(rounds, monkeypatch):
    calls = _spy(monkeypatch)
    p, lo, hi, w, eid, valid, n = _und_case("integer_ties", 6)
    w = w + 0.25  # not integral: what the levels run without pack32
    got = contract.contract_level_und(lo, hi, w, eid, valid, n=n, eid_capacity=4096,
                                      rounds=rounds, pack=False)
    assert calls == [n] * rounds
    # the same level through the dist route's code (combine set) and the
    # directed form
    monkeypatch.undo()
    route = contract.make_und_reduce(lo, hi, w, eid, valid, n=n, eid_capacity=4096,
                                     combine=lambda x: x)
    via_combine = contract.contract_rounds(route, n, rounds, lo.device)
    directed = contract.contract_level(torch.cat([lo, hi]), torch.cat([hi, lo]),
                                       torch.cat([w, w]), torch.cat([eid, eid]),
                                       torch.cat([valid, valid]), n=n, rounds=rounds)
    for want in (via_combine, directed):
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("pack,combine", [(True, None), (True, "identity"),
                                          (False, "identity")])
def test_pack_and_combine_routes_do_not_call_the_wrapper(pack, combine, monkeypatch):
    calls = _spy(monkeypatch)
    p, lo, hi, w, eid, valid, n = _und_case("integer_ties", 8)
    reduce_fn = contract.make_und_reduce(
        lo, hi, w, eid, valid, n=n, eid_capacity=4096, pack=pack,
        combine=(lambda x: x) if combine else None)
    got = reduce_fn(p)
    assert calls == []
    want, _ = ref.min_outgoing_und64_ref(p, lo, hi, w, eid, valid, n)
    assert torch.equal(got.eid, want.eid) and torch.equal(got.payload[0], want.payload[0])
    assert torch.equal(got.w, want.w)


def test_cost_counts_the_undirected_kernel_on_the_card():
    """``coarsen_level0_terms`` of an unpacked plan resolved for the card
    charges each hook round the undirected kernel (the flat kernel's
    passes, its payload pass reading both roots' keys) and no eid →
    position table; a plan resolved for the CPU keeps the scatter route's
    terms, and pack32 plans are the same on both."""
    from repro_torch.coarsen import CoarsenConfig
    from repro_torch.graphs.generators import random_graph
    from repro_torch.solve import SolveSpec
    from repro_torch.solve import cost as tcost

    g = random_graph(300, 1200, seed=2, device="cpu")
    e, n = g.src.numel(), g.n
    spec = SolveSpec(mode="coarsen", pack=False, coarsen=CoarsenConfig(cutoff=16))
    card, label = tcost.coarsen_level0_terms(n, e, spec.resolve(g, backend="cuda"))
    cpu, label_cpu = tcost.coarsen_level0_terms(n, e, spec.resolve(g))
    assert label == label_cpu == "coarsen.level0"
    pad, n_pad = 1 << (e // 2 - 1).bit_length(), 1 << (n - 1).bit_length()
    rounds = CoarsenConfig().rounds_per_level
    assert card["segment_min"] == (rounds * (17 * pad + 16 * n_pad), rounds * pad)
    assert card["gathers"] == (rounds * 16 * pad, 0.0)
    assert "key_build" not in card and "key_build" in cpu
    assert cpu["segment_min"][1] == rounds * 4 * pad  # four scatter-mins a round
    assert card["index_casts"][0] < cpu["index_casts"][0]  # no lo.long(), hi.long()
    assert sum(b for b, _ in card.values()) < sum(b for b, _ in cpu.values())
    packed = SolveSpec(mode="coarsen", pack=True, coarsen=CoarsenConfig(cutoff=16))
    assert tcost.coarsen_level0_terms(n, e, packed.resolve(g, backend="cuda")) == \
        tcost.coarsen_level0_terms(n, e, packed.resolve(g))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernels have no CPU mode)")
    from repro_torch.kernels import build

    try:
        build.find_nvcc()
    except RuntimeError as exc:
        pytest.skip(str(exc))
    return torch.device("cuda")


def _check_on_card(p, src, dst, w, eid, valid, n):
    """The kernel on the card against the twin on the CPU; the count
    against ``count_true`` of the mask; the launch counter advances."""
    from repro_torch import obs

    before = ops.min_outgoing_flat64.launches
    obs.enable("metrics")
    try:
        obs.metrics_reset()
        got, count = ops.min_outgoing_flat64(p, src, dst, w, eid, valid, n, count=True)
        torch.cuda.synchronize()
        snap = obs.metrics_snapshot()
    finally:
        obs.disable()
        obs.metrics_reset()
    assert ops.min_outgoing_flat64.launches == before + 1
    assert snap["counters"]["kernel.min_outgoing_flat64.launches"] == 1
    cpu = [t.cpu() for t in (p, src, dst, w, eid, valid)]
    want, want_count = ref.min_outgoing_flat64_ref(*cpu, n)
    for a, b in zip((got.w, got.eid, got.payload[0]), (want.w, want.eid, want.payload[0])):
        assert torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))
    outgoing = (cpu[0][cpu[1]] != cpu[0][cpu[2]]) & cpu[5]
    assert int(count) == int(want_count) == int(count_true(outgoing))
    nocount, none = ops.min_outgoing_flat64(p, src, dst, w, eid, valid, n)
    assert none is None and torch.equal(nocount.eid, got.eid)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_twin(card, case):
    args = _case(case, 5)
    _check_on_card(*(a.to(card) for a in args[:6]), args[6])


@pytest.mark.gpu
@pytest.mark.parametrize("e", [0, 1, 2, 3, 5])
def test_kernel_below_the_vector_width(card, e):
    p, src, dst, w, eid, valid, n = _case("integer_ties", 7)
    _check_on_card(*(a[:e].to(card) if a is not p else a.to(card)
                     for a in (p, src, dst, w, eid, valid)), n)


@pytest.mark.gpu
def test_kernel_on_unaligned_views(card):
    p, src, dst, w, eid, valid, n = (a.to(card) if isinstance(a, torch.Tensor) else a
                                     for a in _case("hot_star", 9))
    # src[1:] beside w[0:]: no head aligns all five, the body reads edge by edge
    assert not ops.flat64_layout([t.data_ptr() for t in (src[1:], dst[:-1], w[:-1], eid[:-1])],
                                 valid[:-1].data_ptr(), src.numel() - 1)[1]
    _check_on_card(p, src[1:], dst[:-1], w[:-1], eid[:-1], valid[:-1], n)
    # every array one edge in: a head of 3 edges, then 16-byte loads
    assert ops.flat64_layout([t.data_ptr() for t in (src[1:], dst[1:], w[1:], eid[1:])],
                             valid[1:].data_ptr(), src.numel() - 1) == (3, True)
    _check_on_card(p, src[1:], dst[1:], w[1:], eid[1:], valid[1:], n)


def _unpacked(g, halves=False):
    """``g`` with non-integral weights (each undirected edge keeps one), so
    that the planner cannot pack it whatever its size: two-decimal ones,
    or with ``halves`` ``w + 0.5``, whose float32 sums are exact in any
    order."""
    from repro_torch.graphs.structures import Graph

    w = g.w + 0.5 if halves else torch.round(g.w * 37.0) / 100.0 + 0.01
    return Graph(g.src, g.dst, w, g.eid, g.valid, n=g.n)


@pytest.mark.gpu
@pytest.mark.parametrize("scale", [16, 18, 20])
def test_kernel_in_every_round_of_rmat_solves(card, scale):
    from repro_torch.core import shortcut as sc
    from repro_torch.core.msf import hook_and_tiebreak
    from repro_torch.graphs.generators import rmat_graph

    g = _unpacked(rmat_graph(scale, 8, seed=scale, device=card))
    p = torch.arange(g.n, dtype=torch.int32, device=card)
    rounds = 0
    while True:
        r = _check_on_card(p, g.src, g.dst, g.w, g.eid, g.valid, g.n)
        p_next = sc.complete_shortcut(hook_and_tiebreak(p, r.w, r.eid, r.payload[0])[0])
        rounds += 1
        if torch.equal(p_next, p):
            break
        p = p_next
    assert rounds >= 3  # the last round is all dead: no edge leaves a component


@pytest.mark.gpu
@pytest.mark.parametrize("scale", [16, 18])
def test_solve_on_the_card_matches_the_cpu(card, scale):
    from repro_torch.graphs.generators import rmat_graph
    from repro_torch.graphs.structures import Graph
    from repro_torch.solve import SolveSpec, plan

    from repro_torch import obs

    g = _unpacked(rmat_graph(scale, 8, seed=3, device=card), halves=True)
    g_cpu = Graph(*(t.cpu() for t in (g.src, g.dst, g.w, g.eid, g.valid)), n=g.n)
    before = ops.min_outgoing_flat64.launches
    p = plan(g, SolveSpec())
    assert p.resolved.pack is False
    got = p.solve()
    assert ops.min_outgoing_flat64.launches - before == got.iterations
    want = plan(g_cpu, SolveSpec()).solve()
    assert sorted(got.msf_eids.tolist()) == sorted(want.msf_eids.tolist())
    assert (got.parent == want.parent).all()
    assert got.iterations == want.iterations
    assert got.weight == want.weight
    # traced: the kernel's own outgoing count reads what the CPU's mask does
    counts = []
    try:
        for graph in (g, g_cpu):
            obs.reset()
            plan(graph, SolveSpec(obs="trace")).solve()
            events = sorted((e for e in obs.trace_events() if e[0] == "msf.counts"),
                            key=lambda e: e[1])
            counts.append([e[4]["outgoing"] for e in events])
    finally:
        obs.disable()
        obs.reset()
        obs.metrics_reset()
    assert counts[0] == counts[1] and len(counts[0]) == got.iterations


def _check_und_on_card(p, lo, hi, w, eid, valid, n):
    """The undirected mode on the card against its twin on the CPU, bit
    for bit; the count against ``count_true`` of the mask; its own launch
    counter advances and the directed one does not."""
    from repro_torch import obs

    before = (ops.min_outgoing_und64.launches, ops.min_outgoing_flat64.launches)
    obs.enable("metrics")
    try:
        obs.metrics_reset()
        got, count = ops.min_outgoing_und64(p, lo, hi, w, eid, valid, n, count=True)
        torch.cuda.synchronize()
        snap = obs.metrics_snapshot()
    finally:
        obs.disable()
        obs.metrics_reset()
    assert (ops.min_outgoing_und64.launches, ops.min_outgoing_flat64.launches) == \
        (before[0] + 1, before[1])
    assert snap["counters"]["kernel.min_outgoing_und64.launches"] == 1
    assert "kernel.min_outgoing_flat64.launches" not in snap["counters"]
    cpu = [t.cpu() for t in (p, lo, hi, w, eid, valid)]
    want, want_count = ref.min_outgoing_und64_ref(*cpu, n)
    for a, b in zip((got.w, got.eid, got.payload[0]), (want.w, want.eid, want.payload[0])):
        assert torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))
    assert int(count) == int(want_count) == int(count_true((cpu[0][cpu[1]] != cpu[0][cpu[2]])
                                                           & cpu[5]))
    return got


def _und_views(p, lo, hi, w, eid, valid, n):
    """The arrays whole (16-byte loads from edge 0), every one from edge 1
    (a head of 3 edges, then 16-byte loads) and lo, hi from edge 1 beside
    w, eid, valid from edge 0 (no head aligns all five: edge by edge)."""
    e = lo.numel()
    views = [(lo, hi, w, eid, valid), tuple(a[1:] for a in (lo, hi, w, eid, valid)),
             (lo[1:], hi[1:], w[:-1], eid[:-1], valid[:-1])]
    assert ops.flat64_layout([t.data_ptr() for t in views[1][:4]], views[1][4].data_ptr(),
                             e - 1) == (3, True)
    assert not ops.flat64_layout([t.data_ptr() for t in views[2][:4]],
                                 views[2][4].data_ptr(), e - 1)[1]
    return [(p, *v, n) for v in views]


@pytest.mark.gpu
@pytest.mark.parametrize("case", UND_CASES)
def test_und_kernel_matches_twin(card, case):
    args = _und_case(case, 5)
    moved = (*(a.to(card) for a in args[:6]), args[6])
    if moved[1].numel() < 2:
        _check_und_on_card(*moved)
        return
    for view in _und_views(*moved):
        _check_und_on_card(*view)


@pytest.mark.gpu
@pytest.mark.parametrize("e", [0, 1, 2, 3, 5])
def test_und_kernel_below_the_vector_width(card, e):
    p, lo, hi, w, eid, valid, n = _und_case("integer_ties", 7)
    _check_und_on_card(p.to(card), *(a[:e].to(card) for a in (lo, hi, w, eid, valid)), n)


@pytest.mark.gpu
@pytest.mark.parametrize("scale", [16, 18, 20])
def test_und_kernel_in_every_level_round_of_rmat(card, scale):
    """Each hook round of a level over R-MAT's undirected edges, sorted by
    lo as the levels hold them, in the three layouts of
    :func:`_und_views`."""
    from repro_torch.core import shortcut as sc
    from repro_torch.core.msf import hook_and_tiebreak
    from repro_torch.graphs.generators import rmat_graph

    g = _unpacked(rmat_graph(scale, 8, seed=scale, device=card))
    keep = g.valid & (g.src < g.dst)
    order = torch.sort(g.src[keep], stable=True).indices
    lo, hi, w, eid = (a[keep][order].contiguous() for a in (g.src, g.dst, g.w, g.eid))
    valid = torch.ones_like(lo, dtype=torch.bool)
    p = torch.arange(g.n, dtype=torch.int32, device=card)
    rounds = 0
    while True:
        for k, view in enumerate(_und_views(p, lo, hi, w, eid, valid, g.n)):
            r = _check_und_on_card(*view)
            if k == 0:
                whole = r
        p_next = sc.complete_shortcut(hook_and_tiebreak(p, whole.w, whole.eid,
                                                        whole.payload[0])[0])
        rounds += 1
        if torch.equal(p_next, p):
            break
        p = p_next
    assert rounds >= 3  # the last round is all dead: no edge leaves a component


@pytest.mark.gpu
def test_coarsen_solve_launches_the_undirected_mode(card, monkeypatch):
    """An unpacked coarsen solve of R-MAT s20 launches the undirected mode
    once per level round and the directed one once per residual round, and
    its forest is the one the replaced scatter route gives."""
    from repro_torch import obs
    from repro_torch.graphs.generators import rmat_graph
    from repro_torch.solve import SolveSpec, plan

    g = _unpacked(rmat_graph(20, 8, seed=3, device=card))
    p = plan(g, SolveSpec(mode="coarsen"))
    assert p.resolved.pack is False
    before = (ops.min_outgoing_und64.launches, ops.min_outgoing_flat64.launches)
    obs.enable("metrics")
    try:
        obs.metrics_reset()
        got = p.solve()
        torch.cuda.synchronize()
        counters = obs.metrics_snapshot()["counters"]
    finally:
        obs.disable()
        obs.metrics_reset()
    und = ops.min_outgoing_und64.launches - before[0]
    flat = ops.min_outgoing_flat64.launches - before[1]
    level_rounds = len(got.levels) * p.resolved.coarsen.rounds_per_level
    assert und == level_rounds > 0
    assert counters["kernel.min_outgoing_und64.launches"] == und
    assert flat == got.iterations - level_rounds
    monkeypatch.setattr(ops, "min_outgoing_und64", und_scatter_route)
    want = plan(g, SolveSpec(mode="coarsen")).solve()
    assert ops.min_outgoing_und64 is und_scatter_route
    assert sorted(got.msf_eids.tolist()) == sorted(want.msf_eids.tolist())
    assert (got.parent == want.parent).all()
    assert got.iterations == want.iterations
    assert got.weight == want.weight
    assert len(got.levels) == len(want.levels)
