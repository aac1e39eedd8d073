"""Shared helpers of the PyTorch-port parity tests (``test_torch_*.py``).

Import only after ``pytest.importorskip("torch")``. Inputs are made with
numpy and handed to both packages; results are compared as numpy.
"""
import numpy as np
import torch

from repro_torch.graphs.structures import from_reference


def to_np(x) -> np.ndarray:
    """numpy view of a torch tensor, a jax array or anything array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def cpu_graph(g):
    """The port's CPU ``Graph`` holding the same arrays as a JAX ``Graph``."""
    return from_reference(g, device="cpu")


def assert_same_msf(ref_report, port_report, *, exact_weight=True):
    """The slice's parity contract: eid sequence, parent, edge count and
    rounds identical; the weight exact (pack32 integer regime) or compared
    as float64 sums over the eid set (float weights)."""
    np.testing.assert_array_equal(to_np(port_report.msf_eids), to_np(ref_report.msf_eids))
    np.testing.assert_array_equal(to_np(port_report.parent), to_np(ref_report.parent))
    assert port_report.n_msf_edges == ref_report.n_msf_edges
    assert port_report.iterations == ref_report.iterations
    if exact_weight:
        assert port_report.weight == ref_report.weight


def float64_weight(g, eids) -> float:
    """Float64 sum of the weights of ``eids`` in a (JAX or port) graph."""
    valid = to_np(g.valid)
    by_eid = dict(zip(to_np(g.eid)[valid].tolist(), to_np(g.w)[valid].astype(np.float64)))
    return float(sum(by_eid[int(e)] for e in eids))


# ---------------------------------------------------------------------------
# stream engines: one trace through both packages, compared after every op
# ---------------------------------------------------------------------------

def assert_same_state(want: dict, got: dict):
    """Two ``StreamEngine.state_dict()`` trees: same keys, dtypes and values."""
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = np.asarray(want[k]), np.asarray(got[k])
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(b, a, err_msg=k)


def assert_same_snapshot(want, got):
    """Two snapshots field by field; the labels compared as numpy."""
    assert got._fields == want._fields
    for f in want._fields:
        a, b = getattr(want, f), getattr(got, f)
        if f in ("parent", "comp_size"):
            np.testing.assert_array_equal(to_np(b), to_np(a), err_msg=f)
            assert to_np(b).dtype == to_np(a).dtype == np.int32
        else:
            assert b == a, f


def assert_same_stream_report(want, got):
    """Two stream-mode ``SolveReport``s (of either package) field by field:
    arrays as numpy with their dtypes, ``raw`` (the last stats) as tuples.
    ``cost`` is left out: neither package analyses stream plans."""
    assert got._fields == want._fields
    for f in want._fields:
        a, b = getattr(want, f), getattr(got, f)
        if isinstance(a, np.ndarray) or f == "parent":
            np.testing.assert_array_equal(to_np(b), to_np(a), err_msg=f)
            assert to_np(b).dtype == to_np(a).dtype, f
        elif f == "raw":
            assert type(b).__name__ == type(a).__name__
            assert a is None or tuple(b) == tuple(a)
        elif f == "levels":
            assert tuple(map(tuple, b)) == tuple(map(tuple, a))
        elif f != "cost":
            assert b == a, f


def assert_same_engine(je, te, *, union=True):
    """The observable state of a reference and a port ``StreamEngine``;
    ``union=False`` leaves out the union-buffer record (the last shape and
    the shape count), which a checkpoint does not carry."""
    assert (te.version, te.weight, te.n_forest_edges, te.reservoir_size, te.unhealed) == (
        je.version, je.weight, je.n_forest_edges, je.reservoir_size, je.unhealed)
    for a, b in zip(je.forest_edges(), te.forest_edges()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)
    assert_same_snapshot(je.snapshots.acquire(), te.snapshots.acquire())
    if union:
        assert te.last_union_shape == je.last_union_shape
        assert te.recompiles == je.recompiles
    assert_same_state(je.state_dict(), te.state_dict())


class StreamTrace:
    """A seeded random trace of stream operations and the surviving edge
    multiset it leaves (the system of record ``recertify`` replays).

    ``next_op()`` returns ``(name, args)`` with ``name`` in insert /
    delete / compact / recertify; ``args`` are numpy arrays, the same for
    both packages. Inserts draw at most ``batch`` raw edges; deletes mix
    live pairs, pairs never inserted and repeats, and may exceed
    ``batch`` to cross the engine's probe chunks."""

    def __init__(self, n, batch, seed, *, fractional=False, max_w=255,
                 p=(0.55, 0.3, 0.05, 0.1)):
        self.n, self.batch, self.fractional, self.max_w = n, batch, fractional, max_w
        self.rng = np.random.default_rng(seed)
        self.p = p
        self.alive: dict = {}  # (lo, hi) -> min weight inserted since its last delete

    def _weights(self, m):
        if self.fractional:
            return self.rng.random(m) * 10.0
        return self.rng.integers(1, self.max_w + 1, m).astype(np.float64)

    def insert(self, m=None):
        m = int(self.rng.integers(1, self.batch + 1)) if m is None else m
        u = self.rng.integers(0, self.n, m)
        v = self.rng.integers(0, self.n, m)
        w = self._weights(m)
        for a, b, x in zip(u.tolist(), v.tolist(), w.astype(np.float32).tolist()):
            if a != b:
                key = (min(a, b), max(a, b))
                self.alive[key] = min(self.alive.get(key, np.inf), x)
        return "insert", (u, v, w)

    def delete(self, m=None):
        pairs = list(self.alive)
        m = int(self.rng.integers(1, 2 * self.batch + 1)) if m is None else m
        take = min(len(pairs), m)
        idx = self.rng.choice(len(pairs), take, replace=False) if take else []
        chosen = [pairs[i] for i in idx]
        missing = [tuple(x) for x in self.rng.integers(0, self.n, (max(1, m // 8), 2))]
        for key in chosen:
            del self.alive[key]
        for a, b in missing:
            self.alive.pop((min(a, b), max(a, b)), None)
        both = chosen + missing + chosen[:2]  # repeats count as in-batch duplicates
        flip = self.rng.random(len(both)) < 0.5
        u = np.array([b if f else a for (a, b), f in zip(both, flip)], np.int64)
        v = np.array([a if f else b for (a, b), f in zip(both, flip)], np.int64)
        return "delete", (u, v)

    def recertify(self):
        keys = sorted(self.alive)
        u = np.array([k[0] for k in keys], np.int64)
        v = np.array([k[1] for k in keys], np.int64)
        w = np.array([self.alive[k] for k in keys], np.float64)
        return "recertify", (v, u, w)  # reversed endpoints: canonicalized by the engine

    def next_op(self):
        name = self.rng.choice(["insert", "delete", "compact", "recertify"], p=self.p)
        if name == "compact":
            return "compact", ()
        return getattr(self, name)()


def apply_op(engine, name, args):
    """Run one trace op on a ``StreamEngine`` of either package."""
    return {"insert": engine.insert_batch, "delete": engine.delete_batch,
            "compact": engine.compact, "recertify": engine.recertify}[name](*args)
