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


# ---------------------------------------------------------------------------
# distributed plans: a group of spawned ranks on a FileStore
# ---------------------------------------------------------------------------

RANK_PRELUDE = """
import os, pickle
from datetime import timedelta
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
RANK, WORLD = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init_process_group("gloo", store=dist.FileStore(os.environ["STORE"], WORLD),
                        rank=RANK, world_size=WORLD, timeout=timedelta(seconds=60))
with open(os.environ["INPUTS"], "rb") as f:
    INPUTS = pickle.load(f)
OUT = {}
"""

# Every rank waits for the others and then leaves without tearing its
# gloo groups down: a rank whose peers have already exited can abort in
# the teardown ("terminate called without an active exception").
RANK_EPILOGUE = """
with open(os.environ["OUT"], "wb") as f:
    pickle.dump(OUT, f)
dist.barrier()
os._exit(0)
"""


def start_ranks(body: str, world: int, inputs, workdir):
    """Start ``world`` ranks of a gloo group (one interpreter each, on a
    ``FileStore`` under ``workdir``: no TCP rendezvous port). Each runs
    ``body`` with ``RANK``, ``WORLD``, ``INPUTS`` (``inputs``, pickled)
    and fills the dict ``OUT``. Returns a handle for :func:`join_ranks`."""
    import os
    import pickle
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    with open(workdir / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, PYTHONPATH=str(root / "src"), GLOO_SOCKET_IFNAME="lo",
               OMP_NUM_THREADS="1", WORLD_SIZE=str(world), STORE=str(workdir / "store"),
               INPUTS=str(workdir / "inputs.pkl"))
    code = RANK_PRELUDE + body + RANK_EPILOGUE
    procs = []
    for r in range(world):
        log = open(workdir / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-c", code], cwd=root, stdout=log, stderr=subprocess.STDOUT,
            env=dict(env, RANK=str(r), OUT=str(workdir / f"rank{r}.pkl"))), log))
    return workdir, procs


def join_ranks(handle, timeout: float = 120.0) -> list:
    """Wait for every rank of :func:`start_ranks` at most ``timeout``
    seconds in all; on a timeout or any failure kill the rest and fail
    with the ranks' logs. Returns each rank's ``OUT``."""
    import pickle
    import subprocess
    import time

    workdir, procs = handle
    deadline = time.monotonic() + timeout
    try:
        for p, _ in procs:
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                break
            if p.returncode != 0:
                break
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    bad = [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
    if bad:
        logs = "\n".join(f"--- rank {r} (exit {procs[r][0].returncode}) ---\n"
                         + (workdir / f"rank{r}.log").read_text()[-3000:] for r in bad)
        raise AssertionError(f"ranks {bad} of {len(procs)} failed or timed out:\n{logs}")
    out = []
    for r in range(len(procs)):
        with open(workdir / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def report_fields(rep) -> dict:
    """A ``SolveReport`` of either package as plain host values: the fields
    that both packages hold to one contract (not ``raw``, ``cost``,
    ``timings``)."""
    return {
        "mode": rep.mode,
        "weight": float(rep.weight),
        "msf_eids": to_np(rep.msf_eids),
        "parent": to_np(rep.parent),
        "n_msf_edges": int(rep.n_msf_edges),
        "iterations": int(rep.iterations),
        "levels": tuple(tuple(int(x) for x in lv) for lv in rep.levels),
        "host_roundtrips": int(rep.host_roundtrips),
    }


def assert_same_fields(want: dict, got: dict):
    """Two dicts of host values (arrays compared exactly, with dtypes)."""
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = want[k], got[k]
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(b, a, err_msg=k)
            assert np.asarray(b).dtype == a.dtype, k
        else:
            assert b == a, k


def stats_fields(st) -> tuple:
    """A ``DistCoarsenStats`` of either package as plain ints."""
    return (tuple(tuple(int(x) for x in lv) for lv in st.levels), int(st.residual_n),
            int(st.residual_m), int(st.residual_iters), int(st.host_roundtrips))
