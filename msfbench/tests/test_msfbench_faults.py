"""The comparison that decides ``correct``, on small cells on the CPU:
sound runs of the port pass; the control (the reference in the program's
place, on 4 of the weights' 8 bits) and every planted fault a cell can
have fail. Everything of a run but the look for a card runs here."""
import numpy as np
import pytest
import torch

import _small
from msfbench import control, harness
from msfbench.loops.solve import Answer, PortSolver

SOLVE_CELLS = _small.CELLS


@pytest.mark.parametrize("cell", SOLVE_CELLS)
@pytest.mark.parametrize("seed", [_small.SEED, 12])
def test_sound_run_is_correct(cell, seed):
    result, lines = _small.run(cell, seed=seed)
    assert result["correct"], lines
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"
    assert lines[-1] == "correct = True"


@pytest.mark.parametrize("cell", SOLVE_CELLS)
def test_traced_run_reads_the_spans(cell):
    result, _ = _small.run(cell, trace=True)
    assert result["correct"]
    names = set(result["metrics"])
    want = {m["name"] for m in harness.cell_metrics(_small.BENCH, cell, "per_layer")
            if m["source"] != "device_trace"}
    assert len(want) >= 3 and want <= names
    # no card here: no device metric, and no 0 in its place
    assert not any(k.startswith("device_idle") or "roofline" in k for k in names)


@pytest.mark.parametrize("cell", SOLVE_CELLS)
def test_control_is_not_correct(cell):
    result, _ = _small.run(cell, system=control.ControlSolver)
    assert not result["correct"]
    assert result["checks"]["weight_gap"]["value"] > result["checks"]["weight_gap"]["limit"]


# -- planted faults: the timed path broken underneath -------------------------

class StateUnchanged(PortSolver):
    """A solve that returns its initial state: no hook, no edge."""

    def solve(self, p):
        n = p.target.n
        return Answer(np.zeros(0, np.int32), np.arange(n, dtype=np.int32), 0.0, 1)


class HalfBatch(PortSolver):
    """Half of the edges left out of the solve."""

    def graph(self, e):
        h = e.m // 2
        return super().graph(e._replace(lo=e.lo[:h], hi=e.hi[:h], w=e.w[:h]))


class AlteredAnswer(PortSolver):
    """One edge id of the answer altered where it is produced."""

    def solve(self, p):
        a = super().solve(p)
        eids = a.eids.copy()
        eids[0] = (eids[0] + 1) % (p.target.num_directed_edges // 2)
        return a._replace(eids=eids)


@pytest.mark.parametrize("cell", SOLVE_CELLS)
@pytest.mark.parametrize("fault", [StateUnchanged, HalfBatch, AlteredAnswer])
def test_solve_fault_is_not_correct(cell, fault):
    result, _ = _small.run(cell, system=fault)
    assert not result["correct"]


def test_a_failing_request_is_not_correct():
    class Raises(PortSolver):
        def solve(self, p):
            raise RuntimeError("planted")

    first = _small.small_traffic(SOLVE_CELLS[0])["pool"] + 1  # after the warm-up's solves

    class Once(PortSolver):
        calls = 0

        def solve(self, p):
            Once.calls += 1
            if Once.calls == first:  # the window's first request, which always runs
                raise RuntimeError("planted")
            return super().solve(p)

    with pytest.raises(RuntimeError):
        _small.run(SOLVE_CELLS[0], system=Raises)  # a warm-up that fails ends the run
    result, _ = _small.run(SOLVE_CELLS[0], system=Once)
    assert result["failed"] == 1 and not result["correct"]


@pytest.mark.parametrize("cell", SOLVE_CELLS)
def test_graph_seed_fixes_the_graphs(cell):
    """With the configuration's ``graph_seed`` every run solves the same
    graphs; without it the run's seed draws them."""
    seen = []

    class Records(PortSolver):
        def graph(self, e):
            seen.append((e.m, int(e.w.long().sum()), int(e.lo.long().sum())))
            return super().graph(e)

    cfg = _small.small_config(cell)
    assert "graph_seed" in cfg
    for config in (cfg, {k: v for k, v in cfg.items() if k != "graph_seed"}):
        seen.clear()
        for seed in (_small.SEED, 12):
            result, _ = harness.run_cell(
                cell, seed=seed, seconds=0.2, trace=False, device="cpu", t_process=0.0,
                bench=_small.BENCH, config=config, traffic=_small.small_traffic(cell),
                system=Records)
            assert result["correct"]
        pool = len(seen) // 2
        same = seen[:pool] == seen[pool:]
        assert same == ("graph_seed" in config)


def test_control_weights_are_the_precision_below():
    w = torch.tensor([1, 15, 16, 255], dtype=torch.uint8)
    assert control.coarse(w).tolist() == [0, 0, 1, 15]
