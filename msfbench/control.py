"""The control of the comparison that decides ``correct``.

The plain reference, put in the program's place and computed in the
precision below the one the configurations state: their weights are
8-bit integers (1..255), the control orders edges by the top 4 bits of
the weight alone (``w >> 4``), ties by edge id. It answers every request
the window makes, and the run's comparison has to find it not correct.

    python3 msfbench/control.py --workload <cell> --seeds 1,2,3 --seconds 5

prints one JSON line per seed with the readings and ``correct``. The
benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
BITS = 4  # kept of the weights' 8


def coarse(w: torch.Tensor) -> torch.Tensor:
    return w.long() >> (8 - BITS)


class ControlSolver:
    """``loops.solve``'s system: each request is the reference's MSF of the
    graph under the 4-bit order, reported with its true weight."""

    def __init__(self, device, spec=None):
        self.device = device

    def graph(self, e):
        return e

    def plan(self, e):
        return e

    def solve(self, e):
        from msfbench.loops.solve import Answer
        from msfbench.reference import msf as R

        f = R.msf(e.lo, e.hi, coarse(e.w), e.n)
        eids = torch.nonzero(f.in_forest).squeeze(1)
        weight = float(e.w[f.in_forest].double().sum())
        return Answer(eids.cpu().numpy(), f.labels.cpu().numpy(), weight, 0)

    def trace(self):
        pass

    def spans(self):
        return []

    def release(self):
        pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from msfbench import harness

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    for seed in (int(s) for s in args.seeds.split(",")):
        result, _ = harness.run_cell(args.workload, seed=seed, seconds=args.seconds, trace=False,
                                     device=args.device, t_process=time.perf_counter(),
                                     bench=bench, system=ControlSolver)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": True,
                          "correct": result["correct"], "checks": result["checks"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
