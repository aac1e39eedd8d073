"""Small cells for the CPU tests: the cells of BENCHMARK.json with their
configurations cut to sizes a test run holds."""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from msfbench import harness  # noqa: E402

BENCH = harness.load_json(ROOT / "BENCHMARK.json")
SEED = 2**31 + 977  # seeds may exceed 32 signed bits
CELLS = [w["name"] for w in BENCH["workloads"]]


def small_config(cell: str) -> dict:
    w = harness.workload(BENCH, cell)
    cfg = harness.load_json(ROOT / harness.config_entry(BENCH, w["config"])["file"])
    assert cfg["generator"] == "kronecker", cfg["generator"]
    return dict(cfg, scale=9, edgefactor=8)


def small_traffic(cell: str) -> dict:
    tr = harness.load_json(harness.traffic_path(harness.workload(BENCH, cell)["traffic"]))
    return dict(tr, pool=3, profile_requests=4)


def run(cell: str, *, seed: int = SEED, seconds: float = 0.3, trace: bool = False,
        system=None):
    return harness.run_cell(cell, seed=seed, seconds=seconds, trace=trace, device="cpu",
                            t_process=time.perf_counter(), bench=BENCH,
                            config=small_config(cell), traffic=small_traffic(cell),
                            system=system)
