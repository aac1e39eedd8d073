"""Runs one cell of ``BENCHMARK.json`` and builds its result line.

Everything a cell needs is found by name: its configuration file
(``configs/<config>.json``, whose ``generator`` names ``gen/<generator>.py``),
its traffic file (``traffic/<traffic>.json``, whose ``loop`` names
``loops/<loop>.py``), its limits (``limits/<cell>.json``) and each
per-layer metric's reader (``metrics/<metric>.py``). A later cell or
metric is new files and new entries, not edits.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import NamedTuple

import torch

from msfbench import peaks
from msfbench.devtrace import SubWindow

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def config_entry(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise SystemExit(f"no configuration {name!r} in BENCHMARK.json")


def traffic_path(traffic: str) -> Path:
    return HERE / "traffic" / f"{traffic}.json"


def limits_path(cell: str) -> Path:
    return HERE / "limits" / f"{cell}.json"


def metric_path(metric: str) -> Path:
    return HERE / "metrics" / f"{metric}.py"


def metric_reader(metric: str):
    """The ``read(reading)`` function of ``metrics/<metric>.py``."""
    path = metric_path(metric)
    spec = importlib.util.spec_from_file_location("msfbench_metric_" + metric.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The metrics of ``kind`` ("end_to_end" or "per_layer") that ``cell``
    reports: those that list it, and those without a list whose
    end-to-end metric the cell reports."""
    e2e = {m["name"] for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]}
    out = []
    for m in bench[kind]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


class Reading(NamedTuple):
    """What a per-layer metric's reader reads."""

    requests: list  # one dict per request of the window, as the loop records them
    spans: list  # the program's span events (name, t0_ns, dur_ns, tid, attrs) in the window
    profile: object  # devtrace.Profile of the traced sub-window, or None
    peaks: dict  # the card's published peaks (peaks.H100_SXM)


class Ctx:
    """One run's parameters and its clock, handed to the loop."""

    def __init__(self, *, cell, config, traffic, limits, generator, seed, seconds, trace,
                 device, t_process):
        self.cell, self.config, self.traffic, self.limits = cell, config, traffic, limits
        self.generator = generator
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device = torch.device(device)
        self.t_process = t_process
        self.setup_s = None
        self.memory_peak_bytes = 0

    def log(self, msg: str) -> None:
        print(f"[msfbench {self.cell}] {msg}", file=sys.stderr, flush=True)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup_done(self) -> None:
        """Set-up ends: everything before the first timed request."""
        self.sync()
        self.setup_s = time.perf_counter() - self.t_process

    def window_closed(self) -> None:
        """The window has closed: read the device's peak before the reference runs."""
        self.sync()
        if self.device.type == "cuda":
            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated(self.device))

    def free_memory(self) -> None:
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def subwindow(self, label: str) -> SubWindow:
        return SubWindow(self.trace, self.traffic["profile_requests"], label)


def run_cell(cell: str, *, seed: int, seconds: float, trace: bool, device, t_process: float,
             bench: dict | None = None, config: dict | None = None, traffic: dict | None = None,
             limits: dict | None = None, system=None) -> tuple[dict, list]:
    """Run ``cell`` and return (result line, check lines). The keyword
    arguments after ``t_process`` replace what is otherwise read from
    the files (the tests run small cells on the CPU this way)."""
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    w = workload(bench, cell)
    config = config or load_json(ROOT / config_entry(bench, w["config"])["file"])
    traffic = traffic or load_json(traffic_path(w["traffic"]))
    limits = limits or load_json(limits_path(cell))
    gen = importlib.import_module(f"msfbench.gen.{config['generator']}")
    loop = importlib.import_module(f"msfbench.loops.{traffic['loop']}")
    ctx = Ctx(cell=cell, config=config, traffic=traffic, limits=limits, generator=gen,
              seed=seed, seconds=seconds, trace=trace, device=device, t_process=t_process)
    out = loop.run(ctx, system)

    metrics = {}
    if trace:
        reading = Reading(out.requests, out.spans, out.profile, peaks.H100_SXM)
        for m in cell_metrics(bench, cell, "per_layer"):
            v = metric_reader(m["name"])(reading)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in cell_metrics(bench, cell, "end_to_end"):
            v = ctx.setup_s if m["name"] == "setup_s" else out.end_to_end[m["name"]]
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = ctx.device
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": int(w["chips"]),
        "memory_peak_bytes": ctx.memory_peak_bytes,
    }
    result = {
        "correct": bool(out.correct),
        "attempted": int(out.attempted),
        "failed": int(out.failed),
        "metrics": metrics,
        "device": device_info,
    }
    if trace and out.profile is not None and out.profile.n_device_events:
        device_info["busy_s"] = out.profile.busy_s
        device_info["window_s"] = out.profile.window_s
        result["breakdown"] = {"device_ops": out.profile.device_ops,
                               "idle_gaps": out.profile.idle_gaps}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in out.checks.items()}
    lines = [f"check {k} = {v!r} (limit {lim!r})" for k, (v, lim) in out.checks.items()]
    lines.append(f"correct = {bool(out.correct)}")
    return result, lines
