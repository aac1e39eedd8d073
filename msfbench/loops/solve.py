"""Closed loop of whole MSF solves by one caller.

Set-up makes a pool of graphs of the cell's configuration, from the
configuration's ``graph_seed`` where it states one (then every run solves
the same graphs, and the run's seed draws only the answers judged), else
from the run's seed, and solves each once (the warm-up: the kernel
library's build and load, the plan cache, the allocator). A request is one
``plan(g, SolveSpec(**spec))`` of the next graph of the pool, round robin,
with the traffic file's ``spec``, and its ``solve()`` up to the report on
the host. The answers judged are drawn by blocks (``is_judged``): requests
fall into consecutive blocks of ``1 / check_share``, and the run's seed
picks one position in each, known as the block's first request leaves.
So each answer has the chance ``check_share`` of being judged, and a run
of N requests keeps ``floor(N * check_share)`` or ``ceil(N * check_share)``
drawn answers whatever the seed: a kept answer holds its report's host
buffers, which the solves that follow pay for. After the window, the
answers drawn (and the last answer of every graph of the pool) are
compared with the plain reference: the forest's edge ids, its partition
and its weight.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from msfbench import bytecount as B
from msfbench import rng
from msfbench.loops import Outcome, judge
from msfbench.reference import msf as R


class Answer(NamedTuple):
    eids: np.ndarray  # edge ids of the forest
    parent: np.ndarray  # component representative of each vertex
    weight: float  # the forest's weight as the system reports it
    rounds: int


class PortSolver:
    """The system under test: ``repro_torch.solve.plan(g, SolveSpec(**spec)).solve()``
    on a ``repro_torch`` graph built from the benchmark's edges; ``spec``
    is the traffic file's (none: the defaults)."""

    def __init__(self, device, spec=None):
        from repro_torch import obs, solve
        from repro_torch.graphs.structures import Graph

        self._obs, self._solve, self._Graph = obs, solve, Graph
        self.spec = solve.SolveSpec(**(spec or {}))

    def graph(self, e):
        eid = torch.arange(e.m, dtype=torch.int32, device=e.lo.device)
        w = e.w.to(torch.float32)
        return self._Graph(
            src=torch.cat([e.lo, e.hi]), dst=torch.cat([e.hi, e.lo]),
            w=torch.cat([w, w]), eid=torch.cat([eid, eid]),
            valid=torch.ones(2 * e.m, dtype=torch.bool, device=e.lo.device), n=e.n,
        )

    def plan(self, g):
        return self._solve.plan(g, self.spec)

    def solve(self, p) -> Answer:
        rep = p.solve()
        return Answer(rep.msf_eids, rep.parent, float(rep.weight), int(rep.iterations))

    def trace(self) -> None:
        self._obs.enable("trace")

    def spans(self) -> list:
        return self._obs.trace_events()

    def release(self) -> None:
        self._solve.clear_plan_cache()


def block_size(share: float) -> int:
    """Requests per block of the judged draw: ``1 / share``, which has to
    be a whole number."""
    b = round(1 / share) if share > 0 else 0
    if b < 1 or abs(b * share - 1) > 1e-9:
        raise ValueError(f"check_share {share!r}: its inverse is not a whole number")
    return b


def is_judged(seed: int, share: float, k: int) -> bool:
    """Whether the answer of request ``k`` (from 0) is judged: the seed's
    ``sample`` stream picks one position in each block of ``1 / share``
    consecutive requests."""
    b = block_size(share)
    return rng.stream_seed(seed, "sample", k // b) % b == k % b


def run(ctx, system=None) -> Outcome:
    tr = ctx.traffic
    share = float(tr["check_share"])
    block_size(share)  # a share whose inverse is not whole fails before set-up
    dev = ctx.device
    system = (system or PortSolver)(dev, tr.get("spec"))
    if ctx.trace:
        system.trace()
    gseed = int(ctx.config.get("graph_seed", ctx.seed))
    pool = [ctx.generator.base_edges(ctx.config, gseed, i, dev) for i in range(int(tr["pool"]))]
    graphs = [system.graph(e) for e in pool]
    for g in graphs:  # warm-up: every graph once
        system.solve(system.plan(g))
    keep_mask: list = []  # request index -> its answer is judged
    sub = ctx.subwindow("msfbench.solve")
    sub.begin()
    kept: dict = {}  # request index -> (graph index, Answer)
    last: dict = {}  # graph index -> request index of its latest answer
    requests: list = []
    failed = 0
    ctx.setup_done()
    t_start = time.perf_counter_ns()
    deadline = t_start + int(ctx.seconds * 1e9)
    k = 0
    while time.perf_counter_ns() < deadline:
        i = k % len(graphs)
        keep_mask.append(is_judged(ctx.seed, share, k))
        sub.step(k)
        with sub.range():
            t0 = time.perf_counter_ns()
            try:
                p = system.plan(graphs[i])
                t1 = time.perf_counter_ns()
                ans = system.solve(p)
            except Exception as exc:  # a request that fails counts, the loop goes on
                ctx.log(f"request {k} failed: {exc!r}")
                failed += 1
                k += 1
                continue
            t2 = time.perf_counter_ns()
        requests.append(dict(plan_s=(t1 - t0) * 1e-9, latency_s=(t2 - t0) * 1e-9,
                             rounds=ans.rounds, e_directed=2 * pool[i].m,
                             bytes=B.solve_bytes(pool[i].n, 2 * pool[i].m, ans.rounds),
                             profiled=sub.active))
        if i in last and not keep_mask[last[i]]:
            kept.pop(last[i], None)
        kept[k] = (i, ans)
        last[i] = k
        k += 1
    t_end = time.perf_counter_ns()
    sub.close()
    ctx.window_closed()
    spans = [ev for ev in system.spans() if ev[1] >= t_start and ev[1] < t_end]
    system.release()
    del graphs, system
    ctx.free_memory()

    # the reference, once per graph that has an answer to judge
    readings = dict(failed=failed, unanswered=0 if kept else 1,
                    eid_mismatch=0, partition_mismatch=0, weight_gap=0.0)
    refs: dict = {}
    for k in sorted(kept):
        i, ans = kept[k]
        if i not in refs:
            e = pool[i]
            refs[i] = R.msf(e.lo, e.hi, e.w, e.n)
        ref = refs[i]
        readings["eid_mismatch"] += eid_mismatch(ans.eids, ref.in_forest)
        labels = R.root_labels(torch.as_tensor(np.asarray(ans.parent)).to(dev), pool[i].n)
        readings["partition_mismatch"] += (
            pool[i].n if labels is None else int((labels != ref.labels).sum()))
        gap = abs(ans.weight - ref.weight) / max(ref.weight, 1.0)
        readings["weight_gap"] = max(readings["weight_gap"], gap)
    checks, ok = judge(readings, ctx.limits)
    ctx.log(f"answers judged: {len(kept)} of {len(requests)}, graphs: {len(refs)}")
    window_s = (t_end - t_start) * 1e-9
    # directed edges of every solve completed over the window: the traffic
    # file names the metric (a flat and a coarsen solve are bound apart)
    e2e = {tr.get("rate_metric", "solve_edges_per_s"):
           sum(r["e_directed"] for r in requests) / window_s}
    return Outcome(
        attempted=len(requests) + failed, failed=failed, end_to_end=e2e, requests=requests,
        profile=sub.summary(), spans=spans, checks=checks, correct=ok,
    )


def eid_mismatch(eids, in_forest: torch.Tensor) -> int:
    """Edges in one forest and not the other, counted with multiplicity
    (an id the system gives twice counts once more); ids outside the
    graph count too."""
    m = int(in_forest.shape[0])
    e = torch.as_tensor(np.asarray(eids)).to(in_forest.device).long()
    inside = (e >= 0) & (e < m)
    cnt = torch.bincount(e[inside], minlength=m)
    return int((cnt - in_forest.long()).abs().sum()) + int((~inside).sum())
