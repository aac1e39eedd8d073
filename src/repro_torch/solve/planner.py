"""``plan(target, spec)`` — compile a :class:`SolveSpec` into a ``Plan``.

The plan compiler resolves the spec against the target (concrete backend
choices for the target's device), looks the (resolved spec, static
shape, mesh) key up in a bounded per-process cache, and wraps the cached
engine in a cheap :class:`Plan` handle:

    report = plan(graph, SolveSpec()).solve()
    report = plan(part, SolveSpec(mode="dist"), mesh=mesh).solve()  # every rank
    p = plan(n, SolveSpec(mode="stream"))   # on the card; device="cpu" there
    p.update(u, v, w)                       # stream mode only
    p.query(u, v)                           # stream mode only

Engines are target-free: the cache stores machinery, never the target's
tensors. Stream plans are stateful (they own a forest) and are not
cached. ``mode="flat"``, ``"coarsen"``, ``"dist"`` and ``"stream"`` are
registered. A dist plan is SPMD: every rank of the mesh plans the same
``Partition2D`` and calls ``solve()``, and every rank gets the same
report. Each engine built carries its analytic
:class:`~repro_torch.solve.cost.PlanCost` (``Plan.cost``, and
``SolveReport.cost`` of every call), computed once from shapes.

``SolveSpec(obs="metrics"|"trace")`` scopes that observability mode
around planning (``plan.resolve`` and ``plan.build`` spans, the
``plan.cache.{hit,miss}`` counters) and around every plan call (a
``solve.<mode>[.<call>]`` span, and the span totals of the call in
``SolveReport.timings``), as in the reference. In trace mode the
``solve.flat`` and ``solve.coarsen`` spans also carry the solve's host
waits (``host_syncs``, ``host_syncs_by_site``: ``obs.host_sync``'s tally).
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.solve import spec as _spec_mod
from repro_torch.solve.cost import plan_cost
from repro_torch.solve.report import SolveReport
from repro_torch.solve.spec import MODES, ResolvedSpec, SolveSpec

PLAN_CACHE_MAXSIZE = 64
#: solve spans whose every host wait counts in obs.host_sync's tally: in
#: trace mode they carry ``host_syncs`` and ``host_syncs_by_site``
_TALLIED = ("solve.flat", "solve.coarsen")

_lock = threading.Lock()
_cache: "OrderedDict[Any, Any]" = OrderedDict()  # key -> engine (LRU)


class _EngineDef(NamedTuple):
    mode: str
    builder: Callable  # (target, resolved, mesh) -> engine
    cacheable: bool


_engines: dict[str, _EngineDef] = {}


def register_engine(mode: str, builder: Callable, *, cacheable: bool = False):
    """Register a solver engine for ``mode``.

    ``builder(target, resolved, mesh)`` returns an object with
    ``solve(target, *args, **kw) -> SolveReport``. Set ``cacheable=True``
    only if the engine is target-free. Registering a mode also makes it a
    legal ``SolveSpec.mode`` value.
    """
    _engines[mode] = _EngineDef(mode, builder, cacheable)
    if mode not in MODES:
        _spec_mod.EXTRA_MODES.add(mode)
    return builder


def registered_modes() -> tuple:
    return tuple(_engines)


# ---------------------------------------------------------------------------
# plan cache
# ---------------------------------------------------------------------------

def _shape_key(target) -> tuple:
    """Static-shape fingerprint of a plan target (never its data)."""
    if target is None:
        return ("none",)
    if isinstance(target, (int, np.integer)):
        return ("n", int(target))
    shard = getattr(target, "shard_size", None)
    if shard is not None:  # Partition2D
        return ("part2d", target.rows, target.cols, target.e_max, target.n, target.n_pad,
                shard)
    src = getattr(target, "src", None)
    if src is not None:  # Graph
        return ("graph", target.n, int(src.shape[0]))
    raise TypeError(f"cannot plan against target of type {type(target).__name__}")


def _cache_get(key):
    with _lock:
        eng = _cache.get(key)
        if eng is not None:
            _cache.move_to_end(key)
        return eng


def _cache_put(key, engine):
    with _lock:
        _cache[key] = engine
        _cache.move_to_end(key)
        while len(_cache) > PLAN_CACHE_MAXSIZE:
            _cache.popitem(last=False)


def plan_cache_info() -> tuple:
    """(current entries, max entries) of the per-process plan cache."""
    with _lock:
        return len(_cache), PLAN_CACHE_MAXSIZE


def clear_plan_cache() -> None:
    with _lock:
        _cache.clear()


# ---------------------------------------------------------------------------
# the compiler
# ---------------------------------------------------------------------------

def plan(target, spec: SolveSpec | None = None, *, mesh=None, device=None,
         **overrides) -> "Plan":
    """Compile ``spec`` against ``target`` into a reusable :class:`Plan`.

    ``target``: a port ``Graph`` (flat / coarsen), a host ``Partition2D``
    of the original graph plus ``mesh=`` (dist: a
    :class:`~repro_torch.launch.mesh.Mesh`), or an ``int`` vertex count or
    ``Graph`` (stream — only ``n`` is read). Keyword ``overrides`` are
    folded into the spec (``plan(g, pack=False)``). The plan runs on the
    device where a graph's tensors live; a dist plan on the mesh's device;
    for a target without tensors, on the type of ``device`` (``None`` =
    ``"cuda"``, which raises without a card once an engine needs it).
    """
    if spec is None:
        spec = SolveSpec(**overrides)
    elif overrides:
        spec = dataclasses.replace(spec, **overrides)
    edef = _engines.get(spec.mode)
    if edef is None:
        raise ValueError(
            f"no engine registered for mode {spec.mode!r} "
            f"(registered: {registered_modes()})"
        )
    if spec.mode == "dist" and mesh is None:
        raise ValueError("mode='dist' needs a mesh= (a repro_torch.launch.mesh.Mesh)")
    on_graph = isinstance(getattr(target, "src", None), torch.Tensor)
    if spec.mode == "dist":
        backend = mesh.device.type
    else:
        backend = None if device is None or on_graph else torch.device(device).type
    with obs.enabled(spec.obs):
        with obs.span("plan.resolve", mode=spec.mode):
            resolved = spec.resolve(target, backend=backend, mesh=mesh)
        engine = None
        key = None
        if edef.cacheable:
            # The key carries the *resolved* spec: two same-shape targets whose
            # data or device resolves differently must not share an engine.
            key = (resolved, _shape_key(target), mesh)
            engine = _cache_get(key)
            if obs.metrics_active():
                obs.counter(
                    "plan.cache.hit" if engine is not None else "plan.cache.miss"
                ).inc()
        if engine is None:
            with obs.span("plan.build", mode=spec.mode):
                engine = edef.builder(target, resolved, mesh)
                # Stored on the engine, so cache hits reuse it. Shapes
                # only: no pass over the edges, no host sync.
                engine._plan_cost = plan_cost(spec.mode, target, resolved)
            if key is not None:
                _cache_put(key, engine)
    return Plan(spec=spec, resolved=resolved, target=target, mesh=mesh, engine=engine)


class Plan:
    """A compiled solve: spec + resolved backends + a (possibly shared)
    engine, bound to one target."""

    def __init__(self, *, spec, resolved, target, mesh, engine):
        self.spec: SolveSpec = spec
        self.resolved: ResolvedSpec = resolved
        self.target = target
        self.mesh = mesh
        self._engine = engine

    @property
    def mode(self) -> str:
        return self.spec.mode

    @property
    def driver(self):
        """The engine-native callable (dist mode: the block driver, or the
        ``DistCoarsenMSF`` instance with ``coarsen=``), called with the
        partition's five [R, C, Emax] arrays; ``None`` for engines
        without one."""
        return getattr(self._engine, "driver", None)

    @property
    def engine(self):
        """The engine-native object (stream mode: the ``StreamEngine`` —
        ``forest_edges()``, ``union_edge_capacity``, ...)."""
        return getattr(self._engine, "engine", self._engine)

    @property
    def service(self):
        """Stream mode: the engine's shared
        :class:`~repro_torch.stream.service.QueryService` — reads from the
        published snapshot store, safe to call from any thread while the
        single writer applies ``update()``/``delete()``."""
        svc = getattr(self._stream(), "service", None)
        if svc is None:
            raise ValueError(
                f"service is a stream-mode surface; this plan's mode "
                f"is {self.mode!r}"
            )
        return svc

    @property
    def cost(self):
        """Analytic :class:`~repro_torch.solve.cost.PlanCost` of this plan,
        computed once at build (``None`` out of the model's scope:
        stream, or on failure)."""
        return getattr(self._engine, "_plan_cost", None)

    def _attach_cost(self, rep):
        if isinstance(rep, SolveReport) and rep.cost is None:
            c = self.cost
            if c is not None:
                rep = rep._replace(cost=c)
        return rep

    def _observed(self, what: str, call):
        """Run one engine call under this spec's ``obs`` scope: a
        ``solve.<mode>[.<what>]`` span and, for a ``SolveReport``, the
        per-span ``timings``. With the global mode and the spec's knob
        both off, this is two checks and the cost attach around the call."""
        if not obs.metrics_active() and self.spec.obs == "off":
            return self._attach_cost(call())
        name = f"solve.{self.spec.mode}" + (f".{what}" if what else "")
        with obs.enabled(self.spec.obs):
            with obs.collect_timings() as t, obs.span(name) as sp:
                if obs.trace_active() and name in _TALLIED:
                    with obs.collect_syncs() as syncs:
                        rep = call()
                    sp.set(host_syncs=sum(syncs.values()), host_syncs_by_site=dict(syncs))
                else:
                    rep = call()
            if t and isinstance(rep, SolveReport):
                rep = rep._replace(timings=dict(t))
        return self._attach_cost(rep)

    def solve(self, *args, **kw) -> SolveReport:
        """Run the full solve for this plan's target; flat plans accept
        ``parent0=`` (array-like, moved to the graph's device) for warm
        starts, dist plans the five block arrays positionally in place of
        the target's own."""
        return self._observed("", lambda: self._engine.solve(self.target, *args, **kw))

    # -- stream-mode surfaces -------------------------------------------

    def _stream(self):
        if not hasattr(self._engine, "update"):
            raise ValueError(
                f"update()/query() are stream-mode surfaces; this plan's "
                f"mode is {self.mode!r}"
            )
        return self._engine

    def update(self, u, v, w) -> SolveReport:
        """Stream mode: apply one batch of edge insertions."""
        eng = self._stream()
        return self._observed("update", lambda: eng.update(u, v, w))

    def delete(self, u, v) -> SolveReport:
        """Stream mode: delete a batch of edges (exact replacement-edge
        search by default; tombstones under ``exact_deletes=False``)."""
        eng = self._stream()
        return self._observed("delete", lambda: eng.delete(u, v))

    def recertify(self, u, v, w) -> SolveReport:
        """Stream mode: rebuild forest + reservoir exactly from a
        caller-supplied surviving edge multiset — the recovery path when
        ``SolveReport.n_unhealed > 0`` after reservoir exhaustion."""
        eng = self._stream()
        return self._observed("recertify", lambda: eng.recertify(u, v, w))

    def query(self, u, v):
        """Stream mode: batched connectivity queries against the latest
        published snapshot; returns a bool array."""
        eng = self._stream()
        return self._observed("query", lambda: eng.query(u, v))

    def compact(self) -> SolveReport:
        """Stream mode: drop tombstones and rebuild the forest."""
        eng = self._stream()
        return self._observed("compact", lambda: eng.compact())

    def __repr__(self):
        return (
            f"Plan(mode={self.mode!r}, target={_shape_key(self.target)}, "
            f"pack={self.resolved.pack}, backend={self.resolved.backend!r})"
        )
