"""SolveSpec autotuner and persisted plan database (counterpart of
``repro.solve.tune``).

``SolveSpec.resolve()`` picks pack / segmin / dedupe / fused / shortcut by
hand-written rules; no single configuration wins across graph classes.
This module closes the loop:

1. **enumerate** — candidate ``SolveSpec``s for one (shape class, weights
   class, mode, backend, device count, mesh) key
   (:func:`enumerate_candidates`);
2. **prune** — rank them by :func:`repro_torch.solve.cost.predicted_time_s`
   before any measurement and drop the clearly dominated tail
   (:func:`prune_by_cost`: the model orders, it does not decide);
3. **measure** — time ``plan(target, candidate).solve()`` (median and IQR,
   every call ended by a device sync) and assert that every candidate
   returns the same forest weight and MSF edge set (:func:`tune`);
4. **persist** — winners go into a ``tuning-db/v1`` database
   (:class:`TuningDB`), the reference's on-disk format;
5. **look up** — ``SolveSpec.resolve(target)`` with ``tuning="db"``
   consults the active database (exact key, then the nearest shape bucket)
   and falls back to the rules on a missing, invalid or non-matching one
   (:func:`resolve_overrides`); ``tuning="measure"`` tunes the target on
   first resolve and keeps the winner in process.

The database only fills *auto* knobs: a knob the user pinned
(``pack=False``, ``segmin="torch"``, ...) always wins.

Where the port differs: ``backend`` is a device type (``"cuda"`` on the
card, ``"cpu"``), the fingerprint names ``torch``, and the candidate
space never offers the plain segment-min (``segmin="torch"``), which
nothing on the card's main path runs: the full space is ``(None,
"cuda")`` where the reference's is ``(None, "jnp", "pallas")``. A stored
``segmin="torch"`` on a ``cuda`` key is ignored at resolve (once-only
warning, ``tune.db.fallback``).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import threading
import time
import warnings
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

SCHEMA = "tuning-db/v1"
#: Environment variable naming the default on-disk database consulted by
#: ``tuning="db"`` when no database was set programmatically.
DB_ENV_VAR = "REPRO_TUNING_DB"
#: Spec knobs a tuning entry may override (plus the nested "coarsen"
#: block: cutoff / rounds_per_level / max_levels).
TUNABLE_KNOBS = ("pack", "segmin", "dedupe", "fused", "shortcut")
_COARSEN_KNOBS = ("cutoff", "rounds_per_level", "max_levels")
#: Nearest-bucket lookups never jump further than this Manhattan distance
#: in (log2 n, log2 degree) space.
MAX_BUCKET_DISTANCE = 2
#: The plain segment-min: never a candidate, never taken from a database
#: for a CUDA key.
PLAIN_SEGMIN = "torch"

_SHAPE_RE = re.compile(r"^n(\d+)d(\d+)$")


class TuningDBError(ValueError):
    """A tuning database that cannot be trusted (wrong schema, malformed
    entries). Raised by :meth:`TuningDB.load`; resolve-time consultation
    turns it into a one-time warning and the heuristic fallback."""


# ---------------------------------------------------------------------------
# keys: shape-class bucketing + environment
# ---------------------------------------------------------------------------

class TuneKey(NamedTuple):
    """One tuning-database bucket. ``shape_class`` is the coarse
    ``n<log2 n>d<log2 avg-degree>`` bucket; every other field must match
    exactly for an entry to apply."""

    shape_class: str
    weights: str  # "int" (pack32 regime) | "float" | "na" (no edge data)
    mode: str
    backend: str
    device_count: int
    mesh: str  # "RxC" for dist plans, "" otherwise


def shape_class(n: int, m: int) -> str:
    """Bucket a graph's (vertices, directed edges): rounded log2 buckets,
    so graphs within ~sqrt(2)x in size and average degree share one."""
    n = max(int(n), 1)
    m = max(int(m), 0)
    bn = int(round(math.log2(n))) if n > 1 else 0
    deg = m / n if n else 0.0
    bd = int(round(math.log2(deg))) if deg > 1.0 else 0
    return f"n{bn}d{bd}"


def parse_shape_class(s: str) -> Optional[tuple[int, int]]:
    m = _SHAPE_RE.match(s)
    return (int(m.group(1)), int(m.group(2))) if m else None


def weights_class(target) -> str:
    """"int" when the target's live weights sit in the pack32 regime,
    "float" otherwise, "na" when the target carries no edge data."""
    from repro_torch.solve.spec import _pack_probe_arrays, weights_packable

    arrays = _pack_probe_arrays(target)
    if arrays is None:
        return "na"
    w, _, valid, _ = arrays
    return "int" if weights_packable(w[valid]) else "float"


def _mesh_label(mesh) -> str:
    if mesh is None:
        return ""
    shape = getattr(getattr(mesh, "devices", None), "shape", None)
    return "x".join(str(int(d)) for d in shape) if shape else ""


def _target_nm(target) -> Optional[tuple[int, int]]:
    if target is None:
        return None
    if isinstance(target, (int, np.integer)):
        return int(target), 0
    src = getattr(target, "src", None)
    if src is not None:  # Graph
        return int(target.n), int(src.shape[0])
    return None


def _device_count(backend: str) -> int:
    return torch.cuda.device_count() if backend == "cuda" else 1


def key_for(mode: str, target, *, backend: str | None = None,
            mesh=None, device_count: int | None = None) -> TuneKey:
    """The database key of ``target`` under ``mode``: ``backend`` defaults
    to the target graph's device type (``"cuda"`` for a target without
    tensors). Raises ``ValueError`` for targets without a shape."""
    from repro_torch.solve.spec import _target_device_type

    nm = _target_nm(target)
    if nm is None:
        raise ValueError(
            f"cannot derive a tuning key from target of type "
            f"{type(target).__name__}"
        )
    backend = backend or _target_device_type(target)
    return TuneKey(
        shape_class=shape_class(*nm),
        weights=weights_class(target),
        mode=mode,
        backend=backend,
        device_count=int(device_count if device_count is not None
                         else _device_count(backend)),
        mesh=_mesh_label(mesh),
    )


def db_env_fingerprint() -> dict:
    """Provenance of a database build: torch's version, the process's
    device type (``"cuda"`` when a card is visible) and device count."""
    import platform

    backend = "cuda" if torch.cuda.is_available() else "cpu"
    return {
        "torch": torch.__version__,
        "backend": backend,
        "device_count": _device_count(backend),
        "python": platform.python_version(),
        "machine": platform.machine(),
        "cpu_count": os.cpu_count(),
    }


# ---------------------------------------------------------------------------
# the database
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TuningEntry:
    """One persisted winner: the knob overrides and the measurement that
    elected them."""

    key: TuneKey
    knobs: dict  # tunable-knob values (+ optional "coarsen" sub-dict)
    stats: dict  # median_us/iqr_us/iters/candidates/measured/pruned/...

    def as_dict(self) -> dict:
        return {"key": self.key._asdict(), "knobs": self.knobs, "stats": self.stats}


class TuningDB:
    """In-memory view of one ``tuning-db/v1`` document."""

    def __init__(self, entries: dict[TuneKey, TuningEntry] | None = None,
                 env: dict | None = None, created: float | None = None):
        self.entries: dict[TuneKey, TuningEntry] = dict(entries or {})
        self.env = dict(env) if env is not None else db_env_fingerprint()
        self.created = time.time() if created is None else float(created)

    def put(self, key: TuneKey, knobs: dict, stats: dict | None = None):
        self.entries[key] = TuningEntry(key, dict(knobs), dict(stats or {}))

    def lookup(self, key: TuneKey, *, max_distance: int = MAX_BUCKET_DISTANCE
               ) -> Optional[tuple[TuningEntry, bool]]:
        """``(entry, exact)`` for ``key``: the exact bucket first, then the
        nearest compatible one (every non-shape field equal, Manhattan
        distance in (log2 n, log2 degree) ≤ ``max_distance``); ``None``
        when nothing compatible exists."""
        entry = self.entries.get(key)
        if entry is not None:
            return entry, True
        want = parse_shape_class(key.shape_class)
        if want is None:
            return None
        compat = (key.weights, key.mode, key.backend, key.device_count, key.mesh)
        best: Optional[tuple[tuple, TuningEntry]] = None
        for k, e in self.entries.items():
            if (k.weights, k.mode, k.backend, k.device_count, k.mesh) != compat:
                continue
            got = parse_shape_class(k.shape_class)
            if got is None:
                continue
            d = abs(got[0] - want[0]) + abs(got[1] - want[1])
            if d > max_distance:
                continue
            rank = (d, k.shape_class)  # deterministic tie-break
            if best is None or rank < best[0]:
                best = (rank, e)
        return (best[1], False) if best is not None else None

    def to_doc(self) -> dict:
        return {
            "schema": SCHEMA,
            "created": self.created,
            "env": self.env,
            "entries": [e.as_dict() for _, e in sorted(self.entries.items())],
        }

    def save(self, path: str) -> str:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_doc(), f, indent=1, sort_keys=True)
        return path

    @classmethod
    def from_doc(cls, doc: Any) -> "TuningDB":
        if not isinstance(doc, dict):
            raise TuningDBError("tuning DB document is not an object")
        schema = doc.get("schema")
        if schema != SCHEMA:
            raise TuningDBError(
                f"unsupported tuning DB schema {schema!r} "
                f"(this build reads {SCHEMA!r})"
            )
        raw = doc.get("entries")
        if not isinstance(raw, list):
            raise TuningDBError("tuning DB has no entries list")
        entries: dict[TuneKey, TuningEntry] = {}
        for i, item in enumerate(raw):
            try:
                kd = dict(item["key"])
                key = TuneKey(
                    shape_class=str(kd["shape_class"]),
                    weights=str(kd["weights"]),
                    mode=str(kd["mode"]),
                    backend=str(kd["backend"]),
                    device_count=int(kd["device_count"]),
                    mesh=str(kd.get("mesh", "")),
                )
                knobs = item["knobs"]
                if not isinstance(knobs, dict):
                    raise TypeError("knobs is not a dict")
            except (KeyError, TypeError, ValueError) as e:
                raise TuningDBError(f"malformed tuning entry #{i}: {e}")
            entries[key] = TuningEntry(key, dict(knobs), dict(item.get("stats", {})))
        return cls(entries, env=doc.get("env"), created=doc.get("created"))

    @classmethod
    def load(cls, path: str) -> "TuningDB":
        try:
            with open(path) as f:
                doc = json.load(f)
        except OSError as e:
            raise TuningDBError(f"cannot read tuning DB {path}: {e}")
        except ValueError as e:
            raise TuningDBError(f"cannot parse tuning DB {path}: {e}")
        return cls.from_doc(doc)

    def __len__(self) -> int:
        return len(self.entries)


# ---------------------------------------------------------------------------
# process-global active database
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_active: Optional[TuningDB] = None
_active_explicit = False  # set_tuning_db was called (incl. with None)
_env_loaded: dict[str, Optional[TuningDB]] = {}  # path -> db/None (memoized)
_warned: set = set()


def _warn_once(tag: str, msg: str) -> None:
    with _lock:
        if tag in _warned:
            return
        _warned.add(tag)
    warnings.warn(msg, RuntimeWarning, stacklevel=3)


def set_tuning_db(db: "TuningDB | str | None") -> Optional[TuningDB]:
    """Install the process-wide database ``tuning="db"`` consults: a
    :class:`TuningDB`, a path (loaded now; an invalid file raises
    :class:`TuningDBError` here), or ``None`` to clear (resolve then reads
    ``REPRO_TUNING_DB`` again)."""
    global _active, _active_explicit
    if isinstance(db, str):
        db = TuningDB.load(db)
    with _lock:
        _active = db
        _active_explicit = db is not None
        _env_loaded.clear()
        _warned.clear()
    return db


def get_tuning_db() -> Optional[TuningDB]:
    """The active database: the one installed by :func:`set_tuning_db`,
    else the ``REPRO_TUNING_DB`` file (loaded once per path; an invalid
    file warns once and reads as missing)."""
    with _lock:
        if _active_explicit or _active is not None:
            return _active
    path = os.environ.get(DB_ENV_VAR)
    if not path:
        return None
    with _lock:
        if path in _env_loaded:
            return _env_loaded[path]
    try:
        db = TuningDB.load(path)
    except TuningDBError as e:
        db = None
        _warn_once(
            f"env:{path}",
            f"ignoring tuning DB from {DB_ENV_VAR}: {e} — "
            f"SolveSpec.resolve() falls back to heuristics",
        )
    with _lock:
        _env_loaded[path] = db
    return db


# ---------------------------------------------------------------------------
# resolve-time consultation (the spec layer's hook)
# ---------------------------------------------------------------------------

def spec_knobs(spec) -> dict:
    """The tunable-knob values of ``spec``: what :func:`tune` persists for
    a winning candidate."""
    knobs = {k: getattr(spec, k) for k in TUNABLE_KNOBS}
    if spec.coarsen is not None:
        knobs["coarsen"] = {k: getattr(spec.coarsen, k) for k in _COARSEN_KNOBS}
    return knobs


def _apply_knobs(spec, target, knobs: dict):
    """``spec`` with the stored winner folded into its *auto* knobs:
    explicit choices win; a stored ``pack=True`` is dropped unless the
    target's data sits in the pack32 regime."""
    from repro_torch.coarsen.config import CoarsenConfig
    from repro_torch.solve.spec import _pack_probe_arrays, auto_pack

    upd: dict = {}
    v = knobs.get("pack")
    if spec.pack is None and v is not None:
        if v:
            arrays = _pack_probe_arrays(target)
            if arrays is not None and auto_pack(*arrays):
                upd["pack"] = True
        else:
            upd["pack"] = False
    if spec.segmin is None and knobs.get("segmin") is not None:
        upd["segmin"] = knobs["segmin"]
    if spec.dedupe == "auto" and knobs.get("dedupe") not in (None, "auto"):
        upd["dedupe"] = knobs["dedupe"]
    if spec.fused is None and knobs.get("fused") is not None:
        upd["fused"] = bool(knobs["fused"])
    if spec.shortcut is None and knobs.get("shortcut") is not None:
        upd["shortcut"] = knobs["shortcut"]
    co = knobs.get("coarsen")
    if co and spec.mode == "coarsen" and spec.coarsen is None:
        upd["coarsen"] = CoarsenConfig(**{k: co[k] for k in _COARSEN_KNOBS if k in co})
    if not upd:
        return spec
    # replace() re-runs __post_init__: a stored combination illegal for
    # this mode raises here and the caller falls back to heuristics.
    return dataclasses.replace(spec, **upd)


def _count(name: str) -> None:
    from repro_torch import obs

    if obs.metrics_active():
        obs.counter(name).inc()


def resolve_overrides(spec, target, backend: str, mesh=None):
    """The hook ``SolveSpec.resolve`` calls for ``tuning != "off"``.

    Returns the *effective* spec (auto knobs filled from the database
    winner) or ``None`` to keep the heuristic resolution. Never raises:
    every failure (no database, stale schema, no compatible bucket,
    corrupt knobs, the plain segment-min on a CUDA key) warns at most once
    and falls back.
    """
    try:
        key = key_for(spec.mode, target, backend=backend, mesh=mesh)
    except Exception:
        return None  # shapeless target (e.g. resolve(None)): nothing to key on
    entry = None
    exact = False
    db = get_tuning_db()
    if db is not None:
        found = db.lookup(key)
        if found is not None:
            entry, exact = found
    if spec.tuning == "measure" and not exact and target is not None:
        entry = _measure_into_active_db(spec, target, mesh, key, db)
    if entry is None:
        _count("tune.db.miss")
        return None
    try:
        if key.backend == "cuda" and entry.knobs.get("segmin") == PLAIN_SEGMIN:
            raise ValueError(
                f"segmin={PLAIN_SEGMIN!r} is the plain version, never tuned in on the card"
            )
        eff = _apply_knobs(spec, target, entry.knobs)
    except Exception as e:
        _count("tune.db.fallback")
        _warn_once(
            f"knobs:{key}",
            f"tuning DB entry for {key} is incompatible with the current "
            f"SolveSpec ({e}) — falling back to heuristics",
        )
        return None
    _count("tune.db.hit" if exact else "tune.db.near_hit")
    return eff if eff is not spec else None


def _measure_into_active_db(spec, target, mesh, key: TuneKey,
                            db: Optional[TuningDB]) -> Optional[TuningEntry]:
    """``tuning="measure"``: tune the target now and keep the winner in
    the active in-process database, so later resolves hit exactly."""
    global _active, _active_explicit
    if spec.mode not in ("flat", "coarsen", "dist"):
        return None
    try:
        target_db = db if db is not None else TuningDB()
        tune(target, spec.mode, mesh=mesh, db=target_db, space="smoke", iters=2, warmup=1)
        if db is None:
            with _lock:
                _active = target_db
                _active_explicit = True
        return target_db.entries.get(key)
    except Exception as e:
        _warn_once(
            f"measure:{key}",
            f'tuning="measure" failed for {key} ({e}) — falling back to heuristics',
        )
        return None


# ---------------------------------------------------------------------------
# candidate enumeration
# ---------------------------------------------------------------------------

def enumerate_candidates(target, mode: str = "flat", *, backend: str | None = None,
                         space: str = "smoke") -> list:
    """Deterministic candidate ``SolveSpec`` list for ``target``.

    Candidates are built with ``tuning="off"`` (the tuner never recurses)
    and ``obs="off"``; only combinations that pass static validation and
    the target's pack32 regime are emitted. ``space="smoke"`` is the
    small sweep, ``"full"`` adds the shortcut, round and segment-min
    choices; neither offers the plain segment-min. ``backend`` is
    accepted for the reference's signature: the space does not depend on
    it.
    """
    from repro_torch.coarsen.config import CoarsenConfig
    from repro_torch.solve.spec import SolveSpec, _pack_probe_arrays, auto_pack

    if space not in ("smoke", "full"):
        raise ValueError(f"unknown candidate space {space!r}")
    arrays = _pack_probe_arrays(target)
    packable = arrays is not None and auto_pack(*arrays)
    nm = _target_nm(target)
    n = nm[0] if nm else 1
    segmins = (None,) if space == "smoke" else (None, "cuda")

    out: list = []
    if mode == "flat":
        shortcuts = ("complete", "csp") if space == "smoke" else ("complete", "csp", "os")
        for pack in ((True, False) if packable else (False,)):
            for sc in shortcuts:
                for sm in (segmins if pack else (None,)):
                    out.append(SolveSpec(mode="flat", pack=pack, segmin=sm, shortcut=sc,
                                         tuning="off"))
    elif mode == "coarsen":
        cutoff = max(8, n // 8)
        rounds = (1, 2) if space == "smoke" else (1, 2, 3)
        for fused in (True, False):
            for dd in ("device", "host"):
                for r in rounds:
                    for sm in segmins:
                        out.append(SolveSpec(
                            mode="coarsen",
                            coarsen=CoarsenConfig(cutoff=cutoff, rounds_per_level=r),
                            fused=fused, dedupe=dd, segmin=sm, tuning="off",
                        ))
    elif mode == "dist":
        for sc in ("csp", "os") if space == "smoke" else ("csp", "os", "baseline"):
            for pack in ((True, False) if packable else (False,)):
                out.append(SolveSpec(mode="dist", shortcut=sc, pack=pack, tuning="off"))
    else:
        raise ValueError(f"tuning sweeps cover modes flat/coarsen/dist, not {mode!r}")
    return out


# ---------------------------------------------------------------------------
# cost pruning
# ---------------------------------------------------------------------------

class ScoredCandidate(NamedTuple):
    spec: Any  # SolveSpec
    predicted_s: Optional[float]  # None = model out of scope, never pruned


def prune_by_cost(target, candidates, *, ratio: float = 16.0,
                  min_keep: int = 4) -> tuple[list, int]:
    """``(kept, n_pruned)``: the candidates worth measuring.

    A candidate is dropped only when its predicted time exceeds ``ratio``
    × the best prediction *and* it is outside the ``min_keep`` best ranks;
    a candidate without a prediction is always kept.
    """
    from repro_torch.solve.cost import plan_cost, predicted_time_s

    nm = _target_nm(target)
    # Round-count proxy for per-round costs: AS converges in O(log n) rounds.
    iters_hint = max(1, int(math.ceil(math.log2(max(nm[0], 2))))) if nm else 1
    scored: list[ScoredCandidate] = []
    for c in candidates:
        try:
            rs = c.resolve(target)
            t = predicted_time_s(plan_cost(c.mode, target, rs), iterations=iters_hint)
        except Exception:
            t = None
        scored.append(ScoredCandidate(c, t))
    known = [s.predicted_s for s in scored if s.predicted_s is not None]
    if not known:
        return scored, 0
    best = min(known)
    order = sorted(range(len(scored)),
                   key=lambda i: (scored[i].predicted_s is not None,
                                  scored[i].predicted_s or 0.0))
    rank = {i: r for r, i in enumerate(order)}
    kept = [s for i, s in enumerate(scored)
            if s.predicted_s is None or s.predicted_s <= best * ratio or rank[i] < min_keep]
    return kept, len(scored) - len(kept)


# ---------------------------------------------------------------------------
# measurement + the tuner
# ---------------------------------------------------------------------------

def _measure_samples(fn, *, warmup: int, iters: int, device=None) -> list[float]:
    """Wall-clock seconds per call; on a CUDA ``device`` every call ends
    with a sync of that device, so a sample covers the call's device
    work."""
    def call():
        fn()
        if device is not None and device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(warmup):
        call()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        call()
        ts.append(time.perf_counter() - t0)
    return ts


def _median_iqr(samples_s) -> tuple[float, float]:
    us = np.asarray(samples_s, dtype=np.float64) * 1e6
    if us.size > 1:
        q25, q75 = np.percentile(us, [25, 75])
    else:
        q25 = q75 = us[0]
    return float(np.median(us)), float(q75 - q25)


class CandidateResult(NamedTuple):
    spec: Any  # the candidate SolveSpec
    median_us: float
    iqr_us: float
    predicted_s: Optional[float]


class TuneResult(NamedTuple):
    key: TuneKey
    winner: Any  # SolveSpec
    ranking: tuple  # CandidateResult, fastest first
    pruned: int  # candidates the cost model dropped before measurement
    entry: Optional[TuningEntry]  # what was persisted (None when db=None)


def _eid_set(rep) -> frozenset:
    eids = np.asarray(rep.msf_eids)
    return frozenset(eids[: int(rep.n_msf_edges)].tolist())


def tune(target, mode: str = "flat", *, mesh=None, backend: str | None = None,
         db: Optional[TuningDB] = None, space: str = "smoke",
         iters: int = 3, warmup: int = 1, seed: int = 0,
         ratio: float = 16.0, min_keep: int = 4, timer=None) -> TuneResult:
    """Enumerate → cost-prune → measure → (optionally) persist.

    The measurement order is shuffled with ``seed``; the ranking sorts on
    (median, IQR, canonical knob repr), so a fixed seed and identical
    timings give an identical ranking. ``timer(spec, solve_fn) ->
    [seconds]`` replaces the clock. Every measured candidate's forest
    weight and MSF edge set are asserted identical. ``db.put`` stores the
    winner under :func:`key_for`'s key; the caller owns ``db.save``.
    """
    from repro_torch.solve.planner import plan

    key = key_for(mode, target, backend=backend, mesh=mesh)
    candidates = enumerate_candidates(target, mode, backend=backend, space=space)
    kept, n_pruned = prune_by_cost(target, candidates, ratio=ratio, min_keep=min_keep)
    if not kept:
        raise ValueError(f"no measurable candidates for {key}")
    device = getattr(getattr(target, "src", None), "device", None)

    order = list(range(len(kept)))
    np.random.default_rng(seed).shuffle(order)
    ref_weight = None
    ref_eids = None
    results: list[CandidateResult] = []
    for i in order:
        cand, predicted = kept[i]
        p = plan(target, cand, mesh=mesh)
        rep = p.solve()  # correctness probe (and first warm-up)
        if ref_weight is None:
            ref_weight, ref_eids = float(rep.weight), _eid_set(rep)
        else:
            tol = max(1.0, 1e-6 * abs(ref_weight))
            if abs(float(rep.weight) - ref_weight) > tol or _eid_set(rep) != ref_eids:
                raise AssertionError(
                    f"candidate {spec_knobs(cand)} changed the MSF "
                    f"(weight {rep.weight} vs {ref_weight}) — refusing "
                    f"to tune over non-parity configurations"
                )
        if timer is not None:
            samples = timer(cand, p.solve)
        else:
            samples = _measure_samples(p.solve, warmup=max(warmup - 1, 0), iters=iters,
                                       device=device)
        med, iqr = _median_iqr(samples)
        results.append(CandidateResult(cand, med, iqr, predicted))

    results.sort(key=lambda r: (
        r.median_us, r.iqr_us, json.dumps(spec_knobs(r.spec), sort_keys=True, default=str),
    ))
    winner = results[0]
    entry = None
    if db is not None:
        stats = {
            "median_us": winner.median_us,
            "iqr_us": winner.iqr_us,
            "predicted_s": winner.predicted_s,
            "iters": int(iters),
            "warmup": int(warmup),
            "candidates": len(candidates),
            "measured": len(results),
            "pruned": int(n_pruned),
            "space": space,
        }
        db.put(key, spec_knobs(winner.spec), stats)
        entry = db.entries[key]
    return TuneResult(key, winner.spec, tuple(results), n_pruned, entry)
