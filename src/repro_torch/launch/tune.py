"""Autotune CLI of the port: build, verify and check a ``tuning-db/v1``
database (counterpart of ``tools/tune.py`` and ``tools/check_tuning_db.py``).

Build::

    python -m repro_torch.launch.tune --smoke --out tuning-db/v1.json \\
        [--classes rmat,grid,components] [--modes flat,coarsen] \\
        [--iters 3] [--warmup 1] [--seed 0] [--merge PATH] [--device cuda]

runs the candidate sweep (enumerate → cost-prune → measure) over the graph
classes for each mode and writes the winners as one document.
``--smoke`` shrinks the graphs and the candidate space; ``--merge PATH``
seeds the database from an existing file (keys tuned again are
overwritten, the others kept).

Verify (the parity gate)::

    python -m repro_torch.launch.tune --verify tuning-db/v1.json [--smoke]

solves every class with ``tuning="db"`` and with ``tuning="off"`` and
requires the same forest weight and MSF edge set.

Check (the schema gate)::

    python -m repro_torch.launch.tune --check tuning-db/v1.json

checks, as ``tools/check_tuning_db.py`` does for the reference: the
schema; the environment block (a non-empty backend, a positive device
count); every key complete, its shape class parseable, its weights class
known, its backend and device count those of the environment; every
knob tunable and, with its coarsen block, a valid ``SolveSpec`` of the
port for the entry's mode. On a ``cuda`` key it also rejects the plain
segment-min (``segmin="torch"``), which the tuner never elects on the
card.

Everything runs on the card unless ``--device cpu`` asks for the CPU.
Exit codes: 0 ok, 1 a parity, tuning or check failure, 2 a usage error.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

SMOKE_SCALE = 8
FULL_SCALE = 12
DEFAULT_CLASSES = "rmat,grid,components"
DEFAULT_MODES = "flat,coarsen"
WEIGHT_CLASSES = ("int", "float", "na")


def graph_classes(names: list[str], smoke: bool, device: str):
    """The graph classes by name: ``(label, Graph)`` on ``device``."""
    from repro_torch.graphs import components_graph, grid_road_graph, rmat_graph

    scale = SMOKE_SCALE if smoke else FULL_SCALE
    side = 32 if smoke else 128
    out = []
    for name in names:
        if name == "rmat":
            out.append((f"rmat_s{scale}",
                        rmat_graph(scale, 4 if smoke else 8, seed=9, device=device)))
        elif name == "grid":
            out.append((f"grid_{side}x{side}", grid_road_graph(side, side, seed=2, device=device)))
        elif name == "components":
            k, sz = (8, 32) if smoke else (32, 128)
            out.append((f"components_{k}x{sz}", components_graph(k, sz, seed=5, device=device)))
        else:
            raise SystemExit(f"unknown graph class {name!r} (expected from: {DEFAULT_CLASSES})")
    return out


def _csv(s: str) -> list[str]:
    return [x for x in s.split(",") if x]


def build(args) -> int:
    from repro_torch.solve.tune import TuningDB, tune

    db = TuningDB.load(args.merge) if args.merge and os.path.exists(args.merge) else TuningDB()
    space = "smoke" if args.smoke else "full"
    for gname, g in graph_classes(_csv(args.classes), args.smoke, args.device):
        for mode in _csv(args.modes):
            res = tune(g, mode, db=db, space=space, iters=args.iters, warmup=args.warmup,
                       seed=args.seed)
            best = res.ranking[0]
            print(f"{gname:>22} {mode:>8}: key={res.key.shape_class}/{res.key.weights} "
                  f"winner median={best.median_us:.1f}us iqr={best.iqr_us:.1f}us "
                  f"(measured {len(res.ranking)}, pruned {res.pruned})")
    path = db.save(args.out)
    print(f"# tuning DB: {len(db)} entries -> {path}")
    return 0


def _eids(rep) -> set:
    import numpy as np

    return set(np.asarray(rep.msf_eids)[: int(rep.n_msf_edges)].tolist())


def verify(args) -> int:
    from repro_torch.solve import SolveSpec, plan, set_tuning_db
    from repro_torch.solve.tune import TuningDB

    db = TuningDB.load(args.verify)  # loud on schema or shape problems
    set_tuning_db(db)
    failures = 0
    for gname, g in graph_classes(_csv(args.classes), args.smoke, args.device):
        for mode in _csv(args.modes):
            r_off = plan(g, SolveSpec(mode=mode, tuning="off")).solve()
            r_db = plan(g, SolveSpec(mode=mode, tuning="db")).solve()
            ok = abs(float(r_off.weight) - float(r_db.weight)) <= max(
                1.0, 1e-6 * abs(float(r_off.weight))) and _eids(r_off) == _eids(r_db)
            print(f"{gname:>22} {mode:>8}: tuning=db vs off "
                  f"{'ok' if ok else 'PARITY FAILURE'} "
                  f"(weight {r_db.weight:.1f} vs {r_off.weight:.1f})")
            failures += not ok
    if failures:
        print(f"# {failures} parity failure(s)", file=sys.stderr)
        return 1
    print(f"# tuning=db parity OK against {args.verify} ({len(db)} entries)")
    return 0


def check(path: str) -> list[str]:
    """Every validation failure of the database at ``path`` ([] = valid)."""
    import dataclasses

    from repro_torch.coarsen.config import CoarsenConfig
    from repro_torch.solve.spec import SolveSpec
    from repro_torch.solve.tune import (
        _COARSEN_KNOBS,
        PLAIN_SEGMIN,
        SCHEMA,
        TUNABLE_KNOBS,
        parse_shape_class,
    )

    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        return [f"{path}: cannot parse: {e}"]
    problems: list[str] = []
    schema = doc.get("schema") if isinstance(doc, dict) else None
    if schema != SCHEMA:
        return [f"{path}: unsupported schema {schema!r} (expected {SCHEMA!r})"]

    env = doc.get("env")
    if not isinstance(env, dict):
        problems.append(f"{path}: missing env fingerprint")
        env = {}
    backend = env.get("backend")
    if not isinstance(backend, str) or not backend:
        problems.append(f"{path}: env.backend is not a non-empty string")
    devices = env.get("device_count")
    if not isinstance(devices, int) or devices < 1:
        problems.append(f"{path}: env.device_count is not a positive int")

    entries = doc.get("entries")
    if not isinstance(entries, list):
        return problems + [f"{path}: entries is not a list"]
    allowed = set(TUNABLE_KNOBS) | {"coarsen"}
    for i, item in enumerate(entries):
        where = f"{path}: entry #{i}"
        key = item.get("key") if isinstance(item, dict) else None
        knobs = item.get("knobs") if isinstance(item, dict) else None
        if not isinstance(key, dict) or not isinstance(knobs, dict):
            problems.append(f"{where}: missing key/knobs objects")
            continue
        missing = [f for f in ("shape_class", "weights", "mode", "backend",
                               "device_count", "mesh") if f not in key]
        if missing:
            problems.append(f"{where}: key missing fields {missing}")
            continue
        if parse_shape_class(str(key["shape_class"])) is None:
            problems.append(f"{where}: unparseable shape_class {key['shape_class']!r}")
        if key["weights"] not in WEIGHT_CLASSES:
            problems.append(f"{where}: unknown weights class {key['weights']!r}")
        if isinstance(backend, str) and key["backend"] != backend:
            problems.append(f"{where}: key backend {key['backend']!r} != env backend "
                            f"{backend!r} (mixed-environment database)")
        if isinstance(devices, int) and key["device_count"] != devices:
            problems.append(f"{where}: key device_count {key['device_count']!r} != "
                            f"env device_count {devices}")
        unknown = set(knobs) - allowed
        if unknown:
            problems.append(f"{where}: unknown knob(s) {sorted(unknown)} "
                            f"(tunable: {sorted(allowed)})")
            continue
        if key["backend"] == "cuda" and knobs.get("segmin") == PLAIN_SEGMIN:
            problems.append(f"{where}: segmin={PLAIN_SEGMIN!r} on a cuda key is the plain "
                            f"version, which the tuner never elects on the card")
            continue
        co = knobs.get("coarsen")
        if co is not None and (not isinstance(co, dict) or set(co) - set(_COARSEN_KNOBS)):
            problems.append(f"{where}: bad coarsen block {co!r}")
            continue
        try:
            kw = {k: v for k, v in knobs.items() if k != "coarsen" and v is not None}
            if co:
                kw["coarsen"] = CoarsenConfig(**co)
            dataclasses.replace(SolveSpec(mode=str(key["mode"]), **kw))
        except (TypeError, ValueError) as e:
            problems.append(f"{where}: knobs do not validate against the current "
                            f"SolveSpec ({e})")
    return problems


def run_check(path: str) -> int:
    problems = check(path)
    if problems:
        for p in problems:
            print(p, file=sys.stderr)
        return 1
    with open(path) as f:
        n = len(json.load(f)["entries"])
    print(f"{path}: OK ({n} entries)")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.tune",
                                 description="build, verify or check a tuning-db/v1 database")
    what = ap.add_mutually_exclusive_group(required=True)
    what.add_argument("--out", metavar="PATH", help="build a database and write it here")
    what.add_argument("--verify", metavar="PATH", help="tuning='db' vs 'off' parity")
    what.add_argument("--check", metavar="PATH", help="schema and knob checks")
    ap.add_argument("--smoke", action="store_true",
                    help="small graphs and the small candidate space")
    ap.add_argument("--classes", default=DEFAULT_CLASSES)
    ap.add_argument("--modes", default=DEFAULT_MODES)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--merge", metavar="PATH", default=None,
                    help="seed the database from this file first")
    ap.add_argument("--device", default="cuda",
                    help="where the graphs and solves live (default: the card)")
    return ap


def main(argv: list[str] | None = None) -> int:
    try:
        args = build_parser().parse_args(argv)
    except SystemExit as e:
        return 2 if e.code else 0
    if args.check:
        return run_check(args.check)
    if args.verify:
        return verify(args)
    return build(args)


if __name__ == "__main__":
    raise SystemExit(main())
