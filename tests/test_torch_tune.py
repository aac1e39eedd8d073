"""``repro_torch.solve.tune`` against ``repro.solve.tune`` on the CPU: the
same keys on the property-suite graph classes, tuning-db/v1 documents
crossing between the packages, the same lookups, the same candidate
lists (the full space differing only by the plain segment-min's
absence), the same ranking under one injected timer, pruning safety,
the resolve fallbacks, the plain segment-min refused on a CUDA key,
and ``python -m repro_torch.launch.tune`` (build, verify, check) with
its smoke database passing the reference's checker too."""
import json
import os
import subprocess
import sys
import warnings
import zlib
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_util import cpu_graph  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro import solve as jsolve  # noqa: E402
from repro.graphs.generators import components_graph, grid_road_graph, rmat_graph  # noqa: E402
from repro.solve import tune as jtune  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch import solve as tsolve  # noqa: E402
from repro_torch.launch import tune as tcli  # noqa: E402
from repro_torch.solve import tune as ttune  # noqa: E402
from test_msf_properties import _FIXED_CASES, _fixed_graph  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
_CLASSES = [(c[0], lambda c=c: _fixed_graph(*c)) for c in _FIXED_CASES] + [
    ("rmat", lambda: rmat_graph(7, 4, seed=9)),
    ("grid", lambda: grid_road_graph(10, 10, seed=2)),
    ("components", lambda: components_graph(4, 16, seed=5)),
]


@pytest.fixture(autouse=True)
def _no_active_db():
    """Both packages' active database is process-global: none before and
    after every test, and both obs registries off and empty."""
    for m in (jtune, ttune):
        m.set_tuning_db(None)
    yield
    for m in (jtune, ttune):
        m.set_tuning_db(None)
    for o in (jobs, tobs):
        o.disable()
        o.reset()
        o.metrics_reset()


def _eids(rep):
    return set(np.asarray(rep.msf_eids)[: int(rep.n_msf_edges)].tolist())


def _knobs_json(spec, module) -> str:
    return json.dumps(module.spec_knobs(spec), sort_keys=True, default=str)


def _key(shape="n8d2", mode="flat", **over):
    base = dict(shape_class=shape, weights="int", mode=mode, backend="cpu",
                device_count=1, mesh="")
    base.update(over)
    return base


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,m", [(256, 1024), (1, 0), (300, 1200), (2**12, 2**15),
                                 (1000, 999), (7, 100)])
def test_shape_class_matches_reference(n, m):
    assert ttune.shape_class(n, m) == jtune.shape_class(n, m)
    s = ttune.shape_class(n, m)
    assert ttune.parse_shape_class(s) == jtune.parse_shape_class(s)
    assert ttune.parse_shape_class("bogus") is None


@pytest.mark.parametrize("name,make", _CLASSES, ids=[c[0] for c in _CLASSES])
def test_key_for_matches_reference(name, make):
    g = make()
    tg = cpu_graph(g)
    assert ttune.weights_class(tg) == jtune.weights_class(g)
    for mode in ("flat", "coarsen"):
        want, got = jtune.key_for(mode, g), ttune.key_for(mode, tg)
        assert got == tuple(want) and got.backend == want.backend == "cpu"
    assert ttune.key_for("stream", 64, backend="cpu") == tuple(
        jtune.key_for("stream", 64, backend="cpu"))
    with pytest.raises(ValueError):
        ttune.key_for("flat", object())


# ---------------------------------------------------------------------------
# database: documents across packages, lookups, loud schema rejection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [(jtune, ttune), (ttune, jtune)],
                         ids=["reference-to-port", "port-to-reference"])
def test_db_document_crosses_packages(tmp_path, writer, reader):
    db = writer.TuningDB()
    db.put(writer.TuneKey(**_key()), {"pack": True, "shortcut": "csp"}, {"median_us": 10.0})
    db.put(writer.TuneKey(**_key("n9d3", mode="coarsen")),
           {"fused": True, "coarsen": {"cutoff": 64, "rounds_per_level": 2, "max_levels": 16}})
    path = db.save(str(tmp_path / "v1.json"))
    doc = json.load(open(path))
    assert doc["schema"] == reader.SCHEMA == "tuning-db/v1"
    assert "backend" in doc["env"]
    back = reader.TuningDB.load(path)
    assert len(back) == 2
    entry, exact = back.lookup(reader.TuneKey(**_key()))
    assert exact and entry.knobs == {"pack": True, "shortcut": "csp"}
    assert entry.stats["median_us"] == 10.0
    assert back.to_doc()["entries"] == doc["entries"]


def test_db_lookup_matches_reference():
    dbs = {m: m.TuningDB() for m in (jtune, ttune)}
    for m, db in dbs.items():
        db.put(m.TuneKey(**_key("n7d2")), {"shortcut": "csp"})
        db.put(m.TuneKey(**_key("n6d2")), {"shortcut": "complete"})
        db.put(m.TuneKey(**_key("n7d4", weights="float")), {"pack": False})
    probes = [_key("n7d2"), _key("n8d3"), _key("n6d1"), _key("n9d2"), _key("n5d3"),
              _key(f"n{8 + ttune.MAX_BUCKET_DISTANCE + 7}d2"), _key("n7d2", weights="float"),
              _key("n7d3", weights="float"), _key("n7d2", mode="coarsen"),
              _key("n7d2", device_count=8), _key("n7d2", backend="cuda"), _key("bogus")]
    for probe in probes:
        got = dbs[ttune].lookup(ttune.TuneKey(**probe))
        want = dbs[jtune].lookup(jtune.TuneKey(**probe))
        if want is None:
            assert got is None, probe
        else:
            assert (got[0].knobs, got[1], tuple(got[0].key)) == \
                (want[0].knobs, want[1], tuple(want[0].key)), probe
    # the reference's own cases
    db = dbs[ttune]
    assert db.lookup(ttune.TuneKey(**_key("n7d2")))[1] is True
    entry, exact = db.lookup(ttune.TuneKey(**_key("n8d3")))
    assert not exact and entry.knobs == {"shortcut": "csp"}


def test_db_stale_schema_rejected_loudly(tmp_path):
    path = tmp_path / "stale.json"
    path.write_text(json.dumps({"schema": "tuning-db/v0", "entries": []}))
    with pytest.raises(ttune.TuningDBError, match="tuning-db/v0"):
        ttune.TuningDB.load(str(path))
    with pytest.raises(ttune.TuningDBError):
        tsolve.set_tuning_db(str(path))
    with pytest.raises(ttune.TuningDBError, match="malformed"):
        ttune.TuningDB.from_doc({"schema": ttune.SCHEMA, "entries": [{"key": {}}]})


def test_resolve_falls_back_on_invalid_env_db(tmp_path, monkeypatch):
    """An unreadable REPRO_TUNING_DB warns once and resolves like
    tuning="off"."""
    path = tmp_path / "stale.json"
    path.write_text(json.dumps({"schema": "tuning-db/v0", "entries": []}))
    monkeypatch.setenv("REPRO_TUNING_DB", str(path))
    tsolve.set_tuning_db(None)
    g = cpu_graph(rmat_graph(6, 4, seed=3))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rs_db = tsolve.SolveSpec(mode="flat", tuning="db").resolve(g)
        tsolve.SolveSpec(mode="flat", tuning="db").resolve(g)
    assert len([w for w in caught if issubclass(w.category, RuntimeWarning)]) == 1
    rs_off = tsolve.SolveSpec(mode="flat", tuning="off").resolve(g)
    assert rs_db.pack == rs_off.pack and rs_db.shortcut == rs_off.shortcut


# ---------------------------------------------------------------------------
# the tuner
# ---------------------------------------------------------------------------

def _stable_timer(module):
    """Injected clock: each candidate's 'latency' is a stable hash of its
    knobs, the same in both packages and in every process."""
    def timer(spec, solve_fn):
        base = 1e-4 + (zlib.crc32(_knobs_json(spec, module).encode()) % 1000) * 1e-7
        return [base, base * 1.01, base * 0.99]
    return timer


@pytest.mark.parametrize("mode", ["flat", "coarsen"])
def test_tune_ranking_matches_reference(mode):
    g = rmat_graph(6, 4, seed=1)
    kw = dict(space="smoke", seed=7, ratio=float("inf"), iters=1)
    want = jtune.tune(g, mode, timer=_stable_timer(jtune), **kw)
    got = ttune.tune(cpu_graph(g), mode, timer=_stable_timer(ttune), **kw)
    assert [_knobs_json(r.spec, ttune) for r in got.ranking] == \
        [_knobs_json(r.spec, jtune) for r in want.ranking]
    assert [r.median_us for r in got.ranking] == [r.median_us for r in want.ranking]
    assert tuple(got.key) == tuple(want.key) and got.pruned == want.pruned == 0
    again = ttune.tune(cpu_graph(g), mode, timer=_stable_timer(ttune), **kw)
    assert [_knobs_json(r.spec, ttune) for r in again.ranking] == \
        [_knobs_json(r.spec, ttune) for r in got.ranking]


def test_tune_persists_winner_and_db_resolution_uses_it():
    g = cpu_graph(rmat_graph(6, 4, seed=2))
    db = ttune.TuningDB()
    res = ttune.tune(g, "flat", db=db, space="smoke", timer=_stable_timer(ttune))
    assert res.entry is not None and len(db) == 1
    assert res.entry.key == ttune.key_for("flat", g)
    tsolve.set_tuning_db(db)
    rs = tsolve.SolveSpec(mode="flat", tuning="db").resolve(g)
    knobs = ttune.spec_knobs(res.winner)
    assert rs.spec.shortcut == knobs["shortcut"] and rs.pack == knobs["pack"]
    other = "complete" if knobs["shortcut"] != "complete" else "csp"
    rs_pin = tsolve.SolveSpec(mode="flat", shortcut=other, tuning="db").resolve(g)
    assert rs_pin.spec.shortcut == other


def test_tune_db_parity_flat_and_coarsen():
    """tuning="db" returns the forest of tuning="off", and the reference's."""
    g = grid_road_graph(12, 12, seed=2)
    tg = cpu_graph(g)
    db = ttune.TuningDB()
    for mode in ("flat", "coarsen"):
        ttune.tune(tg, mode, db=db, space="smoke", iters=1, warmup=1)
    tsolve.set_tuning_db(db)
    for mode in ("flat", "coarsen"):
        r_off = tsolve.plan(tg, tsolve.SolveSpec(mode=mode, tuning="off")).solve()
        r_db = tsolve.plan(tg, tsolve.SolveSpec(mode=mode, tuning="db")).solve()
        r_ref = jsolve.plan(g, jsolve.SolveSpec(mode=mode)).solve()
        assert r_db.weight == r_off.weight == float(r_ref.weight), mode
        assert _eids(r_off) == _eids(r_db) == _eids(r_ref), mode


def test_pruning_never_discards_measured_winner():
    """Measuring every candidate elects a winner the pruned sweep kept, or
    one within noise of a kept one."""
    for g in (rmat_graph(6, 4, seed=9), grid_road_graph(10, 10, seed=2),
              components_graph(4, 16, seed=5)):
        g = cpu_graph(g)
        for space in ("smoke", "full"):
            cands = ttune.enumerate_candidates(g, "flat", space=space)
            kept, _ = ttune.prune_by_cost(g, cands)
            assert all(s.predicted_s is not None and s.predicted_s > 0 for s in kept)
            kept_knobs = [_knobs_json(s.spec, ttune) for s in kept]
            full = ttune.tune(g, "flat", space=space, ratio=float("inf"),
                              min_keep=len(cands), iters=2, warmup=1)
            if _knobs_json(full.winner, ttune) not in kept_knobs:
                best_us = full.ranking[0].median_us
                kept_us = [r.median_us for r in full.ranking
                           if _knobs_json(r.spec, ttune) in kept_knobs]
                assert kept_us and min(kept_us) <= best_us * 1.10


@pytest.mark.parametrize("mode", ["flat", "coarsen"])
def test_enumerate_candidates_match_reference(mode):
    """The smoke space is the reference's; the full space is the
    reference's without the plain segment-min ("jnp") and with the
    kernel named "cuda" where the reference says "pallas"."""
    g = rmat_graph(5, 4, seed=4)
    tg = cpu_graph(g)
    port = {s: [_knobs_json(c, ttune) for c in ttune.enumerate_candidates(tg, mode, space=s)]
            for s in ("smoke", "full")}
    ref = {s: [jtune.spec_knobs(c) for c in jtune.enumerate_candidates(g, mode, space=s)]
           for s in ("smoke", "full")}
    assert port["smoke"] == [json.dumps(k, sort_keys=True, default=str) for k in ref["smoke"]]
    renamed = [json.dumps(dict(k, segmin={"pallas": "cuda"}.get(k["segmin"], k["segmin"])),
                          sort_keys=True, default=str)
               for k in ref["full"] if k["segmin"] != "jnp"]
    assert port["full"] == renamed
    assert any(k["segmin"] == "jnp" for k in ref["full"]) == (mode == "flat")
    cands = ttune.enumerate_candidates(tg, mode, space="full")
    assert cands and all(c.tuning == "off" and c.segmin in (None, "cuda") for c in cands)
    assert len(cands) > len(port["smoke"])


def test_enumerate_candidates_validation():
    g = cpu_graph(rmat_graph(5, 4, seed=4))
    with pytest.raises(ValueError, match="space"):
        ttune.enumerate_candidates(g, "flat", space="huge")
    with pytest.raises(ValueError, match="modes"):
        ttune.enumerate_candidates(g, "stream")
    assert [c.shortcut for c in ttune.enumerate_candidates(g, "dist")] == \
        [c.shortcut for c in jtune.enumerate_candidates(rmat_graph(5, 4, seed=4), "dist")]


def test_tuning_spec_validation():
    with pytest.raises(ValueError, match="tuning"):
        tsolve.SolveSpec(mode="flat", tuning="sometimes")
    g = cpu_graph(rmat_graph(5, 4, seed=4))
    for v in ("off", "db", "measure"):
        assert tsolve.SolveSpec(mode="flat", tuning=v).resolve(g).spec.tuning == v


def test_tuning_measure_tunes_on_first_resolve():
    g = cpu_graph(rmat_graph(6, 4, seed=5))
    rs = tsolve.SolveSpec(mode="flat", tuning="measure").resolve(g)
    db = tsolve.get_tuning_db()
    assert db is not None and len(db) == 1
    entry, exact = db.lookup(ttune.key_for("flat", g))
    assert exact and rs.spec.shortcut == entry.knobs["shortcut"]
    assert tsolve.plan(g, tsolve.SolveSpec(mode="flat", tuning="measure")).solve().weight == \
        tsolve.plan(g, tsolve.SolveSpec()).solve().weight


# ---------------------------------------------------------------------------
# plan-cache interaction, stored knobs
# ---------------------------------------------------------------------------

def test_plan_cache_distinguishes_tuning_modes():
    g = cpu_graph(rmat_graph(6, 4, seed=6))
    tsolve.clear_plan_cache()
    tsolve.plan(g, tsolve.SolveSpec(mode="flat", tuning="off"))
    n_after_off = tsolve.plan_cache_info()[0]
    tsolve.plan(g, tsolve.SolveSpec(mode="flat", tuning="db"))
    assert tsolve.plan_cache_info()[0] == n_after_off + 1
    tsolve.plan(g, tsolve.SolveSpec(mode="flat", tuning="off"))
    tsolve.plan(g, tsolve.SolveSpec(mode="flat", tuning="db"))
    assert tsolve.plan_cache_info()[0] == n_after_off + 1
    tsolve.clear_plan_cache()


def test_db_entry_changes_resolved_engine_config():
    g = rmat_graph(6, 4, seed=8)
    tg = cpu_graph(g)
    heur = tsolve.SolveSpec(mode="flat", tuning="off").resolve(tg)
    forced = "complete" if heur.spec.shortcut != "complete" else "csp"
    db = ttune.TuningDB()
    db.put(ttune.key_for("flat", tg), {"shortcut": forced})
    tsolve.set_tuning_db(db)
    assert tsolve.SolveSpec(mode="flat", tuning="db").resolve(tg).spec.shortcut == forced
    tsolve.clear_plan_cache()
    r_db = tsolve.plan(tg, tsolve.SolveSpec(mode="flat", tuning="db")).solve()
    r_ref = jsolve.plan(g, jsolve.SolveSpec(mode="flat", shortcut=forced)).solve()
    assert _eids(r_db) == _eids(r_ref) and r_db.iterations == r_ref.iterations
    tsolve.clear_plan_cache()


def test_plain_segmin_on_a_cuda_key_is_ignored():
    """A stored segmin="torch" on a cuda key falls back to the rules with
    one warning and the tune.db.fallback counter; on a cpu key it applies;
    pinned explicitly it always applies."""
    g = cpu_graph(rmat_graph(6, 4, seed=8))
    db = ttune.TuningDB()
    knobs = {"pack": True, "segmin": "torch", "shortcut": "csp"}
    db.put(ttune.key_for("flat", g, backend="cuda"), knobs)
    db.put(ttune.key_for("flat", g), knobs)
    tsolve.set_tuning_db(db)
    tobs.enable("metrics")
    spec = tsolve.SolveSpec(mode="flat", tuning="db")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(2):
            assert ttune.resolve_overrides(spec, g, "cuda") is None
    assert len([w for w in caught if "plain" in str(w.message)]) == 1
    assert tobs.metrics_snapshot()["counters"]["tune.db.fallback"] == 2
    eff = ttune.resolve_overrides(spec, g, "cpu")
    assert eff.segmin == "torch" and eff.shortcut == "csp"
    assert tobs.metrics_snapshot()["counters"]["tune.db.hit"] == 1
    pinned = tsolve.SolveSpec(mode="flat", segmin="torch", tuning="db")
    assert ttune.resolve_overrides(pinned, g, "cuda") is None  # the entry is refused...
    assert pinned.resolve(g).spec.segmin == "torch"  # ...and the pin stands


# ---------------------------------------------------------------------------
# the CLI: build, verify, check (and the reference's checker)
# ---------------------------------------------------------------------------

def _reference_checker():
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import check_tuning_db
    finally:
        sys.path.pop(0)
    return check_tuning_db


def test_cli_smoke_db_passes_both_checkers_and_verifies(tmp_path, capsys):
    out = str(tmp_path / "db.json")
    args = ["--smoke", "--device", "cpu", "--classes", "rmat,components", "--iters", "1"]
    assert tcli.main(args + ["--out", out]) == 0
    doc = json.load(open(out))
    assert len(doc["entries"]) == 4 and doc["env"]["backend"] == "cpu"
    assert all(e["knobs"]["segmin"] is None for e in doc["entries"])
    assert tcli.check(out) == [] and tcli.main(["--check", out]) == 0
    assert _reference_checker().check(out) == []
    assert tcli.main(args + ["--verify", out]) == 0
    assert "parity OK" in capsys.readouterr().out
    # --merge keeps the entries it does not tune again
    assert tcli.main(args + ["--classes", "grid", "--modes", "flat", "--merge", out,
                             "--out", out]) == 0
    assert len(json.load(open(out))["entries"]) == 5


def test_cli_check_rejects_bad_entries(tmp_path):
    db = ttune.TuningDB(env=dict(ttune.db_env_fingerprint(), backend="cuda", device_count=1))
    db.put(ttune.TuneKey(**_key(backend="cuda")), {"pack": True, "shortcut": "csp"})
    good = db.save(str(tmp_path / "good.json"))
    assert tcli.check(good) == []

    def variant(name, edit):
        doc = json.load(open(good))
        edit(doc)
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(doc))
        return tcli.check(str(path))

    def knob(k, v):
        return lambda d: d["entries"][0]["knobs"].__setitem__(k, v)

    problems = variant("stale", lambda d: d.__setitem__("schema", "tuning-db/v0"))
    assert problems and "tuning-db/v0" in problems[0]
    problems = variant("torch", knob("segmin", "torch"))
    assert problems and "plain version" in problems[0]
    for name in ("jnp", "pallas"):
        problems = variant(name, knob("segmin", name))
        assert problems and "SolveSpec" in problems[0]
    problems = variant("warp", knob("shortcut", "warp-drive"))
    assert problems and "SolveSpec" in problems[0]
    problems = variant("mixed", lambda d: d["env"].__setitem__("backend", "cpu"))
    assert problems and "mixed-environment" in problems[0]
    assert tcli.main(["--check", str(tmp_path / "torch.json")]) == 1
    assert tcli.main([]) == 2


def test_cli_runs_as_a_module(tmp_path):
    out = tmp_path / "db.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    base = [sys.executable, "-m", "repro_torch.launch.tune"]
    proc = subprocess.run(base + ["--smoke", "--device", "cpu", "--classes", "components",
                                  "--modes", "flat", "--iters", "1", "--out", str(out)],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    proc = subprocess.run(base + ["--check", str(out)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "OK (1 entries)" in proc.stdout, proc.stderr
