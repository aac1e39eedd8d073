"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""
import importlib
import json
import re

import pytest

import _small
from msfbench import harness

ROOT = _small.ROOT
BENCH = _small.BENCH
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32 and 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    for word in BENCH["command"][1:]:
        assert not word.startswith("/") and ".." not in word.split("/")
        if "/" in word:  # a file of the repo lies under paths
            assert any(word.startswith(p + "/") for p in BENCH["paths"])
            assert (ROOT / word).is_file()
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_run_seconds_fit_24_cells():
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200


def test_names_units_and_text():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in BENCH["configs"]] + [c["source"] for c in BENCH["configs"]]
                 + [w["why"] for w in BENCH["workloads"]]
                 + [m["layer"] for m in BENCH["per_layer"]] + BENCH["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text, text


def test_entries_have_just_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_cells_and_configs_are_used_and_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)


def test_every_cell_reports_setup_another_metric_and_a_layer():
    assert "setup_s" in E2E
    for cell in CELLS:
        e2e = {m["name"] for m in harness.cell_metrics(BENCH, cell, "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        assert harness.cell_metrics(BENCH, cell, "per_layer"), cell


def test_moves_names_a_metric_each_listed_cell_reports():
    for m in BENCH["per_layer"]:
        assert m["moves"] in E2E and m["moves"] != "setup_s"
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            reported = {x["name"] for x in harness.cell_metrics(BENCH, cell, "end_to_end")}
            assert m["moves"] in reported, (m["name"], cell)


def test_one_layer_name_per_layer():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    for layer in layers:
        assert "\n" not in layer and 1 <= len(layer) <= 200


@pytest.mark.parametrize("cell", CELLS)
def test_every_file_a_cell_names_is_found(cell):
    w = harness.workload(BENCH, cell)
    entry = harness.config_entry(BENCH, w["config"])
    assert entry["file"].startswith("msfbench/configs/")
    cfg = harness.load_json(ROOT / entry["file"])
    assert cfg["name"] == w["config"]
    for key in entry["reduced"]:
        assert key in cfg and key in cfg["reduced"], key
    importlib.import_module(f"msfbench.gen.{cfg['generator']}")
    assert (ROOT / cfg["reference"]).is_file()
    traffic = harness.load_json(harness.traffic_path(w["traffic"]))
    loop = importlib.import_module(f"msfbench.loops.{traffic['loop']}")
    assert callable(loop.run)
    limits = harness.load_json(harness.limits_path(cell))
    assert limits and all(isinstance(v, (int, float)) for v in limits.values())
    for m in harness.cell_metrics(BENCH, cell, "per_layer"):
        assert callable(harness.metric_reader(m["name"]))


def test_no_stray_metric_or_data_files():
    """Every reader, traffic file and limits file belongs to an entry."""
    metrics = {p.name[:-3] for p in (ROOT / "msfbench/metrics").glob("*.py")}
    assert metrics == {m["name"] for m in BENCH["per_layer"]}
    traffic = {p.stem for p in (ROOT / "msfbench/traffic").glob("*.json")}
    assert traffic == {w["traffic"] for w in BENCH["workloads"]}
    limits = {p.name[:-5] for p in (ROOT / "msfbench/limits").glob("*.json")}
    assert limits == set(CELLS)
    json.dumps(BENCH)
