"""Nothing the benchmark runs loads JAX, the JAX package or its
benchmarks: top-level module names compared whole (``repro_torch``
begins with ``repro`` and is allowed)."""
import os
import subprocess
import sys

import _small

ROOT = _small.ROOT

SCRIPT = r"""
import importlib, importlib.util, json, sys
from pathlib import Path
root = Path(sys.argv[1])
sys.path[:0] = [str(root), str(root / "src")]
spec = importlib.util.spec_from_file_location("msfbench_run", root / "msfbench" / "run.py")
run = importlib.util.module_from_spec(spec)
spec.loader.exec_module(run)
from msfbench import harness, control, devtrace, readers
bench = harness.load_json(root / "BENCHMARK.json")
for w in bench["workloads"]:
    cfg = harness.load_json(root / harness.config_entry(bench, w["config"])["file"])
    importlib.import_module("msfbench.gen." + cfg["generator"])
    tr = harness.load_json(harness.traffic_path(w["traffic"]))
    loop = importlib.import_module("msfbench.loops." + tr["loop"])
for m in bench["per_layer"]:
    harness.metric_reader(m["name"])
# the port itself, as the loops' systems load it
import repro_torch.solve, repro_torch.obs, repro_torch.graphs.structures
top = sorted({name.split(".", 1)[0] for name in list(sys.modules)})
print(json.dumps(top))
"""


def test_no_jax_or_reference_package_is_loaded():
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(ROOT)], capture_output=True,
                         text=True, timeout=240, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    import json

    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not top & {"jax", "jaxlib", "flax", "repro", "benchmarks"}, top & {
        "jax", "jaxlib", "flax", "repro", "benchmarks"}
    assert "repro_torch" in top and "msfbench" in top


def test_forbidden_modules_compares_whole_names():
    import importlib.util

    spec = importlib.util.spec_from_file_location("msfbench_run_t", ROOT / "msfbench" / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    ok = ["repro_torch", "repro_torch.solve", "reproducible", "jaxtyping", "benchmarks_x"]
    assert run.forbidden_modules(ok) == []
    assert run.forbidden_modules(ok + ["repro.core", "jax.numpy", "benchmarks.common"]) == [
        "benchmarks", "jax", "repro"]


def test_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, "msfbench/run.py", "--workload", _small.CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=240, cwd=ROOT,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
