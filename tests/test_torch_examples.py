"""The PyTorch port's examples (``examples/torch_*.py``) run to their end
on the CPU (``--device cpu``) at their smallest sizes, each in a fresh
interpreter, and import neither JAX nor the JAX package."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = {
    "torch_quickstart.py": (["--scale", "10"], ["shortcut strategies agree", "coarsen levels"]),
    "torch_msf_at_scale.py": (["--scale", "11", "--edge-factor", "8", "--ranks", "4"],
                              ["ranks=4 (gloo), mesh=(2,2)", "-> MATCH", "[single  ]"]),
    "torch_train_gnn.py": (["--steps", "100"], ["final accuracy"]),
    "torch_train_lm.py": (["--steps", "30"], ["LM training reduced loss"]),
    "torch_serve_decode.py": ([], ["prefill: 4x32", "decoded 11 steps x batch 4"]),
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(name):
    flags, expect = EXAMPLES[name]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(ROOT / "examples" / name), "--device", "cpu",
                          *flags], capture_output=True, text=True, env=env, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    for text in expect:
        assert text in out.stdout, out.stdout[-3000:]


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_imports_no_jax(name):
    tree = ast.parse((ROOT / "examples" / name).read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "jaxlib", "repro"}
    assert "repro.launch" not in (ROOT / "examples" / name).read_text().replace(
        "repro_torch.launch", "")


def test_every_torch_example_is_tested():
    assert sorted(p.name for p in (ROOT / "examples").glob("torch_*.py")) == sorted(EXAMPLES)
