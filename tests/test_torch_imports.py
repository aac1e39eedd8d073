"""Import hygiene of the port: ``src/repro_torch`` and ``chip_smoke.py``
import neither JAX nor the JAX package ``repro``, statically (AST) and
at run time (a fresh interpreter)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "repro"}
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize(
    "path", PORT_FILES + [ROOT / "chip_smoke.py"],
    ids=[str(p.relative_to(ROOT)) for p in PORT_FILES] + ["chip_smoke.py"],
)
def test_no_jax_or_reference_imports(path):
    bad = _imported_roots(path) & FORBIDDEN
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


_PROBE = """
import importlib, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
import chip_smoke
from repro_torch.solve import SolveSpec, plan
from repro_torch.graphs import random_graph
plan(random_graph(20, 40, device="cpu"), SolveSpec()).solve()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(list(pkgutil.walk_packages(repro_torch.__path__))))
sys.exit("loaded: " + ", ".join(bad) if bad else 0)
"""


def test_runtime_imports_stay_clean():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 5  # the subpackages were all walked


#: torch internals the dry run leans on: imported by ``launch/fakedist.py``
#: alone, so a torch upgrade that moves one breaks that file by name
INTERNAL = ("torch.testing._internal", "torch.utils._python_dispatch", "torch.utils._pytree",
            "torch.utils.weak", "torch._subclasses")


@pytest.mark.parametrize(
    "path", PORT_FILES + [ROOT / "chip_smoke.py"],
    ids=[str(p.relative_to(ROOT)) for p in PORT_FILES] + ["chip_smoke.py"],
)
def test_torch_internals_only_in_fakedist(path):
    modules = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            modules.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            modules.add(node.module)
    internal = {m for m in modules if m.startswith(INTERNAL)}
    if path.name == "fakedist.py":
        assert "torch.testing._internal.distributed.fake_pg" in internal
    else:
        assert not internal, f"{path.relative_to(ROOT)} imports {sorted(internal)}"
