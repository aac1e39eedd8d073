"""The port's import layering: ``solve/`` → ``stream/`` → ``coarsen/`` →
``core/`` → ``kernels/``, with ``graphs/`` and ``obs/`` below them all.

An AST walk over every module of the lower packages, function-level
imports included, holds each to the packages below it: none reaches up
into ``solve/``, and ``kernels/`` takes nothing of ``core/`` but
``core.semiring``'s types and constants. One fresh interpreter then
imports each of those modules first in turn, then ``repro_torch.solve``:
the orders that would expose an import cycle.
"""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

#: What each lower package may import of the port besides itself.
ALLOWED = {
    "obs": set(),
    "graphs": set(),
    "kernels": {"obs", "core.semiring"},
    "core": {"kernels", "graphs", "obs"},
    "coarsen": {"core", "kernels", "graphs", "obs"},
    "stream": {"coarsen", "core", "kernels", "graphs", "obs", "checkpoint"},
}


def _modules(pkg):
    """(dotted module name, its package's dotted name, path) of every
    module of ``repro_torch.<pkg>``."""
    out = []
    for path in sorted((SRC / "repro_torch" / pkg).rglob("*.py")):
        parts = path.relative_to(SRC).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
            package = parts
        else:
            package = parts[:-1]
        out.append((".".join(parts), ".".join(package), path))
    return out


def _imported(source: str, package: str) -> set:
    """Every module or package below ``repro_torch`` that ``source``, a
    module of ``package``, imports at any depth of its AST (function
    bodies included), relative imports resolved."""
    names = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                up = package.split(".")[: len(package.split(".")) - node.level + 1]
                base = ".".join(up + ([base] if base else []))
            names += [base] + [f"{base}.{a.name}" for a in node.names]
    return {n.split(".", 1)[1] for n in names if n.startswith("repro_torch.")}


def _allowed(pkg: str, name: str) -> bool:
    """``name`` lies in ``pkg``, in a package it may import, or on the way
    to one (``from repro_torch.core import semiring`` names ``core``)."""
    return any(name == ok or name.startswith(ok + ".") or ok.startswith(name + ".")
               for ok in ALLOWED[pkg] | {pkg})


def test_the_walk_sees_every_form_of_import():
    source = (
        "import repro_torch.solve\n"
        "from repro_torch import obs\n"
        "def f():\n"
        "    from repro_torch.solve.spec import SolveSpec\n"
        "    from ..solve import plan\n"
        "    from . import multilinear\n"
    )
    got = _imported(source, "repro_torch.core")
    assert {"solve", "solve.spec", "solve.spec.SolveSpec", "solve.plan", "obs",
            "core.multilinear"} <= got
    assert not _allowed("core", "solve.spec") and _allowed("core", "obs")
    assert _allowed("kernels", "core") and _allowed("kernels", "core.semiring.IMAX")
    assert not _allowed("kernels", "core.msf") and not _allowed("kernels", "coarsen")


@pytest.mark.parametrize("pkg", sorted(ALLOWED))
def test_lower_packages_import_only_below_them(pkg):
    bad = [f"{name}: repro_torch.{imp}"
           for name, package, path in _modules(pkg)
           for imp in sorted(_imported(path.read_text(), package))
           if not _allowed(pkg, imp)]
    assert not bad, "imports against the layering:\n" + "\n".join(bad)


def test_no_import_order_exposes_a_cycle():
    firsts = [name for pkg in sorted(ALLOWED) for name, _, _ in _modules(pkg)]
    assert "repro_torch.kernels.ops" in firsts and "repro_torch.kernels.ref" in firsts
    code = (
        "import importlib, sys\n"
        f"for first in {firsts!r}:\n"
        "    for m in [m for m in sys.modules if m.split('.')[0] == 'repro_torch']:\n"
        "        del sys.modules[m]\n"
        "    importlib.import_module(first)\n"
        "    importlib.import_module('repro_torch.solve')\n"
        "    print(first)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.split() == firsts
