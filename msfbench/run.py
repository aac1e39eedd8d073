"""Run one cell of the benchmark of the PyTorch/CUDA port on this machine.

    python3 msfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints one JSON line last on standard
output, and the numbers that decide ``correct`` beside their limits as
the last lines on standard error. Exits with 1 and prints no result when
the machine lacks the cards the cell asks for, or when JAX or the JAX
package is loaded once the window has closed.
"""
import time

T_PROCESS = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level modules that may not be loaded in a run: JAX, and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
#: caches a library may keep, at fixed paths inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": "build/msfbench/torch_extensions",
          "TRITON_CACHE_DIR": "build/msfbench/triton"}


def forbidden_modules(names=None) -> list:
    """Top-level names (before the first dot, compared whole) among the
    loaded modules, or among ``names``, that are forbidden."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split(".", 1)[0] for name in names} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for key, rel in CACHES.items():
        os.environ[key] = str(ROOT / rel)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from msfbench import harness

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    chips = int(harness.workload(bench, args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"msfbench: {args.workload} needs {chips} CUDA card(s), found {found}",
              file=sys.stderr)
        return 1
    result, lines = harness.run_cell(args.workload, seed=args.seed, seconds=args.seconds,
                                     trace=bool(args.trace), device="cuda",
                                     t_process=T_PROCESS, bench=bench)
    bad = forbidden_modules()
    if bad:
        print(f"msfbench: forbidden modules loaded in the run: {bad}", file=sys.stderr)
        return 1
    sys.stderr.write("\n".join(lines) + "\n")
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
