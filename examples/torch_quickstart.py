"""Quickstart of the PyTorch port: the paper's algorithm through the
unified solver API, on the card (``--device cpu`` runs it on the CPU).

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

from repro_torch.core import connected_components
from repro_torch.graphs import rmat_graph
from repro_torch.graphs.structures import nx_free_msf_weight
from repro_torch.solve import SolveSpec, plan

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", help="where the graph lives (default: the card)")
ap.add_argument("--scale", type=int, default=12)
ap.add_argument("--edge-factor", type=int, default=8)
args = ap.parse_args()

# An R-MAT graph with integer weights 1..255 (the paper's §VII setup).
g = rmat_graph(args.scale, args.edge_factor, seed=0, device=args.device)

# A SolveSpec is a frozen description of *which* engine and *how*;
# plan() builds it against the graph (cached per spec + shapes).
result = plan(g, SolveSpec()).solve()  # algebraic Awerbuch-Shiloach
oracle = nx_free_msf_weight(g)
print(f"graph: n={g.n}, undirected edges={g.num_directed_edges // 2}, on {g.device}")
print(f"MSF weight      : {result.weight:.0f}")
print(f"scipy oracle    : {oracle:.0f}")
print(f"AS iterations   : {result.iterations}")
print(f"MSF edges       : {result.n_msf_edges}")
assert abs(result.weight - oracle) < 1e-3

cc = connected_components(g)
print(f"components      : {int(cc.n_components)} (CC baseline, §II-D)")

# the three shortcut strategies from §IV-B produce identical forests
for strategy in ("complete", "csp", "os"):
    r = plan(g, SolveSpec(shortcut=strategy)).solve()
    assert abs(r.weight - result.weight) < 1e-3
print("shortcut strategies agree: complete == csp == os")

# the coarsening engine (Borůvka contract-and-filter levels) is one spec
# field away — same forest, geometrically smaller levels
r = plan(g, SolveSpec(mode="coarsen", fused=True)).solve()
assert abs(r.weight - result.weight) < 1e-3
print(f"coarsen levels  : {len(r.levels)} "
      f"({'|'.join(str(lv.n) + '>' + str(lv.n_next) for lv in r.levels)})")
