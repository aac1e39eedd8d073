"""End-to-end driver for the paper's system with the PyTorch port:
distributed MSF on an R-MAT graph with the Fig-2 communication schedule,
one process per rank of a ``torch.distributed`` grid, through the unified
``repro_torch.solve`` API, verified against the scipy oracle and the
single-device solve. On the cards: one NCCL rank per card; with
``--device cpu``: gloo ranks on the CPU.

  PYTHONPATH=src python examples/torch_msf_at_scale.py [--device cpu --ranks 4]
"""
import argparse
import os
import tempfile
import time
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def grid(world: int) -> tuple:
    rows = 2 if world >= 4 and world % 2 == 0 else 1
    return rows, world // rows


def rank_main(rank: int, world: int, store: str, args) -> None:
    from repro_torch.graphs import partition_edges_2d, rmat_graph
    from repro_torch.graphs.structures import nx_free_msf_weight
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.solve import SolveSpec, plan

    backend = "gloo" if args.device == "cpu" else "nccl"
    dist.init_process_group(backend, store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=timedelta(seconds=600))
    rows, cols = grid(world)
    say = print if rank == 0 else (lambda *a, **k: None)
    mesh = make_mesh((rows, cols), ("data", "model"),
                     device="cpu" if args.device == "cpu" else None)
    say(f"ranks={world} ({backend}), mesh=({rows},{cols}), rank 0 on {mesh.device}")
    g = rmat_graph(args.scale, args.edge_factor, seed=0, device="cpu")  # host copy
    say(f"graph: n={g.n} directed_edges={g.num_directed_edges}")
    part = partition_edges_2d(g, rows, cols)
    say(f"2D partition: {part.rows}x{part.cols} blocks, E_max/rank={part.src_row.shape[2]}")

    for shortcut in ("csp", "baseline"):
        p = plan(part, SolveSpec(mode="dist", shortcut=shortcut, capacity=1 << 16), mesh=mesh)
        r = p.solve()  # first solve: uploads the blocks
        mesh.barrier()
        t0 = time.perf_counter()
        r = p.solve()
        dt = time.perf_counter() - t0
        say(f"[{shortcut:8s}] weight={r.weight:.0f} iters={r.iterations} "
            f"time={dt*1e3:.0f}ms ({g.num_directed_edges/dt/1e6:.1f} Medges/s)")

    if rank == 0:
        oracle = nx_free_msf_weight(g)
        print(f"oracle={oracle:.0f} -> {'MATCH' if abs(oracle - r.weight) < 1e-3 else 'MISMATCH'}")
        assert abs(oracle - r.weight) < 1e-3
        # the single-device path for comparison
        g1 = rmat_graph(args.scale, args.edge_factor, seed=0, device=mesh.device)
        t0 = time.perf_counter()
        r1 = plan(g1, SolveSpec()).solve()
        print(f"[single  ] weight={r1.weight:.0f} iters={r1.iterations} "
              f"time={(time.perf_counter()-t0)*1e3:.0f}ms (first solve)")
        assert abs(r1.weight - r.weight) < 1e-3
    mesh.barrier()
    dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda: one NCCL rank per card; cpu: gloo ranks on the CPU")
    ap.add_argument("--ranks", type=int, default=None,
                    help="default: every card, or 4 on the CPU")
    ap.add_argument("--scale", type=int, default=16)  # ~1M directed edges
    ap.add_argument("--edge-factor", type=int, default=16)
    args = ap.parse_args()
    if args.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --device cpu to run on the CPU")
    world = args.ranks or (4 if args.device == "cpu" else torch.cuda.device_count())
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(rank_main, args=(world, os.path.join(tmp, "store"), args),
                           nprocs=world, start_method="spawn")


if __name__ == "__main__":
    main()
