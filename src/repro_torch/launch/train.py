"""End-to-end training driver with fault tolerance (counterpart of
``repro.launch.train``) for every arch. Runs on the card unless
``--device cpu`` asks for the CPU.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b --steps 60
  PYTHONPATH=src python -m repro_torch.launch.train --arch gat-cora --steps 100
  PYTHONPATH=src python -m repro_torch.launch.train --arch xdeepfm --steps 100 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x7b --steps 40 \\
      --ckpt-dir ck --ckpt-every 5 --fault-at 25 --supervise  # crash + restart

Fault tolerance: async checkpoints every ``--ckpt-every`` steps with atomic
DONE markers, in the reference's on-disk layout and array names (a
checkpoint of either package resumes in the other); ``--supervise`` wraps
the run loop in a supervisor that restarts from the latest complete
checkpoint after an injected fault. The data pipeline is step-keyed, so
the restarted run consumes exactly the batches the crashed run would have.
A step-time watchdog flags straggler steps (> mean + 4σ).

In process, ``build_training`` and ``run`` also take a mesh of several
ranks for the LM archs (every rank calls them alike): the model is
sharded over it (``models.transformer``) and its checkpoints hold the
reference's whole arrays, written by rank 0. The CLI runs one process.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

class FaultInjected(RuntimeError):
    pass


def build_training(arch: str, mesh=None, seed: int = 0, full: bool = False, device=None):
    """Returns (params, opt_state, step_fn(params, opt, step_idx) -> (params,
    opt, metrics)) for the smoke config of ``arch`` (its published
    ``CONFIG`` with ``full=True``) on ``device``. ``params`` is a dict of the
    model's parameters under the reference's names (nested for the LM).
    The LM steps run on ``mesh`` (``None``: one device), each rank on its
    blocks of the model, on the mesh's device unless ``device`` names
    another; the GNN and recsys steps use no mesh, as the reference's. With
    ``full=True`` the GNN archs whose ``CONFIG.d_in`` is 0 (set per shape
    cell) raise ``ZeroDivisionError`` in their init, as the reference's do."""
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import (
        LMBatchSource,
        MoleculeBatchSource,
        RecsysBatchSource,
        make_planted_graph_task,
    )
    from repro_torch.graphs.structures import resolve_device
    from repro_torch.models import gnn as G
    from repro_torch.models import recsys as R
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train import steps as S

    family = registry.family_of(arch)
    lm_mesh = mesh if family == "lm" else None
    dev = resolve_device(device if device is not None or lm_mesh is None else lm_mesh.device)
    cfg = registry.get_config(arch, smoke=not full)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def put(a):
        return torch.as_tensor(a, device=dev)

    if family == "lm":
        src = LMBatchSource(cfg.vocab, seq_len=64, batch=8, seed=seed)
        model = T.init_lm(cfg, gen, dev, mesh=lm_mesh)

        def step_fn(params, opt, i):
            toks, labels = src.batch_at(i)
            return S.lm_train_step(params, opt, put(toks), put(labels), cfg, lm_mesh)
    elif family == "gnn":
        if cfg.kind == "nequip":
            src = MoleculeBatchSource(n_atoms=12, n_edges=40, batch=16, seed=seed)
            model = G.init_nequip(cfg, gen, dev)
            n_graphs = 16

            def step_fn(params, opt, i):
                b = {k: put(v) for k, v in src.batch_at(i).items()}
                return S.gnn_train_step(params, opt, b, cfg, n_graphs)
        else:
            task = make_planted_graph_task(200, 800, cfg.d_in, max(cfg.n_classes, 1), seed)
            e = len(task["src"])
            n = len(task["x"])
            batch = dict(
                src=put(task["src"]), dst=put(task["dst"]),
                edge_valid=put(task["edge_valid"]),
                x=put(task["x"]),
                node_mask=torch.ones(n, dtype=torch.float32, device=dev),
            )
            if cfg.kind == "meshgraphnet":
                rngx = np.random.default_rng(seed)
                batch["e_feat"] = put(rngx.standard_normal((e, 4)).astype(np.float32))
                w = rngx.standard_normal((cfg.d_in, cfg.d_out)).astype(np.float32)
                batch["targets"] = put(task["x"] @ w)
                model = G.init_meshgraphnet(cfg, gen, dev)
            elif cfg.kind == "gatedgcn":
                batch["e_feat"] = torch.ones((e, 1), dtype=torch.float32, device=dev)
                batch["labels"] = put(task["labels"] % cfg.n_classes)
                model = G.init_gatedgcn(cfg, gen, dev)
            else:
                batch["labels"] = put(task["labels"] % cfg.n_classes)
                model = G.init_gat(cfg, gen, dev)

            def step_fn(params, opt, i):
                return S.gnn_train_step(params, opt, batch, cfg, 1)
    elif family == "recsys":
        offs, sizes = R.field_offsets(cfg)
        src = RecsysBatchSource(offs, sizes, batch=256, seed=seed)
        model = R.init_xdeepfm(cfg, gen, dev)

        def step_fn(params, opt, i):
            ids, labels = src.batch_at(i)
            return S.recsys_train_step(params, opt, put(ids), put(labels), cfg)
    else:
        raise ValueError(family)

    return model.params, adamw_init(model.params), step_fn


def _load_state(params, opt, state):
    """Copy a restored ``{"p": ..., "o": AdamWState}`` tree of numpy arrays
    into ``params`` and ``opt`` in place; returns the optimizer state with
    the restored step."""
    from repro_torch.optim.adamw import AdamWState, tree_leaves

    pairs = [(params, state["p"]), (opt.mu, state["o"].mu), (opt.nu, state["o"].nu)]
    with torch.no_grad():
        for ours, theirs in pairs:
            for t, a in zip(tree_leaves(ours), tree_leaves(theirs), strict=True):
                t.copy_(torch.as_tensor(a))
    step = torch.as_tensor(state["o"].step, dtype=torch.int32).to(opt.step.device)
    return AdamWState(mu=opt.mu, nu=opt.nu, step=step)


def state_specs(arch: str, mesh, full: bool = False):
    """The :class:`P` tree of a run's ``{"p": params, "o": AdamWState}`` on
    ``mesh`` (``None`` off a mesh and for the archs that use none)."""
    from repro_torch.configs import registry
    from repro_torch.launch.mesh import P
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamWState

    if mesh is None or registry.family_of(arch) != "lm":
        return None
    p = T.lm_param_specs(registry.get_config(arch, smoke=not full), mesh)
    return {"p": p, "o": AdamWState(mu=p, nu=p, step=P())}


def run(args, mesh=None) -> dict:
    """One training run. ``args.fault_at`` raises ``FaultInjected`` at that
    step once per ``args`` object (it records ``args.faulted``), so a
    supervisor that calls ``run(args)`` again resumes past it. With a
    mesh every rank calls it; rank 0 prints and writes the checkpoints."""
    from repro_torch.checkpoint import (
        latest_step, restore_checkpoint, save_checkpoint, wait_for_saves,
    )

    params, opt, step_fn = build_training(args.arch, mesh, seed=args.seed,
                                          device=getattr(args, "device", None))
    specs = state_specs(args.arch, mesh)
    say = print if mesh is None or mesh.rank == 0 else (lambda *a, **k: None)

    start = 0
    if args.ckpt_dir:
        if mesh is not None:  # every rank sees rank 0's last save complete
            wait_for_saves()
            mesh.barrier()
        last = latest_step(args.ckpt_dir)
        if last is not None:
            state = restore_checkpoint(args.ckpt_dir, last, {"p": params, "o": opt},
                                       mesh=mesh, specs=specs)
            opt = _load_state(params, opt, state)
            start = last
            say(f"[restore] resumed from checkpoint step {last}")

    losses = []
    times = []
    for i in range(start, args.steps):
        t0 = time.time()
        if args.fault_at is not None and i == args.fault_at and not getattr(args, "faulted", False):
            args.faulted = True
            raise FaultInjected(f"injected node failure at step {i}")
        params, opt, metrics = step_fn(params, opt, i)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        times.append(dt)
        losses.append(loss)
        # straggler watchdog: flag steps > mean + 4*std of the trailing window
        if len(times) > 10:
            w = np.array(times[-50:-1])
            if dt > w.mean() + 4 * w.std() + 1e-3:
                say(f"[watchdog] step {i} took {dt:.3f}s (window mean {w.mean():.3f}s) — straggler flagged")
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, i + 1, {"p": params, "o": opt}, mesh=mesh,
                            specs=specs)
        if i % max(1, args.steps // 10) == 0:
            say(f"step {i:5d} loss {loss:.4f} ({dt*1e3:.0f} ms)")
    wait_for_saves()
    first = float(np.mean(losses[:5])) if len(losses) >= 5 else losses[0]
    last_l = float(np.mean(losses[-5:]))
    say(f"[done] loss {first:.4f} -> {last_l:.4f} over {len(losses)} executed steps")
    return dict(first_loss=first, last_loss=last_l, steps=len(losses))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--fault-at", type=int, default=None)
    ap.add_argument("--supervise", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (default: the card)")
    args = ap.parse_args(argv)

    if not args.supervise:
        return run(args)

    # supervisor: restart from latest checkpoint on failure (max 3 restarts)
    for attempt in range(4):
        try:
            return run(args)
        except FaultInjected as e:
            print(f"[supervisor] attempt {attempt}: {e}; restarting from latest checkpoint")
    raise RuntimeError("too many restarts")


if __name__ == "__main__":
    main()
