"""Multi-pod dry run: count rank 0's program of every (arch × shape × mesh)
cell on a fake 16×16 or 2×16×16 world of H100s (counterpart of
``repro.launch.dryrun``). Needs no card. Run:

  PYTHONPATH=src python -m repro_torch.launch.dryrun                    # everything
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single --msf
  PYTHONPATH=src python -m repro_torch.launch.dryrun --variant triangle_skip=1

Per cell: the cell must build and its program run on meta tensors over
the fake process group (``launch/cells.py``); prints FLOPs, bytes and
collective bytes per device, the dominant roofline term on H100s
(``analysis/roofline.py``), argument and peak temporary bytes; writes a
JSON record per cell under ``experiments/dryrun_torch/``
(``python -m repro_torch.analysis.summarize`` tabulates them). A cell
that fails is recorded ``ok: false`` with its error and the run goes on;
the exit code is 1 if any failed.
"""
import argparse
import json
import os
import time
import traceback


def parse_variant(s):
    out = {}
    if not s:
        return out
    for kv in s.split(","):
        k, v = kv.split("=")
        out[k] = int(v) if v.lstrip("-").isdigit() else v
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--msf", action="store_true", help="also run MSF engine cells")
    ap.add_argument("--msf-only", action="store_true")
    ap.add_argument("--variant", default="", help="k=v,... perf-variant knobs")
    ap.add_argument("--outdir", default="experiments/dryrun_torch")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    from repro_torch.analysis.roofline import H100_SXM, roofline
    from repro_torch.configs import registry
    from repro_torch.configs.base import MSF_SHAPES
    from repro_torch.launch import fakedist
    from repro_torch.launch.cells import build_cell, build_msf_cell, run_cell

    os.makedirs(args.outdir, exist_ok=True)
    meshes = {"single": ((16, 16), ("data", "model")),
              "multi": ((2, 16, 16), ("pod", "data", "model"))}
    if args.mesh != "both":
        meshes = {args.mesh: meshes[args.mesh]}

    cells = []
    if not args.msf_only:
        for arch, shape in registry.all_cells():
            if args.arch and arch != args.arch:
                continue
            if args.shape and shape != args.shape:
                continue
            cells.append(("arch", arch, shape))
    if args.msf or args.msf_only:
        for s in MSF_SHAPES:
            if args.shape and s.name != args.shape:
                continue
            cells.append(("msf", "msf-engine", s.name))

    variant = parse_variant(args.variant)
    hw = {"name": H100_SXM["name"], "power_limit_w": H100_SXM["power_limit_w"]}
    n_ok = n_fail = 0
    try:
        for mesh_name, (shape_, axes) in meshes.items():
            mesh = fakedist.fake_mesh(shape_, axes)
            n_dev = mesh.devices.size
            for kind, arch, shape in cells:
                cell_id = f"{arch}:{shape}@{mesh_name}" + (f"+{args.tag}" if args.tag else "")
                t0 = time.time()
                try:
                    if kind == "msf":
                        scfg = next(s for s in MSF_SHAPES if s.name == shape)
                        cell = build_msf_cell(scfg, mesh, **{
                            k: v for k, v in variant.items()
                            if k in ("shortcut", "capacity", "pack")})
                    else:
                        cell = build_cell(arch, shape, mesh, variant)
                    counts = run_cell(cell)
                    rf = roofline(counts, n_devices=n_dev,
                                  model_flops=cell.meta.get("model_flops"))
                    rec = dict(
                        cell=cell_id, arch=arch, shape=shape, mesh=mesh_name,
                        n_devices=n_dev, ok=True,
                        compile_s=round(time.time() - t0, 1),
                        meta={k: v for k, v in cell.meta.items() if k != "family"},
                        family=cell.meta.get("family"),
                        collective_bytes_by_axes={",".join(k): v
                                                  for k, v in counts["collective"].items()},
                        hw=hw,
                        **rf,
                    )
                    print(
                        f"[OK ] {cell_id:48s} {rec['compile_s']:6.1f}s "
                        f"flops/dev={rf['flops_per_device']:.3e} "
                        f"bytes/dev={rf['bytes_per_device']:.3e} "
                        f"coll/dev={rf['collective_bytes_per_device']:.3e} "
                        f"dom={rf['dominant']} "
                        f"args={rf['arg_bytes_per_device']/2**30:.2f}GiB "
                        f"temp={rf['temp_bytes_per_device']/2**30:.2f}GiB",
                        flush=True,
                    )
                    n_ok += 1
                except Exception as e:  # noqa: BLE001 — record and continue
                    rec = dict(
                        cell=cell_id, arch=arch, shape=shape, mesh=mesh_name,
                        n_devices=n_dev, ok=False, error=f"{type(e).__name__}: {e}",
                        compile_s=round(time.time() - t0, 1), hw=hw,
                    )
                    print(f"[FAIL] {cell_id}: {type(e).__name__}: {str(e)[:300]}", flush=True)
                    traceback.print_exc(limit=4)
                    n_fail += 1
                fname = cell_id.replace(":", "_").replace("@", "_").replace("+", "_")
                with open(os.path.join(args.outdir, fname + ".json"), "w") as f:
                    json.dump(rec, f, indent=1, default=str)
    finally:
        fakedist.teardown()
    print(f"\ndry-run: {n_ok} ok, {n_fail} failed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
