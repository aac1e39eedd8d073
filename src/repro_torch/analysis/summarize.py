"""Summarize the dry run's records (``experiments/dryrun_torch/*.json``) into
markdown tables (counterpart of ``repro.analysis.summarize``, the same
tables over the port's records).

  PYTHONPATH=src python -m repro_torch.analysis.summarize [--dir experiments/dryrun_torch]
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def fmt_bytes(b):
    if b >= 2**30:
        return f"{b/2**30:.1f}G"
    if b >= 2**20:
        return f"{b/2**20:.1f}M"
    return f"{b/2**10:.0f}K"


def fmt_s(s):
    if s >= 1:
        return f"{s:.2f}s"
    if s >= 1e-3:
        return f"{s*1e3:.2f}ms"
    return f"{s*1e6:.1f}us"


def load(dir_):
    recs = []
    for p in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(p) as f:
            recs.append(json.load(f))
    return recs


def _tag_of(cell_id: str) -> str:
    return cell_id.split("+", 1)[1] if "+" in cell_id else ""


def dryrun_table(recs, mesh, tag=""):
    rows = [
        "| cell | ok | compile | FLOPs/dev | bytes/dev | coll/dev | args/dev | temp/dev |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r.get("mesh") != mesh or _tag_of(r.get("cell", "")) != tag:
            continue
        if not r.get("ok"):
            rows.append(f"| {r['arch']}:{r['shape']} | FAIL: {r.get('error','')[:60]} | | | | | | |")
            continue
        rows.append(
            f"| {r['arch']}:{r['shape']} | ok | {r['compile_s']}s "
            f"| {r['flops_per_device']:.2e} | {r['bytes_per_device']:.2e} "
            f"| {r['collective_bytes_per_device']:.2e} "
            f"| {fmt_bytes(r['arg_bytes_per_device'])} | {fmt_bytes(r['temp_bytes_per_device'])} |"
        )
    return "\n".join(rows)


def roofline_table(recs, tag=""):
    rows = [
        "| cell | t_compute | t_memory | t_collective | dominant | MODEL_FLOPS | useful/HLO | roofline-frac |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r.get("mesh") != "single" or not r.get("ok") or _tag_of(r.get("cell", "")) != tag:
            continue
        mf = r.get("model_flops")
        rows.append(
            f"| {r['arch']}:{r['shape']} | {fmt_s(r['t_compute_s'])} | {fmt_s(r['t_memory_s'])} "
            f"| {fmt_s(r['t_collective_s'])} | **{r['dominant']}** "
            f"| {mf:.2e} | {r.get('useful_flops_ratio', 0):.3f} "
            f"| {r.get('roofline_fraction', 0):.4f} |"
            if mf else
            f"| {r['arch']}:{r['shape']} | {fmt_s(r['t_compute_s'])} | {fmt_s(r['t_memory_s'])} "
            f"| {fmt_s(r['t_collective_s'])} | **{r['dominant']}** | - | - | - |"
        )
    return "\n".join(rows)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    recs = load(args.dir)
    sel = [r for r in recs if _tag_of(r.get("cell", "")) == args.tag]
    n_ok = sum(1 for r in sel if r.get("ok"))
    print(f"## tag={args.tag or '(baseline)'}: {len(sel)} records, {n_ok} ok\n")
    print("### single-pod (16x16 = 256 H100s)\n")
    print(dryrun_table(recs, "single", args.tag))
    print("\n### multi-pod (2x16x16 = 512 H100s)\n")
    print(dryrun_table(recs, "multi", args.tag))
    print("\n### roofline (single-pod)\n")
    print(roofline_table(recs, args.tag))


if __name__ == "__main__":
    main()
