"""The dry-run cells against the reference's (``repro.launch.cells``) on
the same 2×4 mesh, and the dry-run CLI.

The port's cells run rank 0's program on meta tensors over a fake world
of 8 ranks; the reference's cells are built with ``eval_shape`` only (no
lowering) on 8 forced host devices. Each side runs in a subprocess: a
process holds one default process group, and JAX fixes its device count
at first use. ``meta`` must be equal exactly. The argument bytes per
device must equal the sum of ``NamedSharding(mesh, spec).shard_shape``
over the reference's abstract arguments, but for the port's deliberate
layout differences (ROADMAP Queue 3), asserted here to the byte: the LM
steps take the global tokens on every rank, and the decode cache is
split by batch and KV heads where the reference splits its sequence.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from _torch_util import join_ranks, start_ranks
from repro_torch.configs import registry

ROOT = Path(__file__).resolve().parent.parent
CELLS = [("qwen2-7b", "train_4k"), ("mixtral-8x7b", "long_500k"),
         ("gatedgcn", "full_graph_sm"), ("xdeepfm", "train_batch")]
MSF = "msf:n14"  # n = 2^14, m = 4n, as tests/test_system.py's dry-run smoke
#: the reference dry run's record keys (``repro/launch/dryrun.py``), less
#: the ``xla_*`` cross-checks the port has no counterpart of
#: smoke-config cells run on meta tensors over a fake mesh and for real on
#: four gloo ranks: label -> (arch, ShapeCell fields, mesh shape, variant)
GLOO_CELLS = {
    "lm_decode_1x4": ("qwen2-7b", dict(name="request", kind="decode", seq_len=48,
                                       global_batch=4), (1, 4), {}),
    "lm_train_2x2": ("qwen2-7b", dict(name="t", kind="train", seq_len=32, global_batch=4),
                     (2, 2), {}),
    "moe_fsdp_train_2x2": ("kimi-k2-1t-a32b", dict(name="t", kind="train", seq_len=32,
                                                   global_batch=4), (2, 2), {"fsdp": 1}),
    "moe_prefill_1x4": ("mixtral-8x7b", dict(name="p", kind="prefill", seq_len=64,
                                             global_batch=2), (1, 4), {}),
    "gnn_train_2x2": ("gatedgcn", dict(name="g", kind="train", n_nodes=64, n_edges=100,
                                       d_feat=16), (2, 2), {}),
    "recsys_train_2x2": ("xdeepfm", dict(name="r", kind="train", batch=8), (2, 2), {}),
    "recsys_retrieval_2x2": ("xdeepfm", dict(name="q", kind="retrieval", batch=1,
                                             n_candidates=200), (2, 2), {}),
}
RECORD_KEYS = {
    "cell", "arch", "shape", "mesh", "n_devices", "ok", "compile_s", "meta", "family",
    "flops_per_device", "bytes_per_device", "collective_bytes_per_device", "t_compute_s",
    "t_memory_s", "t_collective_s", "dominant", "bound_time_s", "dynamic_loops",
    "arg_bytes_per_device", "temp_bytes_per_device", "output_bytes_per_device",
}

_PORT = r"""
import json, sys
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import cells, fakedist

out = {}
mesh = fakedist.fake_mesh((2, 4), ("data", "model"))
for arch, shape in json.loads(sys.argv[1]):
    cell = cells.build_cell(arch, shape, mesh)
    counts = cells.run_cell(cell)
    per_arg = [cells.tree_nbytes(a) for a in cell.make_args("meta")]
    out[f"{arch}:{shape}"] = dict(meta=cell.meta, arg_bytes=counts["arg_bytes"], per_arg=per_arg,
                                  flops=counts["flops"], bytes=counts["bytes"],
                                  collective={",".join(k): v for k, v in counts["collective"].items()},
                                  temp=counts["temp_bytes"])
s = ShapeCell(name="msf", kind="msf", n_nodes=1 << 14, n_edges=(1 << 14) * 4)
c = cells.build_msf_cell(s, mesh)
out["MSF"] = dict(meta=c.meta, arg_bytes=c.counts["arg_bytes"],
                  collective={",".join(k): v for k, v in c.counts["collective"].items()})
from repro_torch.configs import registry
for label, (arch, shape, grid, variant) in json.loads(sys.argv[2]).items():
    cell = cells.make_cell(arch, registry.get_config(arch, smoke=True), ShapeCell(**shape),
                           fakedist.fake_mesh(tuple(grid), ("data", "model")), variant)
    out[label] = {",".join(k): v for k, v in cells.run_cell(cell)["collective"].items()}
mesh = fakedist.fake_mesh((16, 16), ("data", "model"))
try:
    cells.build_cell("qwen2-7b", "train_4k", mesh)
    out["qwen16"] = "built"
except ValueError as e:
    out["qwen16"] = f"ValueError: {e}"
fakedist.teardown()
print("PORT" + json.dumps(out))
"""

_REFERENCE = r"""
import json, sys
import jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.base import ShapeCell
from repro.launch.cells import build_cell, build_msf_cell
from repro.launch.mesh import make_mesh

mesh = make_mesh((2, 4), ("data", "model"))

def per_arg(cell):
    out = []
    for spec_tree, arg in zip(cell.in_shardings, cell.abstract_args):
        specs = jax.tree.leaves(spec_tree, is_leaf=lambda x: isinstance(x, P))
        leaves = jax.tree.leaves(arg)
        assert len(specs) == len(leaves)
        out.append(int(sum(np.prod(NamedSharding(mesh, s).shard_shape(x.shape)) *
                           np.dtype(x.dtype).itemsize for s, x in zip(specs, leaves))))
    return out

out = {}
for arch, shape in json.loads(sys.argv[1]):
    cell = build_cell(arch, shape, mesh)
    out[f"{arch}:{shape}"] = dict(meta=cell.meta, per_arg=per_arg(cell))
s = ShapeCell(name="msf", kind="msf", n_nodes=1 << 14, n_edges=(1 << 14) * 4)
c = build_msf_cell(s, mesh)
out["MSF"] = dict(meta=c.meta, per_arg=per_arg(c))
print("REF" + json.dumps(out, default=int))
"""


def _run(code: str, tag: str, env_extra: dict, timeout: int) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **env_extra)
    proc = subprocess.run([sys.executable, "-c", code, json.dumps(CELLS), json.dumps(GLOO_CELLS)],
                          capture_output=True, text=True, env=env, timeout=timeout, cwd=ROOT)
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith(tag)]
    assert proc.returncode == 0 and line, proc.stdout[-2000:] + proc.stderr[-4000:]
    return json.loads(line[0][len(tag):])


@pytest.fixture(scope="module")
def both():
    """The reference's subprocess and the port's, run side by side."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    ref = subprocess.Popen([sys.executable, "-c", _REFERENCE, json.dumps(CELLS)],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                           cwd=ROOT)
    try:
        port = _run(_PORT, "PORT", {"OMP_NUM_THREADS": "1"}, 240)
        stdout, stderr = ref.communicate(timeout=240)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    line = [ln for ln in stdout.splitlines() if ln.startswith("REF")]
    assert ref.returncode == 0 and line, stdout[-2000:] + stderr[-4000:]
    return port, json.loads(line[0][len("REF"):])


def _tokens_difference(arch, shape_name, dp=2) -> int:
    """Bytes the port's rank holds beyond the reference's: the LM steps
    take the global int32 tokens (and labels) on every rank; the
    reference splits them over the data axes where they divide."""
    shape = registry.get_shape(arch, shape_name)
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return 2 * (b * s - (b // dp) * s) * 4 if b % dp == 0 else 0
    if shape.kind == "decode":
        return (b - b // dp) * 4 if b % dp == 0 else 0
    return (b * s - (b // dp) * s) * 4 if b % dp == 0 else 0


def _cache_difference(arch, shape_name, dp=2, m=4) -> int:
    """The decode cache [L, B, T, KV, hd] bf16 (k and v): the port's rank
    holds its batch rows (when dp divides B) and its KV heads (when they
    split over ``model``); the reference's, its batch rows and a 1/model
    share of the sequence, or a 1/(dp·model) share of the sequence when dp
    does not divide B (``repro.models.transformer.cache_specs``)."""
    shape = registry.get_shape(arch, shape_name)
    if shape.kind != "decode":
        return 0
    cfg = registry.get_config(arch)
    b, t = shape.global_batch, shape.seq_len
    if cfg.sliding_window is not None:
        t = min(t, cfg.sliding_window)
    kv, whole = cfg.n_kv_heads, 2 * cfg.n_layers * b * t * cfg.n_kv_heads * cfg.hd * 2
    port = whole // (dp if b % dp == 0 else 1) // (m if kv % m == 0 else 1)
    ref = whole // (dp * m)
    return port - ref


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_meta_equals_reference(both, arch, shape):
    port, ref = both
    key = f"{arch}:{shape}"
    assert port[key]["meta"] == ref[key]["meta"]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_argument_bytes_match_reference(both, arch, shape):
    port, ref = both
    key = f"{arch}:{shape}"
    want = sum(ref[key]["per_arg"]) + _tokens_difference(arch, shape) + _cache_difference(
        arch, shape)
    assert port[key]["arg_bytes"] == want, (port[key]["per_arg"], ref[key]["per_arg"])


def test_stated_differences_are_the_only_ones(both):
    """The cells whose layouts agree with the reference's match it exactly
    (GNN and recsys), and the two LM cells differ by the tokens or the
    cache alone, each non-zero."""
    port, ref = both
    for arch, shape in CELLS[2:]:
        key = f"{arch}:{shape}"
        assert port[key]["per_arg"] == ref[key]["per_arg"]
    assert _tokens_difference("qwen2-7b", "train_4k") > 0
    assert _cache_difference("mixtral-8x7b", "long_500k") > 0
    assert _tokens_difference("mixtral-8x7b", "long_500k") == 0  # a batch of 1 is not split


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_runs_and_counts(both, arch, shape):
    port, _ = both
    got = port[f"{arch}:{shape}"]
    assert sum(got["flops"].values()) > 0 and got["bytes"] > 0 and got["temp"] > 0
    assert got["collective"], "a 2x4 cell with no collective"


def test_msf_cell_meta_and_arguments_equal_reference(both):
    port, ref = both
    assert port["MSF"]["meta"] == ref["MSF"]["meta"]
    assert port["MSF"]["arg_bytes"] == sum(ref["MSF"]["per_arg"])
    assert set(port["MSF"]["collective"]) == {"data", "model"}


def test_qwen2_7b_at_16_way_model_fails_by_name(both):
    port, _ = both
    assert port["qwen16"] == "ValueError: n_heads = 28 does not split over model = 16 ranks"


def _cli(tmp_path, *flags):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--outdir",
                          str(tmp_path), *flags], capture_output=True, text=True, env=env,
                         timeout=240, cwd=ROOT)
    recs = {p.stem: json.loads(p.read_text()) for p in sorted(tmp_path.glob("*.json"))}
    return out, recs


def test_cli_writes_one_record_per_cell(tmp_path):
    out, recs = _cli(tmp_path, "--arch", "gat-cora", "--shape", "full_graph_sm", "--tag", "t")
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    assert sorted(recs) == ["gat-cora_full_graph_sm_multi_t", "gat-cora_full_graph_sm_single_t"]
    for r in recs.values():
        assert RECORD_KEYS <= set(r) and not any(k.startswith("xla_") for k in r)
        assert r["ok"] and r["hw"] == {"name": "NVIDIA H100 80GB HBM3", "power_limit_w": 700.0}
    assert recs["gat-cora_full_graph_sm_multi_t"]["n_devices"] == 512
    assert "[OK ] gat-cora:full_graph_sm@single+t" in out.stdout
    assert "dry-run: 2 ok, 0 failed" in out.stdout


def test_cli_msf_only(tmp_path):
    out, recs = _cli(tmp_path, "--msf-only", "--shape", "road_like")
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    assert sorted(recs) == ["msf-engine_road_like_multi", "msf-engine_road_like_single"]
    for r in recs.values():
        assert RECORD_KEYS | {"model_flops", "useful_flops_ratio", "roofline_fraction"} <= set(r)
        assert r["dynamic_loops"] == 1 and r["family"] == "msf"


def test_cli_records_a_failed_cell(tmp_path):
    out, recs = _cli(tmp_path, "--arch", "qwen2-7b", "--shape", "train_4k", "--mesh", "single")
    assert out.returncode == 1
    (rec,) = recs.values()
    assert rec["ok"] is False and rec["cell"] == "qwen2-7b:train_4k@single"
    assert rec["error"] == "ValueError: n_heads = 28 does not split over model = 16 ranks"
    assert "[FAIL] qwen2-7b:train_4k@single: ValueError" in out.stdout
    assert "dry-run: 0 ok, 1 failed" in out.stdout


_RANKS = r"""
from repro_torch.configs import registry
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import cells
from repro_torch.launch.mesh import make_mesh, shard_leaf
from repro_torch.models import recsys as R
from repro_torch.optim.adamw import adamw_init
from repro_torch.train import steps as S

meshes = {g: make_mesh(g, ("data", "model"), device="cpu") for g in ((1, 4), (2, 2))}
for label, (arch, shape, grid, variant) in INPUTS["cells"].items():
    mesh = meshes[tuple(grid)]
    cell = cells.make_cell(arch, registry.get_config(arch, smoke=True), ShapeCell(**shape),
                           mesh, variant)
    args = cell.make_args("cpu")
    with mesh.count_collectives() as counted:
        cell.fn(*args)
    OUT[label] = {",".join(k): v for k, v in counted.items()}

# the sharded recsys steps against one device's on the same weights and batch
mesh = meshes[(2, 2)]
cfg = registry.get_config("xdeepfm", smoke=True)
gen = torch.Generator().manual_seed(2)
ids = torch.randint(0, cfg.total_vocab, (8, cfg.n_sparse), generator=gen)
labels = (torch.rand(8, generator=gen) > 0.5).float()
rows = slice(4 * mesh.axis_index("data"), 4 * mesh.axis_index("data") + 4)

def copies(tree, m=None):
    specs = S.recsys_specs(tree, mesh)
    return {k: (shard_leaf(v.detach(), specs[k], m) if m else v.detach()).clone()
            .requires_grad_(True) for k, v in tree.items()}

full = R.init_xdeepfm(cfg, torch.Generator().manual_seed(0), "cpu").params
one, blk = copies(full), copies(full, mesh)
p1, _, m1 = S.recsys_train_step(one, adamw_init(one), ids, labels, cfg)
p2, _, m2 = S.recsys_train_step(blk, adamw_init(blk), ids[rows], labels[rows], cfg, mesh=mesh)
specs = S.recsys_specs(full, mesh)
OUT["recsys_train"] = dict(
    loss=(float(m1["loss"]), float(m2["loss"])), gnorm=(float(m1["gnorm"]), float(m2["gnorm"])),
    param_err=max(float((p2[k] - shard_leaf(p1[k].detach(), specs[k], mesh)).abs().max())
                  for k in p1))
blk = copies(full, mesh)
OUT["recsys_serve"] = (S.recsys_serve_step(full, ids, cfg)[rows].numpy(),
                       S.recsys_serve_step(blk, ids[rows], cfg, mesh=mesh).numpy())
full = R.init_retrieval(cfg, 200, torch.Generator().manual_seed(1), "cpu").params
one_s, one_i = S.recsys_retrieval_step(full, ids[:1], cfg, k=20)
got_s, got_i = S.recsys_retrieval_step(copies(full, mesh), ids[:1], cfg, k=20, mesh=mesh)
OUT["recsys_retrieval"] = (one_s.numpy(), one_i.numpy(), got_s.numpy(), got_i.numpy())
"""


@pytest.fixture(scope="module")
def gloo_ranks(tmp_path_factory):
    handle = start_ranks(_RANKS, 4, {"cells": GLOO_CELLS}, tmp_path_factory.mktemp("dryrun"))
    return join_ranks(handle, timeout=240)


@pytest.mark.parametrize("label", list(GLOO_CELLS))
def test_cell_collectives_equal_gloo_ranks(both, gloo_ranks, label):
    """A cell's collective bytes on meta tensors over a fake mesh equal
    what rank 0 (and every rank) counts running the same cell on real
    tensors over four gloo ranks."""
    port, _ = both
    assert port[label], f"{label}: no collective counted"
    for r in gloo_ranks:
        assert r[label] == port[label]


def test_sharded_recsys_train_step_equals_one_device(gloo_ranks):
    # float32; the sharded sums run in another order: rel 1e-5 on the
    # loss and norm, 1e-6 on the updated weights (|w| <~ 1, lr 3e-4 ramp)
    for r in gloo_ranks:
        got = r["recsys_train"]
        np.testing.assert_allclose(got["loss"][1], got["loss"][0], rtol=1e-5)
        np.testing.assert_allclose(got["gnorm"][1], got["gnorm"][0], rtol=1e-5)
        assert got["param_err"] <= 1e-6


def test_sharded_recsys_serve_and_retrieval_equal_one_device(gloo_ranks):
    for r in gloo_ranks:
        want, got = r["recsys_serve"]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
        one_s, one_i, got_s, got_i = r["recsys_retrieval"]
        np.testing.assert_allclose(got_s, one_s, rtol=1e-5, atol=1e-7)
        np.testing.assert_array_equal(got_i, one_i)
