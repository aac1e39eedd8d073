"""The dry run's counters and roofline: ``Mesh.count_collectives`` on a
fake world (in a subprocess: the default process group is global to a
process), ``fakedist.OpTally`` against ``FlopCounterMode`` and hand
counts, ``analysis.roofline.roofline`` and ``link_of`` against hand
counts, and ``analysis.summarize``'s tables against the reference's."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.analysis import summarize as ref_summarize
from repro_torch.analysis import roofline as RL
from repro_torch.analysis import summarize
from repro_torch.launch import fakedist

ROOT = Path(__file__).resolve().parent.parent

_COUNTS = r"""
import json
import torch
from repro_torch.launch import fakedist
from repro_torch.launch.mesh import copy_to, gather, reduce_from

out = {}
mesh = fakedist.fake_mesh((8,), ("d",))
x = torch.zeros(1024, dtype=torch.float32, device="meta")
with mesh.count_collectives() as c:
    mesh.all_reduce(x, "sum", "d")
out["psum"] = dict(c)
with mesh.count_collectives() as c:
    mesh.all_gather(x, "d")
    mesh.gather_dim(x.reshape(32, 32), "d", 1)
out["gathers"] = dict(c)
mesh = fakedist.fake_mesh((1, 2, 4), ("pod", "data", "model"))
y = torch.zeros((4, 8), dtype=torch.bfloat16, device="meta", requires_grad=True)
with mesh.count_collectives() as c:
    mesh.reduce_scatter(y, ("data", "model"), 0)  # gloo's form: an all-reduce inside
    mesh.all_reduce(y, "max", "pod")  # one rank: moves nothing
out["scatter"] = dict(c)
with mesh.count_collectives() as c:
    z = reduce_from(copy_to(y, mesh, "model") * 2, mesh, "model")  # fwd all-reduce
    w = gather(y, mesh, "data", 1)  # fwd all-gather [4, 16]
    (z.sum() + w.sum()).backward()  # copy_to's all-reduce, gather's reduce-scatter
out["autograd"] = dict(c)
fakedist.teardown()
print("COUNTS" + json.dumps({k: {",".join(a): b for a, b in v.items()} for k, v in out.items()}))
"""


@pytest.fixture(scope="module")
def counted():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _COUNTS], capture_output=True, text=True,
                          env=env, timeout=120, cwd=ROOT)
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("COUNTS")]
    assert proc.returncode == 0 and line, proc.stdout[-2000:] + proc.stderr[-3000:]
    return json.loads(line[0][len("COUNTS"):])


def test_collective_bytes_psum(counted):
    # all-reduce of a 1024-element f32 shard = 4096 operand bytes per device,
    # as tests/test_roofline.py::test_collective_bytes_psum has the reference's
    assert counted["psum"] == {"d": 4096}
    assert RL.collective_bytes(counted["psum"]) == 4096


def test_all_gather_counts_its_result_once(counted):
    # all_gather: 8 x 4096; gather_dim is built on the all-gather and counts once
    assert counted["gathers"] == {"d": 2 * 8 * 4096}


def test_reduce_scatter_once_and_one_rank_groups_free(counted):
    assert counted["scatter"] == {"data,model": 4 * 8 * 2}


def test_differentiable_collectives_count_both_passes(counted):
    # forward: reduce_from's all-reduce of [4, 8] bf16 over model, gather's
    # all-gather of [4, 8] over data (2 ranks); backward: copy_to's
    # all-reduce over model, gather's reduce-scatter of the [4, 16] gradient
    assert counted["autograd"] == {"model": 2 * 64, "data": 2 * 64 + 128}


def test_op_tally_flops_equal_flop_counter_mode():
    a = torch.zeros((64, 32), dtype=torch.bfloat16, device="meta")
    b = torch.zeros((32, 16), dtype=torch.bfloat16, device="meta")
    c = torch.zeros((8, 16, 24), dtype=torch.float32, device="meta")
    d = torch.zeros((8, 24, 4), dtype=torch.float32, device="meta")

    def prog():
        return (a @ b).float().sum() + torch.bmm(c, d).sum()

    with fakedist.OpTally() as tally:
        prog()
    with FlopCounterMode(display=False) as fc:
        prog()
    assert tally.flops == {"bfloat16": 2 * 64 * 32 * 16, "float32": 2 * 8 * 16 * 24 * 4}
    assert sum(tally.flops.values()) == fc.get_total_flops()


def test_op_tally_bytes_and_peak_by_hand():
    x = torch.zeros((1000,), dtype=torch.float32, device="meta")  # an argument
    idx = torch.zeros((10,), dtype=torch.int64, device="meta")
    with fakedist.OpTally(keep=(x, idx)) as tally:
        y = x * 2  # reads 4000, writes 4000; allocates 4000 -> 4096
        v = y.view(10, 100)  # a view: nothing
        r = torch.index_select(x, 0, idx)  # 10 rows read and written, 80 B of ids
        y.add_(1.0)  # in place: reads and writes y, allocates nothing
        del y, v  # frees 4096
        z = torch.empty((3000,), device="meta")  # allocates 12288, moves nothing
    assert tally.bytes == 8000 + (2 * 40 + 80) + 8000
    # y (4096), then r (512); y freed; then z (12288)
    assert tally.peak == tally.live == 512 + 12288
    del r, z


def test_roofline_hand_counted_terms():
    hw = RL.H100_SXM
    counts = dict(flops={"bfloat16": 989e9, "float32": 67e9}, ew_ops=0, bytes=3.35e9,
                  collective={("model",): 400e6, ("data",): 50e6},
                  links={("model",): "nvlink", ("data",): "nic"}, dynamic_loops=0,
                  arg_bytes=10, temp_bytes=20, output_bytes=30)
    rf = RL.roofline(counts, n_devices=4, model_flops=4 * 989e9, hw=hw)
    assert rf["t_compute_s"] == pytest.approx(2e-3)
    assert rf["t_memory_s"] == pytest.approx(1e-3)
    assert rf["t_collective_s"] == pytest.approx(400e6 / 450e9 + 1e-3)
    assert rf["dominant"] == "compute" and rf["bound_time_s"] == pytest.approx(2e-3)
    assert rf["flops_per_device"] == 989e9 + 67e9
    assert (rf["arg_bytes_per_device"], rf["temp_bytes_per_device"],
            rf["output_bytes_per_device"]) == (10, 20, 30)
    assert rf["useful_flops_ratio"] == pytest.approx(989e9 / (989e9 + 67e9))
    assert rf["roofline_fraction"] == pytest.approx(0.5)
    assert not any(k.startswith("xla_") for k in rf)


@pytest.mark.parametrize("dominant,scale", [("compute", (10, 1, 1)), ("memory", (1, 10, 1)),
                                            ("collective", (1, 1, 10))])
def test_roofline_dominant_term(dominant, scale):
    f, b, c = scale
    counts = dict(flops={"bfloat16": f * 989e9}, ew_ops=0, bytes=b * 3.35e9,
                  collective={("model",): c * 450e6}, links={("model",): "nvlink"},
                  arg_bytes=0, temp_bytes=0, output_bytes=0)
    rf = RL.roofline(counts, n_devices=1)
    assert rf["dominant"] == dominant
    assert rf["bound_time_s"] == pytest.approx(10e-3)


def test_roofline_msf_ops_at_int32_rate():
    counts = dict(flops={}, ew_ops=RL.H100_SXM["peak_int32"] * 1e-3, bytes=0, collective={},
                  links={}, dynamic_loops=1, arg_bytes=0, temp_bytes=0, output_bytes=0)
    rf = RL.roofline(counts, n_devices=1)
    assert rf["t_compute_s"] == pytest.approx(1e-3) and rf["dynamic_loops"] == 1


class _Grid:
    """A stand-in mesh: ``link_of`` reads the axis names, this rank's
    coordinates and the rank grid only."""

    def __init__(self, shape, names, rank=0):
        self.axis_names = tuple(names)
        self.devices = np.arange(int(np.prod(shape))).reshape(shape)
        self.coords = tuple(int(c) for c in np.unravel_index(rank, shape))


@pytest.mark.parametrize("shape,names,axes,rank,link", [
    ((16, 16), ("data", "model"), ("model",), 0, "nic"),  # 16 row-major ranks: two nodes
    ((16, 16), ("data", "model"), ("data",), 0, "nic"),
    ((2, 4), ("data", "model"), ("data", "model"), 0, "nvlink"),  # one node of 8
    ((1, 4), ("data", "model"), ("model",), 0, "nvlink"),
    ((4, 8), ("data", "model"), ("model",), 9, "nvlink"),
    ((4, 8), ("data", "model"), ("data",), 9, "nic"),
    ((2, 16, 16), ("pod", "data", "model"), ("pod",), 0, "nic"),
])
def test_link_of_row_major_nodes(shape, names, axes, rank, link):
    assert RL.link_of(_Grid(shape, names, rank), axes) == link


def _records():
    rec = dict(cell="qwen3-32b:train_4k@single", arch="qwen3-32b", shape="train_4k",
               mesh="single", n_devices=256, ok=True, compile_s=12.3, flops_per_device=1.2e15,
               bytes_per_device=3.4e13, collective_bytes_per_device=5.6e11,
               arg_bytes_per_device=3 << 30, temp_bytes_per_device=700 << 20,
               t_compute_s=1.2, t_memory_s=10.1, t_collective_s=11.2, dominant="collective",
               model_flops=1e17, useful_flops_ratio=0.33, roofline_fraction=0.01)
    return [rec,
            dict(rec, cell="msf-engine:road_like@single", arch="msf-engine", shape="road_like",
                 model_flops=None, t_compute_s=2e-5, t_memory_s=3e-4, temp_bytes_per_device=900),
            dict(rec, cell="qwen2-7b:train_4k@multi", arch="qwen2-7b", mesh="multi", ok=False,
                 error="ValueError: n_heads = 28 does not split over model = 16 ranks"),
            dict(rec, cell="qwen3-32b:train_4k@single+v1", mesh="single")]


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("tag", ["", "v1"])
def test_summarize_tables_equal_reference(mesh, tag):
    recs = _records()
    assert summarize.dryrun_table(recs, mesh, tag) == ref_summarize.dryrun_table(recs, mesh, tag)
    assert summarize.roofline_table(recs, tag) == ref_summarize.roofline_table(recs, tag)


def test_summarize_cli_prints_three_tables(tmp_path):
    for r in _records():
        (tmp_path / (r["cell"].replace(":", "_").replace("@", "_") + ".json")).write_text(
            json.dumps(r))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis.summarize", "--dir",
                          str(tmp_path)], capture_output=True, text=True, env=env, timeout=60,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "### single-pod (16x16 = 256 H100s)" in out.stdout
    assert "### multi-pod (2x16x16 = 512 H100s)" in out.stdout
    assert "### roofline (single-pod)" in out.stdout
    assert "| qwen2-7b:train_4k | FAIL: ValueError: n_heads = 28" in out.stdout


def test_torch_internals_by_name():
    """The internals the dry run leans on, by the names ``fakedist`` imports
    them under: a torch upgrade that moves one fails here first."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry
    from torch.utils.weak import WeakIdKeyDictionary

    assert issubclass(fakedist.OpTally, TorchDispatchMode)
    assert fakedist.FakeStore is FakeStore and fakedist.flop_registry is flop_registry
    assert fakedist.WeakIdKeyDictionary is WeakIdKeyDictionary
    assert torch.ops.aten.mm in flop_registry
