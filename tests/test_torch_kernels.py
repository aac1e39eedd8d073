"""The port's segment-min kernel module against the JAX package's.

On the CPU the port's wrapper runs its plain version; it must equal the
Pallas kernel (interpret mode) and the jnp oracle exactly, drop
out-of-range ids as they do, and never count a launch. A CUDA request
never falls back: the launcher raises on CPU tensors, and a missing
``nvcc`` raises.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_util import cpu_graph  # noqa: E402
from repro.core.semiring import pack32 as jax_pack32  # noqa: E402
from repro.graphs import random_graph  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.coarsen.config import SEGMIN_BACKENDS, CoarsenConfig  # noqa: E402
from repro_torch.coarsen.engine import _level_setup  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.solve import SolveSpec  # noqa: E402

UMAX = 0xFFFFFFFF


def _keys_segs(n_seg, e, seed, seg_lo=0, seg_hi=None):
    rng = np.random.default_rng(seed)
    seg = rng.integers(seg_lo, n_seg if seg_hi is None else seg_hi, e).astype(np.int32)
    keys = np.asarray(
        jax_pack32(jnp.array(rng.integers(1, 256, e)), jnp.array(rng.integers(0, 1 << 20, e)))
    ).astype(np.uint32)
    keys[rng.random(e) < 0.1] = UMAX  # a share of identity keys
    return keys, seg


def _port(keys, seg, n_seg):
    return ops.segment_min_flat(
        torch.from_numpy(keys.astype(np.int64)), torch.from_numpy(seg), n_seg
    ).numpy()


@pytest.mark.parametrize(
    "n_seg,e,seg_lo,seg_hi",
    [(64, 0, 0, None), (128, 500, 0, None), (300, 2000, 0, None), (37, 129, 0, None),
     (50, 700, -7, 60)],  # last: ids out of range on both sides are dropped
    ids=["64x0", "128x500", "300x2000", "37x129", "out_of_range"],
)
def test_segment_min_flat_matches_pallas_and_ref(n_seg, e, seg_lo, seg_hi):
    keys, seg = _keys_segs(n_seg, e, e + n_seg, seg_lo, seg_hi)
    ops.segment_min_flat.launches = 0
    got = _port(keys, seg, n_seg)
    assert got.dtype == np.int64 and got.shape == (n_seg,)
    pallas = np.asarray(jax_ops.segment_min_flat(jnp.array(keys), jnp.array(seg), num_segments=n_seg))
    oracle = np.asarray(jax_ref.segment_min_flat_ref(jnp.array(keys), jnp.array(seg), n_seg))
    np.testing.assert_array_equal(got, pallas.astype(np.int64))
    np.testing.assert_array_equal(got, oracle.astype(np.int64))
    assert ops.segment_min_flat.launches == 0  # the CPU path launches nothing


def test_plain_version_is_what_cpu_runs():
    """On CPU tensors the wrapper runs the plain version, so the selector
    gives the wrapper for every request but "torch", on every device."""
    keys, seg = _keys_segs(100, 1000, 3)
    k, s = torch.from_numpy(keys.astype(np.int64)), torch.from_numpy(seg)
    assert torch.equal(ops.segment_min_flat(k, s, 100), ref.segment_min_flat_ref(k, s, 100))
    for req in (None, "auto", "cuda", "sorted"):  # "sorted" degrades at a flat site
        assert ops.packed_segmin(req, "flat") is ops.segment_min_flat
    assert ops.packed_segmin("torch", "flat") is ref.segment_min_flat_ref
    with pytest.raises(ValueError):
        ops.packed_segmin("pallas", "flat")
    assert ops.packed_segmin("sorted", "dedupe") is ops.segment_min_sorted
    fn = ops.packed_segmin(None, "flat")
    assert torch.equal(fn(k, s, 100), ref.segment_min_flat_ref(k, s, 100))
    assert ops.segment_min_flat.launches == 0  # the CPU path launches nothing


# The mapping kept from when the selection keyed on the graph's device:
# per (request, site) with pack32 on, the callable a CUDA graph got and the
# one a CPU graph got. With pack32 off no site selects anything.
SEGMIN_TABLE = {
    (None, "flat"): ("segment_min_flat", "segment_min_flat_ref"),
    ("auto", "flat"): ("segment_min_flat", "segment_min_flat_ref"),
    ("torch", "flat"): ("segment_min_flat_ref", "segment_min_flat_ref"),
    ("cuda", "flat"): ("segment_min_flat", "segment_min_flat"),
    ("sorted", "flat"): ("segment_min_flat", "segment_min_flat_ref"),
    (None, "dedupe"): ("segment_min_sorted", "segment_min_sorted_ref"),
    ("auto", "dedupe"): ("segment_min_sorted", "segment_min_sorted_ref"),
    ("torch", "dedupe"): ("segment_min_sorted_ref", "segment_min_sorted_ref"),
    ("cuda", "dedupe"): ("segment_min_sorted", "segment_min_sorted"),
    ("sorted", "dedupe"): ("segment_min_sorted", "segment_min_sorted"),
}


def _site_choice(req, site, pack):
    """What the solve's flat site (``SolveSpec.resolve``) and a coarsening
    level's hook and dedupe sites (``coarsen.engine._level_setup``) select
    on a CPU graph."""
    g = cpu_graph(random_graph(16, 40, seed=1))
    be = _level_setup(g, CoarsenConfig(segmin=req, pack=pack), None)[3]
    if site == "dedupe":
        return be.dedupe_segmin
    flat = SolveSpec(mode="coarsen", segmin=req, pack=pack).resolve(g).segmin_flat
    assert flat is be.hook
    return flat


@pytest.mark.parametrize("pack", [True, False], ids=["pack", "nopack"])
@pytest.mark.parametrize("site", ["flat", "dedupe"])
@pytest.mark.parametrize("req", [None, "auto", "torch", "cuda", "sorted"])
def test_segmin_selection_table(req, site, pack):
    """Every request × site × pack32: on a CUDA graph the selector gives
    the very callable the table names; on CPU tensors its output is bit
    for bit that of the table's CPU choice, on one fixed sorted case."""
    assert req in SEGMIN_BACKENDS and len(SEGMIN_TABLE) == 2 * len(SEGMIN_BACKENDS)
    got = _site_choice(req, site, pack)
    if not pack:
        assert got is None
        return
    assert got is ops.packed_segmin(req, site)
    card, cpu = (getattr(ops, name, None) or getattr(ref, name)
                 for name in SEGMIN_TABLE[req, site])
    assert got is card
    keys, seg = _keys_segs(64, 900, 11)
    k = torch.from_numpy(keys.astype(np.int64))
    s = torch.from_numpy(np.sort(seg))
    want = cpu(k, s, 64)
    assert want.dtype == torch.int64 and torch.equal(got(k, s, 64), want)


def test_wrapper_rejects_bad_inputs():
    k = torch.zeros(8, dtype=torch.int64)
    s = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="int64"):
        ops.segment_min_flat(k.to(torch.int32), s, 4)
    with pytest.raises(ValueError, match="int32"):
        ops.segment_min_flat(k, s.to(torch.int64), 4)
    with pytest.raises(ValueError, match="1-D"):
        ops.segment_min_flat(k, s[:4], 4)
    with pytest.raises(ValueError, match="1-D"):
        ops.segment_min_flat(k.view(2, 4), s.view(2, 4), 4)
    with pytest.raises(ValueError, match="contiguous"):
        ops.segment_min_flat(torch.zeros(16, dtype=torch.int64)[::2], s, 4)
    with pytest.raises(ValueError, match="num_segments"):
        ops.segment_min_flat(k, s, -1)
    with pytest.raises(TypeError):
        ops.segment_min_flat(k.numpy(), s, 4)


def test_launcher_never_falls_back_to_cpu():
    k = torch.zeros(8, dtype=torch.int64)
    s = torch.zeros(8, dtype=torch.int32)
    out = torch.empty(4, dtype=torch.int64)
    with pytest.raises(RuntimeError, match="CUDA device"):
        ops._launch("segment_min_flat", k, s, out, 8, 4, 0, 1)  # head 0, vec_ids


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build("segment_min_flat")
    assert not (tmp_path / "build").exists()


def test_build_is_keyed_on_source_hash():
    assert build.sources() == ["min_outgoing_flat64", "multilinear_dense",
                               "segment_min_bucketed", "segment_min_flat", "segment_min_sorted"]
    lib = build.library_path("segment_min_flat")
    assert lib.parent == build.BUILD_DIR and lib.suffix == ".so"
    assert lib == build.library_path("segment_min_flat")
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


# ---------------------------------------------------------------------------
# sorted-segment kernel module: the adversarial layouts of the Pallas
# kernel's own tests (tests/test_kernels.py), through the port's wrapper
# (plain version on CPU tensors) against the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------


def _runs(n_seg, seed):
    """Run-length layout: singletons, multi-block giants, empty-band jumps."""
    rng = np.random.default_rng(seed)
    runs, cur, total = [], 0, 0
    while total < 1500 and cur < n_seg:
        kind = rng.random()
        ln = int(rng.integers(512, 1300)) if kind < 0.15 else (
            1 if kind < 0.5 else int(rng.integers(1, 40)))
        runs.append(np.full(ln, cur, np.int32))
        total += ln
        cur += int(rng.integers(1, 300)) if rng.random() < 0.2 else int(rng.integers(1, 4))
    return np.minimum(np.concatenate(runs), n_seg - 1)


def _sorted_layouts():
    rng = np.random.default_rng(5)
    srt = lambda lo, hi, e: np.sort(rng.integers(lo, hi, e)).astype(np.int32)  # noqa: E731
    return [
        ("one_segment", 1, np.zeros(1500, np.int32)),
        ("last_segment_only", 64, np.full(1500, 63, np.int32)),
        ("all_singletons_513", 513, np.arange(513, dtype=np.int32)),
        ("all_singletons_2048", 2048, np.arange(2048, dtype=np.int32)),
        ("run_spans_blocks", 384, np.concatenate(
            [np.zeros(100), np.full(1500, 1), np.full(448, 2)]).astype(np.int32)),
        ("straddle_5_blocks", 64, np.concatenate(
            [np.zeros(150), np.full(5 * 512 + 137, 1), np.full(300, 2)]).astype(np.int32)),
        ("empty_segments_gaps", 1024, srt(256, 300, 600)),
        ("two_bands_empty_row_blocks", 2048, np.sort(np.concatenate(
            [rng.integers(0, 8, 200), rng.integers(1500, 1530, 200)])).astype(np.int32)),
        ("empty_input", 256, np.zeros(0, np.int32)),
        ("tail_1", 1, np.zeros(1, np.int32)),
        ("tail_129x37", 37, srt(0, 37, 129)),
        ("tail_1023x129", 129, srt(0, 129, 1023)),
        ("tail_1025x127", 127, srt(0, 127, 1025)),
        ("runs_fuzz", 700, _runs(700, 2024)),
        ("one_run_90pct", 300, np.sort(np.where(
            rng.random(2000) < 0.9, 17, rng.integers(0, 300, 2000))).astype(np.int32)),
    ]


_SORTED_LAYOUTS = _sorted_layouts()


@pytest.mark.parametrize("n_seg,seg", [c[1:] for c in _SORTED_LAYOUTS],
                         ids=[c[0] for c in _SORTED_LAYOUTS])
def test_segment_min_sorted_matches_pallas(n_seg, seg):
    rng = np.random.default_rng(len(seg) * 7 + n_seg)
    keys = rng.integers(0, 1 << 32, len(seg), dtype=np.uint64).astype(np.uint32)
    keys[rng.random(len(seg)) < 0.1] = UMAX  # a share of identity keys
    k, s = torch.from_numpy(keys.astype(np.int64)), torch.from_numpy(seg)
    ops.segment_min_sorted.launches = 0
    got = ops.segment_min_sorted(k, s, n_seg).numpy()
    assert got.dtype == np.int64 and got.shape == (n_seg,)
    pallas = np.asarray(jax_ops.segment_min_sorted(jnp.array(keys), jnp.array(seg),
                                                   num_segments=n_seg))
    np.testing.assert_array_equal(got, pallas.astype(np.int64))
    np.testing.assert_array_equal(ref.segment_min_sorted_ref(k, s, n_seg).numpy(), got)
    oracle = np.asarray(jax_ref.segment_min_sorted_ref(jnp.array(keys), jnp.array(seg), n_seg))
    np.testing.assert_array_equal(got, oracle.astype(np.int64))
    assert ops.segment_min_sorted.launches == 0  # the CPU path launches nothing


def test_dedupe_segmin_backend_resolution():
    """The dedupe site: the sorted kernel's wrapper for every request but
    "torch", which gives its plain version; an unknown request raises."""
    for req in (None, "auto", "sorted", "cuda"):
        assert ops.packed_segmin(req, "dedupe") is ops.segment_min_sorted
    assert ops.packed_segmin("torch", "dedupe") is ref.segment_min_sorted_ref
    with pytest.raises(ValueError):
        ops.packed_segmin("pallas", "dedupe")
    keys, seg = _keys_segs(50, 400, 5)
    k, s = torch.from_numpy(keys.astype(np.int64)), torch.from_numpy(np.sort(seg))
    assert torch.equal(ops.packed_segmin(None, "dedupe")(k, s, 50),
                       ref.segment_min_sorted_ref(k, s, 50))


def test_sorted_wrapper_rejects_bad_inputs():
    k = torch.zeros(8, dtype=torch.int64)
    s = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="int64"):
        ops.segment_min_sorted(k.to(torch.int32), s, 4)
    with pytest.raises(ValueError, match="1-D"):
        ops.segment_min_sorted(k, s[:4], 4)
    with pytest.raises(ValueError, match="contiguous"):
        ops.segment_min_sorted(k, torch.zeros(16, dtype=torch.int32)[::2], 4)
    with pytest.raises(ValueError, match="num_segments"):
        ops.segment_min_sorted(k, s, 1 << 31)


def test_sorted_launcher_never_falls_back_to_cpu():
    k = torch.zeros(8, dtype=torch.int64)
    s = torch.zeros(8, dtype=torch.int32)
    out = torch.empty(4, dtype=torch.int64)
    before = ops.segment_min_sorted.launches
    with pytest.raises(RuntimeError, match="segment_min_sorted's CUDA kernel"):
        ops._launch("segment_min_sorted", k, s, out, 8, 4)
    assert ops.segment_min_sorted.launches == before


def test_sorted_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    ops._kernel_lib.cache_clear()
    build.load.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        ops._kernel_lib("segment_min_sorted")
    assert not (tmp_path / "build").exists()
