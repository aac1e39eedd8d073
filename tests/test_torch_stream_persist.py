"""``repro_torch.checkpoint`` and ``repro_torch.stream.persist`` against
``repro.checkpoint`` and ``repro.stream.persist`` on the CPU: the same
on-disk layout and array names, so a checkpoint written by either package
restores in the other, bit for bit; atomic steps, async saves and
``latest_step``; exact resume of a stream engine."""
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from _torch_util import StreamTrace, apply_op, assert_same_engine, assert_same_state  # noqa: E402
from repro import checkpoint as jckpt  # noqa: E402
from repro import stream as jstream  # noqa: E402
from repro.stream import persist as jpersist  # noqa: E402
from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch import stream as tstream  # noqa: E402
from repro_torch.checkpoint.checkpoint import _leaves  # noqa: E402
from repro_torch.stream import persist as tpersist  # noqa: E402

from collections import namedtuple  # noqa: E402

Pair = namedtuple("Pair", "left right")


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "b": rng.random(3).astype(np.float32),
        "a": {"x": rng.integers(0, 9, (2, 2)), "c": [np.int64(4), (rng.random(2), np.bool_(True))]},
        "p": Pair(np.arange(3, dtype=np.int32), None),
        "reservoir/lo": np.zeros(0, np.int32),
        "e": [],
    }


def test_array_names_are_the_reference_paths():
    tree = _tree()
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    want = ["/".join(str(k) for k in path) for path, _ in flat]
    got = [name for name, _ in _leaves(tree)]
    assert got == want
    assert "['a']/['x']" in got and "['b']" in got and "['p']/.left" in got


def _assert_same_tree(a, b, *, dtypes=True):
    la, lb = _leaves(a), _leaves(b)
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (name, x), (_, y) in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        if not dtypes:  # the reference restores into jax arrays, 32-bit unless x64 is on
            x = x.astype(y.dtype)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(y, x, err_msg=name)


def test_both_packages_write_the_same_files(tmp_path):
    tree = _tree(2)
    for name, save in (("ref", jckpt.save_checkpoint), ("port", tckpt.save_checkpoint)):
        save(str(tmp_path / name), 7, tree, async_save=False)
        step = tmp_path / name / "step_000000007"
        assert sorted(os.listdir(step)) == ["DONE", "arrays.npz", "meta.json"]
        assert json.loads((step / "meta.json").read_text()) == {"step": 7}
        assert (step / "DONE").read_text() == "ok"
    with np.load(tmp_path / "ref/step_000000007/arrays.npz") as want, \
            np.load(tmp_path / "port/step_000000007/arrays.npz") as got:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_restores_across_packages(tmp_path, writer):
    tree = _tree(1)
    save, restore = ((jckpt.save_checkpoint, tckpt.restore_checkpoint) if writer == "reference"
                     else (tckpt.save_checkpoint, jckpt.restore_checkpoint))
    save(str(tmp_path), 7, tree, async_save=False)
    assert jckpt.latest_step(str(tmp_path)) == tckpt.latest_step(str(tmp_path)) == 7
    template = jax.tree_util.tree_map(np.zeros_like, tree)
    _assert_same_tree(tree, restore(str(tmp_path), 7, template), dtypes=writer == "reference")


def test_restore_rebuilds_the_template_structure(tmp_path):
    """Tensors are saved from the host; every leaf comes back as numpy with
    its dtype, in the template's containers."""
    tree = {"t": torch.arange(5, dtype=torch.int32), "n": [np.ones(2), (np.int64(7),)],
            "k": Pair(torch.zeros(2), None)}
    tckpt.save_checkpoint(str(tmp_path), 1, tree, async_save=False)
    got = tckpt.restore_checkpoint(str(tmp_path), 1, tree)
    assert isinstance(got["k"], Pair) and got["k"].right is None
    assert isinstance(got["n"], list) and isinstance(got["n"][1], tuple)
    assert got["t"].dtype == np.int32 and got["n"][1][0].dtype == np.int64
    np.testing.assert_array_equal(got["t"], np.arange(5))
    np.testing.assert_array_equal(got["k"].left, np.zeros(2, np.float32))


def test_async_save_latest_and_incomplete_steps(tmp_path):
    d = str(tmp_path)
    assert tckpt.latest_step(d) is None and tckpt.latest_step(str(tmp_path / "none")) is None
    for step in (3, 10, 5):
        tckpt.save_checkpoint(d, step, {"x": np.full(4, step)})
    tckpt.wait_for_saves()
    assert tckpt.latest_step(d) == jckpt.latest_step(d) == 10
    (tmp_path / "step_000000099.tmp").mkdir()  # a crash mid-save
    (tmp_path / "step_000000050").mkdir()  # renamed but no DONE marker
    assert tckpt.latest_step(d) == 10
    tckpt.save_checkpoint(d, 10, {"x": np.zeros(4)}, async_save=False)  # overwrite in place
    np.testing.assert_array_equal(
        tckpt.restore_checkpoint(d, 10, {"x": np.ones(4)})["x"], np.zeros(4))


_CONFIGS = {
    "default": (64, 16, {}),
    "bounded reservoir": (48, 16, dict(reservoir_capacity=6, reservoir_per_component=2)),
    "legacy deletes": (64, 16, dict(exact_deletes=False)),
    "adaptive capacity": (96, 32, dict(adaptive_capacity=True, min_capacity=4)),
    "n > 2^16": (70_000, 64, {}),
}


def _run_trace(engines, n, cap, seed, n_ops):
    trace = StreamTrace(n, cap, seed=seed, p=(0.6, 0.35, 0.05, 0.0))
    for i in range(n_ops):
        op, args = trace.insert() if i < 3 else trace.next_op()
        for e in engines:
            apply_op(e, op, args)
    return trace


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("config", list(_CONFIGS))
def test_stream_checkpoint_restores_across_packages(tmp_path, writer, config):
    """A stream engine saved by either package resumes in the other at the
    same version with the same forest, reservoir, labels and snapshot, and
    both go on identically."""
    n, cap, kw = _CONFIGS[config]
    je = jstream.StreamEngine(n, cap, **kw)
    te = tstream.StreamEngine(n, cap, **kw, device="cpu")
    trace = _run_trace([je, te], n, cap, seed=len(config), n_ops=12)
    assert_same_engine(je, te)
    d = str(tmp_path)
    src, dst = (je, tstream.StreamEngine(n, cap, **kw, device="cpu")) if writer == "reference" \
        else (te, jstream.StreamEngine(n, cap, **kw))
    save, restore = ((jpersist.save_stream, tpersist.restore_stream) if writer == "reference"
                     else (tpersist.save_stream, jpersist.restore_stream))
    assert save(d, src) == src.version
    assert tpersist.latest_stream_step(d) == jpersist.latest_stream_step(d) == src.version
    assert restore(d, dst) == src.version
    assert_same_state(src.state_dict(), dst.state_dict())
    pair = (je, dst) if writer == "reference" else (dst, te)
    assert_same_engine(*pair, union=False)
    for _ in range(4):  # the restored engine goes on as the saved one does
        op, args = trace.next_op()
        want, got = (apply_op(e, op, args) for e in pair)
        if hasattr(want, "recompiles"):  # counted per engine object, not saved
            want, got = want._replace(recompiles=0), got._replace(recompiles=0)
        assert tuple(got) == tuple(want)
        assert_same_engine(*pair, union=False)


def test_stream_persist_async_latest_and_mismatch(tmp_path):
    d = str(tmp_path)
    with pytest.raises(FileNotFoundError, match="no completed stream checkpoint"):
        tpersist.restore_stream(d, tstream.StreamEngine(32, 8, device="cpu"))
    e = tstream.StreamEngine(32, 8, device="cpu")
    versions = []
    for seed in range(3):
        rng = np.random.default_rng(seed)
        e.insert_batch(rng.integers(0, 32, 8), rng.integers(0, 32, 8), rng.random(8) * 9)
        versions.append(tpersist.save_stream(d, e, async_save=True))
    tpersist.wait_for_saves()
    assert tpersist.latest_stream_step(d) == versions[-1] == e.version
    fresh = tstream.StreamEngine(32, 8, device="cpu")
    assert tpersist.restore_stream(d, fresh, step=versions[0]) == versions[0]
    assert tpersist.restore_stream(d, fresh) == e.version
    assert_same_state(e.state_dict(), fresh.state_dict())
    # the float64 weight comes back exactly (the reference rounds it to
    # float32 when JAX runs without x64)
    assert fresh.snapshots.acquire().weight == e.weight == fresh.weight
    with pytest.raises(ValueError, match="does not match"):
        tpersist.restore_stream(d, tstream.StreamEngine(32, 16, device="cpu"))
    with pytest.raises(ValueError, match="does not match"):
        tpersist.restore_stream(d, tstream.StreamEngine(32, 8, exact_deletes=False, device="cpu"))
