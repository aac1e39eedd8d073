"""``repro_torch.checkpoint`` on dict subclasses, against ``repro.checkpoint``
on the CPU: an ``OrderedDict`` keeps its insertion order, a
``defaultdict`` its type and ``default_factory``, a plain ``dict`` its
sorted keys, in the array names and in the restored containers, whichever
package wrote the checkpoint."""
from collections import OrderedDict, defaultdict, namedtuple

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch.checkpoint.checkpoint import _leaves  # noqa: E402

Pair = namedtuple("Pair", "left right")


def _ordered():
    return OrderedDict([("b", np.arange(2)), ("a", np.ones(1, np.float32))])


def _default():
    d = defaultdict(list)
    d["z"] = np.arange(3, dtype=np.int32)
    d["y"] = np.float32(2.5) * np.ones(2, np.float32)
    return d


def _plain():
    return {"q": np.arange(4, dtype=np.int64), "p": np.zeros(1, np.float32)}


def _nested():
    inner = OrderedDict([("k2", _default()), ("k1", np.arange(5, dtype=np.int32))])
    return {
        "outer": inner,
        "list": [_ordered(), Pair(_plain(), np.ones(2, np.int32))],
        "dd": defaultdict(dict, {"m": OrderedDict([("y", np.ones(1)), ("x", np.zeros(1))])}),
    }


TREES = {"ordered": _ordered, "default": _default, "plain": _plain, "nested": _nested}


def _shape(tree):
    """(type, default_factory, key order) of every container, in order."""
    if isinstance(tree, dict):
        head = [(type(tree), getattr(tree, "default_factory", None), list(tree))]
        return head + [s for k in tree for s in _shape(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [(type(tree), None, len(tree))] + [s for c in tree for s in _shape(c)]
    return []


def _values(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return ["/".join(str(k) for k in path) for path, _ in flat], [np.asarray(x) for _, x in flat]


@pytest.mark.parametrize("name", sorted(TREES))
def test_array_names_follow_jax_order(name):
    tree = TREES[name]()
    want, _ = _values(tree)
    assert [n for n, _ in _leaves(tree)] == want
    if name == "ordered":
        assert want == ["['b']", "['a']"]


@pytest.mark.parametrize("name", sorted(TREES))
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_dict_subclasses_restore_like_the_reference(tmp_path, name, writer):
    tree = TREES[name]()
    save = jckpt.save_checkpoint if writer == "reference" else tckpt.save_checkpoint
    save(str(tmp_path), 3, tree, async_save=False)
    target = TREES[name]()  # the structure; values ignored
    want = jckpt.restore_checkpoint(str(tmp_path), 3, target)
    got = tckpt.restore_checkpoint(str(tmp_path), 3, target)
    assert _shape(got) == _shape(want)
    names_w, vals_w = _values(want)
    names_g, vals_g = _values(got)
    assert names_g == names_w
    _, vals_t = _values(tree)
    for n, g, w, t in zip(names_g, vals_g, vals_w, vals_t):
        np.testing.assert_array_equal(g, t, err_msg=n)
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=n)


def test_ordered_dict_repro_case(tmp_path):
    """The reproduction: an OrderedDict saved by the port comes back as an
    OrderedDict in insertion order from both packages."""
    tckpt.save_checkpoint(str(tmp_path), 0, _ordered(), async_save=False)
    for restore in (jckpt.restore_checkpoint, tckpt.restore_checkpoint):
        r = restore(str(tmp_path), 0, _ordered())
        assert type(r) is OrderedDict and list(r) == ["b", "a"]
    d = _default()
    tckpt.save_checkpoint(str(tmp_path), 1, d, async_save=False)
    got = tckpt.restore_checkpoint(str(tmp_path), 1, _default())
    assert type(got) is defaultdict and got.default_factory is list
    assert list(got) == ["y", "z"]  # sorted, as JAX flattens it
    assert got["missing"] == []  # the factory still works
