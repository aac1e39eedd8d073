"""Atomic checkpoints with async save (counterpart of ``repro.checkpoint``).

- Saves are atomic: write to ``step_<n>.tmp/``, then rename to
  ``step_<n>/`` with a ``DONE`` marker, so a crash mid-save never
  corrupts the latest restorable state.
- Async: the device→host copy happens on the caller's thread (a copy of
  CPU tensors and arrays too, which the caller may go on updating in
  place); the serialization runs on a background thread;
  ``wait_for_saves`` joins.
- The on-disk layout is the reference's (``arrays.npz``, ``meta.json``,
  ``DONE``), and every array is stored under the name
  ``jax.tree_util.tree_flatten_with_path`` gives its path: a checkpoint
  written by either package restores in the other.

A tree is nested dicts, lists, tuples and named tuples; as in JAX, an
``OrderedDict`` keeps its insertion order and every other dict (a
``defaultdict`` too) its sorted keys, and restore rebuilds each dict as
the target's own type (a ``defaultdict`` with its ``default_factory``); ``None`` and empty containers hold no leaves; anything
else is a leaf (a torch tensor, a numpy array or a scalar), saved from
the host and restored as numpy.

A run on a mesh saves and restores the reference's whole arrays: with
``mesh`` and ``specs`` (a tree shaped as the saved one whose leaves are
:class:`repro_torch.launch.mesh.P`, or ``None`` for a replicated leaf)
every rank takes part in gathering each split leaf and rank 0 alone
copies it to the host and writes; a restore gives each rank its blocks.
So a checkpoint crosses packages and mesh shapes both ways. Restore takes
no device shardings. A split leaf is gathered a piece at a time along a
dimension no mesh axis splits, each piece at most ``SAVE_PIECE_BYTES``
whole (or one index of that dimension, if that is larger), and the piece
is on the host before the next is gathered: beyond the blocks a save
holds under three whole pieces on the device (the gather's parts, their
concatenation and a contiguous copy), never a whole tree or leaf.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import threading
from collections import OrderedDict, defaultdict
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.launch.mesh import P, gather_leaf, live_axes, shard_leaf

_PENDING: list[threading.Thread] = []
SAVE_PIECE_BYTES = 256 << 20


def _dict_keys(node: dict) -> list:
    """A dict's keys in JAX's flattening order: an ``OrderedDict``'s in
    insertion order, every other dict's sorted."""
    return list(node) if isinstance(node, OrderedDict) else sorted(node)


def _children(node):
    """``[(path entry, child)]`` of a container node, or ``None`` for a leaf.
    The entries print as JAX's key types do: ``['k']``, ``[i]``, ``.name``.
    A :class:`P` is a leaf (of a tree of specs)."""
    if isinstance(node, P):
        return None
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in _dict_keys(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", c) for i, c in enumerate(node)]
    if node is None:
        return []
    return None


def _leaves(tree, prefix=()):
    """``[(path name, leaf)]`` in JAX's flattening order."""
    kids = _children(tree)
    if kids is None:
        return [("/".join(prefix), tree)]
    return [item for entry, c in kids for item in _leaves(c, prefix + (entry,))]


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves drawn in order from ``leaves``."""
    kids = _children(tree)
    if kids is None:
        return next(leaves)
    if isinstance(tree, dict):
        items = [(k, _rebuild(tree[k], leaves)) for k in _dict_keys(tree)]
        if isinstance(tree, defaultdict):
            return type(tree)(tree.default_factory, items)
        return type(tree)(items)
    if hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(c, leaves) for _, c in kids))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(c, leaves) for c in tree)
    return None


def _host_copy(leaf) -> np.ndarray:
    """A host copy of ``leaf`` that no later in-place update reaches."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def _specs_by_name(tree, specs) -> dict:
    if specs is None:
        return {}
    names = [name for name, _ in _leaves(tree)]
    spec_leaves = [s for _, s in _leaves(specs)]
    if len(spec_leaves) != len(names):
        raise ValueError(f"specs hold {len(spec_leaves)} leaves, the tree {len(names)}")
    return dict(zip(names, spec_leaves))


def _whole_on_host(x: torch.Tensor, spec, mesh) -> Optional[np.ndarray]:
    """The whole array of which ``x`` is this rank's block under ``spec``,
    on the host of rank 0 (``None`` on the others); collective. Gathered in
    pieces along the first dimension no axis splits (see the module
    docstring), each copied to the host before the next is gathered."""
    ranks = [mesh.axis_size(live_axes(mesh, e)) if live_axes(mesh, e) else 1
             for e in (spec or ())]
    ranks += [1] * (x.dim() - len(ranks))
    if all(n == 1 for n in ranks):
        return _host_copy(x) if mesh.rank == 0 else None
    free = [d for d, n in enumerate(ranks) if n == 1]
    pieces, dim = [x], 0
    if free:  # whole bytes of one index along ``dim``
        dim = free[0]
        one = x.numel() // max(x.shape[dim], 1) * x.element_size() * math.prod(ranks)
        pieces = x.split(max(1, SAVE_PIECE_BYTES // max(one, 1)), dim)
    host = []
    for piece in pieces:
        whole = gather_leaf(piece, spec, mesh)
        if mesh.rank == 0:
            host.append(_host_copy(whole))
        del whole
    return np.concatenate(host, axis=dim) if mesh.rank == 0 else None


def save_checkpoint(ckpt_dir: str, step: int, tree: Any, *, async_save: bool = True,
                    mesh=None, specs=None):
    """Save ``tree`` as step ``step``; on a mesh (collective) the whole
    arrays, gathered under ``specs`` a leaf and a piece at a time, copied
    to the host and written by rank 0."""
    if mesh is None:
        arrays = {name: _host_copy(leaf) for name, leaf in _leaves(tree)}
    else:
        by_name = _specs_by_name(tree, specs)
        arrays = {name: _whole_on_host(leaf, by_name.get(name), mesh)
                  if isinstance(leaf, torch.Tensor) else _host_copy(leaf)
                  for name, leaf in _leaves(tree)}
        if mesh.rank != 0:
            return
    os.makedirs(ckpt_dir, exist_ok=True)
    # Pulled to host synchronously (cheap vs serialization); serialize async.
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    tmp = final + ".tmp"

    def write():
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step}, f)
        with open(os.path.join(tmp, "DONE"), "w") as f:
            f.write("ok")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    if async_save:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        _PENDING.append(t)
    else:
        write()


def wait_for_saves():
    while _PENDING:
        _PENDING.pop().join()


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "DONE")):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: int, target: Any, *, mesh=None, specs=None):
    """``target`` supplies the tree structure (values ignored); every leaf
    comes back as a numpy array with its stored dtype (on a mesh, this
    rank's block of it under ``specs``)."""
    by_name = _specs_by_name(target, specs)
    path = os.path.join(ckpt_dir, f"step_{step:09d}", "arrays.npz")
    with np.load(path) as data:
        leaves = [shard_leaf(data[name], by_name.get(name), mesh) for name, _ in _leaves(target)]
    return _rebuild(target, iter(leaves))
