"""Rank grids over ``torch.distributed`` (counterpart of
``repro.compat.make_mesh`` and ``repro.launch.mesh``).

A :class:`Mesh` names the axes of a grid of ranks of an initialised
process group, as a JAX mesh names the axes of a grid of devices. The
global rank is the row-major flat index of a rank's coordinates, so
``devices`` is ``arange(world).reshape(shape)``. Every subset of the axes
has one subgroup per choice of the other axes' coordinates; the mesh
keeps the one holding this rank. ``torch.distributed.new_group`` sorts
its ranks, so a collective over a subgroup runs in row-major order of
the subset's coordinates: an all-gather over ``"model"`` concatenates the
shards of row r contiguously, one over ``"data"`` yields the strided
column block, and a tuple of axes such as ``("pod", "data")`` flattens
row-major (the reference's ``_axis_index_flat``). A tuple must list its
axes in mesh order.

The caller initialises the process group and so chooses its backend:
``nccl`` for ranks on distinct cards, ``gloo`` on the CPU and for
several ranks that share one card (NCCL refuses two ranks on one
device). Gloo takes CUDA tensors for every collective used here
(all-gather, all-reduce min/max/sum over int32, int64, float32 and
float64; ``chip_smoke.py`` checks each on the card), so this module
stages no tensor through host memory itself. Each rank's
device is explicit: by default ``cuda:{rank % device_count}``, which
raises without CUDA; pass ``device="cpu"`` to run on the CPU.

The mesh hashes by identity: it keys the plan cache, so plans built on
one mesh share engines and plans on another do not.
"""
from __future__ import annotations

import itertools
import math

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.graphs.structures import resolve_device

_OPS = {"min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX, "sum": dist.ReduceOp.SUM}


class Mesh:
    """A named grid of the ranks of the default process group, and this
    rank's place in it. Build with :func:`make_mesh`."""

    def __init__(self, shape, axis_names, device):
        shape, axis_names = tuple(int(d) for d in shape), tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axis names {axis_names} do not match")
        world = dist.get_world_size()
        if world != math.prod(shape):
            raise ValueError(
                f"a {'x'.join(map(str, shape))} mesh needs {math.prod(shape)} ranks; "
                f"the process group has {world}"
            )
        self.axis_names = axis_names
        self.shape = shape
        self.devices = np.arange(world).reshape(shape)
        self.rank = dist.get_rank()
        self.coords = tuple(int(c) for c in np.unravel_index(self.rank, shape))
        self.device = torch.device(device)
        self.backend = dist.get_backend()
        self._groups = self._make_groups()

    def _make_groups(self) -> dict:
        """This rank's subgroup for every non-empty subset of the axes.
        Every rank creates every subgroup, in the same order, including
        those it is not in: ``new_group`` is collective over the world."""
        k = len(self.shape)
        groups = {}
        for size in range(1, k + 1):
            for subset in itertools.combinations(range(k), size):
                if size == k:
                    groups[subset] = dist.group.WORLD
                    continue
                rest = [i for i in range(k) if i not in subset]
                for fixed in itertools.product(*(range(self.shape[i]) for i in rest)):
                    sel = [slice(None)] * k
                    for i, c in zip(rest, fixed):
                        sel[i] = c
                    ranks = self.devices[tuple(sel)].reshape(-1).tolist()
                    g = dist.new_group(ranks)
                    if self.rank in ranks:
                        groups[subset] = g
        for subset, g in groups.items():
            # Collectives run in the group's rank order: it must be the
            # row-major order of the subset's coordinates.
            if dist.get_rank(g) != self._flat_index(subset):
                raise RuntimeError(
                    f"rank {self.rank}: subgroup over {subset} is not in row-major order"
                )
        return groups

    def __repr__(self):
        dims = ", ".join(f"{a}={d}" for a, d in zip(self.axis_names, self.shape))
        return f"Mesh({dims}; rank {self.rank} at {self.coords} on {self.device}, {self.backend})"

    def _subset(self, axes) -> tuple:
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        try:
            idx = tuple(self.axis_names.index(a) for a in names)
        except ValueError:
            raise ValueError(f"unknown mesh axes {names}; the mesh has {self.axis_names}")
        if not idx or list(idx) != sorted(set(idx)):
            raise ValueError(f"axes {names} must be distinct and in mesh order {self.axis_names}")
        return idx

    def _flat_index(self, subset: tuple) -> int:
        idx = 0
        for i in subset:
            idx = idx * self.shape[i] + self.coords[i]
        return idx

    def axis_size(self, axes) -> int:
        """Ranks along ``axes`` (a name or a tuple of names)."""
        return math.prod(self.shape[i] for i in self._subset(axes))

    def axis_index(self, axes) -> int:
        """This rank's row-major index along ``axes``."""
        return self._flat_index(self._subset(axes))

    def group(self, axes):
        """This rank's subgroup over ``axes``."""
        return self._groups[self._subset(axes)]

    def all_gather(self, x: torch.Tensor, axes) -> torch.Tensor:
        """``x`` of every rank along ``axes``, concatenated along dim 0 in
        row-major order (JAX's ``all_gather(..., tiled=True)``)."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.axis_size(axes))]
        dist.all_gather(parts, x, group=self.group(axes))
        return torch.cat(parts)

    def all_reduce(self, x: torch.Tensor, op: str, axes) -> torch.Tensor:
        """A new tensor: ``x`` reduced with ``op`` ("min", "max" or
        "sum") over the ranks along ``axes``; ``x`` is left as it is."""
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=_OPS[op], group=self.group(axes))
        return out


def make_mesh(shape, axis_names, *, device=None) -> Mesh:
    """A :class:`Mesh` of ``shape`` over the initialised default process
    group, whose world size must equal ``prod(shape)``. ``device``: this
    rank's device; ``None`` means ``cuda:{rank % device_count}`` (made
    the current CUDA device), which raises without CUDA."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised process group: call "
            "torch.distributed.init_process_group(backend, ...) first"
        )
    if device is None:
        resolve_device(None)  # raises without CUDA
        device = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return Mesh(shape, axis_names, device)


def make_host_mesh(*, device=None) -> Mesh:
    """1×1 ``("data", "model")`` mesh for one process.

    Without an initialised process group this starts a world-1 ``gloo``
    group on an in-memory ``torch.distributed.HashStore`` (no network, no
    file); with one, of any backend, its world size must be 1. ``device``
    as in :func:`make_mesh` (``device="cpu"`` on a machine without a card).
    """
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    return make_mesh((1, 1), ("data", "model"), device=device)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The reference's production grid: 16×16 ``("data", "model")``, or
    2×16×16 ``("pod", "data", "model")`` with ``multi_pod``; the process
    group must hold 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)
