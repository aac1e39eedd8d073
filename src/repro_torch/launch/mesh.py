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

:class:`P` is the reference's ``PartitionSpec``: the mesh axes that split
each dimension of an array. :func:`copy_to`, :func:`reduce_from` and
:func:`gather` are the differentiable collectives of the sharded LM
(Megatron's conjugate pairs): each one's backward is the collective that
makes the gradient of a replicated tensor whole on every rank.
``torch.distributed.nn.functional.all_reduce`` is not :func:`reduce_from`:
its backward all-reduces again, which multiplies a gradient that is
already replicated by the number of ranks.

:meth:`Mesh.count_collectives` records, while it is open, the bytes of
every collective the mesh runs, by the set of axes it runs over: the
operand of an all-reduce or a reduce-scatter, the result of an
all-gather (the reference's ``hlo_analyzer`` definition). Each public
collective counts once, also where it is built on another, and a group
of one rank moves nothing and is not counted. The backward passes of the
differentiable collectives call the same methods and so count too.
"""
from __future__ import annotations

import contextlib
import itertools
import math
from collections import Counter

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.graphs.structures import resolve_device

_OPS = {"min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX, "sum": dist.ReduceOp.SUM}


def _spec_entry(e):
    """One dimension of a :class:`P`, normalised as JAX does: a 1-tuple of
    names becomes the name, an empty tuple ``None``."""
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else e[0] if len(e) == 1 else e
    return e


class P(tuple):
    """``PartitionSpec``: per dimension ``None`` (not split), a mesh axis
    name, or a tuple of names (split over their row-major product)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_spec_entry(e) for e in entries))

    def __repr__(self):
        return "P(" + ", ".join(map(repr, self)) + ")"

    def axes(self) -> tuple:
        """Every axis name the spec splits over, in order of appearance."""
        out = []
        for e in self:
            out.extend(() if e is None else (e,) if isinstance(e, str) else e)
        return tuple(out)


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
        self._counts = None  # a Counter while count_collectives is open

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

    @contextlib.contextmanager
    def count_collectives(self):
        """While open, the bytes of this mesh's collectives accumulate in the
        ``Counter`` it yields, keyed by the tuple of axis names each ran
        over (in mesh order)."""
        outer, counts = self._counts, Counter()
        self._counts = counts
        try:
            yield counts
        finally:
            self._counts = outer
            if outer is not None:
                outer.update(counts)

    def _count(self, axes, nbytes: int) -> None:
        if self._counts is not None:
            subset = self._subset(axes)
            if math.prod(self.shape[i] for i in subset) > 1:
                self._counts[tuple(self.axis_names[i] for i in subset)] += int(nbytes)

    def all_gather(self, x: torch.Tensor, axes) -> torch.Tensor:
        """``x`` of every rank along ``axes``, concatenated along dim 0 in
        row-major order (JAX's ``all_gather(..., tiled=True)``)."""
        self._count(axes, x.nbytes * self.axis_size(axes))
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.axis_size(axes))]
        dist.all_gather(parts, x, group=self.group(axes))
        return torch.cat(parts)

    def all_reduce(self, x: torch.Tensor, op: str, axes) -> torch.Tensor:
        """A new tensor: ``x`` reduced with ``op`` ("min", "max" or
        "sum") over the ranks along ``axes``; ``x`` is left as it is."""
        self._count(axes, x.nbytes)
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=_OPS[op], group=self.group(axes))
        return out

    def all_reduce_(self, x: torch.Tensor, op: str, axes) -> torch.Tensor:
        """``x`` (contiguous) reduced in place; returns ``x``."""
        self._count(axes, x.nbytes)
        dist.all_reduce(x, op=_OPS[op], group=self.group(axes))
        return x

    def barrier(self) -> None:
        """Wait for every rank of the mesh."""
        dist.barrier(group=dist.group.WORLD)

    def gather_dim(self, x: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """``x`` of every rank along ``axes`` concatenated along ``dim``
        (counted by the all-gather it runs)."""
        if dim == 0:
            return self.all_gather(x, axes)
        return self.all_gather(x.movedim(dim, 0), axes).movedim(0, dim).contiguous()

    def reduce_scatter(self, x: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """The sum of ``x`` over the ranks along ``axes``, cut into equal
        parts along ``dim``: this rank's part. Counted as its operand, by
        the all-reduce it runs where the backend has no reduce-scatter."""
        n, i = self.axis_size(axes), self.axis_index(axes)
        if self.backend == "nccl":
            self._count(axes, x.nbytes)
            xs = x.movedim(dim, 0).contiguous()
            out = xs.new_empty((xs.shape[0] // n,) + tuple(xs.shape[1:]))
            dist.reduce_scatter_tensor(out, xs, group=self.group(axes))
            return out.movedim(0, dim).contiguous()
        part = x.shape[dim] // n
        return self.all_reduce(x, "sum", axes).narrow(dim, i * part, part).contiguous()


def live_axes(mesh, axes) -> tuple:
    """The names among ``axes`` (a name, a tuple or ``None``) that ``mesh``
    has with more than one rank, in mesh order: the axes a collective over
    ``axes`` must run on. ``mesh`` may be ``None`` (one device)."""
    if mesh is None or axes is None:
        return ()
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    return tuple(a for a in mesh.axis_names if a in names and sizes[a] > 1)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g, "sum", ctx.axes), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return mesh.all_reduce(x, "sum", axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return mesh.gather_dim(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.reduce_scatter(g, ctx.axes, ctx.dim), None, None, None


def shard_leaf(x, spec, mesh):
    """This rank's block of the whole array ``x`` (a tensor or a numpy
    array) under ``spec``: each split dimension cut into equal parts, the
    part of the rank's row-major index along the dimension's axes. A
    tensor comes back as a contiguous copy, so the whole one can be freed."""
    if spec is None or mesh is None:
        return x
    sel, cut = [], False
    for dim, entry in enumerate(spec):
        axes = live_axes(mesh, entry)
        if not axes:
            sel.append(slice(None))
            continue
        n, i = mesh.axis_size(axes), mesh.axis_index(axes)
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of size {x.shape[dim]} does not split over "
                             f"{axes} ({n} ranks)")
        part = x.shape[dim] // n
        sel.append(slice(i * part, (i + 1) * part))
        cut = True
    if not cut:
        return x
    block = x[tuple(sel)]
    return block.contiguous().clone() if isinstance(x, torch.Tensor) else np.ascontiguousarray(block)


def gather_leaf(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole array of which ``x`` is this rank's block under ``spec``
    (collective: every rank of the split axes calls it)."""
    if spec is None or mesh is None:
        return x
    for dim, entry in enumerate(spec):
        axes = live_axes(mesh, entry)
        if axes:
            x = mesh.gather_dim(x, axes, dim)
    return x


def copy_to(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Enter a region split over ``axes``: the identity forward; backward,
    the rank's partial gradients summed over ``axes``. A no-op where no
    axis of ``axes`` has more than one rank."""
    axes = live_axes(mesh, axes)
    return _CopyTo.apply(x, mesh, axes) if axes else x


def reduce_from(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Leave a region split over ``axes``: the ranks' partial results
    summed (all-reduce); backward, the identity."""
    axes = live_axes(mesh, axes)
    return _ReduceFrom.apply(x, mesh, axes) if axes else x


def gather(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """The shards of ``x`` along ``axes`` concatenated along ``dim`` (an
    FSDP weight gather); backward, the reduce-scatter of the gradient."""
    axes = live_axes(mesh, axes)
    return _Gather.apply(x, mesh, axes, dim) if axes else x


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
