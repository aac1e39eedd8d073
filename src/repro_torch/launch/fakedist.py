"""A fake world of ranks and a counter of what one rank's program does:
the dry run's only contact with torch internals.

The dry run (``launch/dryrun.py``) runs rank 0's program of a production
mesh (256 or 512 ranks) in one process. :func:`init_fake_world` starts
torch's ``"fake"`` process-group backend, whose collectives return at once
and move nothing, and :func:`fake_mesh` builds a
:class:`~repro_torch.launch.mesh.Mesh` on it. The program runs on
``"meta"`` tensors: shapes, dtypes and strides without data, so a
2·10¹²-parameter model costs no memory. The ATen operations a program
dispatches on ``"meta"`` are those it dispatches on the card (no path of
the port branches on the device); what differs is only that nothing runs.

:class:`OpTally` is a dispatch mode that counts, per ATen operation:

- the bytes it moves: the bytes of its tensor inputs and outputs, a view
  counting nothing and the allocation-only factories (``empty``) nothing;
  a gather-like operation (``embedding``, ``index_select``, ``gather``,
  ``index``) reads the rows it returns, not its whole source, and an
  in-place scatter (``index_add_``, ``index_put_``, ``scatter*_``) reads
  and writes the rows its source names;
- the multiply-add FLOPs of each operation that
  ``torch.utils.flop_counter`` has a formula for (the formulas of
  ``FlopCounterMode``), by the dtype of its first input;
- the bytes of live storage allocated inside the region, rounded up to
  the 512-byte blocks of the CUDA caching allocator, and their peak. A
  storage is live until its last tensor dies (a weak reference to it).

Torch keeps the fake backend in ``torch.testing._internal``, the
dispatch-mode base class in ``torch.utils._python_dispatch``, the tree
helpers in ``torch.utils._pytree`` and the weak storage map in
``torch.utils.weak``: they are imported here and nowhere else in the
port, so an upgrade that moves one breaks this file by name.
"""
from __future__ import annotations

import math
import weakref

import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore  # registers "fake"
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.launch.mesh import Mesh

FAKE_DEVICE = "meta"
#: The CUDA caching allocator hands out blocks in multiples of 512 bytes.
BLOCK_BYTES = 512

_aten = torch.ops.aten
_GATHERS = {_aten.embedding, _aten.index_select, _aten.gather, _aten.index}
_SCATTERS_INPLACE = {_aten.index_add_, _aten.index_put_, _aten.scatter_, _aten.scatter_add_,
                     _aten.scatter_reduce_, _aten.index_copy_, _aten.index_fill_}
_ALLOCATORS = {_aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
               _aten.new_empty_strided}


def init_fake_world(world_size: int) -> None:
    """Start the default process group on the ``"fake"`` backend as rank 0
    of ``world_size``; a fake group of another size is torn down first."""
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a {dist.get_backend()!r} process group is already running")
        if dist.get_world_size() == world_size:
            return
        teardown()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def fake_mesh(shape, axis_names) -> Mesh:
    """A :class:`Mesh` of ``shape`` for rank 0 of a fake world of
    ``prod(shape)`` ranks, on ``"meta"`` (no CUDA runtime is touched, so
    this is not :func:`~repro_torch.launch.mesh.make_mesh`)."""
    init_fake_world(math.prod(shape))
    return Mesh(shape, axis_names, FAKE_DEVICE)


def teardown() -> None:
    """Destroy the default process group, if one is running."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _block(nbytes: int) -> int:
    return -(-int(nbytes) // BLOCK_BYTES) * BLOCK_BYTES


def tensors(tree) -> list:
    """The tensors among the leaves of nested tuples, lists, dicts and
    named tuples."""
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class OpTally(TorchDispatchMode):
    """Counts bytes, FLOPs by dtype and live storage of the operations
    dispatched while it is entered (see the module docstring). ``keep``:
    tensors that exist before the region (the program's arguments): their
    storages are never counted as allocated."""

    def __init__(self, keep=()):
        super().__init__()
        self.bytes = 0
        self.flops = {}  # dtype name -> FLOPs
        self.live = 0
        self.peak = 0
        self._seen = WeakIdKeyDictionary()
        for t in tensors(keep):
            self._seen[t.untyped_storage()] = None

    def _free(self, nbytes: int) -> None:
        self.live -= nbytes

    def _allocated(self, outs) -> None:
        for t in outs:
            st = t.untyped_storage()
            if st in self._seen:
                continue
            size = _block(st.nbytes())
            self._seen[st] = weakref.ref(st, lambda _, n=size: self._free(n))
            self.live += size
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if func.namespace == "prim" or func.is_view:
            return out
        ins, outs = tensors((args, kwargs)), tensors(out)
        if packet in _GATHERS:
            moved = 2 * _nbytes(outs) + _nbytes(ins[1:])
        elif packet in _SCATTERS_INPLACE:
            moved = _nbytes(ins[1:]) + 2 * _nbytes(ins[-1:])  # ids, source; rows read, written
        elif packet in _ALLOCATORS:
            moved = 0
        else:
            moved = _nbytes(ins) + _nbytes(outs)
        self.bytes += moved
        formula = flop_registry.get(packet)
        if formula is not None:
            dt = str(ins[0].dtype).removeprefix("torch.")
            self.flops[dt] = self.flops.get(dt, 0) + formula(*args, **kwargs, out_val=out)
        if not func._schema.is_mutable:
            self._allocated(outs)
        return out
