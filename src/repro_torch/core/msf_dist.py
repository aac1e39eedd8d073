"""Distributed MSF engine — the paper's Fig-2 schedule on a 2-D grid of
``torch.distributed`` ranks (counterpart of ``repro.core.msf_dist``).

The port is SPMD: every rank calls the same driver with the same host
:class:`~repro_torch.graphs.partition.Partition2D` and works on its own
block ``[r, s]`` and its own shard ``r*C + s`` of the parent vector,
where the reference runs one ``shard_map``-ped ``while_loop``. Per outer
iteration:

1. **Multilinear kernel** (paper §IV-A): all-gather the parent vector's
   row block (over the column axis) and column block (over the row
   axis); apply f(p_i, a_ij, p_j) all-at-once over the local block;
   segment-argmin into a dense accumulator; MINWEIGHT ⊕-combine across
   the grid (masked all-reduce(min) passes).
2. **Hook + tie-break** from the replicated reduction alone: with the
   complete-shortcutting invariant every tree is a star, so a root's
   post-hook parent is known from r — no extra communication.
3. **Shortcut**:
   - ``baseline``: one all-gather of p over the grid per sub-iteration,
     pointer jump locally, repeat (the paper's remote-read loop);
   - ``csp``: the changed map (hooked roots → new parents) is already
     on every rank; compress it by pointer doubling (local reads only)
     and apply it in one pass — Algorithm 2;
   - ``os``: csp when |changed| ≤ capacity, else baseline (``csp`` does
     the same: the map cannot hold more).

The reference's ``while_loop`` and ``lax.cond`` are host loops and
branches here, decided on values every rank holds alike: the count of
hooked roots (one host read per round, which is also the stop test),
one read per pointer-doubling step, and under ``baseline`` one read of
the all-reduced "moved" flag per sub-iteration.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.multilinear import min_outgoing_2d, min_outgoing_2d_packed
from repro_torch.core.semiring import IMAX, INF
from repro_torch.core.shortcut import _compress_changed_map
from repro_torch.graphs.partition import Partition2D

SHORTCUTS = ("csp", "os", "baseline")


class DistMSFResult(NamedTuple):
    weight: torch.Tensor  # float32 scalar
    parent: torch.Tensor  # int32 [n_pad]: the global parent vector, on every rank
    msf_eids: torch.Tensor  # int32 [n_pad], replicated, IMAX padded
    n_msf_edges: torch.Tensor  # int32 scalar
    iterations: torch.Tensor  # int32 scalar


def _csp_apply(ids: torch.Tensor, vals: torch.Tensor, p_local: torch.Tensor) -> torch.Tensor:
    """Apply the changed map ``ids → vals`` (ids ascending, every rank's
    copy alike) to the local parent shard in one pass, after compressing
    it to its fixpoint by pointer doubling over local reads only. The
    reference's ``top_k`` picks the same ids, the smallest changed ones in
    ascending order; here they come from the round's ``nonzero``."""
    ids, vals = _compress_changed_map(ids, vals)
    j = torch.searchsorted(ids, p_local).clamp_(0, ids.shape[0] - 1)
    return torch.where(ids[j] == p_local, vals[j], p_local)


def _flat_axes(row_axis, col_axis) -> tuple:
    return (tuple(row_axis) if isinstance(row_axis, tuple) else (row_axis,)) + (col_axis,)


def _baseline_shortcut(p_local: torch.Tensor, mesh, row_axis, col_axis) -> torch.Tensor:
    """Per sub-iteration: a full all-gather of p over the grid, a local
    jump, and an all-reduce(max) of whether any rank moved."""
    axes = _flat_axes(row_axis, col_axis)
    while True:
        p_full = mesh.all_gather(p_local, axes)
        p_new = p_full[p_local]
        moved = (p_new != p_local).any().to(torch.int32).reshape(1)
        p_local = p_new
        if not bool(mesh.all_reduce(moved, "max", axes)):
            return p_local


def local_blocks(arrays, mesh, row_axis, col_axis):
    """This rank's block ``[r, s]`` of the five [R, C, Emax] partition
    arrays (numpy or tensors), on the mesh's device with the port's
    dtypes."""
    r, s = mesh.axis_index(row_axis), mesh.axis_index(col_axis)
    dtypes = (torch.int32, torch.int32, torch.float32, torch.int32, torch.bool)
    out = []
    for a, dt in zip(arrays, dtypes):
        blk = a[r, s] if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(np.asarray(a)[r, s]))
        out.append(blk.to(device=mesh.device, dtype=dt).contiguous())
    return tuple(out)


def check_mesh(part: Partition2D, mesh, row_axis, col_axis) -> None:
    """The grid of ``mesh`` over (row_axis, col_axis) must be the
    partition's R×C."""
    got = (mesh.axis_size(row_axis), mesh.axis_size(col_axis))
    if got != (part.rows, part.cols):
        raise ValueError(
            f"the partition is {part.rows}x{part.cols} but the mesh's "
            f"({row_axis}, {col_axis}) grid is {got[0]}x{got[1]}"
        )


class _BlockMemo:
    """The last inputs' local blocks, kept while the caller passes the same
    array objects again (the common case: repeated solves of one
    partition skip the slice and the upload), as the reference's
    ``DistCoarsenMSF._prepare`` does."""

    def __init__(self):
        self._last = None

    def get(self, refs, make):
        if self._last is not None and all(a is b for a, b in zip(self._last[0], refs)):
            return self._last[1]
        value = make()
        self._last = (refs, value)
        return value


def build_dist_driver(
    part: Partition2D,
    mesh,
    *,
    row_axis="data",
    col_axis: str = "model",
    shortcut: str = "csp",
    capacity: int = 1 << 16,
    max_iters: int | None = None,
    pack: bool = False,
    segmin=None,
):
    """The flat Fig-2 distributed driver: a callable (src_row, dst_col, w,
    eid, valid) → :class:`DistMSFResult` over the partition's full [R, C,
    Emax] arrays, of which each rank takes its own block. It reads only
    the partition's static fields (``n_pad``, ``shard_size``, the grid),
    so one driver serves every same-shape partition. ``segmin`` is the
    resolved packed segment-min of the ``pack`` path (the flat CUDA kernel
    on the card; ``None``: the plain scatter-min). Public callers go
    through ``plan(part, SolveSpec(mode="dist"), mesh=mesh)``.
    """
    if shortcut not in SHORTCUTS:
        raise ValueError(f"unknown distributed shortcut {shortcut!r}")
    check_mesh(part, mesh, row_axis, col_axis)
    n_pad, size = part.n_pad, part.shard_size
    capacity = min(capacity, n_pad)
    limit = int(max_iters if max_iters is not None else 2 * int(n_pad).bit_length() + 8)
    axes = _flat_axes(row_axis, col_axis)
    kernel = partial(min_outgoing_2d_packed, segmin=segmin) if pack else min_outgoing_2d
    base = (mesh.axis_index(row_axis) * part.cols + mesh.axis_index(col_axis)) * size
    memo = _BlockMemo()

    def driver(src_row, dst_col, w, eid, valid) -> DistMSFResult:
        refs = (src_row, dst_col, w, eid, valid)
        src_l, dst_l, w_l, eid_l, valid_l = memo.get(
            refs, lambda: local_blocks(refs, mesh, row_axis, col_axis))
        dev = mesh.device
        i = torch.arange(n_pad, dtype=torch.int32, device=dev)
        p_loc = i[base:base + size].clone()
        total = torch.zeros((), dtype=torch.float32, device=dev)
        msf_eids = torch.full((n_pad,), IMAX, dtype=torch.int32, device=dev)
        n_f = it = 0
        while it < limit:
            r = kernel(p_loc, src_l, dst_l, w_l, eid_l, valid_l, n_pad,
                       mesh=mesh, row_axis=row_axis, col_axis=col_axis)
            r_parent = r.payload[0]
            hooked = r.w < INF
            # Post-hook parent of any *root* j is r_parent[j] if hooked else
            # j: derivable from the replicated reduction alone (stars).
            tgt = r_parent.clamp(0, n_pad - 1).long()
            tgt_parent = torch.where(hooked[tgt], r_parent[tgt], tgt.to(torch.int32))
            t = hooked & (i < r_parent) & (tgt_parent == i)
            keep = hooked & ~t
            total = total + torch.where(keep, r.w, 0.0).sum()
            # Record MSF edges (replicated bookkeeping) in cumsum order:
            # the hooked roots ascending. One host read per round.
            ids = keep.nonzero().squeeze(1).to(torch.int32)
            n_changed = ids.numel()
            msf_eids[n_f:n_f + n_changed] = r.eid[ids]
            n_f += n_changed
            it += 1
            if n_changed == 0:  # no root hooked: the forest is complete
                break
            # Apply hooks to the local shard, then shortcut.
            keep_loc = keep[base:base + size]
            p_hooked = torch.where(keep_loc, r_parent[base:base + size], p_loc)
            if shortcut != "baseline" and n_changed <= capacity:
                p_loc = _csp_apply(ids, r_parent[ids], p_hooked)
            else:
                # The paper's OS policy: the changed map would not fit the
                # prefetch buffer, so the remote-read loop resolves it.
                p_loc = _baseline_shortcut(p_hooked, mesh, row_axis, col_axis)
        return DistMSFResult(
            weight=total,
            parent=mesh.all_gather(p_loc, axes),
            msf_eids=msf_eids,
            n_msf_edges=torch.tensor(n_f, dtype=torch.int32, device=dev),
            iterations=torch.tensor(it, dtype=torch.int32, device=dev),
        )

    return driver
