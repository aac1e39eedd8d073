"""Edge/vertex partitioning for the distributed MSF engine (paper §IV-A),
counterpart of ``repro.graphs.partition``.

Vertex layout: n is padded to a multiple of R*C shards of size S; shard
k = r*C + s lives on rank (r, s); global vertex v belongs to shard
``v // S``. Row block r (the paper's x^(r)) is the *contiguous* range
[r*C*S, (r+1)*C*S) — an all-gather of the shards of ranks (r, :).
Column block s (y^(s)) is the strided shard set {k : k % C == s}, i.e. an
all-gather over ranks (:, s); the local offset of v inside it is
(v // S // C) * S + v % S.

Edge (u, v) is assigned to rank (row_of(u), col_of(v)) — the 2D √p×√p
distribution of A from the paper's Fig 2. Per-rank edge lists are padded
to the global max, so every rank holds a block of one shape.

The partition is host numpy, as in the reference, array for array: every
rank of a ``torch.distributed`` grid holds the same ``Partition2D`` and
moves only its own block ``[r, s]`` to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.graphs.structures import host_array


@dataclasses.dataclass(frozen=True)
class Partition2D:
    """Host-side partition result; arrays are [R, C, Emax]."""

    src_row: np.ndarray  # int32 — src offset within the rank's row block
    dst_col: np.ndarray  # int32 — dst offset within the rank's column block
    w: np.ndarray  # float32
    eid: np.ndarray  # int32
    valid: np.ndarray  # bool
    rows: int
    cols: int
    shard_size: int
    n: int
    n_pad: int

    @property
    def e_max(self) -> int:
        return int(self.src_row.shape[-1])


def pad_n(n: int, rows: int, cols: int) -> Tuple[int, int]:
    p = rows * cols
    shard = -(-n // p)
    return shard * p, shard


def partition_edges_2d(graph, rows: int, cols: int) -> Partition2D:
    """2D-partition a graph (the port's ``Graph``, or anything with
    ``src/dst/w/eid/valid/n`` arrays) over an R×C grid."""
    n_pad, S = pad_n(graph.n, rows, cols)
    src = host_array(graph.src).astype(np.int64)
    dst = host_array(graph.dst).astype(np.int64)
    w = host_array(graph.w)
    eid = host_array(graph.eid)
    valid = host_array(graph.valid)
    src, dst, w, eid = src[valid], dst[valid], w[valid], eid[valid]

    shard_of_src = src // S
    shard_of_dst = dst // S
    r = shard_of_src // cols
    s = shard_of_dst % cols
    dev = r * cols + s
    counts = np.bincount(dev, minlength=rows * cols)
    e_max = max(1, int(counts.max()))

    src_row = np.zeros((rows, cols, e_max), np.int32)
    dst_col = np.zeros((rows, cols, e_max), np.int32)
    w_out = np.full((rows, cols, e_max), np.inf, np.float32)
    eid_out = np.full((rows, cols, e_max), np.iinfo(np.int32).max, np.int32)
    valid_out = np.zeros((rows, cols, e_max), bool)

    order = np.argsort(dev, kind="stable")
    src, dst, w, eid, dev = src[order], dst[order], w[order], eid[order], dev[order]
    # Local offsets.
    row_off = src - (src // (cols * S)) * (cols * S)
    col_off = (dst // S // cols) * S + dst % S
    starts = np.concatenate([[0], np.cumsum(counts)])
    for d in range(rows * cols):
        lo, hi = starts[d], starts[d + 1]
        k = hi - lo
        rr, ss = d // cols, d % cols
        src_row[rr, ss, :k] = row_off[lo:hi]
        dst_col[rr, ss, :k] = col_off[lo:hi]
        w_out[rr, ss, :k] = w[lo:hi]
        eid_out[rr, ss, :k] = eid[lo:hi]
        valid_out[rr, ss, :k] = True

    return Partition2D(
        src_row=src_row,
        dst_col=dst_col,
        w=w_out,
        eid=eid_out,
        valid=valid_out,
        rows=rows,
        cols=cols,
        shard_size=S,
        n=int(graph.n),
        n_pad=n_pad,
    )


def block_global_ids(src_row, dst_col, shard_size: int):
    """Recover **global** vertex ids from a :class:`Partition2D`'s local
    offsets — [R, C, Emax] arrays in, int32 [R, C, Emax] arrays out.

    Inverse of the layout in the module docstring: row block r is the
    contiguous range [r*C*S, (r+1)*C*S), so a row offset o decodes as
    ``r*C*S + o``; column block s is the strided shard set {k : k % C == s},
    so a column offset o sits in shard ``(o // S)*C + s`` at element
    ``o % S``. The distributed coarsening levels key edges globally (the
    per-level relabeling breaks the block alignment), so this is their
    one-time re-keying at level entry. Works on numpy arrays and torch
    tensors alike (elementwise arithmetic and broadcasting only).
    """
    rows, cols = src_row.shape[0], src_row.shape[1]
    if isinstance(src_row, torch.Tensor):
        dev = src_row.device
        r = torch.arange(rows, dtype=torch.int32, device=dev)[:, None, None]
        s = torch.arange(cols, dtype=torch.int32, device=dev)[None, :, None]
        src_i, dst_i = src_row.to(torch.int32), dst_col.to(torch.int32)
    else:
        r = np.arange(rows, dtype=np.int32)[:, None, None]
        s = np.arange(cols, dtype=np.int32)[None, :, None]
        src_i, dst_i = src_row.astype(np.int32), dst_col.astype(np.int32)
    src_g = r * (cols * shard_size) + src_i
    dst_g = (dst_i // shard_size * cols + s) * shard_size + dst_i % shard_size
    return src_g, dst_g


def partition_edges_1d(graph, parts: int) -> dict:
    """1D (flat) edge partition — the simpler distribution used by the GNN
    full-graph path and as an MSF ablation. Host numpy arrays [parts, Emax]."""
    valid = host_array(graph.valid)
    idx = np.nonzero(valid)[0]
    e = len(idx)
    e_max = -(-e // parts)
    out = {}
    for name, arr, fill in [
        ("src", graph.src, 0),
        ("dst", graph.dst, 0),
        ("w", graph.w, np.float32(np.inf)),
        ("eid", graph.eid, np.iinfo(np.int32).max),
    ]:
        a = host_array(arr)[idx]
        padded = np.full(parts * e_max, fill, a.dtype)
        padded[:e] = a
        out[name] = padded.reshape(parts, e_max)
    v = np.zeros(parts * e_max, bool)
    v[:e] = True
    out["valid"] = v.reshape(parts, e_max)
    return out
