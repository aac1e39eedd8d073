"""Graph container of the port (counterpart of ``repro.graphs.structures``).

The canonical representation is a *symmetric* COO edge list: every
undirected edge {u, v} appears twice, as (u, v) and (v, u), sharing one
global edge id ``eid``. Distinct effective weights come from the
lexicographic pair ``(w, eid)`` (``repro_torch.core.semiring``).

``Graph`` holds torch tensors on one device plus the vertex count ``n``.
Constructors take ``device=None``, which means ``"cuda"``: without a
CUDA device they raise instead of moving to the CPU; pass
``device="cpu"`` to run there. Host-side preprocessing (dedupe, CSR,
the scipy oracles) stays numpy.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

IMAX = int(np.iinfo(np.int32).max)


def resolve_device(device=None) -> torch.device:
    """``None`` → ``"cuda"``. A CUDA request without a CUDA device raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def host_array(a) -> np.ndarray:
    """numpy copy of a tensor (from any device), or ``np.asarray`` of anything else."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _canonicalize(parent) -> np.ndarray:
    """Pointer-jump a parent vector to its root fixpoint (host-side)."""
    p = host_array(parent)
    while True:
        gp = p[p]
        if np.array_equal(gp, p):
            return p
        p = gp


@dataclasses.dataclass(frozen=True)
class Graph:
    """Symmetric COO graph: ``src/dst/eid`` int32 [E], ``w`` float32 [E],
    ``valid`` bool [E] (False for padding), all on one device."""

    src: torch.Tensor
    dst: torch.Tensor
    w: torch.Tensor
    eid: torch.Tensor
    valid: torch.Tensor
    n: int

    @property
    def num_directed_edges(self) -> int:
        return int(self.src.shape[0])

    @property
    def device(self) -> torch.device:
        return self.src.device

    def pad_to(self, e_pad: int) -> "Graph":
        e = self.num_directed_edges
        if e_pad < e:
            raise ValueError(f"pad_to({e_pad}) smaller than E={e}")
        pad = e_pad - e

        def _pad(a, fill):
            return torch.cat([a, torch.full((pad,), fill, dtype=a.dtype, device=a.device)])

        return Graph(
            src=_pad(self.src, 0),
            dst=_pad(self.dst, 0),
            w=_pad(self.w, float("inf")),
            eid=_pad(self.eid, IMAX),
            valid=_pad(self.valid, False),
            n=self.n,
        )


def canonical_edges(u, v):
    """Canonical undirected endpoint order: (lo, hi, keep) with lo < hi.

    ``keep`` masks out self-loops. Works on numpy arrays and tensors.
    """
    if isinstance(u, torch.Tensor):
        lo, hi = torch.minimum(u, v), torch.maximum(u, v)
    else:
        lo, hi = np.minimum(u, v), np.maximum(u, v)
    return lo, hi, lo != hi


def edge_keys(lo, hi, n: int) -> np.ndarray:
    """Collision-free int64 key ``lo * n + hi`` for canonical (lo < hi) pairs."""
    lo = np.asarray(lo, np.int64)
    hi = np.asarray(hi, np.int64)
    return lo * np.int64(n) + hi


def dedupe_canonical(lo, hi, w, n: int):
    """Collapse duplicate canonical pairs, keeping the smallest weight
    (ties: smallest original index). Returns host (lo, hi, w) sorted by key."""
    lo = np.asarray(lo, np.int64)
    hi = np.asarray(hi, np.int64)
    w = np.asarray(w, np.float64)
    key = edge_keys(lo, hi, n)
    order = np.lexsort((w, key))
    key, lo, hi, w = key[order], lo[order], hi[order], w[order]
    first = np.ones(len(key), bool)
    first[1:] = key[1:] != key[:-1]
    return lo[first], hi[first], w[first]


def from_arrays(src, dst, w, eid, valid, n: int, *, device=None) -> Graph:
    """``Graph`` from symmetric edge arrays (numpy or tensors), cast to the
    container's dtypes and placed on ``device``."""
    dev = resolve_device(device)

    def _t(a, dtype):
        return torch.as_tensor(host_array(a)).to(device=dev, dtype=dtype).contiguous()

    return Graph(
        src=_t(src, torch.int32),
        dst=_t(dst, torch.int32),
        w=_t(w, torch.float32),
        eid=_t(eid, torch.int32),
        valid=_t(valid, torch.bool),
        n=int(n),
    )


def from_reference(g, *, device=None) -> Graph:
    """Port ``Graph`` from any object with ``.src/.dst/.w/.eid/.valid/.n``
    (duck-typed: e.g. the JAX package's ``Graph``, read through
    ``np.asarray``)."""
    return from_arrays(
        np.asarray(g.src), np.asarray(g.dst), np.asarray(g.w),
        np.asarray(g.eid), np.asarray(g.valid), int(g.n), device=device,
    )


def from_edges(u, v, w, n: int, *, device=None) -> Graph:
    """Build a symmetric ``Graph`` from one direction of each undirected edge.

    Self-loops are dropped; duplicate undirected pairs are collapsed
    (keeping the smallest weight, then smallest original index).
    """
    u = np.asarray(u, np.int64)
    v = np.asarray(v, np.int64)
    w = np.asarray(w, np.float64)
    lo, hi, keep = canonical_edges(u, v)
    lo, hi, w = dedupe_canonical(lo[keep], hi[keep], w[keep], n)
    m = len(lo)
    eid = np.arange(m, dtype=np.int32)
    return from_arrays(
        np.concatenate([lo, hi]),
        np.concatenate([hi, lo]),
        np.concatenate([w, w]).astype(np.float32),
        np.concatenate([eid, eid]),
        np.ones(2 * m, bool),
        n,
        device=device,
    )


def graph_from_canonical(lo, hi, w, eid, valid, n: int, *, device=None) -> Graph:
    """Symmetric ``Graph`` from canonical undirected arrays, preserving the
    caller's eids (unlike :func:`from_edges`, which renumbers)."""
    lo = np.asarray(host_array(lo), np.int32)
    hi = np.asarray(host_array(hi), np.int32)
    w = np.asarray(host_array(w), np.float32)
    eid = np.asarray(host_array(eid), np.int32)
    valid = np.asarray(host_array(valid), bool)
    return from_arrays(
        np.concatenate([lo, hi]),
        np.concatenate([hi, lo]),
        np.concatenate([w, w]),
        np.concatenate([eid, eid]),
        np.concatenate([valid, valid]),
        n,
        device=device,
    )


def to_csr(graph: Graph) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Return host (indptr, indices, weights, eids) CSR views of the valid edges."""
    valid = host_array(graph.valid)
    src, dst = host_array(graph.src)[valid], host_array(graph.dst)[valid]
    w, eid = host_array(graph.w)[valid], host_array(graph.eid)[valid]
    order = np.argsort(src, kind="stable")
    src, dst, w, eid = src[order], dst[order], w[order], eid[order]
    indptr = np.zeros(graph.n + 1, np.int64)
    np.add.at(indptr, src + 1, 1)
    indptr = np.cumsum(indptr)
    return indptr, dst, w, eid


def _host_coo(graph: Graph):
    valid = host_array(graph.valid)
    return tuple(host_array(a)[valid] for a in (graph.src, graph.dst, graph.w))


def nx_free_msf_weight(graph: Graph) -> float:
    """Oracle MSF weight via scipy (the total is unique across all MSFs;
    scipy's tree is float64, so integer weights sum exactly)."""
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csg

    src, dst, w = _host_coo(graph)
    a = sp.coo_matrix((w, (src, dst)), shape=(graph.n, graph.n)).tocsr()
    return float(csg.minimum_spanning_tree(a).sum())


def nx_free_n_components(graph: Graph) -> int:
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csg

    src, dst, _ = _host_coo(graph)
    a = sp.coo_matrix(
        (np.ones(len(src)), (src, dst)), shape=(graph.n, graph.n)
    ).tocsr()
    ncc, _ = csg.connected_components(a, directed=False)
    return int(ncc)
