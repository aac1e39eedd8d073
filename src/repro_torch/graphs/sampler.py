"""CSR neighbor sampler for minibatch GNN training (GraphSAGE-style; a numpy
copy of the reference's ``graphs/sampler.py``, not exported from
``repro_torch.graphs``).

Host-side (numpy): given seed nodes and per-hop fanouts, samples a k-hop
neighborhood, relabels it into a compact padded subgraph, and returns
static-shape arrays suitable for a jitted train step. The GNN model then
runs *all* of its layers on the induced subgraph with the loss taken on the
seed nodes (standard practice for deep GNNs under fanout sampling).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SampledSubgraph:
    """Padded, relabelled subgraph. Seeds occupy node slots [0, n_seeds)."""

    src: np.ndarray  # int32 [E_pad]
    dst: np.ndarray  # int32 [E_pad]
    edge_valid: np.ndarray  # bool [E_pad]
    node_ids: np.ndarray  # int32 [N_pad] — original ids, -1 for padding
    node_valid: np.ndarray  # bool [N_pad]
    n_seeds: int


def max_sample_sizes(batch_nodes: int, fanouts: Sequence[int]) -> Tuple[int, int]:
    """Static (N_pad, E_pad) upper bounds for a fanout schedule."""
    n = batch_nodes
    e = 0
    frontier = batch_nodes
    for f in fanouts:
        e += frontier * f
        frontier = frontier * f
        n += frontier
    return n, e


class NeighborSampler:
    def __init__(self, indptr: np.ndarray, indices: np.ndarray, seed: int = 0):
        self.indptr = indptr
        self.indices = indices
        self.rng = np.random.default_rng(seed)

    def sample(
        self, seeds: np.ndarray, fanouts: Sequence[int]
    ) -> SampledSubgraph:
        seeds = np.asarray(seeds, np.int64)
        n_pad, e_pad = max_sample_sizes(len(seeds), fanouts)
        srcs, dsts = [], []
        nodes = list(seeds)
        pos = {int(v): k for k, v in enumerate(seeds)}
        frontier = seeds
        for f in fanouts:
            next_frontier = []
            for u in frontier:
                lo, hi = self.indptr[u], self.indptr[u + 1]
                deg = hi - lo
                if deg == 0:
                    continue
                take = min(f, deg)
                sel = self.rng.choice(deg, size=take, replace=False) + lo
                for v in self.indices[sel]:
                    v = int(v)
                    if v not in pos:
                        pos[v] = len(nodes)
                        nodes.append(v)
                        next_frontier.append(v)
                    # message flows v -> u (aggregate neighbors into u)
                    srcs.append(pos[v])
                    dsts.append(pos[int(u)])
            frontier = np.array(next_frontier, np.int64)
            if len(frontier) == 0:
                break

        n, e = len(nodes), len(srcs)
        out_src = np.zeros(e_pad, np.int32)
        out_dst = np.zeros(e_pad, np.int32)
        ev = np.zeros(e_pad, bool)
        out_src[:e] = srcs
        out_dst[:e] = dsts
        ev[:e] = True
        node_ids = np.full(n_pad, -1, np.int32)
        node_ids[:n] = nodes
        nv = np.zeros(n_pad, bool)
        nv[:n] = True
        return SampledSubgraph(
            src=out_src,
            dst=out_dst,
            edge_valid=ev,
            node_ids=node_ids,
            node_valid=nv,
            n_seeds=len(seeds),
        )
