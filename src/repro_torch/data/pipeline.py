"""Deterministic, step-keyed synthetic data pipelines (a numpy copy of the
reference's ``data/pipeline.py``: the same seed and step give bit-identical
batches in both packages).

Every source is a pure function of (seed, step) — no iterator state — so a
restart from checkpoint step k replays exactly the batches the crashed run
would have seen (fault-tolerance requirement, DESIGN.md §5). Each source
plants learnable structure so end-to-end training demonstrably reduces
loss:

- LM: order-1 Markov chain over the vocab (learnable bigram statistics).
- Recsys: logistic ground-truth model over field embeddings.
- Molecules: pairwise Morse-like potential energies.
- GNN: feature-correlated node labels on a fixed graph.
"""
from __future__ import annotations

import numpy as np


class LMBatchSource:
    def __init__(self, vocab: int, seq_len: int, batch: int, seed: int = 0, order: int = 1):
        self.vocab, self.seq_len, self.batch = vocab, seq_len, batch
        rng = np.random.default_rng(seed)
        # sparse-ish transition matrix: each token has ~8 likely successors
        k = min(8, vocab)
        self.succ = rng.integers(0, vocab, size=(vocab, k))
        self.seed = seed

    def batch_at(self, step: int):
        rng = np.random.default_rng((self.seed, step))
        toks = np.zeros((self.batch, self.seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, self.batch)
        choices = rng.integers(0, self.succ.shape[1], (self.batch, self.seq_len))
        noise = rng.random((self.batch, self.seq_len)) < 0.1
        rand_tok = rng.integers(0, self.vocab, (self.batch, self.seq_len))
        for t in range(self.seq_len):
            nxt = self.succ[toks[:, t], choices[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], rand_tok[:, t], nxt)
        return toks[:, :-1], toks[:, 1:]


class RecsysBatchSource:
    def __init__(self, offsets: np.ndarray, sizes: np.ndarray, batch: int, seed: int = 0):
        self.offsets, self.sizes, self.batch = offsets, sizes, batch
        rng = np.random.default_rng(seed)
        self.true_w = {  # planted per-field value weights (hashed)
            "a": rng.standard_normal(len(offsets)),
            "b": rng.standard_normal(1024),
        }
        self.seed = seed

    def batch_at(self, step: int):
        rng = np.random.default_rng((self.seed, step, 1))
        f = len(self.offsets)
        vals = (rng.pareto(1.2, size=(self.batch, f)) * 3).astype(np.int64) % self.sizes
        ids = (self.offsets[None, :] + vals).astype(np.int32)
        logit = (self.true_w["b"][ids.astype(np.int64) % 1024] * self.true_w["a"][None, :]).sum(-1)
        labels = (rng.random(self.batch) < 1 / (1 + np.exp(-logit))).astype(np.float32)
        return ids, labels


class MoleculeBatchSource:
    def __init__(self, n_atoms: int, n_edges: int, batch: int, n_species: int = 4,
                 cutoff: float = 5.0, seed: int = 0):
        self.n_atoms, self.n_edges, self.batch = n_atoms, n_edges, batch
        self.n_species, self.cutoff, self.seed = n_species, cutoff, seed
        rng = np.random.default_rng(seed)
        self.pair_eps = rng.uniform(0.5, 1.5, (n_species, n_species))
        self.pair_eps = (self.pair_eps + self.pair_eps.T) / 2

    def batch_at(self, step: int):
        rng = np.random.default_rng((self.seed, step, 2))
        b, na = self.batch, self.n_atoms
        species = rng.integers(0, self.n_species, (b, na)).astype(np.int32)
        pos = rng.standard_normal((b, na, 3)).astype(np.float32) * 1.5
        # radius-graph edges, padded to n_edges per molecule
        src = np.zeros((b, self.n_edges), np.int32)
        dst = np.zeros((b, self.n_edges), np.int32)
        valid = np.zeros((b, self.n_edges), bool)
        energy = np.zeros(b, np.float32)
        for g in range(b):
            d = np.linalg.norm(pos[g][:, None] - pos[g][None, :], axis=-1)
            iu, ju = np.nonzero((d < self.cutoff) & (d > 0))
            k = min(len(iu), self.n_edges)
            sel = rng.permutation(len(iu))[:k]
            src[g, :k], dst[g, :k] = iu[sel], ju[sel]
            valid[g, :k] = True
            eps = self.pair_eps[species[g][iu], species[g][ju]]
            r = d[iu, ju]
            energy[g] = 0.5 * np.sum(eps * (np.exp(-2 * (r - 1)) - 2 * np.exp(-(r - 1))))
        # flatten into one batched graph with offsets
        off = (np.arange(b) * na)[:, None]
        flat = dict(
            species=species.reshape(-1),
            pos=pos.reshape(-1, 3),
            src=(src + off).reshape(-1),
            dst=(dst + off).reshape(-1),
            edge_valid=valid.reshape(-1),
            graph_ids=np.repeat(np.arange(b, dtype=np.int32), na),
            energy=energy,
        )
        return flat


def make_planted_graph_task(n: int, m: int, d_feat: int, n_classes: int, seed: int = 0):
    """Fixed graph + features whose labels depend on neighborhood features —
    learnable by one round of message passing."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    x = rng.standard_normal((n, d_feat)).astype(np.float32)
    w_true = rng.standard_normal((d_feat, n_classes))
    # label from own + mean-neighbor features
    agg = np.zeros((n, d_feat), np.float32)
    np.add.at(agg, dst, x[src])
    deg = np.maximum(np.bincount(dst, minlength=n), 1)[:, None]
    labels = np.argmax((x + agg / deg) @ w_true, axis=-1).astype(np.int32)
    return dict(
        src=src, dst=dst, edge_valid=np.ones(m, bool), x=x, labels=labels
    )
