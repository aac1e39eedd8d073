"""xDeepFM (CIN + DNN + linear) over one flat embedding table, and
one-query retrieval (counterpart of ``repro.models.recsys``).

The lookup is a gather from a flat offset-indexed table with its ids
clipped into range, as the reference's ``jnp.take(mode="clip")``: a
corrupt id never poisons a step, and on the card it never device-asserts.
Multi-hot bags are the same gather plus a segment sum. Retrieval scores one
query against every candidate and keeps the top k.

On a :class:`~repro_torch.launch.mesh.Mesh` (``mesh=``) the embedding
tables are split by rows over ``model`` (the reference's
``P("model", None)``): a rank looks up the ids that fall in its rows,
zeroes the others and the ranks' rows are summed over ``model``
(``reduce_from``), so every rank holds the whole lookup of its ids. The
ids are the rank's rows of the batch (the caller splits it over the data
axes). Retrieval's candidates are split over every axis: a rank keeps the
top k of its block and the blocks' winners are gathered and cut to k.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import RecsysConfig
from repro_torch.launch.mesh import live_axes, reduce_from
from repro_torch.models.gnn import Init, ParamModel, Params, segment_sum


def field_offsets(cfg: RecsysConfig) -> np.ndarray:
    """Per-field row offsets into the single flat embedding table. Field
    vocab sizes follow a Criteo-like power-law split of total_vocab; the
    largest field absorbs rounding so offsets+sizes never exceed the table."""
    raw = np.logspace(0, 6, cfg.n_sparse)
    sizes = np.maximum((raw / raw.sum() * cfg.total_vocab).astype(np.int64), 4)
    overflow = sizes.sum() - cfg.total_vocab
    if overflow > 0:
        sizes[-1] -= overflow
        assert sizes[-1] >= 4, "total_vocab too small for n_sparse fields"
    return np.concatenate([[0], np.cumsum(sizes)])[:-1], sizes


class XDeepFM(ParamModel):
    def forward(self, ids):
        return xdeepfm_logits(self.params, ids, self.cfg)


def init_xdeepfm(cfg: RecsysConfig, generator=None, device=None) -> XDeepFM:
    init = Init(generator, device)
    f, d = cfg.n_sparse, cfg.embed_dim
    params: Dict[str, torch.Tensor] = {
        "table": init.normal((cfg.total_vocab, d), 0.01),
        "lin_table": init.normal((cfg.total_vocab, 1), 0.01),
        "bias": init.zeros(()),
    }
    h_prev = f
    for i, h in enumerate(cfg.cin_layers):
        params[f"cin_w{i}"] = init.normal((h_prev, f, h), math.sqrt(2.0 / (h_prev * f)))
        h_prev = h
    params["cin_out"] = init.normal((sum(cfg.cin_layers), 1), 0.1)
    dims = [f * d] + list(cfg.mlp_layers) + [1]
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        params[f"mlp_w{i}"] = init.normal((a, b), math.sqrt(2.0 / a))
        params[f"mlp_b{i}"] = init.zeros((b,))
    return XDeepFM(cfg, params)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """ids [B, F] (absolute row ids, clipped into the table) → [B, F, d]."""
    return F.embedding(ids.clamp(0, table.shape[0] - 1).long(), table)


def embedding_bag_sharded(block: torch.Tensor, ids: torch.Tensor, mesh) -> torch.Tensor:
    """ids [B, F] (absolute row ids, clipped into the whole table) → [B, F, d]
    from ``block``, this rank's rows of a table split over ``model``: the
    rows of other ranks are zero here and the sum over ``model`` fills
    them in. Without a live ``model`` axis, :func:`embedding_bag`."""
    axes = live_axes(mesh, "model")
    if not axes:
        return embedding_bag(block, ids)
    v = block.shape[0]
    rel = ids.clamp(0, v * mesh.axis_size(axes) - 1).long() - mesh.axis_index(axes) * v
    inside = (rel >= 0) & (rel < v)
    rows = F.embedding(rel.clamp(0, v - 1), block)
    return reduce_from(torch.where(inside[..., None], rows, 0.0), mesh, axes)


def embedding_bag_multihot(table: torch.Tensor, flat_ids: torch.Tensor, bag_ids: torch.Tensor,
                           n_bags: int) -> torch.Tensor:
    """EmbeddingBag(sum) over arbitrary bag ids in [0, n_bags): gather +
    segment sum."""
    return segment_sum(embedding_bag(table, flat_ids), bag_ids, n_bags)


def _cin(params: Params, x0: torch.Tensor, cfg: RecsysConfig) -> torch.Tensor:
    """Compressed Interaction Network. x0 [B, F, D]."""
    xk = x0
    pooled = []
    for i in range(len(cfg.cin_layers)):
        # outer product along field dims, compressed by conv weights
        z = torch.einsum("bhd,bmd->bhmd", xk, x0)  # [B, Hk, F, D]
        xk = torch.einsum("bhmd,hmn->bnd", z, params[f"cin_w{i}"])  # [B, H, D]
        pooled.append(xk.sum(-1))  # [B, H]
    p = torch.cat(pooled, dim=-1)  # [B, sum(H)]
    return p @ params["cin_out"]  # [B, 1]


def xdeepfm_logits(params: Params, ids: torch.Tensor, cfg: RecsysConfig,
                   mesh=None) -> torch.Tensor:
    """ids [B, F] absolute row indices → logits [B]."""
    emb = embedding_bag_sharded(params["table"], ids, mesh)  # [B, F, D]
    lin = embedding_bag_sharded(params["lin_table"], ids, mesh)[..., 0].sum(-1)  # [B]
    cin = _cin(params, emb, cfg)[..., 0]
    h = emb.reshape(emb.shape[0], -1)
    n_mlp = len(cfg.mlp_layers) + 1
    for i in range(n_mlp):
        h = h @ params[f"mlp_w{i}"] + params[f"mlp_b{i}"]
        if i < n_mlp - 1:
            h = F.relu(h)
    return lin + cin + h[..., 0] + params["bias"]


def xdeepfm_loss(params: Params, ids, labels, cfg: RecsysConfig, mesh=None) -> torch.Tensor:
    logits = xdeepfm_logits(params, ids, cfg, mesh)
    return torch.mean(
        torch.clamp(logits, min=0) - logits * labels + torch.log1p(torch.exp(-torch.abs(logits)))
    )


# ---------------------------------------------------------------------------
# retrieval: 1 query vs n_candidates, batched dot + top-k
# ---------------------------------------------------------------------------

class Retrieval(ParamModel):
    def forward(self, ids, k: int = 100):
        return retrieval_topk(self.params, ids, self.cfg, k=k)


def init_retrieval(cfg: RecsysConfig, n_candidates: int, generator=None,
                   device=None) -> Retrieval:
    init = Init(generator, device)
    f, d, r = cfg.n_sparse, cfg.embed_dim, cfg.retrieval_dim
    return Retrieval(cfg, {
        "table": init.normal((cfg.total_vocab, d), 0.01),
        "tower_w": init.normal((f * d, r), math.sqrt(2.0 / (f * d))),
        "items": init.normal((n_candidates, r), 0.1),
    })


def retrieval_topk(params: Params, ids: torch.Tensor, cfg: RecsysConfig, k: int = 100,
                   mesh=None):
    """ids [B, F] (user features) → (scores [B, k], indices [B, k]), scores
    descending. The order among equal scores is not part of the contract
    (``torch.topk`` on the card promises none). On a mesh ``items`` is this
    rank's block of the candidates split over every axis."""
    emb = embedding_bag_sharded(params["table"], ids, mesh).reshape(ids.shape[0], -1)
    u = emb @ params["tower_w"]  # [B, r]
    items = params["items"]
    scores = u @ items.T  # [B, this rank's candidates]
    axes = () if mesh is None else live_axes(mesh, mesh.axis_names)
    if not axes:
        return torch.topk(scores, k)
    vals, idx = torch.topk(scores, min(k, scores.shape[1]))
    idx = idx + mesh.axis_index(axes) * items.shape[0]
    vals, idx = mesh.gather_dim(vals, axes, 1), mesh.gather_dim(idx, axes, 1)
    top, j = torch.topk(vals, k)
    return top, torch.gather(idx, 1, j)
