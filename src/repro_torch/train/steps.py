"""Train / serve steps of the GNN and recsys families (counterpart of the
GNN and recsys half of ``repro.train.steps``; the LM steps are not ported
yet).

A train step is forward, backward (``torch.autograd.grad`` over the
parameter dict), the cosine learning rate and AdamW with optional int8
gradient compression. ``params`` maps the reference's names to leaf
tensors that require grad (a model's ``params``); it and the optimizer
state are updated in place and returned. Nothing here syncs with the device: the metrics stay tensors.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import GNNConfig, RecsysConfig
from repro_torch.models import gnn as G
from repro_torch.models import recsys as R
from repro_torch.optim.adamw import adamw_update, cosine_lr
from repro_torch.optim.compress import compress_with_error_feedback

LR = dict(peak=3e-4, warmup=100, total=10000)


def _apply_opt(params, opt_state, grads, step, *, compress=False, err_state=None):
    lr = cosine_lr(step, **LR)
    if compress:
        grads, err_state = compress_with_error_feedback(grads, err_state)
    params, opt_state, gnorm = adamw_update(grads, opt_state, params, lr)
    return params, opt_state, gnorm, err_state


def _grads(loss: torch.Tensor, params) -> Dict[str, torch.Tensor]:
    """d loss / d params; a parameter the loss does not reach (GatedGCN's
    last ``ln_e``) gets zeros, as under ``jax.grad``."""
    names = list(params)
    grads = torch.autograd.grad(loss, [params[k] for k in names], allow_unused=True,
                                materialize_grads=True)
    return dict(zip(names, grads))


# ---------------------------------------------------------------------------
# GNN
# ---------------------------------------------------------------------------

def gnn_apply(params, batch: Dict[str, Any], cfg: GNNConfig, n_graphs: int = 1):
    if cfg.kind == "gat":
        return G.apply_gat(params, batch["x"], batch["src"], batch["dst"],
                           batch["edge_valid"], cfg)
    if cfg.kind == "meshgraphnet":
        return G.apply_meshgraphnet(params, batch["x"], batch["e_feat"], batch["src"],
                                    batch["dst"], batch["edge_valid"], cfg)
    if cfg.kind == "gatedgcn":
        return G.apply_gatedgcn(params, batch["x"], batch["e_feat"], batch["src"],
                                batch["dst"], batch["edge_valid"], cfg)
    if cfg.kind == "nequip":
        return G.apply_nequip(params, batch["species"], batch["pos"], batch["src"],
                              batch["dst"], batch["edge_valid"], batch["graph_ids"],
                              n_graphs, cfg)
    raise ValueError(cfg.kind)


def gnn_loss(params, batch, cfg: GNNConfig, n_graphs: int = 1):
    if cfg.kind == "nequip":
        if not cfg.predict_forces:
            energy = gnn_apply(params, batch, cfg, n_graphs)
            return torch.mean((energy - batch["energy"]) ** 2)
        # forces = -dE/dpos inside the loss: a second-order pass, so the
        # parameter gradient flows through the force term too
        pos = batch["pos"].detach().requires_grad_(True)
        energy = gnn_apply(params, dict(batch, pos=pos), cfg, n_graphs)
        forces = -torch.autograd.grad(energy.sum(), pos, create_graph=True)[0]
        return (torch.mean((energy - batch["energy"]) ** 2)
                + torch.mean((forces - batch["forces"]) ** 2))
    out = gnn_apply(params, batch, cfg)
    mask = batch.get("node_mask")
    if cfg.n_classes:
        logp = F.log_softmax(out.float(), dim=-1)
        nll = -torch.gather(logp, -1, batch["labels"].long()[:, None])[:, 0]
        if mask is not None:
            return torch.sum(nll * mask) / torch.clamp(mask.sum(), min=1)
        return torch.mean(nll)
    err = (out - batch["targets"]) ** 2
    if mask is not None:
        return torch.sum(err * mask[:, None]) / torch.clamp(mask.sum() * err.shape[-1], min=1)
    return torch.mean(err)


def gnn_train_step(params, opt_state, batch, cfg: GNNConfig, n_graphs: int = 1):
    loss = gnn_loss(params, batch, cfg, n_graphs)
    grads = _grads(loss, params)
    params, opt_state, gnorm, _ = _apply_opt(params, opt_state, grads, opt_state.step)
    return params, opt_state, {"loss": loss.detach(), "gnorm": gnorm}


# ---------------------------------------------------------------------------
# recsys
# ---------------------------------------------------------------------------

def recsys_train_step(params, opt_state, ids, labels, cfg: RecsysConfig):
    loss = R.xdeepfm_loss(params, ids, labels, cfg)
    grads = _grads(loss, params)
    params, opt_state, gnorm, _ = _apply_opt(params, opt_state, grads, opt_state.step)
    return params, opt_state, {"loss": loss.detach(), "gnorm": gnorm}


@torch.no_grad()
def recsys_serve_step(params, ids, cfg: RecsysConfig):
    return torch.sigmoid(R.xdeepfm_logits(params, ids, cfg))


@torch.no_grad()
def recsys_retrieval_step(params, ids, cfg: RecsysConfig, k: int = 100):
    return R.retrieval_topk(params, ids, cfg, k=k)
