"""Train / serve steps of every architecture family (counterpart of
``repro.train.steps``).

A train step is forward, backward (``torch.autograd.grad`` over the
parameter tree), the cosine learning rate and AdamW with optional int8
gradient compression. ``params`` maps the reference's names to leaf
tensors that require grad (a model's ``params``: flat for the GNN and
recsys models, nested for the LM); it and the optimizer state are updated
in place and returned. The LM prefill and decode steps take the argmax
token of the logits as int32. Nothing here syncs with the device: the
metrics stay tensors.

On a mesh the LM steps run SPMD: every rank passes the global batch and
its blocks of the parameters and optimizer state (``T.lm_param_specs``);
the gradients come back as this rank's blocks of the whole gradient of
the global mean loss, and the optimizer's global norm counts every
element once.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import GNNConfig, LMConfig, RecsysConfig
from repro_torch.launch.mesh import P, live_axes, reduce_from
from repro_torch.models import gnn as G
from repro_torch.models import recsys as R
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import (
    adamw_update, cosine_lr, tree_leaves, tree_map, tree_unflatten,
)
from repro_torch.optim.compress import compress_with_error_feedback

LR = dict(peak=3e-4, warmup=100, total=10000)


def _apply_opt(params, opt_state, grads, step, *, compress=False, err_state=None,
               mesh=None, specs=None):
    lr = cosine_lr(step, **LR)
    if compress:
        grads, err_state = compress_with_error_feedback(grads, err_state)
    params, opt_state, gnorm = adamw_update(grads, opt_state, params, lr, mesh=mesh,
                                            specs=specs)
    return params, opt_state, gnorm, err_state


def _grads(loss: torch.Tensor, params) -> Dict[str, Any]:
    """d loss / d params, a tree shaped as ``params``; a parameter the loss
    does not reach (GatedGCN's last ``ln_e``) gets zeros, as under
    ``jax.grad``."""
    grads = torch.autograd.grad(loss, tree_leaves(params), allow_unused=True,
                                materialize_grads=True)
    return tree_unflatten(params, iter(grads))


# ---------------------------------------------------------------------------
# LM
# ---------------------------------------------------------------------------

def lm_loss_and_grad(params, tokens, labels, cfg: LMConfig, mesh=None, *,
                     triangle_skip: bool | None = None):
    """Loss and gradients, with ``cfg.grad_accum`` microbatches: each
    microbatch's activations live only for its own forward and backward;
    the gradients are summed in float32 and scaled by 1/k, the losses
    averaged. On a mesh each gradient is then summed over the axes of
    ``T.grad_sum_axes`` (once, after the microbatches)."""
    tskip = cfg.triangle_skip if triangle_skip is None else triangle_skip

    def loss_and_grad(t, l):
        x = T.lm_forward(params, t, cfg, mesh, triangle_skip=tskip)
        loss = T.softmax_xent(x, params["unembed"], l, cfg, mesh)
        return loss.detach(), _grads(loss, params)

    k = cfg.grad_accum
    if k <= 1:
        loss, grads = loss_and_grad(tokens, labels)
        return loss, _sum_partial_grads(grads, cfg, mesh)
    b = tokens.shape[0]
    if b % k:
        raise ValueError(f"batch {b} does not split into {k} microbatches")
    g_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                     params)
    loss_acc = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for t, l in zip(tokens.reshape(k, b // k, -1), labels.reshape(k, b // k, -1)):
        loss, g = loss_and_grad(t, l)
        for a, x in zip(tree_leaves(g_acc), tree_leaves(g)):
            a.add_(x.float())
        loss_acc = loss_acc + loss
    inv = 1.0 / k
    return loss_acc * inv, _sum_partial_grads(tree_map(lambda g: g * inv, g_acc), cfg, mesh)


def _sum_partial_grads(grads, cfg: LMConfig, mesh):
    """Each gradient summed in place over its ``T.grad_sum_axes``."""
    if mesh is None:
        return grads
    axes = T.grad_sum_axes(cfg, mesh)
    flat = [g.contiguous() for g in tree_leaves(grads)]
    for g, ax in zip(flat, tree_leaves(axes), strict=True):
        if ax:
            mesh.all_reduce_(g, "sum", ax)
    return tree_unflatten(grads, iter(flat))


def lm_train_step(params, opt_state, tokens, labels, cfg: LMConfig, mesh=None):
    loss, grads = lm_loss_and_grad(params, tokens, labels, cfg, mesh)
    specs = None if mesh is None else T.lm_param_specs(cfg, mesh)
    params, opt_state, gnorm, _ = _apply_opt(params, opt_state, grads, opt_state.step,
                                             mesh=mesh, specs=specs)
    return params, opt_state, {"loss": loss, "gnorm": gnorm}


def lm_prefill_step(params, tokens, cfg: LMConfig, mesh=None):
    logits, cache = T.lm_prefill(params, tokens, cfg, mesh)
    return torch.argmax(logits, dim=-1).to(torch.int32), cache


def lm_decode_step(params, token, cache, pos, cfg: LMConfig, mesh=None):
    logits, cache = T.lm_decode_step(params, token, cache, pos, cfg, mesh)
    return torch.argmax(logits, dim=-1).to(torch.int32), cache


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

def recsys_specs(params, mesh) -> Dict[str, P]:
    """The layout of an xDeepFM or retrieval tree on ``mesh``: the tables
    split by rows over ``model``, the candidates over every axis, the rest
    whole on every rank."""
    split = {"table": P(T.MODEL, None), "lin_table": P(T.MODEL, None),
             "items": P(tuple(mesh.axis_names), None)}
    return {k: split.get(k, P()) for k in params}


def recsys_train_step(params, opt_state, ids, labels, cfg: RecsysConfig, mesh=None):
    """On a mesh ``ids``/``labels`` are this rank's rows of the batch,
    split over the data axes: the loss is the global mean, and every
    gradient is summed over the data axes (the dense part runs alike on
    every ``model`` rank)."""
    loss = R.xdeepfm_loss(params, ids, labels, cfg, mesh)
    specs, dp = None, ()
    if mesh is not None:
        specs, dp = recsys_specs(params, mesh), live_axes(mesh, T.DP_AXES)
    if dp:  # each data rank's share of the global mean, summed
        loss = reduce_from(loss / mesh.axis_size(dp), mesh, dp)
    grads = _grads(loss, params)
    if dp:
        for g in tree_leaves(grads):
            mesh.all_reduce_(g, "sum", dp)
    params, opt_state, gnorm, _ = _apply_opt(params, opt_state, grads, opt_state.step,
                                             mesh=mesh, specs=specs)
    return params, opt_state, {"loss": loss.detach(), "gnorm": gnorm}


@torch.no_grad()
def recsys_serve_step(params, ids, cfg: RecsysConfig, mesh=None):
    return torch.sigmoid(R.xdeepfm_logits(params, ids, cfg, mesh))


@torch.no_grad()
def recsys_retrieval_step(params, ids, cfg: RecsysConfig, k: int = 100, mesh=None):
    return R.retrieval_topk(params, ids, cfg, k=k, mesh=mesh)
