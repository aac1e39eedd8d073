"""AdamW with global-norm clipping and fp32 statistics (counterpart of
``repro.optim.adamw``).

A parameter tree here is a dict of tensors keyed by the reference's
parameter names, flat (the GNN and recsys models) or nested (the LM's
``layers``); its leaves are taken in sorted key order at every level, the
order ``jax.tree.leaves`` gives a dict, and ``mu``/``nu`` nest as the
parameters do. The update runs in place under
``torch.no_grad()``, a bounded chunk at a time, so a 1.2·10⁹-element
embedding table needs no full-size temporaries. ``torch.optim.AdamW`` is
not this update: it has no global-norm clip and applies the learning rate
and the decay in another order.

On a mesh a tree holds this rank's blocks of every leaf, and ``specs``
(a tree of :class:`repro_torch.launch.mesh.P`) names the axes each leaf is
split over: the global norm sums the squares of each split leaf over its
axes and counts each replicated leaf once, so the clip is the one the
whole tree would get.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Iterator, NamedTuple

import torch

from repro_torch.launch.mesh import live_axes

# Elements per elementwise pass: bounds each temporary at 256 MiB of float32.
CHUNK = 1 << 26


class AdamWState(NamedTuple):
    mu: Any  # a tree of float32 tensors shaped as the parameters
    nu: Any
    step: torch.Tensor  # int32 scalar, the checkpoint's ``['o'].step``


def tree_leaves(tree) -> list:
    """The leaves of a (nested) dict in sorted key order at every level."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(tree_leaves(v) if isinstance(v, dict) else [v])
    return out


def tree_map(fn: Callable, tree):
    """``tree``'s structure with ``fn`` applied to every leaf."""
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def tree_unflatten(tree, leaves: Iterator):
    """``tree``'s structure with its leaves drawn in ``tree_leaves`` order
    from ``leaves``."""
    return {k: tree_unflatten(tree[k], leaves) if isinstance(tree[k], dict) else next(leaves)
            for k in sorted(tree)}


def adamw_init(params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return AdamWState(
        mu=tree_map(zeros, params),
        nu=tree_map(zeros, params),
        step=torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device),
    )


def _chunks(t: torch.Tensor) -> Iterator[torch.Tensor]:
    """Flat views of the contiguous ``t``, at most ``CHUNK`` elements each:
    writes to them land in ``t``."""
    flat = t.view(-1)
    for lo in range(0, max(flat.numel(), 1), CHUNK):
        yield flat[lo:lo + CHUNK]


@torch.no_grad()
def global_norm(tree, *, mesh=None, specs=None) -> torch.Tensor:
    """The 2-norm of every element of ``tree``; on a mesh, of the whole
    tree of which ``tree`` holds this rank's blocks under ``specs``."""
    spec_leaves = tree_leaves(specs) if specs is not None else [None] * len(tree_leaves(tree))
    by_axes: dict = {}  # split axes -> sum of squares of the leaves split over them
    for leaf, spec in zip(tree_leaves(tree), spec_leaves, strict=True):
        axes = live_axes(mesh, spec.axes()) if spec is not None else ()
        x = leaf.float().contiguous()
        for c in _chunks(x):
            by_axes[axes] = by_axes.get(axes, 0) + torch.sum(torch.square(c))
    total = 0
    for axes, sq in by_axes.items():
        total = total + (mesh.all_reduce(sq, "sum", axes) if axes else sq)
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(
    grads,
    state: AdamWState,
    params,
    lr: torch.Tensor,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: float = 1.0,
    mesh=None,
    specs=None,
):
    """One step: ``params`` and ``state.mu``/``state.nu`` change in place and
    are returned with the new step and the gradients' global norm (on a
    mesh, of the whole gradient tree: ``specs`` as in :func:`global_norm`)."""
    gnorm = global_norm(grads, mesh=mesh, specs=specs)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    bc1 = 1 - torch.pow(b1, step.float())
    bc2 = 1 - torch.pow(b2, step.float())

    leaves = zip(*(tree_leaves(t) for t in (params, grads, state.mu, state.nu)), strict=True)
    for p, g, mu, nu in leaves:
        pieces = zip(_chunks(p), _chunks(g.contiguous()), _chunks(mu), _chunks(nu))
        for pc, gc, mc, nc in pieces:
            gs = gc.float() * scale
            mc.copy_(b1 * mc + (1 - b1) * gs)
            nc.copy_(b2 * nc + (1 - b2) * gs * gs)
            u = (mc / bc1) / (torch.sqrt(nc / bc2) + eps)
            p32 = pc.float()
            pc.copy_(p32 - lr * (u + weight_decay * p32))
    return params, AdamWState(mu=state.mu, nu=state.nu, step=step), gnorm


def cosine_lr(step: torch.Tensor, *, peak: float, warmup: int, total: int,
              floor_frac: float = 0.1) -> torch.Tensor:
    s = step.float()
    warm = peak * s / max(warmup, 1)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak * (floor_frac + (1 - floor_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(s < warmup, warm, cos)
