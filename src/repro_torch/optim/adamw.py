"""AdamW with global-norm clipping and fp32 statistics (counterpart of
``repro.optim.adamw``).

A parameter tree here is a flat dict of tensors keyed by the reference's
parameter names; its leaves are taken in sorted key order, the order
``jax.tree.leaves`` gives a dict. The update runs in place under
``torch.no_grad()``, a bounded chunk at a time, so a 1.2·10⁹-element
embedding table needs no full-size temporaries. ``torch.optim.AdamW`` is
not this update: it has no global-norm clip and applies the learning rate
and the decay in another order.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, NamedTuple

import torch

# Elements per elementwise pass: bounds each temporary at 256 MiB of float32.
CHUNK = 1 << 26


class AdamWState(NamedTuple):
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    step: torch.Tensor  # int32 scalar, the checkpoint's ``['o'].step``


def adamw_init(params) -> AdamWState:
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()}
    some = next(iter(params.values()))
    return AdamWState(
        mu=zeros,
        nu={k: torch.zeros_like(z) for k, z in zeros.items()},
        step=torch.zeros((), dtype=torch.int32, device=some.device),
    )


def _chunks(t: torch.Tensor) -> Iterator[torch.Tensor]:
    """Flat views of the contiguous ``t``, at most ``CHUNK`` elements each:
    writes to them land in ``t``."""
    flat = t.view(-1)
    for lo in range(0, max(flat.numel(), 1), CHUNK):
        yield flat[lo:lo + CHUNK]


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    total = 0
    for k in sorted(tree):
        x = tree[k].float().contiguous()
        for c in _chunks(x):
            total = total + torch.sum(torch.square(c))
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
):
    """One step: ``params`` and ``state.mu``/``state.nu`` change in place and
    are returned with the new step and the gradients' global norm."""
    gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    bc1 = 1 - torch.pow(b1, step.float())
    bc2 = 1 - torch.pow(b2, step.float())

    for k in sorted(params):
        p, g = params[k], grads[k].contiguous()
        pieces = zip(_chunks(p), _chunks(g), _chunks(state.mu[k]), _chunks(state.nu[k]))
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
