"""int8 gradient compression with error feedback (counterpart of
``repro.optim.compress``).

At real scale the quantized tensors are what crosses the wire in the
gradient all-reduce (8× fewer bytes than f32); here the full quantize →
dequantize round trip runs, so the numerics, the error-feedback correction
included, are what a deployment would see. Per-tensor symmetric scales;
``torch.round`` rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

import torch


def init_error_state(params):
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def _quantize(x: torch.Tensor):
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def compress_with_error_feedback(grads, err_state):
    """Returns (dequantized grads as seen post-all-reduce, new error state)."""
    deq, new_err = {}, {}
    for k, g in grads.items():
        g32 = g.float() + err_state[k]
        q, scale = _quantize(g32)
        deq[k] = q.float() * scale
        new_err[k] = g32 - deq[k]
    return deq, new_err
