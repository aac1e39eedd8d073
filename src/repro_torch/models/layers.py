"""Transformer building blocks (counterpart of ``repro.models.layers``).

Conventions: parameters are float32 tensors; compute casts them to the
activation dtype (bfloat16) with float32 softmax, norm and logit
statistics. Attention is blockwise (a loop over key/value chunks carrying
the running max, denominator and accumulator), so no [S, S] score matrix
is ever held — the 32k prefill needs that. These are plain functions on
tensors; no function here reaches a custom kernel.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = float("-inf")


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [..., S, H, hd]; positions broadcastable to [..., S]."""
    hd = x.shape[-1]
    half = hd // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device), exps)
    ang = positions.float()[..., None] * freqs  # [..., S, half]
    cos = torch.cos(ang)[..., None, :]  # [..., S, 1, half]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def flash_attention(
    q: torch.Tensor,  # [B, Sq, KV, G, hd]
    k: torch.Tensor,  # [B, T, KV, hd]
    v: torch.Tensor,  # [B, T, KV, hd]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_chunk: int = 2048,
    kv_chunk: int = 2048,
    triangle_skip: bool = False,
) -> torch.Tensor:
    """Blockwise softmax attention with running (max, denom, acc) state.

    Queries and keys are padded up to whole chunks; padded keys are masked
    by ``kpos < T``, padded query rows are sliced off. ``triangle_skip``
    (causal only) bounds each query chunk's key loop at the causal
    frontier, skipping the chunk pairs wholly above the diagonal. A query
    row whose keys are all masked comes out 0: its running max stays
    -inf, and both the rescale factor and the probabilities are selected
    to 0 there rather than computed as ``exp(-inf - (-inf))``.
    """
    b, sq, nkv, g, hd = q.shape
    t = k.shape[1]
    qc = min(q_chunk, sq)
    kc = min(kv_chunk, t)
    sq_orig, t_orig = sq, t
    if sq % qc:
        q = F.pad(q, (0, 0, 0, 0, 0, 0, 0, qc - sq % qc))
        sq = q.shape[1]
    if t % kc:
        pad = kc - t % kc
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        t += pad
    nq, nk = sq // qc, t // kc
    scale = 1.0 / math.sqrt(hd)  # rounded to float32 where it multiplies
    dev = q.device
    ar_q = torch.arange(qc, device=dev)
    ar_k = torch.arange(kc, device=dev)

    def kv_step(qblk, q0, m, l, acc, kj):
        kblk = k[:, kj * kc:(kj + 1) * kc]
        vblk = v[:, kj * kc:(kj + 1) * kc]
        logits = torch.einsum("bqkgd,bskd->bkgqs", qblk, kblk).float() * scale
        qpos = q0 + ar_q
        kpos = kj * kc + ar_k
        msk = (kpos[None, :] < t_orig).expand(qc, kc)
        if causal:
            msk = msk & (kpos[None, :] <= qpos[:, None])
        if window is not None:
            msk = msk & (kpos[None, :] > qpos[:, None] - window)
        logits = torch.where(msk, logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_new), 0.0)
        diff = torch.where(msk, logits - m_new[..., None], NEG_INF)
        pexp = torch.exp(diff)
        l_new = l * alpha + pexp.sum(dim=-1)
        pv = torch.einsum("bkgqs,bskd->bkgqd", pexp.to(vblk.dtype), vblk).float()
        return m_new, l_new, acc * alpha[..., None] + pv

    def q_block(qi, nk_bound):
        qblk = q[:, qi * qc:(qi + 1) * qc]
        m = torch.full((b, nkv, g, qc), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, nkv, g, qc), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, nkv, g, qc, hd), dtype=torch.float32, device=dev)
        for kj in range(nk_bound):
            m, l, acc = kv_step(qblk, qi * qc, m, l, acc, kj)
        return acc / torch.clamp(l, min=1e-30)[..., None]  # [B, KV, G, qc, hd]

    outs = []
    for qi in range(nq):
        bound = min(nk, -(-((qi + 1) * qc) // kc)) if triangle_skip and causal else nk
        outs.append(q_block(qi, bound))
    out = torch.stack(outs, dim=0)  # [nq, B, KV, G, qc, hd]
    out = out.permute(1, 0, 4, 2, 3, 5).reshape(b, sq, nkv, g, hd)
    return out[:, :sq_orig].to(q.dtype)


def decode_attention(
    q: torch.Tensor,  # [B, KV, G, hd] — one new token
    cache_k: torch.Tensor,  # [B, T, KV, hd] (keys after RoPE)
    cache_v: torch.Tensor,  # [B, T, KV, hd]
    pos,  # int or 0-d tensor: index of the new token
) -> torch.Tensor:
    t = cache_k.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bkgd,bskd->bkgs", q, cache_k).float() * scale
    valid = torch.arange(t, device=q.device) <= pos
    logits = torch.where(valid, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", w.to(cache_v.dtype), cache_v)
    return out.to(q.dtype)

