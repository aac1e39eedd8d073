"""Decoder-only LM (dense and MoE) with train, prefill and decode paths
(counterpart of ``repro.models.transformer``) on one device.

The parameters are the reference's nested tree: ``embed``, ``unembed``,
``final_norm`` and ``layers``, whose weights are stacked ``[L, ...]``. An
:class:`LM` registers each under that name (``layers.wq``, ...) and
``model.params`` is the nested dict of them that the steps, the optimizer
and the checkpoints take. Layers run in a Python loop over the stacked
weights; with ``cfg.remat`` and grad enabled each layer is recomputed in
the backward pass (``torch.utils.checkpoint``), which changes memory, not
values. Every expert of an MoE layer runs on this device.

The reference shards the model with GSPMD over a ``model`` mesh axis and
the batch over ``pod``/``data``. Here ``mesh`` is taken for the
reference's signatures and may be ``None`` or a mesh of one rank; a mesh
with more ranks on either raises ``NotImplementedError``. The reference's
layout hints (``lm_param_specs``, ``cache_specs``, ``wsc``) and its
``optimization_barrier`` have no single-device meaning and no counterpart.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig
from repro_torch.models.gnn import Init, ParamModel
from repro_torch.models.layers import decode_attention, flash_attention, rms_norm, rope

SHARDED_NOT_PORTED = ("the mesh-sharded LM (tensor, expert and FSDP parallelism) is not "
                      "ported yet: ROADMAP Queue 1 item 13d")

def dtype_of(name: str) -> torch.dtype:
    """A config's dtype name ("bfloat16", "float32") as a torch dtype."""
    return getattr(torch, name)


def check_mesh(mesh) -> None:
    """``None`` or a mesh whose data and model axes hold one rank each."""
    if mesh is None:
        return
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    dp = math.prod(sizes.get(a, 1) for a in ("pod", "data"))
    if dp > 1 or sizes.get("model", 1) > 1:
        raise NotImplementedError(f"{mesh}: {SHARDED_NOT_PORTED}")


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

class LM(ParamModel):
    """The LM's parameters under the reference's nested names: the top-level
    tensors on this module, the stacked layer weights on ``self.layers``."""

    def __init__(self, cfg: LMConfig, params: Dict[str, Any]):
        super().__init__(cfg, {k: v for k, v in params.items() if k != "layers"})
        self.layers = ParamModel(cfg, params["layers"])
        self.params["layers"] = self.layers.params

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return lm_forward(self.params, tokens, self.cfg)


def init_lm(cfg: LMConfig, generator: Optional[torch.Generator] = None, device=None) -> LM:
    init = Init(generator, device)
    pdt = dtype_of(cfg.param_dtype)
    d, hd, hq, kv, l = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads, cfg.n_layers

    def nrm(shape, scale=0.02):
        return init.normal(shape, scale).to(pdt)

    def ones(shape):
        return init.ones(shape).to(pdt)

    def zeros(shape):
        return init.zeros(shape).to(pdt)

    out_scale = 0.02 / math.sqrt(2 * l)
    layers = {
        "wq": nrm((l, d, hq * hd)),
        "wk": nrm((l, d, kv * hd)),
        "wv": nrm((l, d, kv * hd)),
        "wo": nrm((l, hq * hd, d), out_scale),
        "ln1": ones((l, d)),
        "ln2": ones((l, d)),
    }
    if cfg.qkv_bias:
        layers.update(bq=zeros((l, hq * hd)), bk=zeros((l, kv * hd)), bv=zeros((l, kv * hd)))
    if cfg.qk_norm:
        layers.update(q_norm=ones((l, hd)), k_norm=ones((l, hd)))
    if cfg.moe is None:
        layers.update(wi=nrm((l, d, cfg.d_ff)), wg=nrm((l, d, cfg.d_ff)),
                      wo_ff=nrm((l, cfg.d_ff, d), out_scale))
    else:
        e = cfg.moe.n_experts
        layers.update(router=nrm((l, d, e)), ewi=nrm((l, e, d, cfg.d_ff)),
                      ewg=nrm((l, e, d, cfg.d_ff)), ewo=nrm((l, e, cfg.d_ff, d), out_scale))
        if cfg.moe.n_shared:
            s = cfg.moe.n_shared * cfg.d_ff
            layers.update(swi=nrm((l, d, s)), swg=nrm((l, d, s)), swo=nrm((l, s, d), out_scale))
    return LM(cfg, {"embed": nrm((cfg.vocab, d)), "unembed": nrm((d, cfg.vocab)),
                    "final_norm": ones((d,)), "layers": layers})


def _layer_views(params) -> list:
    """Per-layer dicts of views into the stacked ``[L, ...]`` weights. One
    ``unbind`` per weight: its gradient is one stack, not a full-size
    tensor per layer."""
    per = {k: v.unbind(0) for k, v in params["layers"].items()}
    return [{k: v[i] for k, v in per.items()} for i in range(len(per["ln1"]))]


def _embed(table: torch.Tensor, tokens: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """Rows of ``table`` for ``tokens``, ids clamped into range (the
    reference's ``take(..., mode='clip')``)."""
    ids = torch.clamp(tokens.long(), 0, table.shape[0] - 1)
    return F.embedding(ids, table).to(dt)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _dense_ffn(x, wi, wg, wo):
    dt = x.dtype
    h = F.silu(x @ wg.to(dt)) * (x @ wi.to(dt))
    return h @ wo.to(dt)


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k``: the k largest along the last axis, the lower index
    first among equal values (``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_block(x: torch.Tensor, lp: Dict[str, torch.Tensor], cfg: LMConfig, mesh=None):
    """Top-k routed experts with the reference's capacity rule: expert e
    takes its ``cap`` highest-gated tokens (tokens of gate 0 fill spare
    slots with weight 0), and their outputs are added back per token."""
    check_mesh(mesh)
    moe = cfg.moe
    b, s, d = x.shape
    t = b * s
    e = moe.n_experts
    cap = int(t * moe.top_k / e * moe.capacity_factor + 0.999)
    cap = min(t, max(8, -(-cap // 8) * 8))
    dt = x.dtype
    xl = x.reshape(-1, d)
    # Router matmul in the compute dtype; only the [t, E] logits go to f32.
    logits = (xl @ lp["router"].to(dt)).float()
    probs = torch.softmax(logits, dim=-1)
    gval, gidx = _top_k(probs, moe.top_k)
    gval = gval / torch.clamp(gval.sum(-1, keepdim=True), min=1e-9)
    out = torch.zeros_like(xl)
    experts = zip(lp["ewi"].unbind(0), lp["ewg"].unbind(0), lp["ewo"].unbind(0))
    for ei, (wi_e, wg_e, wo_e) in enumerate(experts):
        gate_e = torch.where(gidx == ei, gval, 0.0).sum(-1)  # [t]
        topv, topi = _top_k(gate_e, cap)
        xe = torch.index_select(xl, 0, topi)
        h = F.silu(xe @ wg_e.to(dt)) * (xe @ wi_e.to(dt))
        ye = (h @ wo_e.to(dt)) * topv[:, None].to(dt)
        out.index_add_(0, topi, ye)
    out = out.reshape(x.shape)
    if moe.n_shared:
        out = out + _dense_ffn(x, lp["swi"], lp["swg"], lp["swo"])
    return out


def _qkv(x, lp, cfg: LMConfig, positions):
    b, s = x.shape[0], x.shape[1]
    hd, hq, kvh = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    g = hq // kvh
    dt = x.dtype
    q = x @ lp["wq"].to(dt)
    k = x @ lp["wk"].to(dt)
    v = x @ lp["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + lp["bq"].to(dt)
        k = k + lp["bk"].to(dt)
        v = v + lp["bv"].to(dt)
    q = q.reshape(b, s, kvh * g, hd)
    k = k.reshape(b, s, kvh, hd)
    v = v.reshape(b, s, kvh, hd)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"], cfg.norm_eps)
        k = rms_norm(k, lp["k_norm"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q.reshape(b, s, kvh, g, hd), k, v


def _attend(q, k, v, cfg: LMConfig, triangle_skip: bool):
    b, s = q.shape[0], q.shape[1]
    o = flash_attention(q, k, v, causal=True, window=cfg.sliding_window,
                        q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk,
                        triangle_skip=triangle_skip)
    return o.reshape(b, s, cfg.n_heads * cfg.hd)


def attention_block(x, lp, cfg: LMConfig, positions, triangle_skip=False):
    q, k, v = _qkv(x, lp, cfg, positions)
    return _attend(q, k, v, cfg, triangle_skip) @ lp["wo"].to(x.dtype)


def _ffn(x, lp, cfg: LMConfig, mesh):
    if cfg.moe is None:
        return _dense_ffn(x, lp["wi"], lp["wg"], lp["wo_ff"])
    return moe_block(x, lp, cfg, mesh)


# ---------------------------------------------------------------------------
# forward paths
# ---------------------------------------------------------------------------

def _layer(x, lp, cfg: LMConfig, mesh, positions, triangle_skip):
    x = x + attention_block(rms_norm(x, lp["ln1"], cfg.norm_eps), lp, cfg, positions,
                            triangle_skip=triangle_skip)
    return x + _ffn(rms_norm(x, lp["ln2"], cfg.norm_eps), lp, cfg, mesh)


def lm_forward(params, tokens, cfg: LMConfig, mesh=None, *, triangle_skip=False):
    """Shared trunk: tokens [B, S] → final hidden states [B, S, d]."""
    check_mesh(mesh)
    x = _embed(params["embed"], tokens, dtype_of(cfg.dtype))
    positions = torch.arange(tokens.shape[1], device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in _layer_views(params):
        if remat:
            x = checkpoint(_layer, x, lp, cfg, mesh, positions, triangle_skip,
                           use_reentrant=False)
        else:
            x = _layer(x, lp, cfg, mesh, positions, triangle_skip)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def lm_loss(params, tokens, labels, cfg: LMConfig, mesh=None) -> torch.Tensor:
    x = lm_forward(params, tokens, cfg, mesh)
    return softmax_xent(x, params["unembed"], labels, cfg)


def softmax_xent(x, unembed, labels, cfg: LMConfig) -> torch.Tensor:
    """Token-mean cross entropy; with ``cfg.vocab_chunk`` a running
    logsumexp over vocabulary chunks (no [B, S, V] float32 logits)."""
    b, s, d = x.shape
    v = unembed.shape[1]
    labels = labels.long()
    if cfg.vocab_chunk is None:
        logits = (x @ unembed.to(x.dtype)).float()
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels[..., None])[..., 0]
        return torch.mean(lse - ll)
    vc = cfg.vocab_chunk
    if v % vc:
        raise ValueError(f"vocab {v} is not a multiple of vocab_chunk {vc}")
    m = torch.full((b, s), float("-inf"), dtype=torch.float32, device=x.device)
    ssum = torch.zeros((b, s), dtype=torch.float32, device=x.device)
    ll = torch.zeros((b, s), dtype=torch.float32, device=x.device)
    for ci in range(v // vc):
        lg = (x @ unembed[:, ci * vc:(ci + 1) * vc].to(x.dtype)).float()  # [B, S, vc]
        m_new = torch.maximum(m, lg.amax(-1))
        ssum = ssum * torch.exp(m - m_new) + torch.exp(lg - m_new[..., None]).sum(-1)
        m = m_new
        rel = labels - ci * vc
        inside = (rel >= 0) & (rel < vc)
        lab = torch.gather(lg, -1, torch.clamp(rel, 0, vc - 1)[..., None])[..., 0]
        ll = torch.where(inside, lab, ll)
    lse = m + torch.log(ssum)
    return torch.mean(lse - ll)


# ---------------------------------------------------------------------------
# serving: prefill and decode with a KV cache (inference only: no autograd)
# ---------------------------------------------------------------------------

class CacheSpec(NamedTuple):
    """Shape and dtype of one cache tensor (the reference's ShapeDtypeStruct)."""
    shape: tuple
    dtype: torch.dtype


def cache_shape(cfg: LMConfig, batch: int, cache_len: int) -> Dict[str, CacheSpec]:
    t = cache_len if cfg.sliding_window is None else min(cache_len, cfg.sliding_window)
    spec = CacheSpec((cfg.n_layers, batch, t, cfg.n_kv_heads, cfg.hd), dtype_of(cfg.dtype))
    return {"k": spec, "v": spec}


@torch.no_grad()
def lm_prefill(params, tokens, cfg: LMConfig, mesh=None):
    """tokens [B, S] → (last-token logits [B, V] float32, cache
    ``{"k", "v": [L, B, T, KV, hd]}``). With a sliding window shorter than
    S the cache holds the last W tokens, token p at slot p % W."""
    check_mesh(mesh)
    x = _embed(params["embed"], tokens, dtype_of(cfg.dtype))
    b, s = tokens.shape
    positions = torch.arange(s, device=x.device)
    w = cfg.sliding_window
    rolled = w is not None and s > w
    layers = _layer_views(params)
    t = w if rolled else s
    shp = (len(layers), b, t, cfg.n_kv_heads, cfg.hd)
    cache = {"k": x.new_empty(shp), "v": x.new_empty(shp)}
    for i, lp in enumerate(layers):
        q, k, v = _qkv(rms_norm(x, lp["ln1"], cfg.norm_eps), lp, cfg, positions)
        x = x + _attend(q, k, v, cfg, False) @ lp["wo"].to(x.dtype)
        x = x + _ffn(rms_norm(x, lp["ln2"], cfg.norm_eps), lp, cfg, mesh)
        if rolled:
            k = torch.roll(k[:, -w:], shifts=s % w, dims=1)
            v = torch.roll(v[:, -w:], shifts=s % w, dims=1)
        cache["k"][i] = k
        cache["v"][i] = v
    x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = (x @ params["unembed"].to(x.dtype)).float()
    return logits[:, 0], cache


@torch.no_grad()
def lm_decode_step(params, token, cache, pos, cfg: LMConfig, mesh=None):
    """token [B]; cache ``{"k", "v": [L, B, T, KV, hd]}``; ``pos`` (an int)
    the position of the new token. Writes the token's keys and values into
    ``cache`` in place and returns (logits [B, V] float32, cache). The
    write slot is ``pos % T`` with a sliding window, else ``pos`` clamped
    to T − 1 (the reference's ``dynamic_update_slice``), and attention sees
    slots up to ``min(pos, T − 1)``."""
    check_mesh(mesh)
    pos = int(pos)
    x = _embed(params["embed"], token[:, None], dtype_of(cfg.dtype))  # [B, 1, d]
    b = token.shape[0]
    t_cache = cache["k"].shape[2]
    write_idx = pos % t_cache if cfg.sliding_window is not None else pos
    write_idx = min(max(write_idx, 0), t_cache - 1)
    mask_pos = min(pos, t_cache - 1)
    positions = torch.tensor([pos], device=x.device)
    for i, lp in enumerate(_layer_views(params)):
        q, k, v = _qkv(rms_norm(x, lp["ln1"], cfg.norm_eps), lp, cfg, positions)
        kc, vc = cache["k"][i], cache["v"][i]
        kc[:, write_idx] = k[:, 0].to(kc.dtype)
        vc[:, write_idx] = v[:, 0].to(vc.dtype)
        o = decode_attention(q[:, 0], kc, vc, mask_pos)
        x = x + o.reshape(b, 1, cfg.n_heads * cfg.hd) @ lp["wo"].to(x.dtype)
        x = x + _ffn(rms_norm(x, lp["ln2"], cfg.norm_eps), lp, cfg, mesh)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x @ params["unembed"].to(x.dtype)).float()
    return logits[:, 0], cache
