"""Decoder-only LM (dense and MoE) with train, prefill and decode paths
(counterpart of ``repro.models.transformer``), on one device or SPMD over
the ranks of a :class:`repro_torch.launch.mesh.Mesh`.

The parameters are the reference's nested tree: ``embed``, ``unembed``,
``final_norm`` and ``layers``, whose weights are stacked ``[L, ...]``. An
:class:`LM` registers each under that name (``layers.wq``, ...) and
``model.params`` is the nested dict of them that the steps, the optimizer
and the checkpoints take. Layers run in a Python loop over the stacked
weights; with ``cfg.remat`` and grad enabled each layer is recomputed in
the backward pass (``torch.utils.checkpoint``), which changes memory, not
values.

On a mesh each rank holds its block of every weight under
:func:`lm_param_specs` (:func:`shard_params` cuts a whole tree,
:func:`gather_params` joins one) and runs the same program on it:

- Tensor parallelism over ``model`` (Megatron): ``wq``/``wk``/``wv``/
  ``wi``/``wg`` and the biases split their output dimension, ``wo``/
  ``wo_ff`` their input one. A block's input enters the split region
  through ``copy_to`` and its partial output leaves through
  ``reduce_from`` (an all-reduce), so the gradients of the replicated
  weights outside the region (``ln1``, ``ln2``, ``final_norm``) come out
  whole. Query heads split over ``model``; KV heads split with them when
  ``n_kv_heads % model == 0`` and are otherwise replicated (every rank
  holds and caches all of them, and its query heads read KV head
  ``(rank · hq/model) // (hq/kv)``).
- ``embed`` is split by vocabulary: a rank looks up the ids in its range
  (ids clamped first, as ``take(mode='clip')``) and an all-reduce sums the
  rows. ``unembed`` is split by vocabulary too: the cross entropy takes
  its max and its sum across ``model`` and the label logit from the rank
  that holds it; prefill and decode logits are all-gathered to ``[B, V]``.
- The batch splits over the data axes (``pod``, ``data``): every rank
  takes the global ``tokens``/``labels`` and computes on its rows; when
  ``B % dp != 0`` every data rank computes the whole batch (the
  reference's ``shard_batch`` rule). Loss and logits come back global;
  ``lm_forward``'s hidden states and the cache are this rank's rows.
- MoE: expert-parallel over ``model`` when ``n_experts % model == 0`` and
  ``n_experts >= model``, else expert-tensor-parallel (``d_ff`` split);
  the capacity is computed from this rank's tokens, as the reference's
  ``shard_map`` island computes it per data shard.
- FSDP (``cfg.fsdp``): the big dimension of every weight is also split
  over the data axes, and each layer gathers its weights inside the layer
  loop (the experts one at a time), cast to the compute dtype first; the
  gather's backward reduce-scatters the gradient. The whole stack is
  never held.

The reference's ``wsc`` (a GSPMD layout hint) and ``optimization_barrier``
(an XLA scheduling pin) have no meaning here and no counterpart.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig
from repro_torch.launch.mesh import (
    P, copy_to, gather, gather_leaf, live_axes, reduce_from, shard_leaf,
)
from repro_torch.models.gnn import Init, ParamModel
from repro_torch.models.layers import decode_attention, flash_attention, rms_norm, rope

MODEL = "model"
DP_AXES = ("pod", "data")


def dtype_of(name: str) -> torch.dtype:
    """A config's dtype name ("bfloat16", "float32") as a torch dtype."""
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# mesh helpers and layouts
# ---------------------------------------------------------------------------

def _sizes(mesh) -> Dict[str, int]:
    return {} if mesh is None else dict(zip(mesh.axis_names, mesh.shape))


def dp_axis_names(mesh) -> tuple:
    return () if mesh is None else tuple(a for a in DP_AXES if a in mesh.axis_names)


def dp_size(mesh) -> int:
    return math.prod(_sizes(mesh)[a] for a in dp_axis_names(mesh))


def model_size(mesh) -> int:
    return _sizes(mesh).get(MODEL, 1)


def _expert_parallel(cfg: LMConfig, m: int) -> bool:
    return cfg.moe.n_experts % m == 0 and cfg.moe.n_experts >= m


def lm_param_specs(cfg: LMConfig, mesh) -> Dict[str, Any]:
    """The :class:`P` tree of the layout the port holds (``init_lm``'s
    tree). It is the reference's but for one case: KV heads that do not
    split over ``model`` (``n_kv_heads % model != 0``) are replicated, so
    ``wk``/``wv`` are ``P(None, fs, None)`` and ``bk``/``bv``
    ``P(None, None)`` where the reference asks GSPMD to split inside heads."""
    dp = dp_axis_names(mesh)
    fs = dp if cfg.fsdp else None
    m = MODEL
    kv = m if cfg.n_kv_heads % model_size(mesh) == 0 else None
    layers: Dict[str, P] = {
        "wq": P(None, fs, m), "wk": P(None, fs, kv), "wv": P(None, fs, kv),
        "wo": P(None, m, fs), "ln1": P(None, None), "ln2": P(None, None),
    }
    if cfg.qkv_bias:
        layers.update(bq=P(None, m), bk=P(None, kv), bv=P(None, kv))
    if cfg.qk_norm:
        layers.update(q_norm=P(None, None), k_norm=P(None, None))
    if cfg.moe is None:
        layers.update(wi=P(None, fs, m), wg=P(None, fs, m), wo_ff=P(None, m, fs))
    else:
        if _expert_parallel(cfg, model_size(mesh)):
            layers.update(router=P(None, None, None), ewi=P(None, m, fs, None),
                          ewg=P(None, m, fs, None), ewo=P(None, m, None, fs))
        else:
            layers.update(router=P(None, None, None), ewi=P(None, None, fs, m),
                          ewg=P(None, None, fs, m), ewo=P(None, None, m, fs))
        if cfg.moe.n_shared:
            layers.update(swi=P(None, fs, m), swg=P(None, fs, m), swo=P(None, m, fs))
    return {"embed": P(m, fs), "unembed": P(fs, m), "final_norm": P(None), "layers": layers}


def cache_specs(cfg: LMConfig, mesh, batch: int) -> Dict[str, P]:
    """The layout of the ``[L, B, T, KV, hd]`` cache the port holds: batch
    over the data axes when they split it (``batch % dp == 0``, dp > 1),
    KV heads over ``model`` when they split. The reference splits the
    sequence over ``model`` (and over the data axes too when they do not
    split the batch; ``:403-410``); each of the port's ranks holds the
    whole sequence of its rows and heads."""
    dp = dp_axis_names(mesh)
    b = dp if dp_size(mesh) > 1 and batch % dp_size(mesh) == 0 else None
    h = MODEL if MODEL in _sizes(mesh) and cfg.n_kv_heads % model_size(mesh) == 0 else None
    spec = P(None, b, None, h, None)
    return {"k": spec, "v": spec}


def check_mesh(cfg: LMConfig, mesh) -> None:
    """Raise ``ValueError`` naming the limit unless ``cfg`` splits over
    ``mesh``: query heads, ``d_ff`` and the vocabulary over ``model``, KV
    heads over ``model`` or ``model`` over KV heads, ``d_model`` over the
    data axes under FSDP, and no axis but ``pod``/``data``/``model`` with
    more than one rank."""
    if mesh is None:
        return
    sizes = _sizes(mesh)
    extra = {a: n for a, n in sizes.items() if a not in DP_AXES + (MODEL,) and n > 1}
    if extra:
        raise ValueError(f"the LM runs on ('pod', 'data', 'model') axes; {extra} has more "
                         f"than one rank")
    m, dp = model_size(mesh), dp_size(mesh)
    limits = [("n_heads", cfg.n_heads), ("d_ff", cfg.d_ff), ("vocab", cfg.vocab)]
    if cfg.moe is not None and cfg.moe.n_shared:
        limits.append(("n_shared * d_ff", cfg.moe.n_shared * cfg.d_ff))
    for name, n in limits:
        if n % m:
            raise ValueError(f"{name} = {n} does not split over model = {m} ranks")
    kv = cfg.n_kv_heads
    if kv % m and m % kv:
        raise ValueError(f"n_kv_heads = {kv} neither splits over model = {m} ranks nor "
                         f"divides it (KV heads are split or replicated whole)")
    if cfg.fsdp and cfg.d_model % dp:
        raise ValueError(f"FSDP: d_model = {cfg.d_model} does not split over the data "
                         f"axes ({dp} ranks)")


def _tree_map2(fn, tree, specs):
    return {k: _tree_map2(fn, v, specs[k]) if isinstance(v, dict) else fn(v, specs[k])
            for k, v in tree.items()}


def shard_params(params, cfg: LMConfig, mesh):
    """This rank's blocks of a whole parameter tree (tensors or numpy
    arrays) under :func:`lm_param_specs`."""
    check_mesh(cfg, mesh)
    return _tree_map2(lambda x, s: shard_leaf(x, s, mesh), params, lm_param_specs(cfg, mesh))


def gather_params(params, cfg: LMConfig, mesh):
    """The whole tree of which ``params`` holds this rank's blocks (a tree
    of gradients or optimizer moments too). Collective."""
    return _tree_map2(lambda x, s: gather_leaf(x.detach(), s, mesh), params,
                      lm_param_specs(cfg, mesh))


def grad_sum_axes(cfg: LMConfig, mesh) -> Dict[str, Any]:
    """Per parameter, the mesh axes over which the ranks' gradients must be
    summed after the backward pass: the data axes of every weight they do
    not split (each data rank saw its own rows), and ``model`` for the
    replicated weights used inside the split region on the rank's own
    heads or experts only (``q_norm``, ``k_norm``, ``router``, and
    ``wk``/``wv``/``bk``/``bv`` when KV heads are replicated). The
    FSDP-split weights get their data-axis sum from the gather's
    reduce-scatter; ``ln1``, ``ln2``, ``final_norm`` and ``embed`` come
    out whole through the conjugate collectives and take no ``model`` sum."""
    specs = lm_param_specs(cfg, mesh)
    partial = {"q_norm", "k_norm", "router"}
    if cfg.n_kv_heads % model_size(mesh):
        partial |= {"wk", "wv", "bk", "bv"}

    def axes(spec, name):
        named = spec.axes()
        want = tuple(a for a in dp_axis_names(mesh) if a not in named)
        if name in partial:
            want += (MODEL,)
        return live_axes(mesh, want)

    out = {k: axes(v, k) for k, v in specs.items() if k != "layers"}
    out["layers"] = {k: axes(v, k) for k, v in specs["layers"].items()}
    return out


class _Shard(NamedTuple):
    """This rank's share of one LM call on ``mesh`` (``None``: the whole)."""
    mesh: Any
    model_axes: tuple  # live "model" axis, or ()
    mi: int
    dp_axes: tuple  # live data axes
    dpn: int
    dpi: int
    fs: tuple  # the live data axes FSDP splits over, or ()
    fs_dim: dict  # per layer weight: the dimension FSDP splits, or absent
    hq: int  # query heads on this rank
    kv_held: int  # KV heads this rank computes and caches
    kv_lo: int  # the first of them its query heads read
    kv_used: int
    g: int  # query heads per KV head read
    e0: int  # the first of this rank's experts (expert-parallel), else 0


def _shard_of(cfg: LMConfig, mesh) -> _Shard:
    check_mesh(cfg, mesh)
    model_axes, dp_axes = live_axes(mesh, MODEL), live_axes(mesh, DP_AXES)
    m = model_size(mesh)
    mi = mesh.axis_index(model_axes) if model_axes else 0
    fs = dp_axes if cfg.fsdp else ()
    fs_dim = {}
    if fs:
        for k, spec in lm_param_specs(cfg, mesh)["layers"].items():
            dims = [d for d, e in enumerate(spec[1:]) if e is not None and e != MODEL]
            if dims:
                fs_dim[k] = dims[0]
    hq, kv = cfg.n_heads // m, cfg.n_kv_heads
    g = cfg.n_heads // kv
    if kv % m == 0:
        kv_held, kv_lo, kv_used, g_loc = kv // m, 0, kv // m, g
    else:  # replicated: this rank's query heads all read one KV head
        kv_held, kv_lo, kv_used, g_loc = kv, (mi * hq) // g, 1, hq
    e0 = 0
    if cfg.moe is not None and _expert_parallel(cfg, m):
        e0 = mi * (cfg.moe.n_experts // m)
    return _Shard(mesh, model_axes, mi, dp_axes, math.prod(_sizes(mesh)[a] for a in dp_axes),
                  mesh.axis_index(dp_axes) if dp_axes else 0, fs, fs_dim, hq, kv_held,
                  kv_lo, kv_used, g_loc, e0)


def _rows(t: torch.Tensor, sh: _Shard) -> torch.Tensor:
    """This rank's rows of a global batch: a slice when the data axes split
    it, else the whole batch."""
    b = t.shape[0]
    if sh.dpn > 1 and b % sh.dpn == 0:
        return t.narrow(0, sh.dpi * (b // sh.dpn), b // sh.dpn)
    return t


def _global_rows(x: torch.Tensor, b: int, sh: _Shard) -> torch.Tensor:
    """``x`` of this rank's rows of a batch of ``b`` gathered to all ``b``."""
    if sh.dpn > 1 and b % sh.dpn == 0:
        return sh.mesh.all_gather(x, sh.dp_axes)
    return x


def _w(lp, key: str, sh: _Shard, dt: torch.dtype) -> torch.Tensor:
    """A layer weight in the compute dtype, whole along its FSDP dimension
    (cast first: the gather moves half the bytes of float32)."""
    w = lp[key].to(dt)
    dim = sh.fs_dim.get(key)
    return w if dim is None else gather(w, sh.mesh, sh.fs, dim)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

class LM(ParamModel):
    """The LM's parameters under the reference's nested names: the top-level
    tensors on this module, the stacked layer weights on ``self.layers``.
    On a mesh each is this rank's block."""

    def __init__(self, cfg: LMConfig, params: Dict[str, Any], mesh=None):
        super().__init__(cfg, {k: v for k, v in params.items() if k != "layers"})
        self.layers = ParamModel(cfg, params["layers"])
        self.params["layers"] = self.layers.params
        self.mesh = mesh

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return lm_forward(self.params, tokens, self.cfg, self.mesh)


def init_lm(cfg: LMConfig, generator: Optional[torch.Generator] = None, device=None,
            mesh=None) -> LM:
    """Initial weights drawn on ``device`` (default: the mesh's), a stacked
    weight one layer at a time. On a mesh every rank draws each whole
    weight (each layer's whole slice) in turn, as one device does, and
    keeps its block: the same ``generator`` seed gives the same model on
    every mesh, and no rank ever holds more than one layer's whole slice
    of a weight beside its blocks."""
    check_mesh(cfg, mesh)
    if device is None and mesh is not None:
        device = mesh.device
    init = Init(generator, device)
    pdt = dtype_of(cfg.param_dtype)
    d, hd, hq, kv, l = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads, cfg.n_layers
    specs = lm_param_specs(cfg, mesh)
    s = specs["layers"]

    def block(spec, shape, draw):
        return shard_leaf(draw(shape).to(pdt), spec, mesh)

    def stacked(key, shape, draw):
        layer_spec = P(*s[key][1:])
        first = block(layer_spec, shape, draw)
        out = first.new_empty((l,) + tuple(first.shape))
        out[0] = first
        for i in range(1, l):
            out[i] = block(layer_spec, shape, draw)
        return out

    def nrm(scale=0.02):
        return lambda shape: init.normal(shape, scale)

    out_scale = 0.02 / math.sqrt(2 * l)
    shapes = {"wq": ((d, hq * hd), nrm()), "wk": ((d, kv * hd), nrm()),
              "wv": ((d, kv * hd), nrm()), "wo": ((hq * hd, d), nrm(out_scale)),
              "ln1": ((d,), init.ones), "ln2": ((d,), init.ones)}
    if cfg.qkv_bias:
        shapes.update(bq=((hq * hd,), init.zeros), bk=((kv * hd,), init.zeros),
                      bv=((kv * hd,), init.zeros))
    if cfg.qk_norm:
        shapes.update(q_norm=((hd,), init.ones), k_norm=((hd,), init.ones))
    if cfg.moe is None:
        shapes.update(wi=((d, cfg.d_ff), nrm()), wg=((d, cfg.d_ff), nrm()),
                      wo_ff=((cfg.d_ff, d), nrm(out_scale)))
    else:
        e = cfg.moe.n_experts
        shapes.update(router=((d, e), nrm()), ewi=((e, d, cfg.d_ff), nrm()),
                      ewg=((e, d, cfg.d_ff), nrm()), ewo=((e, cfg.d_ff, d), nrm(out_scale)))
        if cfg.moe.n_shared:
            f = cfg.moe.n_shared * cfg.d_ff
            shapes.update(swi=((d, f), nrm()), swg=((d, f), nrm()),
                          swo=((f, d), nrm(out_scale)))
    layers = {k: stacked(k, shape, draw) for k, (shape, draw) in shapes.items()}
    return LM(cfg, {"embed": block(specs["embed"], (cfg.vocab, d), nrm()),
                    "unembed": block(specs["unembed"], (d, cfg.vocab), nrm()),
                    "final_norm": block(specs["final_norm"], (d,), init.ones),
                    "layers": layers}, mesh)


def _layer_views(params) -> list:
    """Per-layer dicts of views into the stacked ``[L, ...]`` weights. One
    ``unbind`` per weight: its gradient is one stack, not a full-size
    tensor per layer."""
    per = {k: v.unbind(0) for k, v in params["layers"].items()}
    return [{k: v[i] for k, v in per.items()} for i in range(len(per["ln1"]))]


def _embed(table: torch.Tensor, tokens: torch.Tensor, dt: torch.dtype, sh: _Shard,
           vocab: int) -> torch.Tensor:
    """Rows of the (vocabulary-split) table for ``tokens``, ids clamped into
    ``[0, vocab)`` (the reference's ``take(..., mode='clip')``)."""
    if sh.fs:
        table = gather(table, sh.mesh, sh.fs, 1)
    ids = torch.clamp(tokens.long(), 0, vocab - 1)
    if not sh.model_axes:
        return F.embedding(ids, table).to(dt)
    v = table.shape[0]
    rel = ids - sh.mi * v
    inside = (rel >= 0) & (rel < v)
    x = torch.where(inside[..., None], F.embedding(torch.clamp(rel, 0, v - 1), table), 0.0)
    return reduce_from(x, sh.mesh, sh.model_axes).to(dt)


def _logits(x: torch.Tensor, params, b: int, sh: _Shard) -> torch.Tensor:
    """float32 logits [B, V] of the last hidden state of this rank's rows,
    gathered over the vocabulary and the batch: equal on every rank."""
    un = params["unembed"]
    if sh.fs:
        un = gather(un, sh.mesh, sh.fs, 0)
    logits = (x @ un.to(x.dtype)).float()[:, 0]
    if sh.model_axes:
        logits = sh.mesh.gather_dim(logits, sh.model_axes, 1)
    return _global_rows(logits, b, sh)


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


def _expert(w: torch.Tensor, sh: _Shard, dt: torch.dtype, fs_dim: int) -> torch.Tensor:
    w = w.to(dt)
    return gather(w, sh.mesh, sh.fs, fs_dim) if sh.fs else w


def _moe_partial(x: torch.Tensor, lp, cfg: LMConfig, sh: _Shard) -> torch.Tensor:
    """This rank's share of the routed experts' output for its tokens ``x``
    [b, s, d]: its experts (expert-parallel) or its ``d_ff`` slice of every
    expert; summed over ``model`` by the caller."""
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
        gate_e = torch.where(gidx == sh.e0 + ei, gval, 0.0).sum(-1)  # [t]
        topv, topi = _top_k(gate_e, cap)
        xe = torch.index_select(xl, 0, topi)
        wi_e, wg_e, wo_e = (_expert(wi_e, sh, dt, 0), _expert(wg_e, sh, dt, 0),
                            _expert(wo_e, sh, dt, 1))
        h = F.silu(xe @ wg_e) * (xe @ wi_e)
        ye = (h @ wo_e) * topv[:, None].to(dt)
        out.index_add_(0, topi, ye)
    out = out.reshape(x.shape)
    if moe.n_shared:
        out = out + _dense_ffn(x, _w(lp, "swi", sh, dt), _w(lp, "swg", sh, dt),
                               _w(lp, "swo", sh, dt))
    return out


def _ffn(x, lp, cfg: LMConfig, sh: _Shard):
    """The FFN block on the normed ``x`` (replicated over ``model``)."""
    h = copy_to(x, sh.mesh, sh.model_axes)
    dt = x.dtype
    if cfg.moe is None:
        out = _dense_ffn(h, _w(lp, "wi", sh, dt), _w(lp, "wg", sh, dt), _w(lp, "wo_ff", sh, dt))
    else:
        out = _moe_partial(h, lp, cfg, sh)
    return reduce_from(out, sh.mesh, sh.model_axes)


def moe_block(x: torch.Tensor, lp: Dict[str, torch.Tensor], cfg: LMConfig, mesh=None):
    """Top-k routed experts with the reference's capacity rule: expert e
    takes its ``cap`` highest-gated tokens of ``x`` (tokens of gate 0 fill
    spare slots with weight 0), and their outputs are added back per
    token; plus the shared experts. On a mesh ``x`` is this rank's rows
    and ``lp`` its blocks of one layer's weights."""
    return _ffn(x, lp, cfg, _shard_of(cfg, mesh))


def _qkv(x, lp, cfg: LMConfig, positions, sh: _Shard):
    """This rank's query heads [b, s, kv_used, g, hd] and its held KV heads
    [b, s, kv_held, hd]."""
    b, s = x.shape[0], x.shape[1]
    hd = cfg.hd
    dt = x.dtype
    q = x @ _w(lp, "wq", sh, dt)
    k = x @ _w(lp, "wk", sh, dt)
    v = x @ _w(lp, "wv", sh, dt)
    if cfg.qkv_bias:
        q = q + lp["bq"].to(dt)
        k = k + lp["bk"].to(dt)
        v = v + lp["bv"].to(dt)
    q = q.reshape(b, s, sh.hq, hd)
    k = k.reshape(b, s, sh.kv_held, hd)
    v = v.reshape(b, s, sh.kv_held, hd)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"], cfg.norm_eps)
        k = rms_norm(k, lp["k_norm"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q.reshape(b, s, sh.kv_used, sh.g, hd), k, v


def _read_heads(kv: torch.Tensor, sh: _Shard) -> torch.Tensor:
    """The KV heads (dim 2) this rank's query heads read."""
    return kv if sh.kv_used == sh.kv_held else kv[:, :, sh.kv_lo:sh.kv_lo + sh.kv_used]


def _attend(q, k, v, cfg: LMConfig, triangle_skip: bool, sh: _Shard):
    b, s = q.shape[0], q.shape[1]
    o = flash_attention(q, _read_heads(k, sh), _read_heads(v, sh), causal=True,
                        window=cfg.sliding_window, q_chunk=cfg.attn_q_chunk,
                        kv_chunk=cfg.attn_kv_chunk, triangle_skip=triangle_skip)
    return o.reshape(b, s, sh.hq * cfg.hd)


def _attention(x, lp, cfg: LMConfig, positions, triangle_skip, sh: _Shard):
    """The attention block on the normed ``x``: (its output, replicated over
    ``model``; the rank's keys; its values)."""
    h = copy_to(x, sh.mesh, sh.model_axes)
    q, k, v = _qkv(h, lp, cfg, positions, sh)
    o = _attend(q, k, v, cfg, triangle_skip, sh) @ _w(lp, "wo", sh, x.dtype)
    return reduce_from(o, sh.mesh, sh.model_axes), k, v


def attention_block(x, lp, cfg: LMConfig, positions, triangle_skip=False, mesh=None):
    return _attention(x, lp, cfg, positions, triangle_skip, _shard_of(cfg, mesh))[0]


# ---------------------------------------------------------------------------
# forward paths
# ---------------------------------------------------------------------------

def _layer(x, lp, cfg: LMConfig, sh: _Shard, positions, triangle_skip):
    x = x + _attention(rms_norm(x, lp["ln1"], cfg.norm_eps), lp, cfg, positions,
                       triangle_skip, sh)[0]
    return x + _ffn(rms_norm(x, lp["ln2"], cfg.norm_eps), lp, cfg, sh)


def _forward(params, tokens, cfg: LMConfig, sh: _Shard, triangle_skip):
    tokens = _rows(tokens, sh)
    x = _embed(params["embed"], tokens, dtype_of(cfg.dtype), sh, cfg.vocab)
    positions = torch.arange(tokens.shape[1], device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in _layer_views(params):
        if remat:
            x = checkpoint(_layer, x, lp, cfg, sh, positions, triangle_skip,
                           use_reentrant=False)
        else:
            x = _layer(x, lp, cfg, sh, positions, triangle_skip)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def lm_forward(params, tokens, cfg: LMConfig, mesh=None, *, triangle_skip=False):
    """Shared trunk: global tokens [B, S] → final hidden states [b, S, d]
    of this rank's rows (all B off a mesh)."""
    return _forward(params, tokens, cfg, _shard_of(cfg, mesh), triangle_skip)


def lm_loss(params, tokens, labels, cfg: LMConfig, mesh=None) -> torch.Tensor:
    x = lm_forward(params, tokens, cfg, mesh)
    return softmax_xent(x, params["unembed"], labels, cfg, mesh)


def softmax_xent(x, unembed, labels, cfg: LMConfig, mesh=None) -> torch.Tensor:
    """Token-mean cross entropy over the global batch of ``labels`` [B, S]
    from this rank's hidden states ``x``; with ``cfg.vocab_chunk`` a
    running logsumexp over vocabulary chunks (no [B, S, V] float32
    logits). On a mesh the logits split by vocabulary: the max and the sum
    of exponentials combine across ``model``, the label logit comes from
    the rank that holds it, and the data ranks' shares of the mean are
    summed (``reduce_from``: its backward hands each rank the gradient of
    its own share, which the train step sums over the data axes)."""
    sh = _shard_of(cfg, mesh)
    labels = _rows(labels.long(), sh)
    if sh.fs:
        unembed = gather(unembed, sh.mesh, sh.fs, 0)
    x = copy_to(x, sh.mesh, sh.model_axes)
    b, s, d = x.shape
    v = unembed.shape[1]
    lo = sh.mi * v
    vc = cfg.vocab_chunk or v
    if v % vc:
        raise ValueError(f"vocab {v} (this rank's) is not a multiple of vocab_chunk {vc}")
    m = torch.full((b, s), float("-inf"), dtype=torch.float32, device=x.device)
    ssum = torch.zeros((b, s), dtype=torch.float32, device=x.device)
    ll = torch.zeros((b, s), dtype=torch.float32, device=x.device)
    for ci in range(v // vc):
        lg = (x @ unembed[:, ci * vc:(ci + 1) * vc].to(x.dtype)).float()  # [B, S, vc]
        m_new = torch.maximum(m, lg.amax(-1))
        ssum = ssum * torch.exp(m - m_new) + torch.exp(lg - m_new[..., None]).sum(-1)
        m = m_new
        rel = labels - lo - ci * vc
        inside = (rel >= 0) & (rel < vc)
        lab = torch.gather(lg, -1, torch.clamp(rel, 0, vc - 1)[..., None])[..., 0]
        ll = torch.where(inside, lab, ll)
    if sh.model_axes:
        top = sh.mesh.all_reduce(m.detach(), "max", sh.model_axes)
        ssum = reduce_from(ssum * torch.exp(m - top), sh.mesh, sh.model_axes)
        m = top
        ll = reduce_from(ll, sh.mesh, sh.model_axes)
    lse = m + torch.log(ssum)
    share = torch.mean(lse - ll) / sh.dpn
    return reduce_from(share, sh.mesh, sh.dp_axes)


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
    """Global tokens [B, S] → (last-token logits [B, V] float32, equal on
    every rank; this rank's cache ``{"k", "v": [L, b, T, KV, hd]}`` under
    :func:`cache_specs`). With a sliding window shorter than S the cache
    holds the last W tokens, token p at slot p % W."""
    sh = _shard_of(cfg, mesh)
    b_all = tokens.shape[0]
    tokens = _rows(tokens, sh)
    x = _embed(params["embed"], tokens, dtype_of(cfg.dtype), sh, cfg.vocab)
    b, s = tokens.shape
    positions = torch.arange(s, device=x.device)
    w = cfg.sliding_window
    rolled = w is not None and s > w
    layers = _layer_views(params)
    t = w if rolled else s
    shp = (len(layers), b, t, sh.kv_held, cfg.hd)
    cache = {"k": x.new_empty(shp), "v": x.new_empty(shp)}
    for i, lp in enumerate(layers):
        o, k, v = _attention(rms_norm(x, lp["ln1"], cfg.norm_eps), lp, cfg, positions,
                             False, sh)
        x = x + o
        x = x + _ffn(rms_norm(x, lp["ln2"], cfg.norm_eps), lp, cfg, sh)
        if rolled:
            k = torch.roll(k[:, -w:], shifts=s % w, dims=1)
            v = torch.roll(v[:, -w:], shifts=s % w, dims=1)
        cache["k"][i] = k
        cache["v"][i] = v
    x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return _logits(x, params, b_all, sh), cache


@torch.no_grad()
def lm_decode_step(params, token, cache, pos, cfg: LMConfig, mesh=None):
    """Global token [B]; this rank's cache ``{"k", "v": [L, b, T, KV, hd]}``;
    ``pos`` (an int) the position of the new token. Writes the token's
    keys and values into ``cache`` in place and returns (logits [B, V]
    float32, cache). The write slot is ``pos % T`` with a sliding window,
    else ``pos`` clamped to T − 1 (the reference's
    ``dynamic_update_slice``), and attention sees slots up to
    ``min(pos, T − 1)``."""
    sh = _shard_of(cfg, mesh)
    pos = int(pos)
    b_all = token.shape[0]
    token = _rows(token, sh)
    x = _embed(params["embed"], token[:, None], dtype_of(cfg.dtype), sh, cfg.vocab)
    b = token.shape[0]
    t_cache = cache["k"].shape[2]
    write_idx = pos % t_cache if cfg.sliding_window is not None else pos
    write_idx = min(max(write_idx, 0), t_cache - 1)
    mask_pos = min(pos, t_cache - 1)
    positions = torch.tensor([pos], device=x.device)
    for i, lp in enumerate(_layer_views(params)):
        h = copy_to(rms_norm(x, lp["ln1"], cfg.norm_eps), sh.mesh, sh.model_axes)
        q, k, v = _qkv(h, lp, cfg, positions, sh)
        kc, vc = cache["k"][i], cache["v"][i]
        kc[:, write_idx] = k[:, 0].to(kc.dtype)
        vc[:, write_idx] = v[:, 0].to(vc.dtype)
        o = decode_attention(q[:, 0], _read_heads(kc, sh), _read_heads(vc, sh), mask_pos)
        o = o.reshape(b, 1, sh.hq * cfg.hd) @ _w(lp, "wo", sh, x.dtype)
        x = x + reduce_from(o, sh.mesh, sh.model_axes)
        x = x + _ffn(rms_norm(x, lp["ln2"], cfg.norm_eps), lp, cfg, sh)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(x, params, b_all, sh), cache
