"""GNN architectures over an edge index (counterpart of ``repro.models.gnn``).

Message passing is the paper's multilinear form ``⊕_j f(x_i, a_ij, x_j)``:
an edge-wise ``f``, then a per-destination reduction. The reference
reduces with ``jax.ops.segment_sum``/``segment_max``, outside any Pallas
kernel; here the same reductions are ``index_add`` and ``scatter_reduce``.

Models: GAT (SDDMM → edge-softmax → SpMM), MeshGraphNet (edge-MLP MPNN),
GatedGCN (gated aggregation), NequIP (E(3) tensor-product interactions via
``repro_torch.models.o3``). Each is an ``nn.Module`` whose parameters are
registered under the reference's names (``w0``, ``enc_node_w0``, ``A10``,
``radial0_w0``, ``self0_l1``, …) and gathered in the dict ``params``, so
optimizer states and checkpoints line up with the reference's trees. The
``apply_*`` functions take any mapping of those names to tensors.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import GNNConfig
from repro_torch.graphs.structures import resolve_device
from repro_torch.models.o3 import bessel_basis_np, clebsch_gordan, tp_paths

Params = Mapping[str, torch.Tensor]


class ParamModel(nn.Module):
    """A model held as named parameters, each registered on the module under
    the reference's name. ``self.params`` is a plain dict of them, the tree
    the train steps, the optimizer and the checkpoints take: an
    ``nn.ParameterDict`` cannot hold the retrieval model's ``items``, the
    name of one of its methods."""

    def __init__(self, cfg, params: Dict[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        for k, v in params.items():
            self.register_parameter(k, nn.Parameter(v))
        self.params: Dict[str, nn.Parameter] = {k: getattr(self, k) for k in params}


class Init:
    """Draws initial parameters on ``device`` from ``generator`` (a fresh
    one seeded 0 when None). ``jax.random`` draws other values, so the
    tests carry weights across with ``repro_torch.models.from_reference``."""

    def __init__(self, generator: Optional[torch.Generator] = None, device=None):
        self.device = resolve_device(device)
        self.gen = generator or torch.Generator(device=self.device).manual_seed(0)

    def normal(self, shape, scale: float) -> torch.Tensor:
        return torch.randn(shape, generator=self.gen, device=self.device).mul_(scale)

    def zeros(self, shape) -> torch.Tensor:
        return torch.zeros(shape, device=self.device)

    def ones(self, shape) -> torch.Tensor:
        return torch.ones(shape, device=self.device)


def segment_sum(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.ops.segment_sum(x, seg, num_segments=n)`` for ids in [0, n)."""
    return x.new_zeros((n,) + tuple(x.shape[1:])).index_add(0, seg, x)


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along dim 0. Its gradient is an ``index_add``: the
    gradient of ``x[idx]`` sorts the ids and gives each distinct id one
    warp on the card, which walks a sampler's 10^5 padded edges (all id 0)
    one row at a time (3.9 s per GatedGCN step at ``minibatch_lg`` on one
    H100, against 0.16 s with ``index_select``)."""
    return torch.index_select(x, 0, idx)


def _mlp_init(init: Init, sizes, name, params, ln=True):
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        params[f"{name}_w{i}"] = init.normal((a, b), math.sqrt(2.0 / a))
        params[f"{name}_b{i}"] = init.zeros((b,))
    if ln:
        params[f"{name}_ln"] = init.ones((sizes[-1],))


def _ln(x, g):
    mu = x.mean(-1, keepdim=True)
    sd = torch.sqrt(((x - mu) ** 2).mean(-1, keepdim=True) + 1e-6)
    return (x - mu) / sd * g


def _mlp_apply(params, name, x, n_layers, ln=True, act=F.relu):
    for i in range(n_layers):
        x = x @ params[f"{name}_w{i}"] + params[f"{name}_b{i}"]
        if i < n_layers - 1:
            x = act(x)
    if ln:
        x = _ln(x, params[f"{name}_ln"])
    return x


def _edge_softmax(scores, dst, n, edge_valid):
    """Numerically-stable softmax over incoming edges per destination."""
    ev = edge_valid[:, None]
    scores = torch.where(ev, scores, -math.inf)
    # The per-segment max only shifts the softmax, which is invariant to
    # it: it carries no gradient (the reference's segment_max gradient
    # sums to zero up to rounding). Empty segments keep -inf, mapped to 0.
    idx = dst.long()[:, None].expand_as(scores)
    mx = scores.new_full((n, scores.shape[1]), -math.inf).scatter_reduce(
        0, idx, scores.detach(), "amax", include_self=False)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    ex = torch.where(ev, torch.exp(scores - gather(mx, dst)), 0.0)
    denom = segment_sum(ex, dst, n)
    return ex / torch.clamp(gather(denom, dst), min=1e-9)


# ---------------------------------------------------------------------------
# GAT
# ---------------------------------------------------------------------------

class GAT(ParamModel):
    def forward(self, x, src, dst, edge_valid):
        return apply_gat(self.params, x, src, dst, edge_valid, self.cfg)


def init_gat(cfg: GNNConfig, generator=None, device=None) -> GAT:
    init = Init(generator, device)
    h, heads = cfg.d_hidden, cfg.n_heads
    dims = [cfg.d_in] + [h * heads] * (cfg.n_layers - 1) + [cfg.n_classes]
    params: Dict[str, torch.Tensor] = {}
    for i in range(cfg.n_layers):
        d_in = dims[i]
        d_out = h if i < cfg.n_layers - 1 else cfg.n_classes
        params[f"w{i}"] = init.normal((d_in, heads, d_out), math.sqrt(2.0 / d_in))
        params[f"a_src{i}"] = init.normal((heads, d_out), 0.1)
        params[f"a_dst{i}"] = init.normal((heads, d_out), 0.1)
    return GAT(cfg, params)


def apply_gat(params: Params, x, src, dst, edge_valid, cfg: GNNConfig):
    n = x.shape[0]
    for i in range(cfg.n_layers):
        h = torch.einsum("nd,dhk->nhk", x, params[f"w{i}"])  # [N, H, K]
        s_src = (h * params[f"a_src{i}"][None]).sum(-1)  # [N, H]
        s_dst = (h * params[f"a_dst{i}"][None]).sum(-1)
        e = F.leaky_relu(gather(s_src, src) + gather(s_dst, dst), 0.2)  # [E, H]
        alpha = _edge_softmax(e, dst, n, edge_valid)
        msg = alpha[..., None] * gather(h, src)  # [E, H, K]
        agg = segment_sum(msg, dst, n)
        if i < cfg.n_layers - 1:
            x = F.elu(agg.reshape(n, -1))
        else:
            x = agg.mean(dim=1)  # average heads for the output layer
    return x  # [N, n_classes]


# ---------------------------------------------------------------------------
# MeshGraphNet
# ---------------------------------------------------------------------------

class MeshGraphNet(ParamModel):
    def forward(self, x, e_feat, src, dst, edge_valid):
        return apply_meshgraphnet(self.params, x, e_feat, src, dst, edge_valid, self.cfg)


def init_meshgraphnet(cfg: GNNConfig, generator=None, device=None,
                      d_edge_in: int = 4) -> MeshGraphNet:
    init = Init(generator, device)
    h = cfg.d_hidden
    params: Dict[str, torch.Tensor] = {}
    _mlp_init(init, [cfg.d_in, h, h], "enc_node", params)
    _mlp_init(init, [d_edge_in, h, h], "enc_edge", params)
    for i in range(cfg.n_layers):
        _mlp_init(init, [3 * h, h, h], f"edge{i}", params)
        _mlp_init(init, [2 * h, h, h], f"node{i}", params)
    _mlp_init(init, [h, h, cfg.d_out], "dec", params, ln=False)
    return MeshGraphNet(cfg, params)


def apply_meshgraphnet(params: Params, x, e_feat, src, dst, edge_valid, cfg: GNNConfig):
    n = x.shape[0]
    h = _mlp_apply(params, "enc_node", x, 2)
    e = _mlp_apply(params, "enc_edge", e_feat, 2)
    ev = edge_valid[:, None]
    for i in range(cfg.n_layers):
        e_in = torch.cat([e, gather(h, src), gather(h, dst)], dim=-1)
        e = e + _mlp_apply(params, f"edge{i}", e_in, 2)
        agg = segment_sum(torch.where(ev, e, 0.0), dst, n)
        h = h + _mlp_apply(params, f"node{i}", torch.cat([h, agg], -1), 2)
    return _mlp_apply(params, "dec", h, 2, ln=False)


# ---------------------------------------------------------------------------
# GatedGCN
# ---------------------------------------------------------------------------

class GatedGCN(ParamModel):
    def forward(self, x, e_feat, src, dst, edge_valid):
        return apply_gatedgcn(self.params, x, e_feat, src, dst, edge_valid, self.cfg)


def init_gatedgcn(cfg: GNNConfig, generator=None, device=None) -> GatedGCN:
    init = Init(generator, device)
    h = cfg.d_hidden
    params: Dict[str, torch.Tensor] = {
        "embed_node": init.normal((cfg.d_in, h), math.sqrt(1.0 / cfg.d_in)),
        "embed_edge": init.normal((1, h), 0.1),
    }
    for i in range(cfg.n_layers):
        for nm in ["A1", "A2", "A3", "U", "V"]:
            params[f"{nm}{i}"] = init.normal((h, h), math.sqrt(1.0 / h))
        params[f"ln_h{i}"] = init.ones((h,))
        params[f"ln_e{i}"] = init.ones((h,))
    params["out_w"] = init.normal((h, cfg.n_classes), math.sqrt(1.0 / h))
    params["out_b"] = init.zeros((cfg.n_classes,))
    return GatedGCN(cfg, params)


def apply_gatedgcn(params: Params, x, e_feat, src, dst, edge_valid, cfg: GNNConfig):
    n = x.shape[0]
    h = x @ params["embed_node"]
    e = e_feat @ params["embed_edge"]
    ev = edge_valid[:, None]
    for i in range(cfg.n_layers):
        h_src, h_dst = gather(h, src), gather(h, dst)
        e_new = h_src @ params[f"A1{i}"] + h_dst @ params[f"A2{i}"] + e @ params[f"A3{i}"]
        eta = torch.sigmoid(e_new)
        msg = torch.where(ev, eta * (h_src @ params[f"V{i}"]), 0.0)
        num = segment_sum(msg, dst, n)
        den = segment_sum(torch.where(ev, eta, 0.0), dst, n)
        h = h + F.relu(_ln(h @ params[f"U{i}"] + num / (den + 1e-6), params[f"ln_h{i}"]))
        e = e + F.relu(_ln(e_new, params[f"ln_e{i}"]))
    return h @ params["out_w"] + params["out_b"]


# ---------------------------------------------------------------------------
# NequIP (simplified; structurally faithful TP interactions, see o3.py)
# ---------------------------------------------------------------------------

class NequIP(ParamModel):
    def forward(self, species, pos, src, dst, edge_valid, graph_ids, n_graphs):
        return apply_nequip(self.params, species, pos, src, dst, edge_valid, graph_ids,
                            n_graphs, self.cfg)


def init_nequip(cfg: GNNConfig, generator=None, device=None, n_species: int = 4) -> NequIP:
    init = Init(generator, device)
    mul, lm = cfg.d_hidden, cfg.l_max
    paths = tp_paths(lm)
    params: Dict[str, torch.Tensor] = {"species_embed": init.normal((n_species, mul), 0.5)}
    for i in range(cfg.n_layers):
        # radial MLP: n_rbf -> mul weights per TP path
        _mlp_init(init, [cfg.n_rbf, 32, len(paths) * mul], f"radial{i}", params, ln=False)
        for l in range(lm + 1):
            params[f"self{i}_l{l}"] = init.normal((mul, mul), math.sqrt(1.0 / mul))
        params[f"gate{i}"] = init.normal((mul, lm * mul), 0.1)
    _mlp_init(init, [mul, 16, 1], "readout", params, ln=False)
    return NequIP(cfg, params)


@lru_cache(maxsize=None)
def _cg(path, device: torch.device) -> torch.Tensor:
    """The coupling tensor of ``path`` as float32 on ``device``, copied once."""
    return torch.as_tensor(clebsch_gordan(*path), dtype=torch.float32, device=device)


def _sph_harm(vec, l):
    """Real spherical harmonics of ``vec`` [E, 3] (torch mirror of
    ``o3.sph_harm_np``, with the safe norm)."""
    nrm = torch.sqrt(torch.clamp(torch.sum(vec * vec, dim=-1, keepdim=True), min=1e-18))
    v = vec / nrm
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    if l == 0:
        return torch.full(v.shape[:-1] + (1,), 0.5 / math.sqrt(math.pi), dtype=vec.dtype,
                          device=vec.device)
    if l == 1:
        c = math.sqrt(3.0 / (4 * math.pi))
        return torch.stack([c * y, c * z, c * x], dim=-1)
    if l == 2:
        c = math.sqrt(15.0 / (4 * math.pi))
        c0 = math.sqrt(5.0 / (16 * math.pi))
        return torch.stack(
            [c * x * y, c * y * z, c0 * (3 * z * z - 1.0), c * x * z, 0.5 * c * (x * x - y * y)],
            dim=-1,
        )
    raise NotImplementedError(f"l={l}")


def apply_nequip(params: Params, species, pos, src, dst, edge_valid, graph_ids, n_graphs,
                 cfg: GNNConfig):
    """species int32 [N]; pos f32 [N, 3]; returns per-graph energy [G]."""
    n = species.shape[0]
    mul, lm = cfg.d_hidden, cfg.l_max
    paths = tp_paths(lm)
    basis = bessel_basis_np(cfg.n_rbf, cfg.cutoff)
    evf = edge_valid[:, None].to(pos.dtype)

    rel = gather(pos, dst) - gather(pos, src)  # [E, 3]
    # safe norm: sqrt(max(|x|², ε²)) keeps the gradient finite at rel = 0
    # (padded edges) — plain norm() has a NaN gradient there.
    r = torch.sqrt(torch.clamp(torch.sum(rel * rel, dim=-1), min=1e-18))
    rbf = basis(r) * evf
    sh = {l: _sph_harm(rel, l) for l in range(lm + 1)}

    # out-of-range species are clipped, as jnp.take(mode='clip') does
    table = params["species_embed"]
    feats = {0: gather(table, species.clamp(0, table.shape[0] - 1))[..., None]}
    for l in range(1, lm + 1):
        feats[l] = pos.new_zeros((n, mul, 2 * l + 1))

    # The reference's einsum "pqr,emq,er,em->emp", contracted in a fixed
    # order: C·Y per path once for all layers, then the features, then the
    # radial weights (a 4-operand torch.einsum plans its order on the host
    # at every call).
    cy = {p: torch.einsum("pqr,er->epq", _cg(p, pos.device), sh[p[1]]) for p in paths}
    for i in range(cfg.n_layers):
        w_all = _mlp_apply(params, f"radial{i}", rbf, 2, ln=False)  # [E, P*mul]
        w_all = w_all.reshape(-1, len(paths), mul)
        msgs = {}
        for pi, path in enumerate(paths):
            l1, _, l3 = path
            hj = gather(feats[l1], src)  # [E, mul, 2l1+1]
            w = w_all[:, pi, :] * evf  # [E, mul]
            m = torch.einsum("emq,epq->emp", hj, cy[path]) * w[..., None]
            msgs[l3] = msgs[l3] + m if l3 in msgs else m
        new = {}
        for l in range(lm + 1):
            agg = segment_sum(msgs[l], dst, n)
            mixed = torch.einsum("nmp,mk->nkp", agg, params[f"self{i}_l{l}"])
            new[l] = feats[l] + mixed
        # gate nonlinearity: scalars via silu, l>0 gated by learned scalars
        scal = new[0][..., 0]
        gates = torch.sigmoid(scal @ params[f"gate{i}"]).reshape(n, lm, mul)
        out = {0: F.silu(scal)[..., None]}
        for l in range(1, lm + 1):
            out[l] = new[l] * gates[:, l - 1, :, None]
        feats = out

    e_atom = _mlp_apply(params, "readout", feats[0][..., 0], 2, ln=False)[..., 0]  # [N]
    return segment_sum(e_atom, graph_ids, n_graphs)
