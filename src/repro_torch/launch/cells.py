"""Dry-run cells: (arch × shape × mesh) → one rank's program and its counts
(counterpart of ``repro.launch.cells``).

The reference lowers and compiles one SPMD program over placeholder
devices and reads XLA's analyses of it. The port runs SPMD programs
eagerly, one per rank, so a cell is **rank 0's program**: ``make_args``
builds the rank's inputs (its blocks of the parameters and the optimizer
state, its rows of the batch) on a device, ``fn`` is the step it runs.
:func:`run_cell` runs it on ``"meta"`` tensors over a mesh of the fake
process group (``launch/fakedist.py``) and counts:

- FLOPs by dtype, from the formulas of ``torch.utils.flop_counter``'s
  ``FlopCounterMode`` (the compute term prices each dtype at its own
  peak; running ``FlopCounterMode`` itself beside the tally would double
  the cost of a cell), device-memory bytes, and argument, output and peak
  temporary bytes (``fakedist.OpTally``);
- collective bytes by axis set (``Mesh.count_collectives``).

Eager PyTorch fuses nothing, so the bytes are the program's traffic
before caches.

The same ``make_args``/``fn`` run for real on a card (``chip_smoke.py``
holds the counts against one).

The families:

- **LM** (``_lm_cell``): ``lm_loss_and_grad`` + ``_apply_opt``,
  ``lm_prefill_step`` and ``lm_decode_step`` on the sharded layout of
  ``models.transformer`` with the reference's variant knobs. A config the
  port's layout cannot split (``T.check_mesh``) raises its
  ``ValueError`` while the cell is built. The port's LM steps take the
  global tokens on every rank (each computes on its rows), and hold
  replicated KV heads and a cache split by batch and heads, where the
  reference splits tokens over the data axes and the cache's sequence.
- **GNN**: nodes and edges padded to a mesh-divisible count as the
  reference pads them; each rank takes a train step on its 1/P share of
  both (its edges' ends taken as its own nodes), the gradients averaged
  over every axis before the optimizer; the parameters are replicated.
- **recsys**: the tables split by rows over ``model``, the candidates
  over every axis, the batch over the data axes when they divide it
  (``models.recsys``'s sharded lookup).
- **MSF** (:func:`build_msf_cell`): the dist driver's loop branches on
  values a meta tensor does not hold, so one Fig-2 round is counted from
  the reference's ``Partition2D`` shapes (``solve.cost.dist_round_terms``)
  and reported per round (``dynamic_loops = 1``), as the reference does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.analysis.roofline import link_of
from repro_torch.configs import registry
from repro_torch.configs.base import GNNConfig, LMConfig, RecsysConfig, ShapeCell
from repro_torch.graphs.partition import pad_n
from repro_torch.graphs.sampler import max_sample_sizes
from repro_torch.launch.fakedist import FAKE_DEVICE, OpTally, tensors
from repro_torch.launch.mesh import P, live_axes, shard_leaf
from repro_torch.models import gnn as G
from repro_torch.models import recsys as R
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import adamw_init, tree_leaves
from repro_torch.solve.cost import dist_round_terms
from repro_torch.train import steps as S


@dataclasses.dataclass
class Cell:
    name: str
    mesh: Any
    meta: Dict[str, Any]
    make_args: Optional[Callable[[Any], tuple]] = None  # device -> the rank's inputs
    fn: Optional[Callable[..., Any]] = None  # the rank's program
    counts: Optional[Dict[str, Any]] = None  # counted from shapes (MSF)


def _gen(device) -> torch.Generator:
    """A seeded generator for ``device`` (a CPU one draws meta tensors)."""
    device = torch.device(device)
    return torch.Generator(device=device if device.type == "cuda" else "cpu").manual_seed(0)


def block_shape(shape, spec, mesh) -> tuple:
    """This rank's block of an array of ``shape`` under ``spec``."""
    out = list(shape)
    for d, entry in enumerate(spec):
        axes = live_axes(mesh, entry)
        if axes:
            n = mesh.axis_size(axes)
            if out[d] % n:
                raise ValueError(f"dimension {d} of {tuple(shape)} does not split over {axes}")
            out[d] //= n
    return tuple(out)


def tree_nbytes(tree) -> int:
    """Bytes of the distinct storages among ``tree``'s tensors."""
    seen, total = set(), 0
    for t in tensors(tree):
        st = t.untyped_storage()
        key = id(st) if t.device.type == "meta" else (st.data_ptr(), st.nbytes())
        if key not in seen:
            seen.add(key)
            total += t.numel() * t.element_size()
    return total


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def _lm_cell(arch: str, cfg: LMConfig, shape: ShapeCell, mesh, variant: Dict) -> Cell:
    if shape.kind in ("prefill", "decode"):
        # serving keeps no float32 master weights
        cfg = dataclasses.replace(cfg, param_dtype=variant.get("serve_param_dtype", "bfloat16"))
    b, s = shape.global_batch, shape.seq_len
    meta: Dict[str, Any] = dict(family="lm", params=cfg.param_count(),
                                active_params=cfg.active_param_count())
    name = f"{arch}:{shape.name}"

    def weights(c, device):
        return T.init_lm(c, _gen(device), device, mesh=mesh).params

    if shape.kind == "train":
        tskip = bool(variant.get("triangle_skip", cfg.triangle_skip))
        cfg = dataclasses.replace(
            cfg,
            vocab_chunk=variant.get("vocab_chunk", cfg.vocab_chunk),
            attn_q_chunk=variant.get("attn_q_chunk", cfg.attn_q_chunk),
            attn_kv_chunk=variant.get("attn_kv_chunk", cfg.attn_kv_chunk),
            remat=bool(variant.get("remat", cfg.remat)),
            fsdp=bool(variant.get("fsdp", cfg.fsdp)),
            grad_accum=int(variant.get("grad_accum", cfg.grad_accum)),
        )
        T.check_mesh(cfg, mesh)
        specs = T.lm_param_specs(cfg, mesh)

        def make_args(device):
            params = weights(cfg, device)
            toks, labels = (torch.zeros((b, s), dtype=torch.int32, device=device)
                            for _ in range(2))
            return params, adamw_init(params), toks, labels

        def fn(params, opt, toks, labels):
            loss, grads = S.lm_loss_and_grad(params, toks, labels, cfg, mesh,
                                             triangle_skip=tskip)
            params, opt, gnorm, _ = S._apply_opt(params, opt, grads, opt.step, mesh=mesh,
                                                 specs=specs)
            return params, opt, {"loss": loss, "gnorm": gnorm}

        meta["model_flops"] = 6 * cfg.active_param_count() * b * s
        return Cell(name, mesh, meta, make_args, fn)

    T.check_mesh(cfg, mesh)
    if shape.kind == "prefill":
        def make_args(device):
            return weights(cfg, device), torch.zeros((b, s), dtype=torch.int32, device=device)

        def fn(params, toks):
            return S.lm_prefill_step(params, toks, cfg, mesh)

        meta["model_flops"] = 2 * cfg.active_param_count() * b * s
        return Cell(name, mesh, meta, make_args, fn)

    if shape.kind == "decode":
        cshape = T.cache_shape(cfg, b, s)
        cspecs = T.cache_specs(cfg, mesh, b)

        def make_args(device):
            cache = {k: torch.zeros(block_shape(c.shape, cspecs[k], mesh), dtype=c.dtype,
                                    device=device) for k, c in cshape.items()}
            return (weights(cfg, device), torch.zeros((b,), dtype=torch.int32, device=device),
                    cache)

        def fn(params, tok, cache):
            return S.lm_decode_step(params, tok, cache, s - 1, cfg, mesh)

        meta["model_flops"] = 2 * cfg.active_param_count() * b
        return Cell(name, mesh, meta, make_args, fn)
    raise ValueError(shape.kind)


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

def _gnn_batch_shapes(cfg: GNNConfig, shape: ShapeCell, mesh):
    """{name: (global shape, dtype)} of a GNN shape cell's batch (directed
    edge count = 2× undirected for the dataset-style cells), node and edge
    counts padded to a multiple of the mesh size as the reference pads
    them; with the input width and the graph count."""
    if shape.name == "minibatch_lg":
        n, e = max_sample_sizes(shape.batch_nodes, shape.fanout)
        n_graphs = 1
    elif shape.name == "molecule":
        n = shape.n_nodes * shape.batch_graphs
        e = shape.n_edges * shape.batch_graphs
        n_graphs = shape.batch_graphs
    else:
        n, e = shape.n_nodes, 2 * shape.n_edges
        n_graphs = 1
    p = math.prod(mesh.shape)
    n = -(-n // p) * p
    e = -(-e // p) * p
    i32, f32 = torch.int32, torch.float32
    batch = dict(src=((e,), i32), dst=((e,), i32), edge_valid=((e,), torch.bool))
    if cfg.kind == "nequip":
        batch.update(species=((n,), i32), pos=((n, 3), f32), graph_ids=((n,), i32),
                     energy=((n_graphs,), f32))
    else:
        batch["x"] = ((n, shape.d_feat), f32)
        if cfg.kind in ("meshgraphnet", "gatedgcn"):
            batch["e_feat"] = ((e, 4 if cfg.kind == "meshgraphnet" else 1), f32)
        if cfg.n_classes:
            batch["labels"] = ((n,), i32)
        else:
            batch["targets"] = ((n, cfg.d_out), f32)
        batch["node_mask"] = ((n,), f32)
    return batch, shape.d_feat, n_graphs


_GNN_INIT = {"gat": G.init_gat, "meshgraphnet": G.init_meshgraphnet,
             "gatedgcn": G.init_gatedgcn, "nequip": G.init_nequip}


def _gnn_cell(arch: str, cfg: GNNConfig, shape: ShapeCell, mesh, variant: Dict) -> Cell:
    batch_shapes, d_in, n_graphs = _gnn_batch_shapes(cfg, shape, mesh)
    cfg = dataclasses.replace(cfg, d_in=d_in or cfg.d_in)
    flat = live_axes(mesh, mesh.axis_names)
    ranks = mesh.axis_size(flat) if flat else 1
    # nodes and edges split over the flattened mesh; the graph energies whole
    specs = {k: P() if k == "energy" else P(tuple(mesh.axis_names)) for k in batch_shapes}

    def make_args(device):
        params = _GNN_INIT[cfg.kind](cfg, _gen(device), device).params
        batch = {k: torch.zeros(block_shape(shp, specs[k], mesh), dtype=dt, device=device)
                 for k, (shp, dt) in batch_shapes.items()}
        return params, adamw_init(params), batch

    def fn(params, opt, batch):
        loss = S.gnn_loss(params, batch, cfg, n_graphs)
        grads = S._grads(loss, params)
        if flat:  # the mean of the ranks' gradients
            for g in tree_leaves(grads):
                mesh.all_reduce_(g.mul_(1.0 / ranks), "sum", flat)
        params, opt, gnorm, _ = S._apply_opt(params, opt, grads, opt.step)
        return params, opt, {"loss": loss.detach(), "gnorm": gnorm}

    # per-edge analytic flops (fwd+bwd ≈ 3×fwd), the reference's
    e = batch_shapes["src"][0][0]
    n = (batch_shapes.get("x") or batch_shapes["species"])[0][0]
    h = cfg.d_hidden
    if cfg.kind == "gat":
        mf = 3 * (2 * n * cfg.d_in * h * cfg.n_heads + 6 * e * h * cfg.n_heads)
    elif cfg.kind == "meshgraphnet":
        mf = 3 * cfg.n_layers * (2 * (3 * h) * h * e * 2 + 2 * (2 * h) * h * n * 2)
    elif cfg.kind == "gatedgcn":
        mf = 3 * cfg.n_layers * (2 * 5 * h * h * (2 * e + 3 * n))
    else:
        paths = len(G.tp_paths(cfg.l_max))
        mf = 3 * cfg.n_layers * e * paths * h * 75  # CG contraction dominated
    return Cell(f"{arch}:{shape.name}", mesh,
                dict(family="gnn", model_flops=mf, n_nodes=n, n_edges=e), make_args, fn)


# ---------------------------------------------------------------------------
# recsys cells
# ---------------------------------------------------------------------------

def _recsys_cell(arch: str, cfg: RecsysConfig, shape: ShapeCell, mesh, variant: Dict) -> Cell:
    dp = live_axes(mesh, T.DP_AXES)
    dsz = mesh.axis_size(dp) if dp else 1
    f = cfg.n_sparse
    name = f"{arch}:{shape.name}"

    def blocks(params):
        """This rank's blocks of whole parameters drawn on their device."""
        specs = S.recsys_specs(params, mesh)
        return {k: shard_leaf(v.detach(), specs[k], mesh).requires_grad_(True)
                for k, v in params.items()}

    if shape.kind == "retrieval":
        # the candidate set padded to a mesh-divisible size (the index build's)
        n_cand = -(-shape.n_candidates // math.prod(mesh.shape)) * math.prod(mesh.shape)

        def make_args(device):
            params = R.init_retrieval(cfg, n_cand, _gen(device), device).params
            return blocks(params), torch.zeros((shape.batch, f), dtype=torch.int32,
                                               device=device)

        def fn(params, ids):
            return S.recsys_retrieval_step(params, ids, cfg, mesh=mesh)

        return Cell(name, mesh, dict(
            family="recsys",
            model_flops=2 * shape.n_candidates * cfg.retrieval_dim * shape.batch),
            make_args, fn)

    b = shape.batch
    rows = b // dsz if b % dsz == 0 and dsz > 1 else b
    d = cfg.embed_dim
    cin_f = 0
    h_prev = f
    for hh in cfg.cin_layers:
        cin_f += 2 * h_prev * f * hh * d
        h_prev = hh
    mlp_f = 0
    dims = [f * d] + list(cfg.mlp_layers) + [1]
    for a_, b_ in zip(dims[:-1], dims[1:]):
        mlp_f += 2 * a_ * b_
    fwd = b * (cin_f + mlp_f)

    def model_args(device):
        params = blocks(R.init_xdeepfm(cfg, _gen(device), device).params)
        return params, torch.zeros((rows, f), dtype=torch.int32, device=device)

    if shape.kind == "train":
        def make_args(device):
            params, ids = model_args(device)
            return (params, adamw_init(params), ids,
                    torch.zeros((rows,), dtype=torch.float32, device=device))

        def fn(params, opt, ids, labels):
            return S.recsys_train_step(params, opt, ids, labels, cfg, mesh=mesh)

        return Cell(name, mesh, dict(family="recsys", model_flops=3 * fwd), make_args, fn)

    def fn(params, ids):
        return S.recsys_serve_step(params, ids, cfg, mesh=mesh)

    return Cell(name, mesh, dict(family="recsys", model_flops=fwd), model_args, fn)


# ---------------------------------------------------------------------------
# MSF engine cells (the paper's own system on the production mesh)
# ---------------------------------------------------------------------------

def build_msf_cell(shape: ShapeCell, mesh, *, shortcut="csp", capacity=1 << 20,
                   pack=0) -> Cell:
    """One Fig-2 round of the dist driver on rank 0, counted from the
    reference's ``Partition2D`` shapes: rows over ``("pod", "data")`` on a
    mesh with a ``pod`` axis, else ``data``; columns over ``model``."""
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    row_axes = ("pod", "data") if "pod" in sizes else ("data",)
    rows = math.prod(sizes[a] for a in row_axes)
    cols = sizes["model"]
    n = shape.n_nodes
    m_dir = 2 * shape.n_edges
    n_pad, size = pad_n(n, rows, cols)
    e_max = -(-m_dir // (rows * cols))
    rnd = dist_round_terms(rows=rows, cols=cols, e_max=e_max, shard_size=size,
                           pack=bool(pack), shortcut=shortcut,
                           capacity=min(capacity, n_pad), row_axes=row_axes)
    counts = dict(
        flops={}, ew_ops=sum(o for _, o in rnd.terms.values()),
        bytes=sum(b for b, _ in rnd.terms.values()), collective=rnd.collective,
        links={k: link_of(mesh, k) for k in rnd.collective}, dynamic_loops=1,
        # src_row, dst_col, w, eid (4 B) and valid (1 B) per edge slot
        arg_bytes=e_max * (4 * 4 + 1), temp_bytes=rnd.temp_bytes,
        # weight, parent [n_pad], msf_eids [n_pad], n_msf_edges, iterations
        output_bytes=4 + 2 * 4 * n_pad + 4 + 4,
        terms=rnd.terms)
    return Cell(
        f"msf-engine:{shape.name}", mesh,
        dict(family="msf", n=n, m=shape.n_edges,
             # per AS iteration: 5 ops/edge × log2(n) iterations as the
             # useful-work proxy (the reference's)
             model_flops=5 * m_dir * max(int(np.log2(max(n, 2))), 1)),
        counts=counts)


# ---------------------------------------------------------------------------

def make_cell(arch: str, cfg, shape: ShapeCell, mesh, variant: Optional[Dict] = None) -> Cell:
    """The cell of ``arch``'s family for a config and a shape of one's own
    (a depth-cut config, a smaller batch)."""
    variant = variant or {}
    family = registry.family_of(arch)
    if family == "lm":
        return _lm_cell(arch, cfg, shape, mesh, variant)
    if family == "gnn":
        return _gnn_cell(arch, cfg, shape, mesh, variant)
    if family == "recsys":
        return _recsys_cell(arch, cfg, shape, mesh, variant)
    raise ValueError(family)


def build_cell(arch: str, shape_name: str, mesh, variant: Optional[Dict] = None) -> Cell:
    return make_cell(arch, registry.get_config(arch), registry.get_shape(arch, shape_name),
                     mesh, variant)


def run_cell(cell: Cell) -> Dict[str, Any]:
    """Rank 0's counts of ``cell`` (the input of
    ``analysis.roofline.roofline``): its program run once on ``"meta"``
    tensors (no data, no memory), or, for an MSF cell, its counts from
    shapes."""
    if cell.counts is not None:
        return cell.counts
    args = cell.make_args(FAKE_DEVICE)
    mesh = cell.mesh
    tally = OpTally(keep=args)
    with mesh.count_collectives() as coll, tally:
        out = cell.fn(*args)
    return dict(flops=tally.flops, ew_ops=0, bytes=tally.bytes, collective=dict(coll),
                links={k: link_of(mesh, k) for k in coll}, dynamic_loops=0,
                arg_bytes=tree_nbytes(args), temp_bytes=tally.peak,
                output_bytes=tree_nbytes(out))
