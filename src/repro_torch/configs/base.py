"""Config dataclasses for every architecture family + shape cells
(a copy of the reference's ``configs/base.py``; ``models.transformer``
builds the LM configs, on one device or sharded over a mesh).

Every assigned architecture gets a module ``repro_torch.configs.<id>``
exporting ``CONFIG`` (the exact published configuration) and ``SMOKE`` (a
reduced same-family config for CPU smoke tests).
``repro_torch.configs.registry`` maps ``--arch`` ids to them and
enumerates the (arch × shape) dry-run cells.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    n_shared: int = 0


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # defaults to d_model // n_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    attn_out_bias: bool = False
    sliding_window: Optional[int] = None  # SWA window (Mixtral: 4096)
    moe: Optional[MoEConfig] = None
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"  # activation/compute dtype
    param_dtype: str = "float32"
    fsdp: bool = False  # additionally shard params over the dp axes
    remat: bool = True
    attn_q_chunk: int = 2048  # blockwise-attention query chunk
    attn_kv_chunk: int = 2048
    vocab_chunk: Optional[int] = None  # chunked CE loss (perf knob)
    grad_accum: int = 1  # microbatches per step (divides activation memory)
    triangle_skip: bool = True  # skip above-diagonal attention chunk pairs

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Analytic parameter count (for 6·N·D roofline bookkeeping)."""
        d, hd = self.d_model, self.hd
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        if self.moe:
            ffn = self.moe.n_experts * 3 * d * self.d_ff + d * self.moe.n_experts
            ffn += self.moe.n_shared * 3 * d * self.d_ff
        else:
            ffn = 3 * d * self.d_ff
        per_layer = attn + ffn + 2 * d
        return self.n_layers * per_layer + 2 * self.vocab * d + d

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k + shared experts only)."""
        if not self.moe:
            return self.param_count()
        d = self.d_model
        dense = self.param_count() - self.n_layers * (
            (self.moe.n_experts - 0) * 3 * d * self.d_ff
        )
        active_ffn = self.n_layers * (self.moe.top_k + self.moe.n_shared) * 3 * d * self.d_ff
        return dense + active_ffn - self.n_layers * self.moe.n_shared * 3 * d * self.d_ff


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    kind: str  # "gat" | "meshgraphnet" | "gatedgcn" | "nequip"
    n_layers: int
    d_hidden: int
    n_heads: int = 1
    aggregator: str = "sum"  # sum | attn | gated
    mlp_layers: int = 2
    # nequip-specific
    l_max: int = 0
    n_rbf: int = 0
    cutoff: float = 0.0
    d_in: int = 0  # input feature dim (set per shape)
    n_classes: int = 0  # classification heads; 0 → regression
    d_out: int = 1
    dtype: str = "float32"
    param_dtype: str = "float32"
    predict_forces: bool = False


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    n_sparse: int
    embed_dim: int
    cin_layers: Tuple[int, ...]
    mlp_layers: Tuple[int, ...]
    total_vocab: int
    n_dense: int = 0
    retrieval_dim: int = 32
    dtype: str = "float32"
    param_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class MSFConfig:
    """Shape cell config for the MSF engine itself (the paper's system)."""

    name: str
    n: int
    m_directed: int  # total directed edge slots (2× undirected, padded)
    shortcut: str = "csp"
    capacity: int = 1 << 20


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (architecture × input-shape) dry-run cell."""

    name: str
    kind: str  # train | prefill | decode | serve | retrieval | ...
    # LM shapes
    seq_len: int = 0
    global_batch: int = 0
    # GNN shapes
    n_nodes: int = 0
    n_edges: int = 0
    d_feat: int = 0
    batch_nodes: int = 0
    fanout: Tuple[int, ...] = ()
    batch_graphs: int = 0
    # recsys shapes
    batch: int = 0
    n_candidates: int = 0


LM_SHAPES = (
    ShapeCell(name="train_4k", kind="train", seq_len=4096, global_batch=256),
    ShapeCell(name="prefill_32k", kind="prefill", seq_len=32768, global_batch=32),
    ShapeCell(name="decode_32k", kind="decode", seq_len=32768, global_batch=128),
    ShapeCell(name="long_500k", kind="decode", seq_len=524288, global_batch=1),
)

GNN_SHAPES = (
    ShapeCell(name="full_graph_sm", kind="train", n_nodes=2708, n_edges=10556, d_feat=1433),
    ShapeCell(
        name="minibatch_lg",
        kind="train",
        n_nodes=232965,
        n_edges=114615892,
        batch_nodes=1024,
        fanout=(15, 10),
        d_feat=602,
    ),
    ShapeCell(name="ogb_products", kind="train", n_nodes=2449029, n_edges=61859140, d_feat=100),
    ShapeCell(name="molecule", kind="train", n_nodes=30, n_edges=64, batch_graphs=128, d_feat=4),
)

RECSYS_SHAPES = (
    ShapeCell(name="train_batch", kind="train", batch=65536),
    ShapeCell(name="serve_p99", kind="serve", batch=512),
    ShapeCell(name="serve_bulk", kind="serve", batch=262144),
    ShapeCell(name="retrieval_cand", kind="retrieval", batch=1, n_candidates=1_000_000),
)

MSF_SHAPES = (
    ShapeCell(name="road_like", kind="msf", n_nodes=23_947_347, n_edges=28_854_312),
    ShapeCell(name="rmat_s23_e8", kind="msf", n_nodes=1 << 23, n_edges=(1 << 23) * 8),
    ShapeCell(name="rmat_s23_e128", kind="msf", n_nodes=1 << 23, n_edges=(1 << 23) * 128),
    ShapeCell(name="friendster_like", kind="msf", n_nodes=65_600_000, n_edges=1_800_000_000),
)
