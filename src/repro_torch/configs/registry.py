"""Arch registry: ``--arch <id>`` → (CONFIG, SMOKE, family, shape cells)."""
from __future__ import annotations

import importlib
from typing import Tuple

from repro_torch.configs.base import (
    GNN_SHAPES,
    LM_SHAPES,
    MSF_SHAPES,
    RECSYS_SHAPES,
    ShapeCell,
)

_ARCHS = {
    # id -> (module, family)
    "kimi-k2-1t-a32b": ("repro_torch.configs.kimi_k2_1t_a32b", "lm"),
    "mixtral-8x7b": ("repro_torch.configs.mixtral_8x7b", "lm"),
    "qwen3-32b": ("repro_torch.configs.qwen3_32b", "lm"),
    "command-r-35b": ("repro_torch.configs.command_r_35b", "lm"),
    "qwen2-7b": ("repro_torch.configs.qwen2_7b", "lm"),
    "gat-cora": ("repro_torch.configs.gat_cora", "gnn"),
    "meshgraphnet": ("repro_torch.configs.meshgraphnet", "gnn"),
    "gatedgcn": ("repro_torch.configs.gatedgcn", "gnn"),
    "nequip": ("repro_torch.configs.nequip", "gnn"),
    "xdeepfm": ("repro_torch.configs.xdeepfm", "recsys"),
}

SHAPES = {"lm": LM_SHAPES, "gnn": GNN_SHAPES, "recsys": RECSYS_SHAPES, "msf": MSF_SHAPES}


def arch_ids():
    return list(_ARCHS)


def family_of(arch: str) -> str:
    return _ARCHS[arch][1]


def get_config(arch: str, smoke: bool = False):
    mod, _ = _ARCHS[arch]
    m = importlib.import_module(mod)
    return m.SMOKE if smoke else m.CONFIG


def shapes_for(arch: str) -> Tuple[ShapeCell, ...]:
    return SHAPES[family_of(arch)]


def get_shape(arch: str, shape_name: str) -> ShapeCell:
    for s in shapes_for(arch):
        if s.name == shape_name:
            return s
    raise KeyError(f"{arch} has no shape {shape_name}")


def all_cells():
    """Every (arch, shape) dry-run cell — 10 archs × 4 shapes = 40."""
    out = []
    for a in _ARCHS:
        for s in shapes_for(a):
            out.append((a, s.name))
    return out
