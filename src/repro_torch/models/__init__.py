"""GNN, recsys and LM models (``gnn``, ``recsys``, ``o3``, ``layers``,
``transformer``), each an ``nn.Module`` holding its parameters under the
reference's names, and the bridge to the reference's parameter trees: flat
dicts (GNN, recsys) or nested ones (the LM's ``layers``)."""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.models.gnn import ParamModel


def _copy_in(ours: Dict[str, Any], theirs: Mapping[str, Any], path: str) -> None:
    if set(theirs) != set(ours):
        raise KeyError(f"parameter names differ{path and ' under ' + path}: "
                       f"{sorted(set(theirs) ^ set(ours))}")
    for k, p in ours.items():
        if isinstance(p, dict):
            _copy_in(p, theirs[k], f"{path}{k}.")
            continue
        v = torch.from_numpy(np.array(theirs[k]))  # a writable host copy
        if v.shape != p.shape:
            raise ValueError(f"{path}{k}: shape {tuple(v.shape)}, the module has {tuple(p.shape)}")
        p.copy_(v)


def from_reference(module: ParamModel, params: Mapping[str, Any]) -> ParamModel:
    """Load the reference's parameter tree (its arrays as numpy, under the
    same names, nesting and shapes) into ``module`` in place, on its device."""
    with torch.no_grad():
        _copy_in(module.params, params, "")
    return module


def _host(tree: Dict[str, Any]) -> Dict[str, Any]:
    return {k: _host(p) if isinstance(p, dict) else p.detach().cpu().numpy()
            for k, p in tree.items()}


def to_reference(module: ParamModel) -> Dict[str, Any]:
    """``module``'s parameters as the reference's tree of numpy arrays."""
    return _host(module.params)
