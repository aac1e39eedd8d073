"""GNN and recsys models (``gnn``, ``recsys``, ``o3``), each an
``nn.Module`` holding its parameters under the reference's names, and
the bridge to the reference's parameter dicts."""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.models.gnn import ParamModel


def from_reference(module: ParamModel, params: Mapping[str, np.ndarray]) -> ParamModel:
    """Load the reference's parameter dict (its arrays as numpy, under the
    same names and shapes) into ``module`` in place, on its device."""
    if set(params) != set(module.params):
        raise KeyError(f"parameter names differ: {sorted(set(params) ^ set(module.params))}")
    with torch.no_grad():
        for k, p in module.params.items():
            v = torch.from_numpy(np.array(params[k]))  # a writable host copy
            if v.shape != p.shape:
                raise ValueError(f"{k}: shape {tuple(v.shape)}, the module has {tuple(p.shape)}")
            p.copy_(v)
    return module


def to_reference(module: ParamModel) -> Dict[str, np.ndarray]:
    """``module``'s parameters as the reference's dict of numpy arrays."""
    return {k: p.detach().cpu().numpy() for k, p in module.params.items()}
