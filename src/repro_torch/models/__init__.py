"""GNN, recsys and LM models (``gnn``, ``recsys``, ``o3``, ``layers``,
``transformer``), each an ``nn.Module`` holding its parameters under the
reference's names, and the bridge to the reference's parameter trees: flat
dicts (GNN, recsys) or nested ones (the LM's ``layers``). An LM on a mesh
holds this rank's blocks: the bridge cuts the reference's whole arrays on
the way in and gathers them on the way out."""
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


def _mesh_of(module: ParamModel):
    return getattr(module, "mesh", None)


def from_reference(module: ParamModel, params: Mapping[str, Any]) -> ParamModel:
    """Load the reference's parameter tree (its arrays as numpy, under the
    same names, nesting and shapes) into ``module`` in place, on its device
    (an LM on a mesh keeps this rank's blocks of them)."""
    mesh = _mesh_of(module)
    if mesh is not None:
        from repro_torch.models.transformer import shard_params

        params = shard_params(params, module.cfg, mesh)
    with torch.no_grad():
        _copy_in(module.params, params, "")
    return module


def _host(tree: Dict[str, Any]) -> Dict[str, Any]:
    return {k: _host(p) if isinstance(p, dict) else p.detach().cpu().numpy()
            for k, p in tree.items()}


def to_reference(module: ParamModel) -> Dict[str, Any]:
    """``module``'s parameters as the reference's tree of numpy arrays
    (an LM on a mesh gathers them: collective)."""
    mesh = _mesh_of(module)
    if mesh is not None:
        from repro_torch.models.transformer import gather_params

        return _host(gather_params(module.params, module.cfg, mesh))
    return _host(module.params)
