"""Plain PyTorch versions of the port's kernels: the CPU path and the
oracle each CUDA kernel is held against on the card."""
from __future__ import annotations

import torch

from repro_torch.core.semiring import PACK_IDENTITY


def segment_min_flat_ref(keys: torch.Tensor, segs: torch.Tensor, num_segments: int):
    """``out[s] = min{keys[e] : segs[e] == s}`` over unsorted segment ids.

    keys: int64 [E] holding uint32 pack32 values (``0xFFFFFFFF`` =
    identity); segs: int32 [E]. Returns int64 [num_segments], the identity
    at empty segments. Ids outside ``[0, num_segments)`` are dropped, as
    ``jax.ops.segment_min`` drops them: they are routed to a spare slot
    past the end instead of being scattered out of bounds.
    """
    segs = segs.long()
    in_range = (segs >= 0) & (segs < num_segments)
    idx = torch.where(in_range, segs, num_segments)
    out = torch.full((num_segments + 1,), PACK_IDENTITY, dtype=torch.int64, device=keys.device)
    out.scatter_reduce_(0, idx, keys, "amin", include_self=True)
    return out[:num_segments]


def segment_min_sorted_ref(keys: torch.Tensor, segs: torch.Tensor, num_segments: int):
    """Plain version of the sorted-segment kernel: the same reduction as
    :func:`segment_min_flat_ref`. Sortedness of ``segs`` only restricts how
    the ids may be laid out, not what the result is."""
    return segment_min_flat_ref(keys, segs, num_segments)
