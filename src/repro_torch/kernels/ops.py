"""Wrappers around the port's CUDA kernels and the segment-min resolvers.

A wrapper checks its inputs and then dispatches on the tensors' device:
on the CPU it runs the kernel's plain version (``kernels.ref``); on a
CUDA device it launches the hand-written kernel or raises. There is no
fallback from a failed build or launch. Each wrapper counts its kernel
launches in a plain integer attribute (``segment_min_flat.launches``,
``segment_min_sorted.launches``).
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import segment_min_flat_ref, segment_min_sorted_ref

_INT32_MAX = int(torch.iinfo(torch.int32).max)


@lru_cache(maxsize=None)
def _segment_min_lib(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, whose C entry points are
    ``<name>_launch(keys, segs, out, num_edges, num_segments, stream)`` and
    ``<name>_error_string(code)``."""
    lib = build.load(name)
    launch = getattr(lib, f"{name}_launch")
    launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
    ]
    launch.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def _launch_segment_min(name: str, keys: torch.Tensor, segs: torch.Tensor,
                        out: torch.Tensor) -> None:
    """Launch the CUDA kernel ``name`` into ``out`` on the current stream.
    Every tensor must lie on one CUDA device; anything else raises."""
    devs = {t.device for t in (keys, segs, out)}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise RuntimeError(
            f"{name}'s CUDA kernel needs tensors on one CUDA device, "
            f"got {sorted(str(d) for d in devs)}"
        )
    lib = _segment_min_lib(name)
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        rc = getattr(lib, f"{name}_launch")(
            keys.data_ptr(), segs.data_ptr(), out.data_ptr(),
            keys.numel(), out.numel(), stream,
        )
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")


def _check_segment_min_args(keys, segs, num_segments) -> None:
    if not isinstance(keys, torch.Tensor) or not isinstance(segs, torch.Tensor):
        raise TypeError("keys and segs must be torch tensors")
    if keys.dtype != torch.int64:
        raise ValueError(f"keys must be int64 holding uint32 pack32 values, got {keys.dtype}")
    if segs.dtype != torch.int32:
        raise ValueError(f"segs must be int32, got {segs.dtype}")
    if keys.dim() != 1 or keys.shape != segs.shape:
        raise ValueError(
            f"keys and segs must be 1-D of one length, got {tuple(keys.shape)} "
            f"and {tuple(segs.shape)}"
        )
    if keys.device != segs.device:
        raise ValueError(f"keys on {keys.device} but segs on {segs.device}")
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {keys.device}")
    if not (keys.is_contiguous() and segs.is_contiguous()):
        raise ValueError("keys and segs must be contiguous")
    if not isinstance(num_segments, int) or not 0 <= num_segments <= _INT32_MAX:
        raise ValueError(f"num_segments must be an int in [0, 2^31), got {num_segments!r}")


def segment_min_flat(keys: torch.Tensor, segs: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Packed segment-min over unsorted segment ids.

    keys int64 [E] (uint32 pack32 values, ``0xFFFFFFFF`` = identity),
    segs int32 [E] → int64 [num_segments], the identity at empty segments;
    ids outside ``[0, num_segments)`` are dropped. CPU tensors run
    :func:`~repro_torch.kernels.ref.segment_min_flat_ref`; CUDA tensors
    launch ``csrc/segment_min_flat.cu``.
    """
    _check_segment_min_args(keys, segs, num_segments)
    if keys.device.type == "cpu":
        return segment_min_flat_ref(keys, segs, num_segments)
    out = torch.empty(num_segments, dtype=torch.int64, device=keys.device)
    _launch_segment_min("segment_min_flat", keys, segs, out)
    segment_min_flat.launches += 1
    return out


segment_min_flat.launches = 0


def segment_min_sorted(keys: torch.Tensor, segs: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Packed segment-min over **sorted** (non-decreasing) segment ids, so
    that every segment is one contiguous run: the coarsening dedupe's
    boundary prefix-sum ranks.

    Same contract as :func:`segment_min_flat` (int64 keys holding uint32
    values, identity ``0xFFFFFFFF``, ids outside ``[0, num_segments)``
    dropped). CPU tensors run
    :func:`~repro_torch.kernels.ref.segment_min_sorted_ref`; CUDA tensors
    launch ``csrc/segment_min_sorted.cu``, which still returns the exact
    minimum on unsorted ids, only with more atomics.
    """
    _check_segment_min_args(keys, segs, num_segments)
    if keys.device.type == "cpu":
        return segment_min_sorted_ref(keys, segs, num_segments)
    out = torch.empty(num_segments, dtype=torch.int64, device=keys.device)
    _launch_segment_min("segment_min_sorted", keys, segs, out)
    segment_min_sorted.launches += 1
    return out


segment_min_sorted.launches = 0


def dedupe_segmin_backend(backend: str | None, device_type: str = "cuda"):
    """Packed segment-min callable for a *dedupe* site, whose segment ids
    are sorted (the boundary prefix-sum over sorted pair keys in the
    coarsening filter).

    "sorted"/"cuda" → :func:`segment_min_sorted` (which runs the plain
    version only on CPU tensors); "torch" → the plain version; None/"auto"
    → the kernel wrapper when ``device_type`` is "cuda", the plain version
    elsewhere.
    """
    if backend in (None, "auto"):
        backend = "cuda" if device_type == "cuda" else "torch"
    if backend in ("sorted", "cuda"):
        return segment_min_sorted
    if backend == "torch":
        return segment_min_sorted_ref
    raise ValueError(f"unknown segment-min backend {backend!r}")


def flat_segmin_backend(backend: str | None) -> str | None:
    """Resolve a segmin request for a *flat* reduction site (unsorted
    segment ids): "sorted" is dedupe-only and degrades to "auto"; every
    other request passes through."""
    return "auto" if backend == "sorted" else backend


def make_packed_segmin(backend: str = "auto", device_type: str = "cuda"):
    """Packed segment-min callable ``fn(keys, segs, num_segments)``.

    ``backend``: "torch" (the plain version), "cuda" (the kernel wrapper,
    which runs the plain version only on CPU tensors), "sorted" (the
    sorted-segment kernel wrapper: the caller's segment ids MUST be
    non-decreasing) or "auto" ("cuda" when ``device_type`` is "cuda",
    "torch" otherwise).
    """
    if backend == "auto":
        backend = "cuda" if device_type == "cuda" else "torch"
    if backend == "torch":
        return segment_min_flat_ref
    if backend == "cuda":
        return segment_min_flat
    if backend == "sorted":
        return segment_min_sorted
    raise ValueError(f"unknown segment-min backend {backend!r}")
