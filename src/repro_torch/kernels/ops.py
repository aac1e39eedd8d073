"""Wrappers around the port's CUDA kernels and the segment-min selector.

A wrapper checks its inputs and then dispatches on the tensors' device:
on the CPU it runs the kernel's plain version (``kernels.ref``); on a
CUDA device it launches the hand-written kernel or raises. There is no
fallback from a failed build or launch. Only the wrappers look at the
device: :func:`packed_segmin` picks a wrapper or its plain version by the
request alone. Each wrapper counts its kernel
launches in a plain integer attribute (``segment_min_flat.launches``,
``segment_min_sorted.launches``, ``segment_min_bucketed.launches``,
``multilinear_dense.launches``, ``min_outgoing_flat64.launches``,
``min_outgoing_und64.launches``) and,
while ``repro_torch.obs`` metrics are on, in the counter
``kernel.<name>.launches``: what a serving process reports of its
launches through its ``metrics`` snapshot.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from repro_torch import obs
from repro_torch.core.semiring import PACK_IDENTITY, EdgeMin
# ``ref`` by module: ``core``'s package imports this one (through
# ``core.multilinear``), so an import that starts at ``kernels.ref``
# reaches here before ref's names are bound.
from repro_torch.kernels import build, ref

_INT32_MAX = int(torch.iinfo(torch.int32).max)

_PTR, _I64 = ctypes.c_void_p, ctypes.c_longlong
# The arguments of each kernel's C entry point ``<name>_launch``, in order,
# before the trailing stream: tensors pass as device pointers, ints as 64 bits.
_LAUNCH_ARGS = {
    # keys, segs, out, E, S, head, vec_ids (flat_layout)
    "segment_min_flat": (_PTR, _PTR, _PTR, _I64, _I64, _I64, _I64),
    "segment_min_sorted": (_PTR, _PTR, _PTR, _I64, _I64),  # keys, segs, out, E, S
    # p, a, n, minw, mincol, minpay
    "multilinear_dense": (_PTR, _PTR, _I64, _PTR, _PTR, _PTR),
    # keys, rows, out, nb, be, block_rows, chunks, buckets_per_block (bucketed_split)
    "segment_min_bucketed": (_PTR, _PTR, _PTR, _I64, _I64, _I64, _I64, _I64),
    # p, src, dst, w, eid, valid, out, minw, mineid, pay, count (or NULL),
    # E, n, head, vec_loads (flat64_layout), und (0: directed, 1: undirected)
    "min_outgoing_flat64": (*(_PTR,) * 11, _I64, _I64, _I64, _I64, _I64),
}


@lru_cache(maxsize=None)
def _kernel_lib(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, whose C entry points are
    ``<name>_launch(*_LAUNCH_ARGS[name], stream)`` and
    ``<name>_error_string(code)``."""
    lib = build.load(name)
    launch = getattr(lib, f"{name}_launch")
    launch.argtypes = [*_LAUNCH_ARGS[name], _PTR]
    launch.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def _launch(name: str, *args) -> None:
    """Launch the CUDA kernel ``name`` on the current stream with ``args``
    in the order of ``_LAUNCH_ARGS[name]`` (tensors and ints). Every tensor
    must lie on one CUDA device; anything else raises, and so does a
    non-zero return, with the CUDA error string."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    devs = {t.device for t in tensors}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise RuntimeError(
            f"{name}'s CUDA kernel needs tensors on one CUDA device, "
            f"got {sorted(str(d) for d in devs)}"
        )
    dev = tensors[0].device
    lib = _kernel_lib(name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, f"{name}_launch")(
            *(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args), stream
        )
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")


def _count_launch(wrapper) -> None:
    """One launch of ``wrapper``'s kernel: its ``launches`` attribute, and
    the ``kernel.<name>.launches`` obs counter while metrics are on."""
    wrapper.launches += 1
    if obs.metrics_active():
        obs.counter(f"kernel.{wrapper.__name__}.launches").inc()


@lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def flat_layout(keys_addr: int, segs_addr: int, num_edges: int) -> tuple[int, bool]:
    """Where the flat kernel's warp body starts: ``(head, vec_ids)``.

    The body reads keys two at a time (16 bytes) and, under ``vec_ids``,
    ids four at a time, so it starts at the first edge ``head`` (< 4) at
    which the key address is 16-byte aligned and, where the two addresses
    allow it, the id address too; otherwise ``vec_ids`` is False and the
    body reads ids one by one. The ``head`` edges before the body (at most
    ``num_edges``) are reduced one by one. ``keys_addr`` and ``segs_addr``
    are the data addresses of an int64 and an int32 tensor, so 8- and
    4-byte aligned (a view such as ``keys[1:]`` is only that).
    """
    ks = keys_addr // 8 % 2  # keys past a 16-byte boundary
    ss = segs_addr // 4 % 4  # ids past a 16-byte boundary
    head, vec_ids = ((4 - ss) % 4, True) if ss % 2 == ks else (ks, False)
    return min(head, num_edges), vec_ids


def flat64_layout(int_addrs, valid_addr: int, num_edges: int) -> tuple[int, bool]:
    """Where the min-outgoing kernel's body starts: ``(head, vec_loads)``.

    The body reads each 4-edge group's src, dst, w and eid (4-byte
    elements at the addresses ``int_addrs``) as 16-byte vectors and its
    valid bytes (at ``valid_addr``) as one 4-byte word, from the first edge
    ``head`` (< 4, at most ``num_edges``) at which all five are so aligned.
    Where no edge aligns them all (views that start at different offsets),
    ``vec_loads`` is False, ``head`` is 0 and the body reads edge by edge.
    """
    offsets = {a // 4 % 4 for a in int_addrs} | {valid_addr % 4}
    if len(offsets) != 1:
        return 0, False
    return min((4 - offsets.pop()) % 4, num_edges), True


def _min_outgoing64(wrapper, und: bool, p, a, b, w, eid, valid, n: int, count: bool):
    """Check, then run :func:`min_outgoing_flat64`'s kernel in the mode
    ``und`` (``a``, ``b``: src and dst, or lo and hi) and count the launch
    on ``wrapper``."""
    ends = ("lo", "hi") if und else ("src", "dst")
    arrays = {"p": p, ends[0]: a, ends[1]: b, "w": w, "eid": eid, "valid": valid}
    for name, t in arrays.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch tensor")
        want = {"w": torch.float32, "valid": torch.bool}.get(name, torch.int32)
        if t.dtype != want:
            raise ValueError(f"{name} must be {want}, got {t.dtype}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be 1-D and contiguous")
        if t.device != p.device:
            raise ValueError(f"{name} on {t.device} but p on {p.device}")
    e = a.numel()
    if any(t.numel() != e for t in (b, w, eid, valid)):
        raise ValueError(f"{ends[0]}, {ends[1]}, w, eid and valid must have one length")
    if not isinstance(n, int) or not 0 <= n <= _INT32_MAX or p.numel() != n:
        raise ValueError(f"p must be [n] with n an int in [0, 2^31), got n={n!r}, "
                         f"p {tuple(p.shape)}")
    if p.device.type == "cpu":
        twin = ref.min_outgoing_und64_ref if und else ref.min_outgoing_flat64_ref
        r, cnt = twin(p, a, b, w, eid, valid, n)
        return r, (cnt if count else None)
    if p.device.type != "cuda":
        raise ValueError(f"unsupported device {p.device}")
    dev = p.device
    out = torch.empty(n, dtype=torch.int64, device=dev)
    minw = torch.empty(n, dtype=torch.float32, device=dev)
    mineid = torch.empty(n, dtype=torch.int32, device=dev)
    pay = torch.empty(n, dtype=torch.int32, device=dev)
    cnt = torch.empty((), dtype=torch.int64, device=dev) if count else None
    head, vec = flat64_layout([t.data_ptr() for t in (a, b, w, eid)], valid.data_ptr(), e)
    _launch("min_outgoing_flat64", p, a, b, w, eid, valid, out, minw, mineid, pay,
            cnt if count else 0, e, n, head, int(vec), int(und))
    _count_launch(wrapper)
    return EdgeMin(w=minw, eid=mineid, payload=(pay,)), cnt


def min_outgoing_flat64(p, src, dst, w, eid, valid, n: int, *, count: bool = False):
    """Per-root minimum outgoing edge of a symmetric COO graph whose every
    tree is a star, with 64-bit ``(w, eid)`` keys:
    ``min_outgoing_coo(segment="root")`` without pack32.

    p int32 [n]; src, dst, eid int32 [E]; w float32 [E] (not NaN); valid
    bool [E]; all 1-D and contiguous on one device. Returns ``(EdgeMin over
    [n] with payload (p_dst,), count)``: what ``semiring.segment_argmin``
    gives over the outgoing edges (``valid`` and ``p[src] != p[dst]``), a
    zero weight as ``+0.0``; ``count`` is the 0-d int64 number of outgoing
    edges when asked for, else ``None``. CPU tensors run
    :func:`~repro_torch.kernels.ref.min_outgoing_flat64_ref`; CUDA tensors
    launch ``csrc/min_outgoing_flat64.cu``, which allocates nothing
    edge-sized and waits on nothing.
    """
    return _min_outgoing64(min_outgoing_flat64, False, p, src, dst, w, eid, valid, n, count)


min_outgoing_flat64.launches = 0


def min_outgoing_und64(p, lo, hi, w, eid, valid, n: int, *, count: bool = False):
    """:func:`min_outgoing_flat64` over undirected edges held once each:
    the per-root MINWEIGHT of a coarsen level's hook round.

    An edge ``(lo, hi)`` is outgoing when ``valid`` and ``p[lo] != p[hi]``;
    it offers its ``(w, eid)`` to ``p[lo]`` with the payload ``p[hi]`` and
    to ``p[hi]`` with ``p[lo]``. Returns ``(EdgeMin over [n] with payload
    (the winner's other root,), count)``: what ``semiring.segment_argmin``
    gives over both directions of the outgoing edges, a zero weight as
    ``+0.0`` and ``(inf, IMAX, IMAX)`` at a root with none; ``count`` is
    the 0-d int64 number of outgoing undirected edges when asked for, else
    ``None``. Arguments as :func:`min_outgoing_flat64`'s. CPU tensors run
    :func:`~repro_torch.kernels.ref.min_outgoing_und64_ref`; CUDA tensors
    launch ``csrc/min_outgoing_flat64.cu`` in its undirected mode.
    """
    return _min_outgoing64(min_outgoing_und64, True, p, lo, hi, w, eid, valid, n, count)


min_outgoing_und64.launches = 0


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
        return ref.segment_min_flat_ref(keys, segs, num_segments)
    out = torch.empty(num_segments, dtype=torch.int64, device=keys.device)
    head, vec_ids = flat_layout(keys.data_ptr(), segs.data_ptr(), keys.numel())
    _launch("segment_min_flat", keys, segs, out, keys.numel(), num_segments, head, int(vec_ids))
    _count_launch(segment_min_flat)
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
        return ref.segment_min_sorted_ref(keys, segs, num_segments)
    out = torch.empty(num_segments, dtype=torch.int64, device=keys.device)
    _launch("segment_min_sorted", keys, segs, out, keys.numel(), num_segments)
    _count_launch(segment_min_sorted)
    return out


segment_min_sorted.launches = 0


def _check_bucketed_args(keys, rows, block_rows) -> None:
    """The reference's validation of the bucketed layout
    (``repro.kernels.segment_min_bucketed``), on the port's dtypes."""
    if not isinstance(keys, torch.Tensor) or not isinstance(rows, torch.Tensor):
        raise TypeError("keys and rows must be torch tensors")
    if keys.shape != rows.shape:
        raise ValueError(f"keys/rows shape mismatch: {tuple(keys.shape)} vs {tuple(rows.shape)}")
    if keys.dtype != torch.int64:
        raise ValueError(f"keys must be int64 holding uint32 pack32 values, got {keys.dtype}")
    if rows.dtype != torch.int32:
        raise ValueError(f"rows must be int32, got {rows.dtype}")
    if not isinstance(block_rows, int) or block_rows <= 0 or block_rows % 8:
        raise ValueError(f"block_rows must be a positive multiple of 8, got {block_rows!r}")
    if keys.dim() != 2:
        raise ValueError(f"expected [NB, BE] bucketed layout, got {tuple(keys.shape)}")
    nb, be = keys.shape
    if nb == 0 or be == 0:
        raise ValueError(
            f"empty bucket layout {tuple(keys.shape)}; pad each bucket to >= 128 "
            f"lanes (see bucket_edges_by_row_block)"
        )
    if be % 128:
        raise ValueError(f"bucket edge dim {be} must be a multiple of 128 lanes")
    if keys.device != rows.device:
        raise ValueError(f"keys on {keys.device} but rows on {rows.device}")
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {keys.device}")
    if not (keys.is_contiguous() and rows.is_contiguous()):
        raise ValueError("keys and rows must be contiguous")


# About how many entries a block of the bucketed kernel should reduce, so
# that setting and writing its slots stays a small share of its work.
_BUCKET_BLOCK_ENTRIES = 4096
_MAX_CLUSTER = 8  # the card's portable thread-block cluster size
_DEFAULT_SHARED_BYTES = 48 * 1024


def bucketed_split(nb: int, be: int, block_rows: int, sms: int) -> tuple[int, int]:
    """How the bucketed kernel cuts an [NB, BE] layout into blocks:
    ``(chunks, buckets_per_block)``, one of them 1.

    A few wide buckets (R-MAT's hubs) are each cut into ``chunks`` ranges,
    one block per range and one thread-block cluster per bucket, doubling
    while the card holds fewer than 8 blocks per SM (``sms`` SMs) and a
    range keeps at least a quarter of ``_BUCKET_BLOCK_ENTRIES``; at most
    ``_MAX_CLUSTER``, and only while one bucket's slots fit in 48 KB of
    shared memory. Narrow buckets (the grid's) go ``buckets_per_block`` to
    a block, doubling while a block holds fewer than
    ``_BUCKET_BLOCK_ENTRIES`` entries, the card keeps at least one block
    per SM and the slots fit in 48 KB.
    """
    slot_bytes = block_rows * 8
    chunks = 1
    while (chunks < _MAX_CLUSTER and be // (2 * chunks) >= _BUCKET_BLOCK_ENTRIES // 4
           and nb * chunks < 8 * sms and slot_bytes <= _DEFAULT_SHARED_BYTES):
        chunks *= 2
    per_block = 1
    while (chunks == 1 and per_block * be < _BUCKET_BLOCK_ENTRIES
           and -(-nb // (2 * per_block)) >= sms
           and 2 * per_block * slot_bytes <= _DEFAULT_SHARED_BYTES):
        per_block *= 2
    return chunks, per_block


def segment_min_bucketed(keys: torch.Tensor, rows: torch.Tensor, *,
                         block_rows: int = 128) -> torch.Tensor:
    """Packed segment-min over edges pre-grouped by output row block:
    ``out[b * block_rows + r] = min{keys[b, e] : rows[b, e] == r}``.

    keys int64 [NB, BE] (uint32 pack32 values, ``0xFFFFFFFF`` = identity
    and padding), rows int32 [NB, BE] (local row in the bucket's block) →
    int64 [NB * block_rows]; rows outside ``[0, block_rows)`` are dropped.
    The layout comes from :func:`bucket_edges_by_row_block`. CPU tensors
    run :func:`~repro_torch.kernels.ref.segment_min_bucketed_ref`; CUDA
    tensors launch ``csrc/segment_min_bucketed.cu``, cut into blocks by
    :func:`bucketed_split`; the launch raises when ``block_rows * 8`` bytes
    exceed the card's shared memory per block.
    """
    _check_bucketed_args(keys, rows, block_rows)
    if keys.device.type == "cpu":
        return ref.segment_min_bucketed_ref(keys, rows, block_rows)
    nb, be = keys.shape
    out = torch.empty(nb * block_rows, dtype=torch.int64, device=keys.device)
    chunks, per_block = bucketed_split(nb, be, block_rows, _sm_count(keys.device))
    _launch("segment_min_bucketed", keys, rows, out, nb, be, block_rows, chunks, per_block)
    _count_launch(segment_min_bucketed)
    return out


segment_min_bucketed.launches = 0


def multilinear_dense(p: torch.Tensor, a: torch.Tensor):
    """Min outgoing edge per vertex over a dense adjacency (paper §III-A).

    For each row i, the lexicographic argmin over j of ``(a_ij, j)``
    subject to ``p_i != p_j`` and ``a_ij < inf`` (NaN is never valid,
    -inf is), with payload ``p_j`` of the winner. p [n] is cast to int32;
    a must be a square, contiguous float32 [n, n] (+inf = no edge).
    Returns (minw float32 [n], mincol int32 [n], minpay int32 [n]), the
    identity ``(inf, IMAX, IMAX)`` at rows with no valid entry. When +0.0
    and -0.0 tie for the minimum, the smaller column wins and the CUDA
    kernel's ``minw`` carries the sign of ``a[i, mincol]`` (the plain
    version's sign there is ``torch.amin``'s).

    CPU tensors run :func:`~repro_torch.kernels.ref.multilinear_dense_ref`;
    CUDA tensors launch ``csrc/multilinear_dense.cu``, on any n (no
    padding).
    """
    if not isinstance(p, torch.Tensor) or not isinstance(a, torch.Tensor):
        raise TypeError("p and a must be torch tensors")
    if a.dtype != torch.float32:
        raise ValueError(f"a must be float32, got {a.dtype}")
    if a.dim() != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"a must be square [n, n], got {tuple(a.shape)}")
    if not a.is_contiguous():
        raise ValueError("a must be contiguous")
    n = a.shape[0]
    if p.shape != (n,):
        raise ValueError(f"p must be [n] = [{n}], got {tuple(p.shape)}")
    if p.device != a.device:
        raise ValueError(f"p on {p.device} but a on {a.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {a.device}")
    p = p.to(torch.int32).contiguous()
    if a.device.type == "cpu":
        return ref.multilinear_dense_ref(p, a)
    minw = torch.empty(n, dtype=torch.float32, device=a.device)
    mincol = torch.empty(n, dtype=torch.int32, device=a.device)
    minpay = torch.empty(n, dtype=torch.int32, device=a.device)
    _launch("multilinear_dense", p, a, n, minw, mincol, minpay)
    _count_launch(multilinear_dense)
    return minw, mincol, minpay


multilinear_dense.launches = 0


def packed_segmin(request: str | None, site: str):
    """The packed segment-min ``fn(keys, segs, num_segments)`` that a
    segmin ``request`` (``coarsen.config.SEGMIN_BACKENDS``) selects at a
    reduction ``site``: "flat" (unsorted segment ids: the hook loops) or
    "dedupe" (the coarsening filter's sorted boundary prefix-sum ranks).

    "torch" gives the plain version. Every other request gives the kernel
    wrapper, which runs the plain version on CPU tensors itself:
    :func:`segment_min_flat` at a flat site ("sorted" degrades to it
    there) and :func:`segment_min_sorted` at the dedupe site. The
    selection takes no device. Unlike ``repro.solve.spec``, None gives a
    level's hook the kernel too: the plain ``scatter_reduce_`` serialises
    on the identity keys of the edges that are not outgoing, which the
    kernel skips; the minimum is the same.
    """
    if request not in (None, "auto", "torch", "cuda", "sorted"):
        raise ValueError(f"unknown segment-min backend {request!r}")
    kernel, plain = {"flat": (segment_min_flat, ref.segment_min_flat_ref),
                     "dedupe": (segment_min_sorted, ref.segment_min_sorted_ref)}[site]
    return plain if request == "torch" else kernel


def bucket_edges_by_row_block(seg: torch.Tensor, keys: torch.Tensor, n: int,
                              block_rows: int = 128):
    """Group edges by output row block ``seg // block_rows`` and pad every
    bucket to the widest one, rounded up to a multiple of 128 (at least
    128), for :func:`segment_min_bucketed`.

    seg: integer [E] in ``[0, n)``; keys: [E] uint32 pack32 values (any
    integer dtype). Returns (keys int64 [NB, BE], rows int32 [NB, BE]) on
    the input's device, NB = ceil(n / block_rows): within a bucket the
    edges keep their input order; padding has the identity key and row 0.
    The same arrays as the reference's host loop, built with one stable
    sort and one scatter.
    """
    if seg.shape != keys.shape or seg.dim() != 1:
        raise ValueError(f"seg and keys must be 1-D of one length, got "
                         f"{tuple(seg.shape)} and {tuple(keys.shape)}")
    dev = seg.device
    nb = -(-n // block_rows)
    e = seg.numel()
    seg = seg.long()
    if e and (int(seg.min()) < 0 or int(seg.max()) >= n):
        raise ValueError(f"segment ids must lie in [0, {n})")
    b = seg // block_rows
    counts = torch.bincount(b, minlength=nb)
    be = max(128, -(-int(counts.max()) // 128) * 128) if e else 128
    order = torch.sort(b, stable=True).indices
    b_s = b[order]
    starts = torch.cumsum(counts, 0) - counts
    pos = b_s * be + torch.arange(e, device=dev) - starts[b_s]
    keys_out = torch.full((nb * be,), PACK_IDENTITY, dtype=torch.int64, device=dev)
    rows_out = torch.zeros(nb * be, dtype=torch.int32, device=dev)
    keys_out[pos] = keys.long()[order]
    rows_out[pos] = (seg[order] - b_s * block_rows).to(torch.int32)
    return keys_out.view(nb, be), rows_out.view(nb, be)
