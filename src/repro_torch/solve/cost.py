"""Analytic cost of a plan — ``Plan.cost`` and ``SolveReport.cost``
(counterpart of ``repro.solve.cost``).

The reference lowers the jitted driver and reads the counts off the XLA
HLO. The port runs eager PyTorch, so there is no executable to read:
this module counts, pass by pass, the device memory traffic and the
elementwise operations of the code the engine runs, from the shapes
alone (``n`` and the directed edge count ``E``) and the resolved spec.
It reads no tensor and adds no host sync at plan build.

Scope and units, as in the reference:

- **flat** — one AS round of ``core/msf.py::_make_msf_body``
  (``dynamic_loops = 1``: the counts are per round; multiply by
  ``report.iterations``). The terms: the ``p[src]``/``p[dst]`` gathers
  (``gathers``), the int32 → int64 casts torch indexing makes of every
  int32 index (``index_casts``), the pack32 key build (``key_build``),
  the segment-min (``segment_min``, counted as ``chip_smoke.py``'s
  ``segmin_bytes`` counts it at its ``live == E`` upper bound: 8 B per
  key, 4 B per id, 8 B per output), the winners' payload pass
  (``payload``), ``hook_and_tiebreak`` (``hook``), ``record_edges``
  (``record``) and the shortcut (``shortcut``: ``SHORTCUT_STEPS``
  pointer-jump steps, or CSP's changed map) with the convergence test.
  Without pack32 the reduction is, on the card, the hand-written
  64-bit-key kernel (``kernels.ops.min_outgoing_flat64``, charged with
  every edge outgoing: ``gathers`` its two passes' reads of ``p``,
  ``segment_min`` the fill and the reduce pass, ``payload`` the payload
  pass and the decode), and for a plan resolved for another device the
  three-pass masked float ``segment_argmin`` (``segment_min``: the
  scatters at their traffic, ``payload``: the passes between them), not
  the passes of the kernel's twin that the CPU runs.
- **coarsen** — level 0 of ``coarsen/engine.py``: its K hook rounds over
  the undirected arrays (``contract.py::make_und_reduce``: two
  segment-mins per round; without pack32, for a plan resolved for the
  card, one call of the 64-bit kernel's undirected mode,
  ``kernels.ops.min_outgoing_und64``, charged as the flat round's with
  the payload pass reading both roots' keys), the rank relabel and, for
  ``fused=True``,
  the dedupe (sort, ``segment_min_sorted``, compaction) and the label
  composition (``analyzed="coarsen.level0.fused"``; unfused:
  ``"coarsen.level0"``, the contract half only, as the reference
  analyses ``contract_level_und``). The rounds are a fixed count, so
  ``dynamic_loops = 0``. The undirected edge count is taken as ``E // 2``
  and the eid capacity as its power of two (symmetric graphs whose eids
  number the undirected edges). When ``n <= cutoff`` no level runs and
  the flat cost is reported.
- **stream, dist, int or partitioned targets, variants other than
  "complete"** — ``None``, as in the reference. One Fig-2 round of the
  dist driver on one rank is counted by :func:`dist_round_terms`, which
  the dry run's MSF cells call (``launch/cells.py``), not ``plan_cost``.

What the model cannot see: the pointer-jump steps a round really takes
(data-dependent; charged as ``SHORTCUT_STEPS``), the live share of the
keys (the segment-min is charged at ``live == E``), the winners' count
(charged at its bound, one per vertex), cache reuse, kernel launch and
host time. Every failure yields ``None`` rather than a failed plan.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

from repro_torch.analysis.roofline import H100_SXM, roofline_time_s
from repro_torch.coarsen.config import resolve_dedupe

#: Pointer-jump steps charged per shortcut: one jump and the fixpoint test.
SHORTCUT_STEPS = 2
#: Passes of the radix sort of int64 keys with int64 indices (8-bit digits).
RADIX_PASSES_INT64 = 8
#: Doubling iterations charged for CSP's changed-map compression.
CSP_COMPRESS_STEPS = 2
PACK_IDX_MASK = (1 << 24) - 1

_I32, _I64, _F32, _B = 4, 8, 4, 1


class PlanCost(NamedTuple):
    """Analytic cost of the plan's dominant work (one card)."""

    flops: float  # dot_flops + ew_flops
    dot_flops: float
    ew_flops: float
    bytes: float  # device memory traffic, each pass's inputs read once, outputs written once
    collective_bytes: float  # inter-device volume (0 on one card)
    dynamic_loops: int  # > 0: counts are per round of the AS loop
    analyzed: str  # which work the counts describe

    def as_dict(self) -> dict:
        d = self._asdict()
        d["dynamic_loops"] = int(self.dynamic_loops)
        return d


def predicted_time_s(cost: Optional[PlanCost], *, iterations: int = 1) -> Optional[float]:
    """Roofline time of the plan's work on one H100 SXM at 700 W
    (``repro_torch.analysis.roofline``), in seconds. Per-round costs
    (``dynamic_loops > 0``) are multiplied by ``iterations``. The
    autotuner's pruning metric: only the order matters. ``None`` in,
    ``None`` out."""
    if cost is None:
        return None
    mult = max(int(iterations), 1) if cost.dynamic_loops else 1
    return mult * roofline_time_s(dot_flops=cost.dot_flops, ew_ops=cost.ew_flops,
                                  bytes_=cost.bytes, hw=H100_SXM)


# ---------------------------------------------------------------------------
# pass counting
# ---------------------------------------------------------------------------

class _Tally:
    """Named terms of (bytes, elementwise ops)."""

    def __init__(self):
        self.terms: dict = {}

    def add(self, term: str, bytes_: float, ops: float = 0.0) -> None:
        b, o = self.terms.get(term, (0.0, 0.0))
        self.terms[term] = (b + bytes_, o + ops)

    def ew(self, term: str, k: int, b_in: int, b_out: int, ops: int = 1) -> None:
        """One elementwise pass over ``k`` elements."""
        self.add(term, k * (b_in + b_out), k * ops)

    def gather(self, term: str, k: int, val: int, idx32: bool = True) -> None:
        """``x[idx]`` with ``k`` indices: an int32 index is first cast to
        int64 (``index_casts``); the gather reads the index and the
        values and writes the values."""
        if idx32:
            self.ew("index_casts", k, _I32, _I64)
        self.add(term, k * (_I64 + 2 * val))

    def scatter_min(self, term: str, k: int, val: int, n: int, idx32: bool = True) -> None:
        """``semiring.segment_min``: fill [n], cast the ids, scatter-min
        ``k`` values (each output read and written)."""
        self.add(term, n * val)
        if idx32:
            self.ew("index_casts", k, _I32, _I64)
        self.add(term, k * (_I64 + val) + 2 * n * val, k)


def _key_build(t: _Tally, k: int) -> None:
    """``where(out, w, 0).to(int64)``, ``pack32`` and the identity mask."""
    t.ew("key_build", k, _B + _F32, _F32)  # where(out, w, 0.0)
    t.ew("key_build", k, _F32, _I64)  # .to(int64)
    t.ew("key_build", k, _I64, _I64)  # & 0xFFFFFFFF
    t.ew("key_build", k, _I64, _I64)  # << 24
    t.ew("key_build", k, _I64, _I64)  # & 0xFFFFFFFF
    t.ew("key_build", k, _I32, _I64)  # eid.to(int64)
    t.ew("key_build", k, _I64, _I64)  # & 0xFFFFFF
    t.ew("key_build", k, 2 * _I64, _I64)  # |
    t.ew("key_build", k, _B + _I64, _I64)  # where(out, key, identity)


def _segmin_packed(t: _Tally, e: int, n: int) -> None:
    """A packed segment-min of ``e`` keys into ``n`` segments, as
    ``chip_smoke.py::segmin_bytes`` counts it with every key live."""
    t.add("segment_min", e * (_I64 + _I32) + n * _I64, e)


def _outgoing_mask(t: _Tally, e: int) -> None:
    """``p[src]``, ``p[dst]`` and the outgoing mask, in torch."""
    t.gather("gathers", e, _I32)  # p[src]
    t.gather("gathers", e, _I32)  # p[dst]
    t.ew("key_build", e, 2 * _I32, _B)  # ps != pd
    t.ew("key_build", e, 2 * _B, _B)  # & valid


def _min_outgoing64(t: _Tally, e: int, n: int, sides: int = 1) -> None:
    """``kernels.ops.min_outgoing_flat64`` with every edge outgoing: the
    fill, the reduce pass and the payload pass (each streams src, dst,
    valid, w and eid and gathers ``p`` twice; the payload pass reads the
    root's key per edge, and in the undirected mode, ``sides`` 2, both
    roots' keys) and the decode."""
    for term in ("segment_min", "payload"):
        t.add(term, e * (2 * _I32 + _B + _F32 + _I32), e)
        t.add("gathers", e * 2 * _I32)
    t.add("segment_min", n * 2 * _I64)  # the fill; one key written per root
    t.add("payload", sides * e * _I64 + n * 2 * _I32)  # out[ps]; the fill, one payload per root
    t.add("payload", n * (_I64 + _F32 + _I32))  # the decode


def _unpack(t: _Tally, term: str, n: int) -> None:
    t.ew(term, n, _I64, _I64)  # >> 24
    t.ew(term, n, _I64, _I32)  # .to(int32)
    t.ew(term, n, _I64, _I64)  # & 0xFFFFFF
    t.ew(term, n, _I64, _I32)  # .to(int32)
    t.ew(term, n, _I64, _B)  # == identity
    t.ew(term, n, _B + _I32, _F32, 2)  # where(empty, inf, w.to(f32))
    t.ew(term, n, _B + _I32, _I32)  # where(empty, IMAX, eid)


def _hook_record(t: _Tally, n: int) -> None:
    """``hook_and_tiebreak``, the weight sum and ``record_edges``."""
    t.add("hook", n * _I32)  # arange
    t.ew("hook", n, _F32, _B)  # r_w < inf
    t.ew("hook", n, _B + 2 * _I32, _I32)  # where(hooked, r_parent, p)
    t.ew("hook", n, 2 * _I32, _B)  # i < p_h
    t.gather("hook", n, _I32)  # p_h[p_h]
    t.ew("hook", n, 2 * _I32, _B)  # == i
    t.ew("hook", n, 2 * _B, _B, 2)  # the two &
    t.ew("hook", n, _B + 2 * _I32, _I32)  # where(t, i, p_h)
    t.ew("hook", n, 2 * _B, _B, 2)  # hooked & ~t
    t.ew("record", n, _B + _F32, _F32)  # where(keep, w, 0)
    t.ew("record", n, _F32, 0)  # .sum()
    t.ew("record", n, _B, _I32)  # cumsum
    t.ew("record", n, _I32, _I32, 2)  # n_f + cumsum - 1
    t.ew("record", n, _B, _I64)  # nonzero (winners at their bound)
    t.gather("record", n, _I32, idx32=False)  # pos[win]
    t.ew("index_casts", n, _I32, _I64)  # .long()
    t.gather("record", n, _I32, idx32=False)  # r_eid[win]
    t.add("record", n * (_I64 + 2 * _I32))  # msf_eids[pos] = ...
    t.ew("record", n, _B, 0)  # keep.sum()


def _complete_shortcut(t: _Tally, n: int) -> None:
    for _ in range(SHORTCUT_STEPS):
        t.gather("shortcut", n, _I32)  # p[p]
        t.ew("shortcut", n, 2 * _I32, _B)  # pp != p
        t.ew("shortcut", n, _B, 0)  # .any()


def _csp_shortcut(t: _Tally, n: int, capacity: int) -> None:
    """``csp_shortcut``'s no-overflow branch: the changed map, its
    compression and one application."""
    cap = min(capacity, n)
    t.ew("shortcut", n, 2 * _I32, _B)  # p != p_prev
    t.ew("shortcut", n, _B, 0)  # .sum()
    t.add("shortcut", n * _I32)  # arange
    t.ew("shortcut", n, _B + _I32, _I32)  # where(changed, arange, IMAX)
    t.ew("shortcut", n, _I32, _I32)  # -key
    t.add("shortcut", n * _I32 + cap * (_I32 + _I64), n)  # topk
    t.ew("shortcut", cap, _I32, _I32, 2)  # -values, clamp
    t.gather("shortcut", cap, _I32, idx32=False)  # p[safe]
    t.ew("shortcut", cap, 2 * _I32, _I32)  # where(ids == IMAX, ...)
    search = max(1, (cap - 1).bit_length())
    for _ in range(CSP_COMPRESS_STEPS):  # lookup(vals)
        t.add("shortcut", cap * (_I32 + _I64 + search * _I32), cap * search)
        t.gather("shortcut", cap, _I32, idx32=False)
        t.ew("shortcut", cap, 3 * _I32, _I32, 3)
    t.add("shortcut", n * (_I32 + _I64 + search * _I32), n * search)  # searchsorted(ids, p)
    t.gather("shortcut", n, _I32, idx32=False)  # ids[j]
    t.gather("shortcut", n, _I32, idx32=False)  # vals[j]
    t.ew("shortcut", n, 3 * _I32, _I32, 2)  # where(ids[j] == p, vals[j], p)


# ---------------------------------------------------------------------------
# the two models
# ---------------------------------------------------------------------------

def flat_round_terms(n: int, e: int, rs) -> dict:
    """Per-round terms of the flat AS solve: ``{term: (bytes, ops)}``."""
    t = _Tally()
    if rs.pack:
        _outgoing_mask(t, e)
        _key_build(t, e)
        _segmin_packed(t, e, n)
        _unpack(t, "payload", n)
        t.gather("payload", e, _I64)  # minkey[ps]
        t.ew("payload", e, 2 * _I64, _B)  # key == minkey[ps]
        t.ew("payload", e, 2 * _B, _B)  # outgoing &
        t.ew("payload", e, _B, 0)  # nonzero: read
        t.add("payload", n * _I64)  # nonzero: the winners (at their bound)
        t.gather("payload", n, _I32, idx32=False)  # pd[win]
        t.gather("payload", n, _I32, idx32=False)  # ps[win]
        t.scatter_min("payload", n, _I32, n)  # the payload segment-min
    elif rs.backend == "cuda":
        _min_outgoing64(t, e, n)
    else:  # semiring.segment_argmin over the root segments
        _outgoing_mask(t, e)
        t.ew("index_casts", e, _I32, _I64)  # seg.long()
        t.ew("payload", e, _B + _F32, _F32)  # where(valid, w, inf)
        t.scatter_min("segment_min", e, _F32, n, idx32=False)
        t.gather("payload", e, _F32, idx32=False)  # minw[seg]
        t.ew("payload", e, 2 * _F32, _B)  # ==
        t.ew("payload", e, 2 * _B, _B)  # & valid
        t.ew("payload", e, _B + _I32, _I32)  # where(on_min, eid, IMAX)
        t.scatter_min("segment_min", e, _I32, n, idx32=False)
        t.gather("payload", e, _I32, idx32=False)  # mineid[seg]
        t.ew("payload", e, 2 * _I32, _B)  # ==
        t.ew("payload", e, 2 * _B, _B)  # &
        t.ew("payload", e, _B + _I32, _I32)  # where(winner, pd, IMAX)
        t.scatter_min("segment_min", e, _I32, n, idx32=False)
    _hook_record(t, n)
    if rs.shortcut == "complete":
        _complete_shortcut(t, n)
    else:
        _csp_shortcut(t, n, rs.spec.capacity)
    t.ew("shortcut", n, 2 * _I32, 0)  # torch.equal(p_next, p_prev)
    return t.terms


class DistRound(NamedTuple):
    """One Fig-2 round of the dist driver on one rank."""

    terms: Dict[str, Tuple[float, float]]  # term -> (device bytes, int32 ops)
    collective: Dict[tuple, int]  # axis names -> bytes, as Mesh.count_collectives keys them
    temp_bytes: int  # the arrays live at the round's peak, beside its five edge blocks


def dist_round_terms(*, rows: int, cols: int, e_max: int, shard_size: int, pack: bool,
                     shortcut: str = "csp", capacity: int = 1 << 16,
                     row_axes: tuple = ("data",), col_axis: str = "model") -> DistRound:
    """One round of ``core/msf_dist.py::build_dist_driver`` on one rank of
    a ``rows`` × ``cols`` grid, from shapes: ``n = rows·cols·shard_size``
    parent slots, ``e_max`` edge slots in the rank's block. The row and
    column gathers of the parent vector (``gathers``), the pack32 keys or
    the masked float keys (``key_build``), the local reduction over the
    ``e_max`` edges (``segment_min``, every slot live), the two ⊕-combine
    passes (``combine``: each all-reduce copies its operand), the
    winners' payload (``payload``), hook and record over the replicated
    ``n`` (``hook``, ``record``: counted as the flat round counts them)
    and the shortcut of the rank's shard (``shortcut``: CSP's changed map
    applied in one pass, or ``SHORTCUT_STEPS`` sub-iterations of the
    baseline's grid all-gather). Collective bytes as the mesh counts
    them: an all-gather's result, an all-reduce's operand, nothing over an
    axis of one rank. CSP is charged as if the changed map fits
    ``capacity`` (the driver falls back to the baseline when it does not)."""
    if shortcut not in ("csp", "os", "baseline"):
        raise ValueError(f"unknown distributed shortcut {shortcut!r}")
    n, s_ = rows * cols * shard_size, shard_size
    row_axes = tuple(row_axes) if isinstance(row_axes, (tuple, list)) else (row_axes,)
    grid_axes = row_axes + (col_axis,)
    col_key, row_key = (col_axis,), row_axes
    coll: Dict[tuple, int] = {}

    def collective(key, nbytes, ranks):
        if ranks > 1:
            coll[key] = coll.get(key, 0) + int(nbytes)

    t = _Tally()
    row_blk, col_blk = cols * s_, rows * s_
    # all-gather of p over the columns (row block) and over the rows (column
    # block): the parts written, then concatenated
    for k, key, ranks in ((row_blk, col_key, cols), (col_blk, row_key, rows)):
        collective(key, k * _I32, ranks)
        t.add("gathers", 3 * k * _I32)
    t.gather("gathers", e_max, _I32)  # x_row[src_row]
    t.gather("gathers", e_max, _I32)  # y_col[dst_col]
    t.ew("key_build", e_max, 2 * _I32, _B)  # ps != pd
    t.ew("key_build", e_max, 2 * _B, _B)  # & valid

    def allreduce(key, k, val, ranks):
        collective(key, k * val, ranks)
        t.add("combine", 2 * k * val)  # the copy the all-reduce runs on

    if pack:
        _key_build(t, e_max)
        _segmin_packed(t, e_max, n)
        for key, ranks in ((col_key, cols), (row_key, rows)):
            allreduce(key, n, _I64, ranks)
        _unpack(t, "payload", n)
        t.gather("payload", e_max, _I64)  # minkey[ps]
        t.ew("payload", e_max, 2 * _I64, _B)  # key == minkey[ps]
        t.ew("payload", e_max, 2 * _B, _B)  # outgoing &
        t.ew("payload", e_max, _B, 0)  # nonzero: read
        t.add("payload", n * _I64)  # nonzero: the winners (at their bound)
        t.gather("payload", n, _I32, idx32=False)  # pd[win]
        t.gather("payload", n, _I32, idx32=False)  # ps[win]
        t.scatter_min("payload", n, _I32, n)  # the payload segment-min
        for key, ranks in ((col_key, cols), (row_key, rows)):
            allreduce(key, n, _I32, ranks)
        temp = e_max * (2 * _I32 + _B + 2 * _I64) + 2 * n * _I64
    else:  # segment_argmin, then allreduce_argmin over each axis
        t.ew("index_casts", e_max, _I32, _I64)  # seg.long()
        t.ew("payload", e_max, _B + _F32, _F32)  # where(valid, w, inf)
        t.scatter_min("segment_min", e_max, _F32, n, idx32=False)
        t.gather("payload", e_max, _F32, idx32=False)  # minw[seg]
        t.ew("payload", e_max, 2 * _F32, _B)  # ==
        t.ew("payload", e_max, 2 * _B, _B)  # & valid
        t.ew("payload", e_max, _B + _I32, _I32)  # where(on_min, eid, IMAX)
        t.scatter_min("segment_min", e_max, _I32, n, idx32=False)
        t.gather("payload", e_max, _I32, idx32=False)  # mineid[seg]
        t.ew("payload", e_max, 2 * _I32, _B)  # ==
        t.ew("payload", e_max, 2 * _B, _B)  # &
        t.ew("payload", e_max, _B + _I32, _I32)  # where(winner, pd, IMAX)
        t.scatter_min("segment_min", e_max, _I32, n, idx32=False)
        for key, ranks in ((col_key, cols), (row_key, rows)):
            allreduce(key, n, _F32, ranks)  # minw
            t.ew("combine", n, 2 * _F32, _B)  # on_min
            t.ew("combine", n, _B + _I32, _I32)  # where(on_min, eid, IMAX)
            allreduce(key, n, _I32, ranks)  # mineid
            t.ew("combine", n, 2 * _I32, _B)  # ==
            t.ew("combine", n, 2 * _B, _B)  # winner
            t.ew("combine", n, _B + _I32, _I32)  # where(winner, p, IMAX)
            allreduce(key, n, _I32, ranks)  # payload
        temp = e_max * (2 * _I32 + _B + _F32) + 6 * n * _I32
    _hook_record(t, n)
    if shortcut == "baseline":
        for _ in range(SHORTCUT_STEPS):
            collective(grid_axes, n * _I32, rows * cols)
            t.add("shortcut", 3 * n * _I32)  # the grid all-gather's parts and concatenation
            t.gather("shortcut", s_, _I32, idx32=True)  # p_full[p_local]
            t.ew("shortcut", s_, 2 * _I32, _B)  # !=
            t.ew("shortcut", s_, _B, 0)  # .any()
            collective(grid_axes, _I32, rows * cols)  # moved flag, all-reduce(max)
    else:  # _csp_apply: compress the changed map, one pass over the shard
        cap = min(capacity, n)
        search = max(1, (cap - 1).bit_length())
        for _ in range(CSP_COMPRESS_STEPS):
            t.add("shortcut", cap * (_I32 + _I64 + search * _I32), cap * search)
            t.gather("shortcut", cap, _I32, idx32=False)
            t.ew("shortcut", cap, 3 * _I32, _I32, 3)
        t.ew("shortcut", s_, _B + 2 * _I32, _I32)  # where(keep_loc, r_parent, p)
        t.add("shortcut", s_ * (_I32 + _I64 + search * _I32), s_ * search)  # searchsorted
        t.gather("shortcut", s_, _I32, idx32=False)  # ids[j]
        t.gather("shortcut", s_, _I32, idx32=False)  # vals[j]
        t.ew("shortcut", s_, 3 * _I32, _I32, 2)  # where(ids[j] == p, vals[j], p)
    # i and msf_eids [n], the row and column blocks of p, and the round's
    # widest arrays
    temp += 2 * n * _I32 + (row_blk + col_blk) * _I32
    return DistRound(t.terms, coll, int(temp))


def _next_pow2(k: int, floor: int) -> int:
    return max(floor, 1 << (max(int(k), 1) - 1).bit_length())


def _sort_int64(t: _Tally, k: int) -> None:
    """``torch.sort(stable=True)`` of int64 keys: radix passes over the
    keys and their int64 indices."""
    t.add("dedupe", k * _I64)  # the index iota
    t.add("dedupe", RADIX_PASSES_INT64 * k * 4 * _I64, RADIX_PASSES_INT64 * k)


def _und_reduce_torch(t: _Tally, pad: int, n: int, pack: bool) -> None:
    """One round of ``make_und_reduce``'s segment-min routes: the gathers,
    the two (pack32) or four (float, then eid) scatter-mins and
    ``payload_from_eid``."""
    t.gather("gathers", pad, _I32, idx32=False)  # p[lo_l]
    t.gather("gathers", pad, _I32, idx32=False)  # p[hi_l]
    t.ew("key_build", pad, 2 * _I32, _B)  # plo != phi
    t.ew("key_build", pad, 2 * _B, _B)  # & valid
    if pack:
        _key_build(t, pad)
        _segmin_packed(t, pad, n)
        _segmin_packed(t, pad, n)
        t.ew("payload", n, 2 * _I64, _I64)  # minimum(m1, m2)
        _unpack(t, "payload", n)
    else:
        t.ew("key_build", pad, _B + _F32, _F32)  # where(out, w, inf)
        t.scatter_min("segment_min", pad, _F32, n)
        t.scatter_min("segment_min", pad, _F32, n)
        t.ew("payload", n, 2 * _F32, _F32)  # minimum
        for _ in range(2):  # on1, on2 and their eid mins
            t.gather("payload", pad, _F32)
            t.ew("payload", pad, 2 * _F32 + _B, _B, 2)
            t.ew("payload", pad, _B + _I32, _I32)
            t.scatter_min("segment_min", pad, _I32, n)
        t.ew("payload", n, 2 * _I32, _I32)  # minimum
        t.ew("payload", n, _F32, _B)  # empty
    # payload_from_eid
    t.ew("payload", n, _I32, _I32)  # clamp
    t.gather("payload", n, _I32)  # pos_of_eid[...]
    t.ew("payload", n, _I32 + _B, _B, 3)  # local
    t.ew("payload", n, _I32, _I64, 2)  # clamp, long
    t.gather("payload", n, _I64, idx32=False)  # lo_l[safe]
    t.gather("payload", n, _I64, idx32=False)  # hi_l[safe]
    t.gather("payload", n, _I32, idx32=False)  # p[...]
    t.gather("payload", n, _I32, idx32=False)
    t.ew("payload", n, 3 * _I32, _I32, 2)  # where(plo == i_n, phi, plo)
    t.ew("payload", n, _B + _I32, _I32)  # where(local, pd, IMAX)


def coarsen_level0_terms(n0: int, e: int, rs) -> tuple:
    """``(terms, analyzed)`` of coarsen level 0, or ``None`` when no level
    runs (``n0 <= cutoff``): the flat cost applies then."""
    cfg = rs.coarsen
    if n0 <= cfg.cutoff or e == 0:
        return None
    m0 = e // 2
    pad = _next_pow2(m0, 8)
    n = _next_pow2(n0, 8)
    cap = pad  # eid capacity: eids number the undirected edges
    pack = cfg.pack if cfg.pack is not None else bool(rs.pack) and 2 * pad < PACK_IDX_MASK
    kernel = not pack and rs.backend == "cuda"  # ops.min_outgoing_und64 on the card
    t = _Tally()
    if not kernel:  # make_und_reduce's setup
        t.ew("index_casts", pad, _I32, _I64, 2)  # lo.long(), hi.long()
        t.ew("index_casts", pad, _I32, _I64)
        t.ew("payload", pad, _B + 2 * _I32, _B, 5)  # keep
        t.add("payload", (cap + 1) * _I32)  # pos_of_eid fill
        t.ew("payload", pad, _B + _I32, _I64, 2)  # where(keep, eid, cap).long()
        t.add("payload", pad * (_I32 + _I64 + _I32))  # arange, scatter
        t.add("hook", n * _I32)  # i_n
    for _ in range(cfg.rounds_per_level):
        if kernel:
            _min_outgoing64(t, pad, n, sides=2)
        else:
            _und_reduce_torch(t, pad, n, pack)
        _hook_record(t, n)
        _complete_shortcut(t, n)
    # rank_relabel
    t.add("relabel", n * _I32)  # arange
    t.ew("relabel", n, 2 * _I32, _B)  # p == i
    t.ew("relabel", n, _B, _I32)  # .to(int32)
    t.ew("relabel", n, _I32, _I32, 2)  # cumsum - 1
    t.gather("relabel", n, _I32)  # rank[p]
    t.ew("relabel", n, _I32, 0)  # .sum()
    if not cfg.fused:
        return t.terms, "coarsen.level0"
    if resolve_dedupe(cfg.dedupe, rs.backend) == "host":
        # filter_level_callback: the level's arrays to the host and back
        t.add("dedupe", pad * (2 * _I32 + _F32 + _I32 + _B) * 2 + n * _I32)
    else:
        t.gather("dedupe", pad, _I32)  # new_ids[lo]
        t.gather("dedupe", pad, _I32)  # new_ids[hi]
        t.ew("dedupe", pad, 2 * _I32, _I32, 2)  # minimum, maximum
        t.ew("dedupe", pad, 2 * _I32, _I32)
        t.ew("dedupe", pad, 2 * _I32 + _B, _B, 2)  # real
        if pack:
            _key_build(t, pad)  # wkey
        t.ew("dedupe", pad, _B + _I32, _I64, 2)  # the pair key's halves
        t.ew("dedupe", pad, _B + _I32, _I64, 2)
        t.ew("dedupe", pad, _I64, _I64)  # shift
        t.ew("dedupe", pad, 2 * _I64, _I64)  # |
        if pack:
            _sort_int64(t, pad)
            t.gather("dedupe", pad, _I64, idx32=False)  # wkey[order]
            t.ew("dedupe", pad, 2 * _I64, _B)  # boundary
            t.ew("dedupe", pad, _B, _I32, 2)  # cumsum - 1
            _segmin_packed(t, pad, pad)  # segment_min_sorted
            t.ew("dedupe", pad, _I64, _B)  # seg_live
            _unpack(t, "dedupe", pad)
            t.add("dedupe", (pad + 1) * _I64)  # keyseg fill
            t.ew("dedupe", pad, _B + _I32, _I64, 2)  # where(boundary, seg, e).long()
            t.add("dedupe", pad * (_I64 + 2 * _I64))  # keyseg scatter
            t.ew("dedupe", pad, _I64, _I32, 2)  # lo_out
            t.ew("dedupe", pad, _I64, _I32, 2)  # hi_out
            t.ew("dedupe", pad, _B + _I32, _I32, 4)  # the four outputs
            t.ew("dedupe", pad, 3 * _I32, 0)
        else:  # three stable sorts and the float segment_argmin
            for _ in range(3):
                _sort_int64(t, pad)
                t.gather("dedupe", pad, _I64, idx32=False)
            for val in (_I32, _I32, _F32, _I32, _B):  # lo, hi, w, eid, real
                t.gather("dedupe", pad, val, idx32=False)
            t.scatter_min("segment_min", pad, _F32, pad)
            t.scatter_min("segment_min", pad, _I32, pad)
            t.ew("dedupe", pad, 4 * _I32, _I32, 6)
            for _ in range(4):
                t.gather("dedupe", pad, _I32, idx32=False)
    t.gather("relabel", n0, _I32)  # label_map = new_ids[label_map]
    return t.terms, "coarsen.level0.fused"


def _from_terms(terms: dict, dynamic_loops: int, analyzed: str) -> PlanCost:
    bytes_ = sum(b for b, _ in terms.values())
    ops = sum(o for _, o in terms.values())
    return PlanCost(flops=float(ops), dot_flops=0.0, ew_flops=float(ops),
                    bytes=float(bytes_), collective_bytes=0.0,
                    dynamic_loops=dynamic_loops, analyzed=analyzed)


def plan_cost(mode: str, target, rs) -> Optional[PlanCost]:
    """Best-effort :class:`PlanCost` for a freshly built engine; ``None``
    when out of the model's scope or on any failure."""
    try:
        if mode not in ("flat", "coarsen") or rs.spec.variant != "complete":
            return None
        src = getattr(target, "src", None)
        if src is None:  # None, an int n
            return None
        n, e = int(target.n), int(src.shape[0])
        if mode == "coarsen":
            level = coarsen_level0_terms(n, e, rs)
            if level is not None:
                terms, analyzed = level
                return _from_terms(terms, 0, analyzed)
        return _from_terms(flat_round_terms(n, e, rs), 1, "flat")
    except Exception:
        return None
