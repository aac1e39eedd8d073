"""How the segment-min wrappers lay their inputs out for the CUDA kernels.

``ops.flat_layout`` picks where the flat kernel's 16-byte loads start on
any view, and ``ops.bucketed_split`` how the bucketed kernel cuts a layout
into blocks; both are pure functions checked here on the CPU. The wrappers
themselves run their plain versions on CPU tensors; on misaligned views
and odd tails they must still equal the Pallas kernels (interpret mode)
exactly.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.semiring import pack32 as jax_pack32  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

UMAX = 0xFFFFFFFF
H100_SMS = 132


@pytest.mark.parametrize("key_off", [0, 1])
@pytest.mark.parametrize("seg_off", [0, 1, 2, 3])
@pytest.mark.parametrize("e", [0, 1, 2, 3, 4, 5, 33, 1031])
def test_flat_layout_aligns_the_body(key_off, seg_off, e):
    keys_addr, segs_addr = (1 << 20) + 8 * key_off, (1 << 20) + 4 * seg_off
    head, vec_ids = ops.flat_layout(keys_addr, segs_addr, e)
    assert 0 <= head <= min(3, e)
    # the ids can share the keys' 16-byte alignment exactly when their
    # offsets, counted in elements, have the same parity
    assert vec_ids == (key_off % 2 == seg_off % 2)
    if e - head >= 4:  # the kernel reads a body
        assert (keys_addr + 8 * head) % 16 == 0
        if vec_ids:
            assert (segs_addr + 4 * head) % 16 == 0


@pytest.mark.parametrize("nb,be,block_rows,want", [
    (128, 27_264, 128, (8, 1)),   # R-MAT s14 ef8: a few wide buckets, split
    (8_192, 512, 128, (1, 8)),    # the 1024 x 1024 grid: narrow buckets, shared
    (1, 128, 128, (1, 1)),        # the smallest layout
    (1, 27_264, 128, (8, 1)),     # one wide bucket
    (8_192, 128, 128, (1, 32)),
    (300, 128, 128, (1, 2)),      # keeps a block per SM
    (128, 27_264, 8_192, (1, 1)),  # 64 KB of slots: no cluster, no sharing
    (8_192, 512, 2_048, (1, 2)),  # 16 KB of slots per bucket: two fit in 48 KB
])
def test_bucketed_split_at_the_entry_point_shapes_and_extremes(nb, be, block_rows, want):
    assert ops.bucketed_split(nb, be, block_rows, H100_SMS) == want


@pytest.mark.parametrize("nb", [1, 2, 7, 128, 1000, 8_192, 100_000])
@pytest.mark.parametrize("be", [128, 512, 1_024, 4_096, 27_264, 1 << 20])
@pytest.mark.parametrize("block_rows", [8, 128, 1_024, 8_192])
def test_bucketed_split_invariants(nb, be, block_rows):
    chunks, per_block = ops.bucketed_split(nb, be, block_rows, H100_SMS)
    assert 1 in (chunks, per_block)
    assert chunks in (1, 2, 4, 8) and per_block & (per_block - 1) == 0
    if chunks > 1:  # one cluster per bucket, ranges of >= 1K entries
        assert be // chunks >= 1_024 and block_rows * 8 <= 48 * 1024
        assert nb * chunks // 2 < 8 * H100_SMS
    if per_block > 1:  # whole buckets shared, the slots within 48 KB
        assert per_block * be // 2 < 4_096 and per_block * block_rows * 8 <= 48 * 1024
        assert -(-nb // per_block) >= H100_SMS


def _keys_segs(e, n_seg, seed):
    rng = np.random.default_rng(seed)
    seg = rng.integers(-2, n_seg + 2, e).astype(np.int32)  # some out of range
    seg[: e // 3] = np.sort(seg[: e // 3])  # runs of equal ids
    keys = np.asarray(
        jax_pack32(jnp.array(rng.integers(1, 256, e)), jnp.array(rng.integers(0, 1 << 20, e)))
    ).astype(np.uint32)
    keys[rng.random(e) < 0.3] = UMAX
    return keys, seg


def _pallas_flat(keys, seg, n_seg):
    return np.asarray(jax_ops.segment_min_flat(jnp.array(keys), jnp.array(seg),
                                               num_segments=n_seg)).astype(np.int64)


@pytest.mark.parametrize("key_off,seg_off", [(1, 0), (0, 1), (0, 3), (1, 1), (1, 3)],
                         ids=["keys[1:]", "segs[1:]", "segs[3:]", "both[1:]", "keys[1:],segs[3:]"])
@pytest.mark.parametrize("e", [1, 3, 5, 33, 1031])
def test_segment_min_flat_on_views_matches_pallas(key_off, seg_off, e):
    n_seg = 50
    keys, seg = _keys_segs(e + 3, n_seg, 100 * e + 10 * key_off + seg_off)
    tk = torch.from_numpy(keys.astype(np.int64))[key_off:key_off + e]
    ts = torch.from_numpy(seg)[seg_off:seg_off + e]
    assert tk.is_contiguous() and ts.is_contiguous()
    got = ops.segment_min_flat(tk, ts, n_seg).numpy()
    want = _pallas_flat(keys[key_off:key_off + e], seg[seg_off:seg_off + e], n_seg)
    np.testing.assert_array_equal(got, want)


def _offset_view(a: np.ndarray, off: int, shape) -> torch.Tensor:
    """A contiguous [NB, BE] view that starts ``off`` elements into its storage."""
    flat = np.zeros(a.size + off, a.dtype)
    flat[off:] = a.reshape(-1)
    return torch.from_numpy(flat)[off:].view(*shape)


@pytest.mark.parametrize("off", [1, 3])
@pytest.mark.parametrize("nb,be,block_rows", [(1, 128, 8), (3, 256, 128), (2, 384, 1024)])
def test_segment_min_bucketed_on_views_matches_pallas(off, nb, be, block_rows):
    rng = np.random.default_rng(nb * be + off)
    keys = rng.integers(0, 1 << 32, (nb, be), dtype=np.uint64).astype(np.int64)
    keys[rng.random((nb, be)) < 0.2] = UMAX
    keys[-1, be // 2:] = UMAX  # a padded tail
    rows = rng.integers(-2, block_rows + 2, (nb, be)).astype(np.int32)
    rows[0, : be // 2] = block_rows // 2  # one row holds half a bucket
    tk, tr = _offset_view(keys, off, (nb, be)), _offset_view(rows, off, (nb, be))
    assert tk.storage_offset() == off and tk.is_contiguous()
    got = ops.segment_min_bucketed(tk, tr, block_rows=block_rows).numpy()
    want = np.asarray(jax_ops.segment_min_bucketed(jnp.array(keys.astype(np.uint32)),
                                                   jnp.array(rows), block_rows=block_rows))
    np.testing.assert_array_equal(got, want.astype(np.int64))
