"""The port's dense multilinear and bucketed segment-min modules against
the JAX package's.

On the CPU the port's wrappers run their plain versions; they must equal
the Pallas kernels (interpret mode), the jnp oracles and the core dense
multilinear exactly, and never count a launch. The bucketing must give
the reference's arrays, and the layout checks reject what the reference
rejects. A CUDA request never falls back: the launcher raises on CPU
tensors.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.multilinear import min_outgoing_dense as jax_min_outgoing_dense  # noqa: E402
from repro.core.semiring import pack32 as jax_pack32  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.core.multilinear import min_outgoing_dense  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

UMAX = 0xFFFFFFFF
IMAX = np.iinfo(np.int32).max


def _random_dense(n, m, seed):
    """The adjacency of the reference's kernel sweep (tests/test_kernels.py)."""
    rng = np.random.default_rng(seed)
    a = np.full((n, n), np.inf, np.float32)
    u, v = rng.integers(0, n, m), rng.integers(0, n, m)
    w = rng.integers(1, 256, m).astype(np.float32)
    a[u, v] = np.minimum(a[u, v], w)
    np.fill_diagonal(a, np.inf)
    p = rng.integers(0, max(1, n // 3), n).astype(np.int32)
    return p, a


def _port_dense(p, a):
    return tuple(x.numpy() for x in ops.multilinear_dense(torch.from_numpy(p),
                                                          torch.from_numpy(a)))


def _assert_triple(got, want):
    for g, w, dtype in zip(got, want, (np.float32, np.int32, np.int32)):
        w = np.asarray(w)
        assert g.dtype == dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n", [8, 100, 128, 257, 384])
def test_multilinear_dense_matches_pallas_ref_and_core(n):
    p, a = _random_dense(n, 4 * n, seed=n)
    ops.multilinear_dense.launches = 0
    got = _port_dense(p, a)
    _assert_triple(got, jax_ops.multilinear_dense(jnp.array(p), jnp.array(a)))
    _assert_triple(got, jax_ref.multilinear_dense_ref(jnp.array(p), jnp.array(a)))
    em = jax_min_outgoing_dense(jnp.array(p), jnp.array(a))
    _assert_triple(got, (em.w, em.eid, em.payload[0]))
    tem = min_outgoing_dense(torch.from_numpy(p), torch.from_numpy(a))
    _assert_triple(got, (tem.w.numpy(), tem.eid.numpy(), tem.payload[0].numpy()))
    assert ops.multilinear_dense.launches == 0  # the CPU path launches nothing


def _adversarial_dense():
    """(label, p, a): the cases the CUDA kernel is held to on the card.
    Never +0.0 and -0.0 tied for a row's minimum (the sign is unspecified)."""
    rng = np.random.default_rng(11)
    n = 37
    out = []
    p, a = _random_dense(n, 3 * n, seed=1)
    a[:5] = np.inf  # rows with no entry
    out.append(("empty_rows", p, a))
    out.append(("all_equal_weights_ties_to_smallest_col",
                np.arange(n, dtype=np.int32), np.full((n, n), 7.0, np.float32)))
    a = rng.integers(1, 9, (n, n)).astype(np.float32)
    a[rng.random((n, n)) < 0.2] = np.nan
    a[rng.random((n, n)) < 0.05] = -np.inf
    out.append(("nan_and_minus_inf", rng.integers(0, 5, n).astype(np.int32), a))
    out.append(("nan_only", np.arange(n, dtype=np.int32), np.full((n, n), np.nan, np.float32)))
    out.append(("p_all_equal", np.zeros(n, np.int32), rng.random((n, n)).astype(np.float32)))
    out.append(("p_all_distinct_negative", -np.arange(1, n + 1, dtype=np.int32),
                rng.integers(1, 4, (n, n)).astype(np.float32)))
    out.append(("n1", np.zeros(1, np.int32), np.zeros((1, 1), np.float32)))
    a = rng.integers(-3, 3, (33, 33)).astype(np.float32)  # -0.0 never appears
    out.append(("negative_weights_n33", rng.integers(0, 4, 33).astype(np.int32), a))
    return out


_DENSE_CASES = _adversarial_dense()


@pytest.mark.parametrize("p,a", [c[1:] for c in _DENSE_CASES], ids=[c[0] for c in _DENSE_CASES])
def test_multilinear_dense_adversarial_matches_ref(p, a):
    got = _port_dense(p, a)
    _assert_triple(got, jax_ref.multilinear_dense_ref(jnp.array(p), jnp.array(a)))
    _assert_triple(got, ref.multilinear_dense_ref(torch.from_numpy(p), torch.from_numpy(a)))


def test_multilinear_dense_casts_p_and_rejects_bad_inputs():
    p, a = _random_dense(20, 60, seed=3)
    want = _port_dense(p, a)
    got = ops.multilinear_dense(torch.from_numpy(p.astype(np.int64)), torch.from_numpy(a))
    _assert_triple(tuple(x.numpy() for x in got), want)
    assert all(x.shape == (0,) for x in ops.multilinear_dense(
        torch.zeros(0, dtype=torch.int32), torch.zeros(0, 0)))
    t, ta = torch.from_numpy(p), torch.from_numpy(a)
    with pytest.raises(ValueError, match="float32"):
        ops.multilinear_dense(t, ta.double())
    with pytest.raises(ValueError, match="square"):
        ops.multilinear_dense(t, ta[:, :10].contiguous())
    with pytest.raises(ValueError, match="square"):
        ops.multilinear_dense(t, ta.reshape(-1))
    with pytest.raises(ValueError, match="contiguous"):
        ops.multilinear_dense(t, ta.t())
    with pytest.raises(ValueError, match=r"p must be \[n\]"):
        ops.multilinear_dense(t[:5], ta)
    with pytest.raises(TypeError):
        ops.multilinear_dense(p, ta)


def _bucket_inputs(n, e, seed):
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, n, e)
    keys = np.asarray(
        jax_pack32(jnp.array(rng.integers(1, 256, e)), jnp.array(rng.integers(0, 1 << 20, e)))
    ).astype(np.uint32)
    return seg, keys


@pytest.mark.parametrize("n,e,block_rows", [
    (128, 0, 128), (128, 500, 128), (300, 2000, 128), (1024, 10000, 128),
    (0, 0, 128), (37, 129, 8), (5000, 3000, 1024),
    (256, 1000, 128),  # skewed below: one row holds most of a bucket
])
def test_bucket_edges_by_row_block_matches_reference(n, e, block_rows):
    seg, keys = _bucket_inputs(n, e, e + n)
    if n == 256:
        seg[: e // 2] = 3
    kb, rb = jax_ops.bucket_edges_by_row_block(seg, keys, n, block_rows)
    tk, tr = ops.bucket_edges_by_row_block(torch.from_numpy(seg),
                                           torch.from_numpy(keys.astype(np.int64)), n,
                                           block_rows)
    assert tk.dtype == torch.int64 and tr.dtype == torch.int32
    np.testing.assert_array_equal(tk.numpy(), kb.astype(np.int64))
    np.testing.assert_array_equal(tr.numpy(), rb)


def test_bucket_edges_rejects_ids_out_of_range():
    seg = torch.tensor([0, 5, 10])
    keys = torch.tensor([1, 2, 3])
    with pytest.raises(ValueError, match="segment ids"):
        ops.bucket_edges_by_row_block(seg, keys, 10)
    with pytest.raises(ValueError, match="segment ids"):
        ops.bucket_edges_by_row_block(seg - 1, keys, 11)
    with pytest.raises(ValueError, match="1-D"):
        ops.bucket_edges_by_row_block(seg, keys[:2], 11)


def _jax_bucketed(kb, rb, block_rows):
    kb = jnp.array(kb.astype(np.uint32))
    rb = jnp.array(rb)
    pallas = np.asarray(jax_ops.segment_min_bucketed(kb, rb, block_rows=block_rows))
    oracle = np.asarray(jax_ref.segment_min_bucketed_ref(kb, rb, block_rows))
    np.testing.assert_array_equal(pallas, oracle)
    return pallas.astype(np.int64)


@pytest.mark.parametrize("n,e,block_rows", [
    (128, 0, 128), (128, 500, 128), (300, 2000, 128), (1024, 10000, 128),
    (37, 129, 8), (100, 700, 1024),
])
def test_segment_min_bucketed_matches_pallas(n, e, block_rows):
    seg, keys = _bucket_inputs(n, e, e + n)
    tk, tr = ops.bucket_edges_by_row_block(torch.from_numpy(seg),
                                           torch.from_numpy(keys.astype(np.int64)), n,
                                           block_rows)
    ops.segment_min_bucketed.launches = 0
    got = ops.segment_min_bucketed(tk, tr, block_rows=block_rows).numpy()
    nb = -(-n // block_rows)
    assert got.dtype == np.int64 and got.shape == (nb * block_rows,)
    np.testing.assert_array_equal(got, _jax_bucketed(tk.numpy(), tr.numpy(), block_rows))
    # the same as the flat segment-min over the vertices (segment = row)
    flat = ops.segment_min_flat(torch.from_numpy(keys.astype(np.int64)),
                                torch.from_numpy(seg.astype(np.int32)), nb * block_rows)
    np.testing.assert_array_equal(got, flat.numpy())
    assert ops.segment_min_bucketed.launches == 0  # the CPU path launches nothing


@pytest.mark.parametrize("block_rows", [8, 128])
def test_segment_min_bucketed_drops_rows_out_of_range(block_rows):
    rng = np.random.default_rng(block_rows)
    nb, be = 3, 256
    keys = rng.integers(0, 1 << 32, (nb, be), dtype=np.uint64).astype(np.int64)
    keys[rng.random((nb, be)) < 0.1] = UMAX
    rows = rng.integers(-4, block_rows + 4, (nb, be)).astype(np.int32)
    rows[1] = 2  # one row holds a whole bucket
    got = ops.segment_min_bucketed(torch.from_numpy(keys), torch.from_numpy(rows),
                                   block_rows=block_rows).numpy()
    np.testing.assert_array_equal(got, _jax_bucketed(keys, rows, block_rows))


def test_segment_min_bucketed_rejects_what_the_reference_rejects():
    """tests/test_kernels.py::test_segment_min_kernel_validation, the
    bucketed half, on the port's dtypes (int64 keys holding uint32)."""
    ku = torch.zeros((2, 128), dtype=torch.int64)
    ri = torch.zeros((2, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="shape mismatch"):
        ops.segment_min_bucketed(ku, torch.zeros((2, 256), dtype=torch.int32))
    with pytest.raises(ValueError, match="uint32"):
        ops.segment_min_bucketed(ku.to(torch.int32), ri)
    with pytest.raises(ValueError, match="int32"):
        ops.segment_min_bucketed(ku, ri.to(torch.int64))
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.segment_min_bucketed(ku, ri, block_rows=100)
    with pytest.raises(ValueError, match="empty bucket"):
        ops.segment_min_bucketed(torch.zeros((0, 128), dtype=torch.int64),
                                 torch.zeros((0, 128), dtype=torch.int32))
    with pytest.raises(ValueError, match="multiple of 128 lanes"):
        ops.segment_min_bucketed(torch.zeros((2, 100), dtype=torch.int64),
                                 torch.zeros((2, 100), dtype=torch.int32))
    with pytest.raises(ValueError, match=r"\[NB, BE\]"):
        ops.segment_min_bucketed(ku.reshape(-1), ri.reshape(-1))
    with pytest.raises(ValueError, match="contiguous"):
        ops.segment_min_bucketed(torch.zeros((128, 2), dtype=torch.int64).t(),
                                 torch.zeros((128, 2), dtype=torch.int32).t())


def test_new_launchers_never_fall_back_to_cpu():
    keys = torch.zeros((1, 128), dtype=torch.int64)
    rows = torch.zeros((1, 128), dtype=torch.int32)
    out = torch.empty(128, dtype=torch.int64)
    with pytest.raises(RuntimeError, match="segment_min_bucketed's CUDA kernel"):
        ops._launch("segment_min_bucketed", keys, rows, out, 1, 128, 128, 1, 1)
    p = torch.zeros(4, dtype=torch.int32)
    a = torch.zeros((4, 4))
    outs = [torch.empty(4), torch.empty(4, dtype=torch.int32), torch.empty(4, dtype=torch.int32)]
    with pytest.raises(RuntimeError, match="multilinear_dense's CUDA kernel"):
        ops._launch("multilinear_dense", p, a, 4, *outs)
    assert ops.segment_min_bucketed.launches == 0 and ops.multilinear_dense.launches == 0
