"""Parity of the port's transformer blocks (``repro_torch.models.layers``)
with the reference's ``repro.models.layers`` on the same numpy inputs.

Tolerances: float32 inputs within atol 1e-5 + rtol 1e-5 (the same
operations, reductions in other orders; RoPE atol 2e-5, its angles reach
4e4 rad, where the libraries' float32 cos and sin differ in the last
bits); bfloat16 inputs within 2^-6 of
the largest reference entry (outputs are rounded to bfloat16, whose
spacing is 2^-7 relative, and a sum in another order may round one step
apart); gradients (float32) within rel 1e-4 of the largest entry. A query
row whose keys are all masked is exactly 0 on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_util import assert_rel_close, one_torch_thread, to_np  # noqa: E402,F401
from repro.models import layers as RL  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

BF16_REL = 2.0 ** -6

# (name, B, Sq, T, KV, G, hd, causal, window, q_chunk, kv_chunk, triangle_skip)
ATTN = [
    ("causal", 2, 64, 64, 2, 2, 16, True, None, 32, 32, False),
    ("causal-skip", 2, 64, 64, 2, 2, 16, True, None, 32, 32, True),
    ("noncausal-ragged", 1, 48, 80, 1, 1, 8, False, None, 32, 32, False),
    ("window-ragged", 2, 70, 70, 2, 2, 16, True, 20, 32, 32, False),
    ("window-ragged-skip", 2, 70, 70, 2, 2, 16, True, 20, 32, 32, True),
    ("chunks-16x8-g3-skip", 1, 37, 37, 2, 3, 8, True, None, 16, 8, True),
    ("one-chunk", 1, 20, 20, 1, 4, 8, True, None, 2048, 2048, False),
    # queries past the last key with a window: rows 23.. see no key at all
    ("masked-rows", 1, 64, 16, 1, 2, 8, True, 8, 16, 16, False),
    ("masked-rows-noncausal", 1, 40, 16, 1, 1, 8, False, 4, 16, 16, False),
]
ATTN_IDS = [c[0] for c in ATTN]


def _attn_inputs(case, seed=0):
    _, b, sq, t, kv, g, hd = case[:7]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, kv, g, hd)).astype(np.float32)
    k = rng.standard_normal((b, t, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, t, kv, hd)).astype(np.float32)
    return q, k, v


def _attn_kw(case):
    causal, window, qc, kc, tskip = case[7:]
    return dict(causal=causal, window=window, q_chunk=qc, kv_chunk=kc, triangle_skip=tskip)


@pytest.fixture(scope="module")
def reference():
    """One jit per case: outputs in float32 and bfloat16, and the float32
    gradient of a weighted sum of the output."""
    cache = {}

    def get(name):
        if name not in cache:
            case = ATTN[ATTN_IDS.index(name)]
            kw = _attn_kw(case)
            q, k, v = _attn_inputs(case)
            wts = np.random.default_rng(9).standard_normal(q.shape).astype(np.float32)

            def outs(q, k, v):
                f32 = RL.flash_attention(q, k, v, **kw)
                b16 = RL.flash_attention(*(a.astype(jnp.bfloat16) for a in (q, k, v)), **kw)
                grads = jax.grad(lambda *a: jnp.sum(RL.flash_attention(*a, **kw) * wts),
                                 argnums=(0, 1, 2))(q, k, v)
                return f32, b16.astype(jnp.float32), grads

            cache[name] = jax.tree.map(np.asarray, jax.jit(outs)(q, k, v))
        return cache[name]

    return get


@pytest.mark.parametrize("case", ATTN, ids=ATTN_IDS)
def test_flash_attention_float32(reference, case):
    want = reference(case[0])[0]
    got = L.flash_attention(*map(torch.tensor, _attn_inputs(case)), **_attn_kw(case))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(to_np(got), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", ATTN, ids=ATTN_IDS)
def test_flash_attention_bfloat16(reference, case):
    want = reference(case[0])[1]
    ins = [torch.tensor(a).to(torch.bfloat16) for a in _attn_inputs(case)]
    got = L.flash_attention(*ins, **_attn_kw(case))
    assert got.dtype == torch.bfloat16
    assert_rel_close(got.float(), want, BF16_REL)


@pytest.mark.parametrize("case", ATTN, ids=ATTN_IDS)
def test_flash_attention_gradients(reference, case):
    """Gradients through every mask, fully masked rows included: finite,
    and equal to the reference's."""
    want = reference(case[0])[2]
    ins = [torch.tensor(a, requires_grad=True) for a in _attn_inputs(case)]
    wts = torch.tensor(np.random.default_rng(9).standard_normal(ins[0].shape).astype(np.float32))
    out = L.flash_attention(*ins, **_attn_kw(case))
    grads = torch.autograd.grad((out * wts).sum(), ins)
    for g, w in zip(grads, want):
        assert bool(torch.isfinite(g).all())
        assert_rel_close(g, w, 1e-4)


@pytest.mark.parametrize("case", [c for c in ATTN if c[0].startswith("masked-rows")],
                         ids=lambda c: c[0])
def test_fully_masked_rows_are_zero(case):
    q, k, v = map(torch.tensor, _attn_inputs(case))
    out = L.flash_attention(q, k, v, **_attn_kw(case))
    t, window = k.shape[1], case[8]
    qpos = torch.arange(q.shape[1])
    seen = qpos - window + 1 < t  # some key lies in (qpos - window, min(qpos, t - 1)]
    assert (~seen).any() and seen.any()
    assert not bool(torch.isnan(out).any())
    assert bool((out[:, ~seen] == 0).all())
    assert bool((out[:, seen].abs().sum(dim=(0, 2, 3, 4)) > 0).all())


def test_triangle_skip_changes_no_value():
    case = ATTN[ATTN_IDS.index("chunks-16x8-g3-skip")]
    ins = list(map(torch.tensor, _attn_inputs(case, seed=3)))
    kw = _attn_kw(case)
    a = L.flash_attention(*ins, **{**kw, "triangle_skip": True})
    b = L.flash_attention(*ins, **{**kw, "triangle_skip": False})
    np.testing.assert_allclose(to_np(a), to_np(b), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 5, 3, 16), (4, 64)])
def test_rms_norm(dtype, shape):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    scale = rng.standard_normal(shape[-1]).astype(np.float32)
    want = np.asarray(RL.rms_norm(jnp.asarray(x).astype(dtype), jnp.asarray(scale), 1e-5)
                      .astype(jnp.float32))
    got = L.rms_norm(torch.tensor(x).to(getattr(torch, dtype)), torch.tensor(scale), 1e-5)
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(to_np(got), want, atol=1e-5, rtol=1e-5)
    else:
        assert_rel_close(got.float(), want, BF16_REL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("positions", ["arange", "offset", "one"])
def test_rope(dtype, positions):
    rng = np.random.default_rng(2)
    s = 1 if positions == "one" else 24
    x = rng.standard_normal((2, s, 3, 32)).astype(np.float32)
    pos = {"arange": np.arange(s), "offset": np.arange(s) + 40_000,
           "one": np.array([1234])}[positions].astype(np.int32)
    want = np.asarray(RL.rope(jnp.asarray(x).astype(dtype), jnp.asarray(pos), 1e6)
                      .astype(jnp.float32))
    got = L.rope(torch.tensor(x).to(getattr(torch, dtype)), torch.tensor(pos), 1e6)
    if dtype == "float32":
        # cos/sin of angles up to ~4e4 rad: both sides round the angle in
        # float32, then their libraries' cos/sin differ in the last bits
        np.testing.assert_allclose(to_np(got), want, atol=2e-5, rtol=1e-5)
    else:
        assert_rel_close(got.float(), want, BF16_REL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos", [0, 9, 31])
def test_decode_attention(dtype, pos):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 2, 3, 16)).astype(np.float32)
    ck = rng.standard_normal((2, 32, 2, 16)).astype(np.float32)
    cv = rng.standard_normal((2, 32, 2, 16)).astype(np.float32)
    jd = lambda a: jnp.asarray(a).astype(dtype)  # noqa: E731
    want = np.asarray(RL.decode_attention(jd(q), jd(ck), jd(cv), jnp.int32(pos))
                      .astype(jnp.float32))
    td = lambda a: torch.tensor(a).to(getattr(torch, dtype))  # noqa: E731
    for p in (pos, torch.tensor(pos)):
        got = L.decode_attention(td(q), td(ck), td(cv), p)
        if dtype == "float32":
            np.testing.assert_allclose(to_np(got), want, atol=1e-5, rtol=1e-5)
        else:
            assert_rel_close(got.float(), want, BF16_REL)
