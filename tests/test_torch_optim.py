"""Parity of the port's optimizer (``repro_torch.optim``) with the
reference's on the same numpy inputs.

Tolerances: parameters, ``mu`` and ``nu`` after five AdamW steps and the
global norm within rel 1e-4 of the reference's (float32; the sums run in
another order); ``step`` and the learning-rate schedule within rel 1e-6
(elementwise float32 only); the int8 compression exact."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_util import assert_rel_close  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.optim import compress as ref_compress  # noqa: E402
from repro_torch.optim import adamw, compress  # noqa: E402

SHAPES = {"w": (7, 5), "b": (5,), "emb": (40, 3), "scalar": ()}


def _tree(rng, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in SHAPES.items()}


def _five_steps(ref: bool, monkeypatch=None):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng, scale) for scale in (0.05, 3.0, 0.01, 0.2, 1.5)]  # steps 2 and 5 clip
    lrs = [1e-2, 5e-3, 2e-2, 1e-3, 1e-2]
    if ref:
        p = {k: jnp.asarray(v) for k, v in params.items()}
        st = ref_adamw.adamw_init(p)
        norms = []
        for g, lr in zip(grads, lrs):
            p, st, gn = ref_adamw.adamw_update({k: jnp.asarray(v) for k, v in g.items()}, st, p,
                                               jnp.float32(lr))
            norms.append(float(gn))
        return p, st, norms
    p = {k: torch.tensor(v) for k, v in params.items()}
    st = adamw.adamw_init(p)
    norms = []
    for g, lr in zip(grads, lrs):
        p, st, gn = adamw.adamw_update({k: torch.tensor(v) for k, v in g.items()}, st, p,
                                       torch.tensor(lr))
        norms.append(float(gn))
    return p, st, norms


@pytest.fixture(scope="module")
def reference_steps():
    return _five_steps(ref=True)


def test_adamw_five_steps_match(reference_steps):
    rp, rst, rnorms = reference_steps
    pp, pst, pnorms = _five_steps(ref=False)
    assert max(rnorms) > 1.0 and min(rnorms) < 1.0  # the clip acts in some steps only
    assert_rel_close(pnorms, rnorms, 1e-4)
    assert pst.step.dtype == torch.int32 and int(pst.step) == int(rst.step) == 5
    for k in SHAPES:
        assert_rel_close(pp[k], rp[k], 1e-4)
        assert_rel_close(pst.mu[k], rst.mu[k], 1e-4)
        assert_rel_close(pst.nu[k], rst.nu[k], 1e-4)


def test_adamw_update_in_chunks_matches_whole(monkeypatch):
    whole = _five_steps(ref=False)
    monkeypatch.setattr(adamw, "CHUNK", 7)  # every leaf but the scalar in several chunks
    chunked = _five_steps(ref=False)
    assert_rel_close(chunked[2], whole[2], 1e-6)
    for k in SHAPES:
        assert_rel_close(chunked[0][k], whole[0][k], 1e-6)
        assert_rel_close(chunked[1].nu[k], whole[1].nu[k], 1e-6)


def test_adamw_init_and_global_norm():
    rng = np.random.default_rng(1)
    t = _tree(rng)
    st = adamw.adamw_init({k: torch.tensor(v) for k, v in t.items()})
    rst = ref_adamw.adamw_init({k: jnp.asarray(v) for k, v in t.items()})
    for k in SHAPES:
        assert st.mu[k].dtype == torch.float32 and tuple(st.mu[k].shape) == rst.mu[k].shape
        assert not st.mu[k].any() and not st.nu[k].any()
    assert st.step.dtype == torch.int32 and int(st.step) == 0
    assert_rel_close(float(adamw.global_norm({k: torch.tensor(v) for k, v in t.items()})),
           float(ref_adamw.global_norm({k: jnp.asarray(v) for k, v in t.items()})), 1e-6)


@pytest.mark.parametrize("step", [0, 1, 50, 99, 100, 5_000, 10_000, 20_000])
def test_cosine_lr_matches(step):
    kw = dict(peak=3e-4, warmup=100, total=10000)
    got = adamw.cosine_lr(torch.tensor(step, dtype=torch.int32), **kw)
    want = ref_adamw.cosine_lr(jnp.int32(step), **kw)
    assert got.dtype == torch.float32
    assert_rel_close(float(got), float(want), 1e-6)


def test_compress_with_error_feedback_three_rounds():
    rng = np.random.default_rng(2)
    err = compress.init_error_state({k: torch.zeros(s) for k, s in SHAPES.items()})
    rerr = ref_compress.init_error_state({k: jnp.zeros(s) for k, s in SHAPES.items()})
    for r in range(3):
        g = _tree(rng, 10.0 ** (r - 1))
        if r == 0:  # halves of a quantum: both round half to even
            g["b"] = np.array([127.0, 0.5, 1.5, 2.5, -0.5], np.float32)
        deq, err = compress.compress_with_error_feedback({k: torch.tensor(v) for k, v in g.items()}, err)
        rdeq, rerr = ref_compress.compress_with_error_feedback(
            {k: jnp.asarray(v) for k, v in g.items()}, rerr)
        for k in SHAPES:
            np.testing.assert_array_equal(deq[k].numpy(), np.asarray(rdeq[k]))
            np.testing.assert_array_equal(err[k].numpy(), np.asarray(rerr[k]))


def test_apply_opt_with_compression_matches():
    """The train steps' optimizer stage with int8 error feedback on: the
    learning rate at the state's step, compressed gradients, one AdamW step."""
    from repro.train import steps as ref_steps
    from repro_torch.train import steps

    rng = np.random.default_rng(3)
    params, grads = _tree(rng), _tree(rng, 0.3)
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    ropt = ref_adamw.adamw_init(rp)._replace(step=jnp.int32(150))
    rout = ref_steps._apply_opt(rp, ropt, {k: jnp.asarray(v) for k, v in grads.items()},
                                ropt.step, compress=True,
                                err_state=ref_compress.init_error_state(rp))
    pp = {k: torch.tensor(v) for k, v in params.items()}
    popt = adamw.adamw_init(pp)._replace(step=torch.tensor(150, dtype=torch.int32))
    pout = steps._apply_opt(pp, popt, {k: torch.tensor(v) for k, v in grads.items()},
                            popt.step, compress=True, err_state=compress.init_error_state(pp))
    assert_rel_close(pout[2], rout[2], 1e-4)
    for k in SHAPES:
        assert_rel_close(pout[0][k], rout[0][k], 1e-4)
        assert_rel_close(pout[3][k], rout[3][k], 1e-4)
