"""Parity of the port's recsys models (``repro_torch.models.recsys``) and
their steps with the reference's, on the same numpy ids and the
reference's parameters carried across (``from_reference``).

Tolerances (float32): logits, serve probabilities and retrieval scores
atol 1e-5 + rtol 1e-5; the loss rtol 1e-5; gradients and the parameters,
``mu`` and ``nu`` after one train step within rel 1e-4 of the reference's
largest entry, per parameter; field offsets and retrieval indices exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_util import assert_rel_close  # noqa: E402
from repro.configs import registry as ref_registry  # noqa: E402
from repro.models import recsys as RR  # noqa: E402
from repro.optim.adamw import adamw_init as ref_adamw_init  # noqa: E402
from repro.train import steps as RS  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import from_reference, to_reference  # noqa: E402
from repro_torch.models import recsys as R  # noqa: E402
from repro_torch.optim.adamw import adamw_init  # noqa: E402
from repro_torch.train import steps as S  # noqa: E402

B = 64


def _ids(cfg, b, seed=0):
    rng = np.random.default_rng(seed)
    offs, sizes = RR.field_offsets(cfg)
    vals = (rng.pareto(1.2, size=(b, cfg.n_sparse)) * 3).astype(np.int64) % sizes
    return (offs[None, :] + vals).astype(np.int32), rng.integers(0, 2, b).astype(np.float32)


@pytest.fixture(scope="module")
def reference():
    cfg = ref_registry.get_config("xdeepfm", smoke=True)
    params = RR.init_xdeepfm(jax.random.key(0), cfg)
    ids, labels = _ids(cfg, B)

    @jax.jit
    def results(p, i, y):
        loss, grads = jax.value_and_grad(RR.xdeepfm_loss)(p, i, y, cfg)
        stepped = RS.recsys_train_step(p, ref_adamw_init(p), i, y, cfg)
        return RR.xdeepfm_logits(p, i, cfg), RS.recsys_serve_step(p, i, cfg), loss, grads, stepped

    logits, probs, loss, grads, (p1, o1, met) = results(params, jnp.asarray(ids), jnp.asarray(labels))
    np_ = lambda t: {k: np.asarray(v) for k, v in t.items()}  # noqa: E731
    return dict(params=np_(params), ids=ids, labels=labels, logits=np.asarray(logits),
                probs=np.asarray(probs), loss=float(loss), grads=np_(grads), p1=np_(p1),
                mu1=np_(o1.mu), nu1=np_(o1.nu), loss1=float(met["loss"]),
                gnorm=float(met["gnorm"]))


def _model(ref):
    cfg = registry.get_config("xdeepfm", smoke=True)
    return cfg, from_reference(R.init_xdeepfm(cfg, device="cpu"), ref["params"])


def test_logits_loss_and_gradients_match(reference):
    cfg, model = _model(reference)
    ids, labels = torch.as_tensor(reference["ids"]), torch.as_tensor(reference["labels"])
    np.testing.assert_allclose(model(ids).detach().numpy(), reference["logits"], atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(S.recsys_serve_step(model.params, ids, cfg).numpy(),
                               reference["probs"], atol=1e-5, rtol=1e-5)
    loss = R.xdeepfm_loss(model.params, ids, labels, cfg)
    np.testing.assert_allclose(loss.item(), reference["loss"], rtol=1e-5)
    for k, g in zip(model.params, torch.autograd.grad(loss, list(model.params.values()))):
        assert_rel_close(g, reference["grads"][k], 1e-4)


def test_one_train_step_matches(reference):
    cfg, model = _model(reference)
    params = dict(model.params)
    params, opt, met = S.recsys_train_step(params, adamw_init(params),
                                           torch.as_tensor(reference["ids"]),
                                           torch.as_tensor(reference["labels"]), cfg)
    np.testing.assert_allclose(float(met["loss"]), reference["loss1"], rtol=1e-5)
    assert_rel_close(met["gnorm"], reference["gnorm"], 1e-4)
    for k in reference["p1"]:
        assert_rel_close(params[k], reference["p1"][k], 1e-4)
        assert_rel_close(opt.mu[k], reference["mu1"][k], 1e-4)
        assert_rel_close(opt.nu[k], reference["nu1"][k], 1e-4)


def test_out_of_range_ids_are_clipped_not_raised(reference):
    cfg, model = _model(reference)
    ids = reference["ids"].copy()
    ids[0, :3] = [-5, cfg.total_vocab + 10, np.iinfo(np.int32).max]
    got = model(torch.as_tensor(ids)).detach().numpy()
    want = np.asarray(RR.xdeepfm_logits({k: jnp.asarray(v) for k, v in reference["params"].items()},
                                        jnp.asarray(ids), ref_registry.get_config("xdeepfm", True)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    clipped = np.clip(ids, 0, cfg.total_vocab - 1)
    np.testing.assert_array_equal(got, model(torch.as_tensor(clipped)).detach().numpy())


def test_init_draws_the_reference_shapes_and_round_trips(reference):
    cfg = registry.get_config("xdeepfm", smoke=True)
    model = R.init_xdeepfm(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    assert {k: tuple(p.shape) for k, p in model.params.items()} == {
        k: v.shape for k, v in reference["params"].items()}
    back = to_reference(from_reference(model, reference["params"]))
    for k, v in reference["params"].items():
        np.testing.assert_array_equal(back[k], v)


@pytest.mark.parametrize("smoke", [True, False], ids=["SMOKE", "CONFIG"])
def test_field_offsets_match(smoke):
    got = R.field_offsets(registry.get_config("xdeepfm", smoke))
    want = RR.field_offsets(ref_registry.get_config("xdeepfm", smoke))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 1])
def test_embedding_bag_multihot_matches(seed):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((50, 6)).astype(np.float32)
    flat_ids = rng.integers(-3, 55, 30).astype(np.int32)  # some clipped
    bag_ids = rng.integers(0, 8, 30).astype(np.int32)  # unsorted bags
    got = R.embedding_bag_multihot(torch.as_tensor(table), torch.as_tensor(flat_ids),
                                   torch.as_tensor(bag_ids), 8)
    want = RR.embedding_bag_multihot(jnp.asarray(table), jnp.asarray(flat_ids),
                                     jnp.asarray(bag_ids), 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_retrieval_topk_matches_on_tie_free_scores():
    """Same indices and close scores. The scores here have no ties: the
    order among equal scores is not part of the contract (``jax.lax.top_k``
    takes the lower index first, ``torch.topk`` on the card promises none)."""
    cfg = ref_registry.get_config("xdeepfm", smoke=True)
    params = RR.init_retrieval(jax.random.key(1), cfg, n_candidates=500)
    ids, _ = _ids(cfg, 3, seed=4)
    scores, idx = RS.recsys_retrieval_step(params, jnp.asarray(ids), cfg, k=10)
    assert all(len(set(np.asarray(s).tolist())) == len(s) for s in np.asarray(scores))
    pcfg = registry.get_config("xdeepfm", smoke=True)
    model = from_reference(R.init_retrieval(pcfg, 500, device="cpu"),
                           {k: np.asarray(v) for k, v in params.items()})
    got_s, got_i = S.recsys_retrieval_step(model.params, torch.as_tensor(ids), pcfg, k=10)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(idx))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(scores), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(model(torch.as_tensor(ids), k=10).values, got_s, rtol=0, atol=0)
