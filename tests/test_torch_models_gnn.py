"""Parity of the port's GNN models (``repro_torch.models.gnn``, ``o3``) and
their train step with the reference's, on the same numpy batches and the
reference's initial parameters carried across (``from_reference``).

Tolerances (float32 on both sides, the reductions run in other orders):
forward outputs atol 1e-5 + rtol 1e-5; losses rtol 1e-5; gradients and
the parameters, ``mu``, ``nu`` and global norm after one train step within
rel 1e-4 of the reference's largest entry, per parameter. The ``o3``
numpy copies are exact; the Bessel basis atol 1e-6. The port's own
properties (NequIP's invariance and equivariance) take the reference
test's 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_util import assert_rel_close  # noqa: E402
from repro.configs import registry as ref_registry  # noqa: E402
from repro.models import gnn as RG  # noqa: E402
from repro.models import o3 as ref_o3  # noqa: E402
from repro.optim.adamw import adamw_init as ref_adamw_init  # noqa: E402
from repro.train import steps as RS  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import from_reference, o3, to_reference  # noqa: E402
from repro_torch.models import gnn as G  # noqa: E402
from repro_torch.optim.adamw import adamw_init  # noqa: E402
from repro_torch.train import steps as S  # noqa: E402

ARCHS = ["gat-cora", "meshgraphnet", "gatedgcn", "nequip"]
CASES = ARCHS + ["nequip-forces"]
REF_INIT = {"gat": RG.init_gat, "meshgraphnet": RG.init_meshgraphnet,
            "gatedgcn": RG.init_gatedgcn, "nequip": RG.init_nequip}
PORT_INIT = {"gat": G.init_gat, "meshgraphnet": G.init_meshgraphnet,
             "gatedgcn": G.init_gatedgcn, "nequip": G.init_nequip}


def _cfg(case, ref=False):
    arch = case.removesuffix("-forces")
    cfg = (ref_registry if ref else registry).get_config(arch, smoke=True)
    return dataclasses.replace(cfg, predict_forces=case.endswith("-forces"))


def _batch(cfg, n=40, e=160, seed=1):
    """numpy batch: 10% padded edges; NequIP two molecules with forces."""
    rng = np.random.default_rng(seed)
    b = dict(src=rng.integers(0, n, e).astype(np.int32), dst=rng.integers(0, n, e).astype(np.int32),
             edge_valid=rng.random(e) < 0.9)
    if cfg.kind == "nequip":
        b.update(species=rng.integers(0, 4, n).astype(np.int32),
                 pos=(rng.standard_normal((n, 3)) * 1.5).astype(np.float32),
                 graph_ids=(np.arange(n) * 2 // n).astype(np.int32),
                 energy=rng.standard_normal(2).astype(np.float32),
                 forces=rng.standard_normal((n, 3)).astype(np.float32))
        return b
    b.update(x=rng.standard_normal((n, cfg.d_in)).astype(np.float32),
             node_mask=(rng.random(n) < 0.8).astype(np.float32))
    if cfg.kind == "meshgraphnet":
        b["e_feat"] = rng.standard_normal((e, 4)).astype(np.float32)
        b["targets"] = rng.standard_normal((n, cfg.d_out)).astype(np.float32)
    else:
        b["labels"] = rng.integers(0, cfg.n_classes, n).astype(np.int32)
        if cfg.kind == "gatedgcn":
            b["e_feat"] = rng.standard_normal((e, 1)).astype(np.float32)
    return b


def _n_graphs(cfg):
    return 2 if cfg.kind == "nequip" else 1


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def reference():
    """The reference's results per case, computed once: initial params,
    batch, forward, loss, gradients and one train step (all numpy)."""
    cache = {}

    def get(case):
        if case not in cache:
            cfg = _cfg(case, ref=True)
            params = REF_INIT[cfg.kind](jax.random.key(0), cfg)
            batch = _batch(cfg)
            jb = {k: jnp.asarray(v) for k, v in batch.items()}
            ng = _n_graphs(cfg)

            @jax.jit  # one compile per case: eager JAX dispatch is slower here
            def results(p, b):
                loss, grads = jax.value_and_grad(RS.gnn_loss)(p, b, cfg, ng)
                stepped = RS.gnn_train_step(p, ref_adamw_init(p), b, cfg, ng)
                return RS.gnn_apply(p, b, cfg, ng), loss, grads, stepped

            out, loss, grads, (p1, o1, met) = results(params, jb)
            cache[case] = dict(params=_np(params), batch=batch, out=np.asarray(out),
                               loss=float(loss), grads=_np(grads), p1=_np(p1), mu1=_np(o1.mu),
                               nu1=_np(o1.nu), step1=int(o1.step), gnorm=float(met["gnorm"]),
                               loss1=float(met["loss"]))
        return cache[case]

    return get


def _port(case, ref):
    cfg = _cfg(case)
    model = from_reference(PORT_INIT[cfg.kind](cfg, device="cpu"), ref["params"])
    batch = {k: torch.as_tensor(v) for k, v in ref["batch"].items()}
    return cfg, model, batch


def _forward(model, batch, cfg):
    if cfg.kind == "gat":
        return model(batch["x"], batch["src"], batch["dst"], batch["edge_valid"])
    if cfg.kind == "nequip":
        return model(batch["species"], batch["pos"], batch["src"], batch["dst"],
                     batch["edge_valid"], batch["graph_ids"], _n_graphs(cfg))
    return model(batch["x"], batch["e_feat"], batch["src"], batch["dst"], batch["edge_valid"])


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches(reference, arch):
    ref = reference(arch)
    cfg, model, batch = _port(arch, ref)
    out = _forward(model, batch, cfg)
    np.testing.assert_allclose(out.detach().numpy(), ref["out"], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(S.gnn_apply(model.params, batch, cfg, _n_graphs(cfg)), out,
                               rtol=0, atol=0)


@pytest.mark.parametrize("case", CASES)
def test_loss_and_gradients_match(reference, case):
    ref = reference(case)
    cfg, model, batch = _port(case, ref)
    loss = S.gnn_loss(model.params, batch, cfg, _n_graphs(cfg))
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=1e-5)
    grads = torch.autograd.grad(loss, list(model.params.values()), allow_unused=True,
                                materialize_grads=True)
    for k, g in zip(model.params, grads):
        assert_rel_close(g, ref["grads"][k], 1e-4)


@pytest.mark.parametrize("case", CASES)
def test_one_train_step_matches(reference, case):
    ref = reference(case)
    cfg, model, batch = _port(case, ref)
    params = dict(model.params)
    params, opt, met = S.gnn_train_step(params, adamw_init(params), batch, cfg, _n_graphs(cfg))
    np.testing.assert_allclose(float(met["loss"]), ref["loss1"], rtol=1e-5)
    assert_rel_close(met["gnorm"], ref["gnorm"], 1e-4)
    assert opt.step.dtype == torch.int32 and int(opt.step) == ref["step1"] == 1
    for k in ref["p1"]:
        assert_rel_close(params[k], ref["p1"][k], 1e-4)
        assert_rel_close(opt.mu[k], ref["mu1"][k], 1e-4)
        assert_rel_close(opt.nu[k], ref["nu1"][k], 1e-4)
    assert params[k] is model.params[k]  # the step updates the module in place


@pytest.mark.parametrize("arch", ARCHS)
def test_init_draws_the_reference_shapes_and_round_trips(reference, arch):
    ref = reference(arch)
    cfg = _cfg(arch)
    model = PORT_INIT[cfg.kind](cfg, generator=torch.Generator().manual_seed(5), device="cpu")
    assert {k: tuple(p.shape) for k, p in model.params.items()} == {
        k: v.shape for k, v in ref["params"].items()}
    assert all(p.dtype == torch.float32 and p.requires_grad for p in model.params.values())
    back = to_reference(from_reference(model, ref["params"]))
    assert sorted(back) == sorted(ref["params"])
    for k, v in ref["params"].items():
        np.testing.assert_array_equal(back[k], v)
    again = PORT_INIT[cfg.kind](cfg, generator=torch.Generator().manual_seed(5), device="cpu")
    assert all(torch.equal(again.params[k], PORT_INIT[cfg.kind](
        cfg, generator=torch.Generator().manual_seed(5), device="cpu").params[k])
        for k in again.params)  # a generator's seed fixes the draw
    with pytest.raises(KeyError):
        from_reference(model, {**ref["params"], "extra": np.zeros(1)})


def test_entry_points_want_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        G.init_gat(registry.get_config("gat-cora", smoke=True))


@pytest.mark.parametrize("arch", ARCHS)
def test_message_passing_ignores_invalid_edges(reference, arch):
    """Scrambling the padded edges' endpoints leaves every output alone."""
    ref = reference(arch)
    cfg, model, batch = _port(arch, ref)
    ev = batch["edge_valid"]
    n = batch["species" if cfg.kind == "nequip" else "x"].shape[0]
    out1 = _forward(model, batch, cfg)
    scrambled = dict(batch, src=torch.where(ev, batch["src"], (batch["src"] + 7) % n),
                     dst=torch.where(ev, batch["dst"], (batch["dst"] + 3) % n))
    out2 = _forward(model, scrambled, cfg)
    np.testing.assert_allclose(out2.detach().numpy(), out1.detach().numpy(), atol=1e-5)


def test_nequip_energy_invariance_force_equivariance(reference):
    """The port alone keeps E(3) symmetry (the reference test's
    ``tests/test_models_gnn.py`` properties and tolerance)."""
    ref = reference("nequip")
    cfg, model, _ = _port("nequip", ref)
    rng = np.random.default_rng(3)
    n = 16
    species = torch.as_tensor(rng.integers(0, 4, n), dtype=torch.int32)
    pos = torch.as_tensor(rng.standard_normal((n, 3)) * 2, dtype=torch.float32)
    src = torch.as_tensor(rng.integers(0, n, 48), dtype=torch.int32)
    dst = torch.as_tensor(rng.integers(0, n, 48), dtype=torch.int32)
    ev, gid = src != dst, torch.zeros(n, dtype=torch.int32)

    def energy(p):
        return model(species, p, src, dst, ev, gid, 1)[0]

    def force(p):
        p = p.clone().requires_grad_(True)
        return torch.autograd.grad(energy(p), p)[0]

    r = torch.as_tensor(ref_o3._random_rotation(np.random.default_rng(9)), dtype=torch.float32)
    e1, e2 = energy(pos).item(), energy(pos @ r.T).item()
    assert abs(e1 - e2) < 1e-4 * max(1.0, abs(e1))
    np.testing.assert_allclose(force(pos @ r.T).numpy(), (force(pos) @ r.T).numpy(), atol=1e-4)
    e3 = energy(pos + torch.tensor([1.0, -2.0, 0.5])).item()
    assert abs(e1 - e3) < 1e-4 * max(1.0, abs(e1))


def test_out_of_range_species_are_clipped(reference):
    """Species outside [0, 4) read the nearest row, as the reference's
    ``jnp.take(mode="clip")`` does: ids that clip back to the batch's own
    species give the reference's output on that batch."""
    ref = reference("nequip")
    cfg, model, batch = _port("nequip", ref)
    species = batch["species"]
    wild = torch.where(species == 0, -3, torch.where(species == 3, 99, species))
    assert (wild < 0).any() and (wild > 3).any()
    out = _forward(model, dict(batch, species=wild.to(torch.int32)), cfg)
    np.testing.assert_allclose(out.detach().numpy(), ref["out"], atol=1e-5, rtol=1e-5)


def test_o3_numpy_functions_are_copies():
    rng = np.random.default_rng(0)
    vec = rng.standard_normal((20, 3))
    for l in range(3):
        np.testing.assert_array_equal(o3.sph_harm_np(vec, l), ref_o3.sph_harm_np(vec, l))
    r = o3._random_rotation(np.random.default_rng(4))
    np.testing.assert_array_equal(r, ref_o3._random_rotation(np.random.default_rng(4)))
    for l in range(3):
        np.testing.assert_array_equal(o3.wigner_d_np(r, l, np.random.default_rng(l)),
                                      ref_o3.wigner_d_np(r, l, np.random.default_rng(l)))
    assert o3.tp_paths(2) == ref_o3.tp_paths(2)
    for path in o3.tp_paths(2):
        np.testing.assert_array_equal(o3.clebsch_gordan(*path), ref_o3.clebsch_gordan(*path))
    with pytest.raises(ValueError):
        o3.clebsch_gordan(0, 0, 2)


def test_bessel_basis_and_spherical_harmonics_match():
    rng = np.random.default_rng(1)
    r = np.concatenate([[0.0, 1e-9, 5.0, 7.5], rng.uniform(0, 6, 60)]).astype(np.float32)
    got = o3.bessel_basis_np(8, 5.0)(torch.as_tensor(r))
    want = ref_o3.bessel_basis_np(8, 5.0)(jnp.asarray(r))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    vec = rng.standard_normal((30, 3)).astype(np.float32)
    vec[0] = 0.0  # the safe norm
    for l in range(3):
        np.testing.assert_allclose(G._sph_harm(torch.as_tensor(vec), l).numpy(),
                                   np.asarray(RG._sph_harm_jnp(jnp.asarray(vec), l)), atol=1e-6)
