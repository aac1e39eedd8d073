"""The port's LM train steps against the reference's:
``lm_loss_and_grad`` (with gradient accumulation), ``lm_train_step``,
and AdamW over the nested parameter tree.

Tolerances (``dtype="float32"``): losses within rel 1e-5; gradients, the
global norm, ``mu`` and ``nu`` within rel 1e-4 of the reference's largest
entry, per parameter (the sums run in other orders); parameters after
train steps within rel 1e-4 of their largest entry plus 1e-2 of the
learning rate summed over the steps. AdamW divides each gradient element
by its own RMS plus eps = 1e-8, so where an element's gradient is near
eps (the key bias's, of order 1e-9 at this init) its float32 rounding
reaches the update as a share of the learning rate; ``mu`` and ``nu``,
linear in the gradient, pin the gradients themselves. Nested AdamW alone
within rel 1e-4, as in ``test_torch_optim.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_util import assert_rel_close, one_torch_thread  # noqa: E402,F401
from repro.configs import registry as ref_registry  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.optim.adamw import cosine_lr as ref_cosine_lr  # noqa: E402
from repro.train import steps as RS  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import from_reference  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import steps as S  # noqa: E402

ARCHS = [a for a in registry.arch_ids() if registry.family_of(a) == "lm"]
MESH = make_host_mesh()


def _cfgs(arch, **kw):
    return tuple(dataclasses.replace(reg.get_config(arch, smoke=True), dtype="float32", **kw)
                 for reg in (ref_registry, registry))


def _batch(cfg, b=4, s=40, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
            rng.integers(0, cfg.vocab, (b, s)).astype(np.int32))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_tree_close(got, want, rel, atol=0.0):
    got_leaves = adamw.tree_leaves(got)
    want_leaves = jax.tree.leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        assert tuple(g.shape) == np.shape(w)
        err = float(np.max(np.abs(g.detach().numpy() - w), initial=0))
        assert err <= rel * float(np.max(np.abs(w), initial=0)) + atol, (err, rel, atol)


@pytest.mark.parametrize("case", ARCHS + ["qwen2-7b-accum2", "mixtral-8x7b-accum4"])
def test_loss_and_grad(case):
    arch, _, accum = case.partition("-accum")
    rcfg, cfg = _cfgs(arch, grad_accum=int(accum or 1))
    params = RT.init_lm(jax.random.key(0), rcfg)
    toks, labels = _batch(cfg)
    want_loss, want_g = _np(jax.jit(lambda p, t, l: RS.lm_loss_and_grad(p, t, l, rcfg, MESH))(
        params, toks, labels))
    model = from_reference(T.init_lm(cfg, device="cpu"), _np(params))
    loss, grads = S.lm_loss_and_grad(model.params, torch.tensor(toks), torch.tensor(labels), cfg)
    assert loss.dtype == torch.float32 and not loss.requires_grad
    assert_rel_close(loss, want_loss, 1e-5)
    _assert_tree_close(grads, want_g, 1e-4)
    assert all(g.dtype == torch.float32 for g in adamw.tree_leaves(grads))


@pytest.mark.parametrize("arch", ["qwen2-7b", "mixtral-8x7b"])
def test_train_steps_track_the_reference(arch):
    """Three lm_train_steps from one state: params, mu, nu, step and the
    global norm after each, against the reference's."""
    rcfg, cfg = _cfgs(arch)
    params = RT.init_lm(jax.random.key(0), rcfg)
    opt = ref_adamw.adamw_init(params)
    step = jax.jit(lambda p, o, t, l: RS.lm_train_step(p, o, t, l, rcfg, MESH))
    model = from_reference(T.init_lm(cfg, device="cpu"), _np(params))
    p, o = model.params, adamw.adamw_init(model.params)
    lr_sum = 0.0
    for i in range(3):
        toks, labels = _batch(cfg, seed=10 + i)
        lr_sum += float(ref_cosine_lr(opt.step, **RS.LR))
        params, opt, want_m = step(params, opt, toks, labels)
        p, o, m = S.lm_train_step(p, o, torch.tensor(toks), torch.tensor(labels), cfg)
        assert_rel_close(m["loss"], want_m["loss"], 1e-5)
        assert_rel_close(m["gnorm"], want_m["gnorm"], 1e-4)
        assert int(o.step) == int(opt.step) == i + 1
        _assert_tree_close(p, _np(params), 1e-4, 1e-2 * lr_sum)
        _assert_tree_close(o.mu, _np(opt.mu), 1e-4)
        _assert_tree_close(o.nu, _np(opt.nu), 1e-4)
    assert p is model.params  # updated in place


def test_nested_adamw_matches_the_reference():
    rng = np.random.default_rng(0)
    shapes = {"embed": (9, 4), "final_norm": (4,),
              "layers": {"wq": (2, 4, 6), "ln1": (2, 4), "router": (2, 4, 3)},
              "scalar": ()}

    def draw(sh, scale):
        return {k: draw(s, scale) if isinstance(s, dict)
                else (rng.standard_normal(s) * scale).astype(np.float32) for k, s in sh.items()}

    params = draw(shapes, 1.0)
    grads = [draw(shapes, sc) for sc in (0.05, 3.0, 0.01, 0.2, 1.5)]  # steps 2 and 5 clip
    lrs = [1e-2, 5e-3, 2e-2, 1e-3, 1e-2]
    rp = jax.tree.map(jnp.asarray, params)
    rst = ref_adamw.adamw_init(rp)
    p = adamw.tree_map(torch.tensor, params)
    st = adamw.adamw_init(p)
    assert st.mu["layers"]["wq"].shape == (2, 4, 6)
    for g, lr in zip(grads, lrs):
        rp, rst, rn = ref_adamw.adamw_update(jax.tree.map(jnp.asarray, g), rst, rp,
                                             jnp.float32(lr))
        p, st, n = adamw.adamw_update(adamw.tree_map(torch.tensor, g), st, p, torch.tensor(lr))
        assert_rel_close(n, rn, 1e-4)
    assert int(st.step) == 5
    for got, want in ((p, rp), (st.mu, rst.mu), (st.nu, rst.nu)):
        _assert_tree_close(got, _np(want), 1e-4)
    assert_rel_close(adamw.global_norm(p), ref_adamw.global_norm(rp), 1e-5)
