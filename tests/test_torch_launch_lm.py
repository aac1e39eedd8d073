"""The port's trainer for the LM archs (``repro_torch.launch.train``)
against the reference's: for every LM arch, runs from one shared initial
state tracked step by step, and the trees ``build_training`` gives.

Runs use the configured bfloat16: per-step losses of both packages from
one state within rel 2^-10 (the bfloat16 loss tolerance of
``test_torch_models_lm.py``).
"""
import shutil
import types

import pytest

torch = pytest.importorskip("torch")

from _torch_util import assert_rel_close, one_torch_thread  # noqa: E402,F401
import repro.launch.train as ref_train  # noqa: E402
import repro_torch.launch.train as train  # noqa: E402
from repro.checkpoint import save_checkpoint as ref_save  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.configs import registry  # noqa: E402

ARCHS = [a for a in registry.arch_ids() if registry.family_of(a) == "lm"]
BF16_LOSS_REL = 2.0 ** -10


def _args(**kw):
    d = dict(arch="qwen2-7b", steps=10, seed=0, ckpt_dir=None, ckpt_every=1000,
             fault_at=None, supervise=False, device="cpu")
    d.update(kw)
    return types.SimpleNamespace(**d)


def _record_losses(mod, monkeypatch) -> list:
    """Every step's loss of the runs ``mod.run`` makes while patched."""
    losses = []
    real = mod.build_training

    def build(*a, **kw):
        params, opt, step_fn = real(*a, **kw)

        def step(p, o, i):
            p, o, m = step_fn(p, o, i)
            losses.append(float(m["loss"]))
            return p, o, m

        return params, opt, step

    monkeypatch.setattr(mod, "build_training", build)
    return losses


@pytest.mark.parametrize("arch", ARCHS)
def test_run_tracks_the_reference_step_by_step(arch, tmp_path, monkeypatch):
    """Both packages resume from the reference's step-0 checkpoint (the
    same weights) and train 10 steps on the same batches."""
    params, opt, _ = ref_train.build_training(arch, make_host_mesh(), seed=0)
    ref_save(str(tmp_path / "ref"), 0, {"p": params, "o": opt}, async_save=False)
    shutil.copytree(tmp_path / "ref", tmp_path / "port")
    ref_losses = _record_losses(ref_train, monkeypatch)
    ref_out = ref_train.run(_args(arch=arch, ckpt_dir=str(tmp_path / "ref")))
    port_losses = _record_losses(train, monkeypatch)
    out = train.run(_args(arch=arch, ckpt_dir=str(tmp_path / "port")))
    assert len(port_losses) == len(ref_losses) == out["steps"] == 10
    assert_rel_close(port_losses, ref_losses, BF16_LOSS_REL)
    assert_rel_close([out["first_loss"], out["last_loss"]],
                     [ref_out["first_loss"], ref_out["last_loss"]], BF16_LOSS_REL)


def test_build_training_gives_the_reference_trees():
    import jax

    params, opt, _ = train.build_training("mixtral-8x7b", device="cpu")
    ref_params, ref_opt, _ = ref_train.build_training("mixtral-8x7b", make_host_mesh())
    shapes = jax.tree.map(lambda t: tuple(t.shape), params)
    assert shapes == jax.tree.map(lambda a: tuple(a.shape), ref_params)
    assert jax.tree.map(lambda t: tuple(t.shape), opt.mu) == shapes
    assert int(opt.step) == 0
