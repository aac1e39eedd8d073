"""The port's trainer (``repro_torch.launch.train``) against the
reference's ``repro.launch.train`` for the GNN and recsys archs: runs from
one shared initial state, fault injection and resume, checkpoints crossing
packages both ways, the CLI, and the full configs neither package builds
(the LM archs' runs are in ``test_torch_launch_lm.py`` and
``test_torch_resume_lm.py``).

Tolerances: per-step losses of two runs from the same state within rel
1e-4 over 30 steps (float32 on both sides, sums in other orders; AdamW's
first steps move every weight by about the learning rate whatever the
gradient's size, so rounding does not grow); a resumed run of the port
equals its uninterrupted run within the reference test's 1e-5; a run
resumed across packages ends within rel 1e-4 of the other package's
uninterrupted run.
"""
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_util import assert_rel_close  # noqa: E402
import repro.launch.train as ref_train  # noqa: E402
import repro_torch.launch.train as train  # noqa: E402
from repro.checkpoint import save_checkpoint as ref_save  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    latest_step, restore_checkpoint, save_checkpoint, wait_for_saves,
)

ROOT = Path(__file__).resolve().parent.parent


def _args(**kw):
    d = dict(arch="gat-cora", steps=30, seed=0, ckpt_dir=None, ckpt_every=10,
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


def _reference_state_at_step_0(arch, path):
    """A checkpoint of the reference's initial state: both packages resume
    from it, so their runs start from the same weights."""
    from repro.launch.mesh import make_host_mesh

    params, opt, _ = ref_train.build_training(arch, make_host_mesh(), seed=0)
    ref_save(str(path), 0, {"p": params, "o": opt}, async_save=False)


@pytest.mark.parametrize("arch", ["gat-cora", "xdeepfm"])
def test_run_tracks_the_reference_step_by_step(arch, tmp_path, monkeypatch):
    _reference_state_at_step_0(arch, tmp_path / "ref")
    shutil.copytree(tmp_path / "ref", tmp_path / "port")
    ref_losses = _record_losses(ref_train, monkeypatch)
    ref_out = ref_train.run(_args(arch=arch, ckpt_dir=str(tmp_path / "ref"), ckpt_every=1000))
    port_losses = _record_losses(train, monkeypatch)
    out = train.run(_args(arch=arch, ckpt_dir=str(tmp_path / "port"), ckpt_every=1000))
    assert len(port_losses) == len(ref_losses) == out["steps"] == 30
    assert_rel_close(port_losses, ref_losses, 1e-4)
    assert_rel_close([out["first_loss"], out["last_loss"]],
                     [ref_out["first_loss"], ref_out["last_loss"]], 1e-4)
    assert out["last_loss"] < out["first_loss"]


def test_fault_injection_resume_is_exact(tmp_path):
    """Crash at step 17, restart from the checkpoint: the final loss of an
    uninterrupted run (step-keyed data, deterministic CPU steps)."""
    base = train.run(_args())
    for attempt in range(2):  # the fault is per args object, not per process
        args = _args(ckpt_dir=str(tmp_path / f"ck{attempt}"), ckpt_every=5, fault_at=17)
        with pytest.raises(train.FaultInjected):
            train.run(args)
        assert args.faulted
        resumed = train.run(args)  # the supervisor's retry: no second fault
        assert abs(resumed["last_loss"] - base["last_loss"]) < 1e-5
        assert resumed["steps"] < 30


@pytest.mark.parametrize("direction", ["reference to port", "port to reference"])
def test_checkpoint_crosses_packages(direction, tmp_path):
    """A run of one package checkpoints at step 10; the other package's run
    resumes from it and ends where the first package's uninterrupted run
    does."""
    first, second = (ref_train, train) if direction == "reference to port" else (train, ref_train)
    ck = str(tmp_path / "ck")
    first.run(_args(steps=10, ckpt_dir=ck, ckpt_every=10))
    assert latest_step(ck) == 10
    resumed = second.run(_args(ckpt_dir=ck, ckpt_every=1000))
    assert resumed["steps"] == 20
    whole = first.run(_args())
    assert_rel_close(resumed["last_loss"], whole["last_loss"], 1e-4)


def test_async_save_keeps_the_values_of_its_step(tmp_path):
    """The serialization runs on another thread: updating the tensors in
    place right after ``save_checkpoint`` returns must not reach the file."""
    w = torch.arange(1 << 16, dtype=torch.float32)
    tree = {"p": {"w": w}, "step": torch.tensor(3, dtype=torch.int32)}
    save_checkpoint(str(tmp_path), 1, tree)
    w.mul_(-1)
    wait_for_saves()
    got = restore_checkpoint(str(tmp_path), 1, tree)
    np.testing.assert_array_equal(got["p"]["w"], np.arange(1 << 16, dtype=np.float32))


def _cli(*flags):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *flags], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=300)


def test_cli_trains_on_the_cpu():
    proc = _cli("--arch", "gat-cora", "--steps", "5", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    assert "[done] loss" in proc.stdout


def test_cli_supervisor_restarts_after_a_fault(tmp_path):
    proc = _cli("--arch", "xdeepfm", "--steps", "8", "--device", "cpu", "--ckpt-dir",
                str(tmp_path), "--ckpt-every", "2", "--fault-at", "5", "--supervise")
    assert proc.returncode == 0, proc.stderr
    assert "[supervisor] attempt 0: injected node failure at step 5" in proc.stdout
    assert "[restore] resumed from checkpoint step" in proc.stdout
    assert latest_step(str(tmp_path)) == 8


def test_entry_points_want_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.build_training("gat-cora")
    proc = _cli("--arch", "gat-cora", "--steps", "1")
    assert proc.returncode != 0 and "device='cpu'" in proc.stderr


@pytest.mark.parametrize("arch", ["gat-cora", "meshgraphnet", "gatedgcn"])
def test_full_config_without_d_in_raises_as_the_reference(arch):
    """``CONFIG.d_in`` is 0 for these archs (each shape cell sets it), and
    both packages' inits divide by it."""
    with pytest.raises(ZeroDivisionError):
        ref_train.build_training(arch, None, full=True)
    with pytest.raises(ZeroDivisionError):
        train.build_training(arch, full=True, device="cpu")


def test_full_nequip_builds_with_the_reference_shapes():
    from repro.launch.mesh import make_host_mesh

    ref_params, _, _ = ref_train.build_training("nequip", make_host_mesh(), full=True)
    params, opt, _ = train.build_training("nequip", full=True, device="cpu")
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        k: v.shape for k, v in ref_params.items()}
    assert sorted(opt.mu) == sorted(params) and int(opt.step) == 0
