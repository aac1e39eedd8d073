"""Fault tolerance of the port's trainer for the LM archs: an injected
fault and the resume from the latest checkpoint, LM checkpoints crossing
packages both ways (the nested ``{"p", "o"}`` tree under the reference's
path names), and ``--supervise`` through the CLI.

Runs use the configured bfloat16. Tolerances: a resumed run of the port
equals its uninterrupted run within 1e-5 (deterministic CPU steps,
step-keyed data); a run resumed across packages ends within rel 2^-10 of
the other package's uninterrupted run (the bfloat16 loss tolerance of
``test_torch_models_lm.py``).
"""
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from _torch_util import assert_rel_close, one_torch_thread  # noqa: E402,F401
import repro.launch.train as ref_train  # noqa: E402
import repro_torch.launch.train as train  # noqa: E402
from repro_torch.checkpoint import latest_step, restore_checkpoint  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BF16_LOSS_REL = 2.0 ** -10


def _args(**kw):
    d = dict(arch="qwen3-32b", steps=10, seed=0, ckpt_dir=None, ckpt_every=1000,
             fault_at=None, supervise=False, device="cpu")
    d.update(kw)
    return types.SimpleNamespace(**d)


def test_fault_injection_resume_is_exact(tmp_path):
    """Crash at step 7, restart from the step-6 checkpoint: the mean of the
    last five losses (steps 7..11) equals the uninterrupted run's."""
    base = train.run(_args(arch="mixtral-8x7b", steps=12))
    args = _args(arch="mixtral-8x7b", steps=12, ckpt_dir=str(tmp_path), ckpt_every=3,
                 fault_at=7)
    with pytest.raises(train.FaultInjected):
        train.run(args)
    assert args.faulted and latest_step(str(tmp_path)) == 6
    resumed = train.run(args)  # the supervisor's retry: no second fault
    assert resumed["steps"] == 6
    assert abs(resumed["last_loss"] - base["last_loss"]) < 1e-5


@pytest.fixture(scope="module")
def whole_runs(tmp_path_factory):
    """Each package's uninterrupted 10-step qwen3-32b run, checkpointing at
    steps 5 and 10."""
    out = {}
    for name, mod in (("reference", ref_train), ("port", train)):
        ck = tmp_path_factory.mktemp(name)
        out[name] = (ck, mod.run(_args(ckpt_dir=str(ck), ckpt_every=5)))
    return out


@pytest.mark.parametrize("direction", ["reference to port", "port to reference"])
def test_checkpoint_crosses_packages(direction, whole_runs, tmp_path):
    """The other package resumes from one package's step-5 checkpoint and
    ends where that package's uninterrupted run does."""
    first, second = direction.split(" to ")
    ck, whole = whole_runs[first]
    shutil.copytree(ck / "step_000000005", tmp_path / "step_000000005")
    resumed = (train if second == "port" else ref_train).run(_args(ckpt_dir=str(tmp_path)))
    assert resumed["steps"] == 5
    assert_rel_close(resumed["last_loss"], whole["last_loss"], BF16_LOSS_REL)


def test_checkpoint_names_nest_as_the_reference(whole_runs):
    """Both packages write the same array names, e.g.
    ``['o'].mu['layers']['wq']``, with the same shapes."""
    import numpy as np

    names = {}
    for name, (ck, _) in whole_runs.items():
        with np.load(ck / "step_000000010" / "arrays.npz") as z:
            names[name] = {k: z[k].shape for k in z.files}
    assert names["port"] == names["reference"]
    assert "['o']/.mu/['layers']/['wq']" in names["port"]
    params, opt, _ = train.build_training("qwen3-32b", device="cpu")
    state = restore_checkpoint(str(whole_runs["reference"][0]), 10, {"p": params, "o": opt})
    assert int(state["o"].step) == 10
    assert state["p"]["layers"]["q_norm"].shape == tuple(params["layers"]["q_norm"].shape)


def test_train_cli_supervises_an_lm_run(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen2-7b", "--steps", "6",
         "--device", "cpu", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2", "--fault-at", "3",
         "--supervise"], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "[supervisor] attempt 0: injected node failure at step 3" in proc.stdout
    assert "[restore] resumed from checkpoint step 2" in proc.stdout
    assert "[done] loss" in proc.stdout and latest_step(str(tmp_path)) == 6
