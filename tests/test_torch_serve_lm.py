"""The port's LM serving (``repro_torch.launch.serve``) against the
reference's: ``generate``'s greedy tokens against the reference's
prefill/decode loop with the same weights, its cache padding, and the
CLI's three lines.

Greedy generation under ``dtype="float32"`` gives the reference's tokens
exactly (the logits agree within rel 1e-5, test_torch_models_lm.py, and
no argmax here is that close to a tie).
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_util import one_torch_thread  # noqa: E402,F401
from repro.configs import registry as ref_registry  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.train import steps as RS  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
import repro_torch.launch.train as train  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import from_reference  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
MESH = make_host_mesh()


def _cfgs(arch):
    return tuple(dataclasses.replace(reg.get_config(arch, smoke=True), dtype="float32")
                 for reg in (ref_registry, registry))


def test_generate_matches_the_reference_greedy_loop():
    """mixtral's smoke config in float32 (window 32): a 32-token prompt and
    16 tokens, so the decodes wrap the window; the same tokens as the
    reference's prefill/decode loop with serve's padding."""
    rcfg, cfg = _cfgs("mixtral-8x7b")
    params = RT.init_lm(jax.random.key(0), rcfg)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (3, 32)).astype(np.int32)
    prefill = jax.jit(lambda p, t: RS.lm_prefill_step(p, t, rcfg, MESH))
    decode = jax.jit(lambda p, tok, c, pos: RS.lm_decode_step(p, tok, c, pos, rcfg, MESH))
    nxt, cache = prefill(params, toks)
    want = [nxt]
    for i in range(15):
        nxt, cache = decode(params, want[-1], cache, jnp.int32(32 + i))
        want.append(nxt)
    model = from_reference(T.init_lm(cfg, device="cpu"), jax.tree.map(np.asarray, params))
    gen, cache, prefill_s, decode_s = serve.generate(model.params, torch.tensor(toks), cfg, 16)
    assert gen.dtype == torch.int32 and gen.shape == (3, 16)
    np.testing.assert_array_equal(gen.numpy(), np.stack([np.asarray(w) for w in want], 1))
    assert cache["k"].shape[2] == 32 and prefill_s > 0 and decode_s > 0


def test_generate_pads_the_cache_for_every_token():
    _, cfg = _cfgs("qwen2-7b")
    p = T.init_lm(cfg, device="cpu").params
    gen, cache, _, _ = serve.generate(p, torch.zeros((2, 8), dtype=torch.int32), cfg, 5)
    assert gen.shape == (2, 5) and cache["k"].shape[2] == 13


def _cli(module, *flags):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", module, *flags], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_serve_cli_prints_as_the_reference():
    """The same three lines as ``python -m repro.launch.serve``, numbers
    aside (the two packages draw other random weights and prompts)."""
    proc = _cli("repro_torch.launch.serve", "--arch", "mixtral-8x7b", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    ref = _cli("repro.launch.serve", "--arch", "mixtral-8x7b")
    assert ref.returncode == 0, ref.stderr
    lines, ref_lines = proc.stdout.strip().splitlines(), ref.stdout.strip().splitlines()
    assert len(lines) == len(ref_lines) == 3
    shape = [re.sub(r"\d+(\.\d+)?", "N", line) for line in lines]
    assert shape == [re.sub(r"\d+(\.\d+)?", "N", line) for line in ref_lines]
    assert shape[0] == "prefill: NxN in Ns"
    assert lines[1].startswith("decoded 15 steps x batch 4 in ")
    sample = [int(t) for t in lines[2].removeprefix("sample: [").removesuffix("]").split(",")]
    assert len(sample) == 12 and all(0 <= t < 512 for t in sample)


def test_entry_points_want_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.build_training("qwen2-7b")
    proc = _cli("repro_torch.launch.serve", "--arch", "qwen2-7b", "--tokens", "2")
    assert proc.returncode != 0 and "device='cpu'" in proc.stderr
