"""Train a small LM end-to-end with the PyTorch port (synthetic Markov
data, loss decreases), with checkpointing — a thin wrapper over the
production launcher, on the card (``--device cpu`` trains on the CPU).

  PYTHONPATH=src python examples/torch_train_lm.py [--device cpu] [--steps 100]
"""
import argparse
import tempfile
import types

from repro_torch.launch.train import run

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", help="where the model trains (default: the card)")
ap.add_argument("--steps", type=int, default=100)
args = ap.parse_args()

with tempfile.TemporaryDirectory() as ckpt_dir:
    out = run(types.SimpleNamespace(
        arch="qwen2-7b", steps=args.steps, seed=0,
        ckpt_dir=ckpt_dir, ckpt_every=max(1, args.steps // 4),
        fault_at=None, supervise=False, device=args.device,
    ))
assert out["last_loss"] < out["first_loss"], out
print("LM training reduced loss:", out)
