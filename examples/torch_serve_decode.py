"""Batched serving with the PyTorch port (prefill + greedy decode with a
KV cache) — a thin wrapper over the production serving path, on the card
(``--device cpu`` serves on the CPU).

  PYTHONPATH=src python examples/torch_serve_decode.py [--device cpu]
"""
import argparse
import subprocess
import sys

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", help="where the model serves (default: the card)")
args = ap.parse_args()

subprocess.run(
    [sys.executable, "-m", "repro_torch.launch.serve",
     "--arch", "mixtral-8x7b", "--batch", "4", "--prompt-len", "32",
     "--tokens", "12", "--device", args.device],
    check=True,
)
