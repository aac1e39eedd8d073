"""Train GAT with the PyTorch port on a planted node-classification task
(Cora-shaped) until the accuracy beats the feature-only baseline — the
shared message-passing substrate (the paper's multilinear form with ⊕ =
softmax-weighted sum), on the card (``--device cpu`` trains on the CPU).

  PYTHONPATH=src python examples/torch_train_gnn.py [--device cpu]
"""
import argparse
import dataclasses

import torch

from repro_torch.configs import registry
from repro_torch.data.pipeline import make_planted_graph_task
from repro_torch.graphs.structures import resolve_device
from repro_torch.models import gnn as G
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.train import steps as S

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", help="where the model trains (default: the card)")
ap.add_argument("--steps", type=int, default=300)
args = ap.parse_args()
dev = resolve_device(args.device)

cfg = dataclasses.replace(
    registry.get_config("gat-cora", smoke=True), d_in=32, n_classes=4,
    d_hidden=16, n_heads=4,
)
task = make_planted_graph_task(n=400, m=2000, d_feat=32, n_classes=4, seed=0)
batch = {k: torch.as_tensor(task[k], device=dev)
         for k in ("x", "src", "dst", "edge_valid", "labels")}
batch["node_mask"] = torch.ones(400, device=dev)
params = G.init_gat(cfg, torch.Generator(device=dev).manual_seed(0), dev).params
opt = adamw_init(params)
lr = torch.tensor(5e-3, device=dev)


def step(params, opt):
    loss = S.gnn_loss(params, batch, cfg, 1)
    grads = S._grads(loss, params)
    params, opt, _ = adamw_update(grads, opt, params, lr)
    return params, opt, loss.detach()


@torch.no_grad()
def acc(params):
    logits = S.gnn_apply(params, batch, cfg, 1)
    return float((torch.argmax(logits, -1) == batch["labels"]).float().mean())


print(f"initial accuracy: {acc(params):.3f} (chance = 0.25), on {dev}")
for i in range(args.steps):
    params, opt, loss = step(params, opt)
    if i % 50 == 0:
        print(f"step {i:4d} loss {float(loss):.4f} acc {acc(params):.3f}")
final = acc(params)
print(f"final accuracy: {final:.3f}")
assert final > 0.6, "GAT failed to learn the planted neighborhood structure"
