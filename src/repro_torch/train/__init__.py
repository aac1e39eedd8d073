"""Train and serve steps of the GNN and recsys families."""
from repro_torch.train import steps
