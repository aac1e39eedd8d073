# Borůvka contract-and-filter coarsening: only its static config is
# ported so far (the level pipeline is ROADMAP Queue 1 item 8).
from repro_torch.coarsen.config import CoarsenConfig
