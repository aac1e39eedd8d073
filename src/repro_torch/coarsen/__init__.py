# Borůvka contract-and-filter coarsening (counterpart of repro.coarsen):
# contract-and-filter levels feeding the flat AS solve. The distributed
# levels and the Partition2D pre-contraction are not ported yet.
from repro_torch.coarsen.config import CoarsenConfig
from repro_torch.coarsen.contract import ContractResult, contract_level, contract_level_und
from repro_torch.coarsen.engine import (
    CoarsenMSF,
    CoarsenPrelude,
    CoarsenStats,
    FusedLevel,
    LevelStats,
    coarsen_msf,
    fused_level,
    run_levels,
)
from repro_torch.coarsen.filter import (
    FilterResult,
    filter_level,
    filter_level_callback,
    filter_level_host,
)
from repro_torch.coarsen.relabel import compose_labels, rank_relabel, relabel_edges
