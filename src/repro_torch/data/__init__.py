from repro_torch.data.pipeline import (
    LMBatchSource,
    RecsysBatchSource,
    MoleculeBatchSource,
    make_planted_graph_task,
)
