# Streaming MSF subsystem (counterpart of repro.stream): incremental forest
# maintenance via the sparsification identity + snapshot-isolated batched
# query serving, on the engine's device.
from repro_torch.stream.engine import StreamEngine, StreamingMSF, UpdateStats, DeleteStats
from repro_torch.stream.snapshot import Snapshot, SnapshotStore, make_snapshot
from repro_torch.stream.service import QueryService, MicroBatcher, next_pow2
from repro_torch.stream import delta
