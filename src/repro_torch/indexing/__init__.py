"""Online index updates (port of ``repro.indexing``): the per-shard delta,
its host-side :class:`DeltaWriter` and the multi-master
:class:`ShardedDeltaWriter` with its :class:`VectorVersion` stamp
(:mod:`repro_torch.indexing.delta`), and compaction back into a fresh main
index (:mod:`repro_torch.indexing.compaction`).  The read side,
merge-on-read, is in :mod:`repro_torch.core.engine`."""
from repro_torch.indexing.compaction import (
    CompactionMismatch,
    compact,
    fold_corpus,
    maybe_compact,
)
from repro_torch.indexing.delta import (
    DOC_DEAD,
    DOC_SUPERSEDED,
    DeltaFullError,
    DeltaIndex,
    DeltaWriter,
    ShardedDelta,
    ShardedDeltaWriter,
    VectorVersion,
    local_delta,
)

__all__ = [
    "DOC_DEAD",
    "DOC_SUPERSEDED",
    "CompactionMismatch",
    "DeltaFullError",
    "DeltaIndex",
    "DeltaWriter",
    "ShardedDelta",
    "ShardedDeltaWriter",
    "VectorVersion",
    "compact",
    "fold_corpus",
    "local_delta",
    "maybe_compact",
]
