"""Online index updates (port of ``repro.indexing``): the per-shard delta
and its host-side writer (:mod:`repro_torch.indexing.delta`) and
compaction back into a fresh main index
(:mod:`repro_torch.indexing.compaction`).  The read side, merge-on-read,
is in :mod:`repro_torch.core.engine`."""
