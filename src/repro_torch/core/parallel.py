"""ODYS master/slave query processing on one card (port of
``repro.core.parallel``).

Paper architecture (§3.1): the master broadcasts each query to all
shared-nothing slaves; each slave answers over its document partition
with its local top-k; the master merges the ns sorted streams.

On one H100 the ns slaves are the leading dimension of a
:class:`~repro_torch.core.index.ShardedIndex`.  Each slave's query runs as
its own engine call (one K1 launch per slave per batch, the counterpart of
the reference's per-device ``shard_map`` body), and the master merge runs
over all slaves at once:

- ``tournament`` — the butterfly of log2(ns) rounds: in round ``d`` slave
  ``s`` merges its best k with slave ``s ^ d``'s.  All ns slaves' rows go
  through one K2 launch per round, ``(ns*Q, 2k)``.
- ``allgather``  — the paper-faithful central merge: the ns*k candidates
  of each query in one K2 launch, ``(Q, ns*k)``.

``n_hits`` is the sum over slaves.  A :class:`~repro_torch.indexing.delta.
ShardedDelta` stacked like the index turns on merge-on-read: slave ``s``
answers over its main partition and delta slice ``s`` (K3 + K4 under
``backend="kernel"``).  Replicated sets on their own cards
(``replicated_query_topk``, ``set_mesh_slices``) need several GPUs and
come with a later slice.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.engine import QueryBatch, query_topk
from repro_torch.core.index import (
    InvertedIndex,
    ShardedIndex,
    local_to_global_docids,
)
from repro_torch.indexing.delta import DeltaIndex, ShardedDelta


class SearchResult(NamedTuple):
    docids: torch.Tensor  # int32[Q, k] global docIDs, ascending (= rank order)
    n_hits: torch.Tensor  # int32[Q]    total matches across all shards


def _row_topk(cands: torch.Tensor, k: int, backend: str) -> torch.Tensor:
    """Per-query best-k of concatenated candidates, ascending: K2 under
    ``backend="kernel"``, a plain sort otherwise (``"kernel_staged"``
    included, as the reference sorts plainly for ``"pallas_staged"``)."""
    if backend == "kernel":
        from repro_torch.kernels import ops

        shape = cands.shape
        out = ops.topk_merge_rows(cands.reshape(-1, shape[-1]), k)
        return out.reshape(*shape[:-1], k)
    return cands.sort(dim=-1).values[..., :k]


def tournament_merge(cands: torch.Tensor, ns: int, *,
                     backend: str = "kernel") -> torch.Tensor:
    """Butterfly top-k merge of ``cands`` int32[ns, Q, k] (ns a power of
    two); every slave ends with the same best k, so slave 0's is returned."""
    if ns & (ns - 1):
        raise ValueError(f"tournament merge needs power-of-two shards, got {ns}")
    k = cands.shape[-1]
    d = 1
    while d < ns:
        partner = torch.arange(ns, device=cands.device) ^ d
        cands = _row_topk(torch.cat([cands, cands[partner]], dim=-1), k, backend)
        d *= 2
    return cands[0]


def allgather_merge(cands: torch.Tensor, *, backend: str = "kernel") -> torch.Tensor:
    """Paper-faithful centralized merge of ``cands`` int32[ns, Q, k]."""
    ns, q_n, k = cands.shape
    allc = cands.permute(1, 0, 2).reshape(q_n, ns * k)
    return _row_topk(allc, k, backend)


def slave_topk_unmerged(
    index: ShardedIndex,
    batch: QueryBatch,
    delta: ShardedDelta | None = None,
    *,
    ns: int,
    k: int = 10,
    window: int = 4096,
    attr_strategy: str = "embed",
    backend: str = "kernel",
) -> SearchResult:
    """Slave phase only: per-shard local top-k with no master merge.
    Returns ``docids`` int32[ns, Q, k] (already global) and ``n_hits``
    int32[ns, Q]."""
    if index.postings.shape[0] != ns:
        raise ValueError(f"index holds {index.postings.shape[0]} shards, ns={ns}")
    if delta is not None and delta.postings.shape[0] != ns:
        raise ValueError(f"delta holds {delta.postings.shape[0]} shards, ns={ns}")
    docs, hits = [], []
    for s in range(ns):
        d, h = query_topk(index.shard(s), batch,
                          delta=None if delta is None else delta.shard(s),
                          k=k, window=window, attr_strategy=attr_strategy,
                          backend=backend)
        docs.append(local_to_global_docids(d, s, ns))
        hits.append(h)
    return SearchResult(torch.stack(docs), torch.stack(hits))


def distributed_query_topk(
    index: ShardedIndex,
    batch: QueryBatch,
    delta: ShardedDelta | None = None,
    *,
    ns: int,
    k: int = 10,
    window: int = 4096,
    attr_strategy: str = "embed",
    merge: str = "tournament",
    backend: str = "kernel",
) -> SearchResult:
    """Broadcast the batch to all slaves, local top-k, merge to the global
    top-k.  ``delta`` attaches the slaves' deltas (merge-on-read: live
    traffic sees every mutation of the snapshot).  ``backend`` selects the
    engine on both sides: K1 in every slave and K2 in the master merge under
    ``"kernel"``, plain PyTorch under ``"torch"``; the slaves run their
    staged K9 join and the master sorts plainly under ``"kernel_staged"``
    (any backend of :func:`~repro_torch.core.engine.query_topk` passes
    through)."""
    if merge not in ("tournament", "allgather"):
        raise ValueError(f"unknown merge {merge!r}")
    local = slave_topk_unmerged(index, batch, delta, ns=ns, k=k, window=window,
                                attr_strategy=attr_strategy, backend=backend)
    if merge == "tournament":
        merged = tournament_merge(local.docids, ns, backend=backend)
    else:
        merged = allgather_merge(local.docids, backend=backend)
    return SearchResult(merged, local.n_hits.sum(dim=0, dtype=torch.int32))


def sequential_reference(
    shard_indexes: list[InvertedIndex],
    batch: QueryBatch,
    *,
    ns: int,
    k: int,
    window: int,
    attr_strategy: str = "embed",
    deltas: list[DeltaIndex] | None = None,
    backend: str = "torch",
    codec: str = "raw",
) -> SearchResult:
    """Run each shard in turn and merge with one plain sort — the oracle
    for :func:`distributed_query_topk`.  ``deltas`` gives the per-shard
    deltas (``DeltaWriter.shard_deltas()``); ``codec`` goes to each
    shard's :func:`~repro_torch.core.engine.query_topk` (``"packed"``
    needs every index and delta to carry its twin)."""
    all_cands, all_hits = [], []
    for s, idx in enumerate(shard_indexes):
        docs, hits = query_topk(idx, batch,
                                delta=None if deltas is None else deltas[s],
                                k=k, window=window,
                                attr_strategy=attr_strategy, backend=backend,
                                codec=codec)
        all_cands.append(local_to_global_docids(docs, s, ns))
        all_hits.append(hits)
    cands = torch.cat(all_cands, dim=-1)  # (Q, ns*k)
    merged = cands.sort(dim=-1).values[..., :k]
    return SearchResult(merged, torch.stack(all_hits).sum(dim=0, dtype=torch.int32))
