"""ODYS master/slave query processing (port of ``repro.core.parallel``).

Paper architecture (§3.1): the master broadcasts each query to all
shared-nothing slaves; each slave answers over its document partition
with its local top-k; the master merges the ns sorted streams.

Two forms, with the same answers:

- **One process** (``mesh=None``): the ns slaves are the leading
  dimension of a :class:`~repro_torch.core.index.ShardedIndex` on one
  device.  Each slave's query runs as its own engine call (one K1 launch
  per slave per batch), and the master merge runs over all slaves at
  once: ``tournament``, the butterfly of log2(ns) rounds (in round ``d``
  slave ``s`` merges its best k with slave ``s ^ d``'s; all ns slaves'
  rows in one K2 launch a round, ``(ns*Q, 2k)``), or ``allgather``, the
  paper-faithful central merge (the ns*k candidates of each query in one
  K2 launch, ``(Q, ns*k)``).
- **One process a rank** (``mesh=``, a
  :class:`~torch.distributed.device_mesh.DeviceMesh`): every rank calls
  the same function (SPMD) and holds only its own shard, a stack of
  leading dimension 1 (:func:`rank_shard`), which is what the reference's
  ``shard_map`` body sees.  The slave index is the rank's coordinate on
  ``axis``; ``tournament`` exchanges k candidates with partner ``i ^ d``
  in each round (``batch_isend_irecv``) and ``all_gather`` gathers them;
  every merge round is one K2 launch on the rank's card under
  ``backend="kernel"``; ``n_hits`` is an ``all_reduce``.  The result is
  replicated on every rank of the axis.  A collective's payload lives on
  the group backend's device: the card under ``nccl``, the host under
  ``gloo`` (:func:`wire_device`, an explicit copy each way).

``n_hits`` is the sum over slaves.  A :class:`~repro_torch.indexing.delta.
ShardedDelta` stacked like the index turns on merge-on-read: slave ``s``
answers over its main partition and delta slice ``s`` (K3 + K4 under
``backend="kernel"``).  ODYS sets are the ``pod`` axis
(:func:`replicated_query_topk`: each pod answers its rows of the batch,
and no collective crosses pods), and :func:`set_mesh_slices` gives each
set its own ranks.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core.engine import QueryBatch, query_topk
from repro_torch.core.index import (
    InvertedIndex,
    ShardedIndex,
    local_to_global_docids,
)
from repro_torch.indexing.delta import DeltaIndex, ShardedDelta
from repro_torch.obs.trace import batch_span


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


# ---------------------------------------------------------------------------
# Collectives over one axis of a DeviceMesh
# ---------------------------------------------------------------------------

def wire_device(group, device: torch.device) -> torch.device:
    """Where a collective over ``group`` carries a payload that lives on
    ``device``: the card under ``nccl``, the host under every other
    backend (``gloo`` moves host memory only)."""
    return device if dist.get_backend(group) == "nccl" else torch.device("cpu")


def _axis(mesh: DeviceMesh, axis: str, ns: int):
    """This rank's (group, coordinate) on ``axis``; the axis must hold ns."""
    held = mesh.size(mesh.mesh_dim_names.index(axis))
    if held != ns:
        raise ValueError(f"mesh axis {axis!r} holds {held} ranks, ns={ns}")
    return mesh.get_group(axis), mesh.get_local_rank(axis)


def exchange(t: torch.Tensor, group, peer: int) -> torch.Tensor:
    """Send ``t`` to the rank at coordinate ``peer`` of ``group`` and
    receive its tensor of the same shape (the reference's ``ppermute`` on
    the pair ``(i, i ^ d)``); the result is back on ``t``'s device."""
    wire = wire_device(group, t.device)
    out = t.to(wire).contiguous()
    got = torch.empty_like(out)
    g_peer = dist.get_global_rank(group, peer)
    for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, out, g_peer, group),
                                       dist.P2POp(dist.irecv, got, g_peer, group)]):
        req.wait()
    return got.to(t.device)


def gather(t: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``t`` of ``group``, in coordinate order, on ``t``'s
    device (the reference's ``all_gather``)."""
    wire = wire_device(group, t.device)
    out = t.to(wire).contiguous()
    parts = [torch.empty_like(out) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, out, group=group)
    return [p.to(t.device) for p in parts]


def psum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group`` (the reference's ``psum``)."""
    wire = wire_device(group, t.device)
    out = t.to(wire, copy=True).contiguous()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out.to(t.device)


def tournament_merge(cands: torch.Tensor, ns: int, *, backend: str = "kernel",
                     mesh: DeviceMesh | None = None,
                     axis: str = "data") -> torch.Tensor:
    """Butterfly top-k merge (ns a power of two).

    With no ``mesh``, ``cands`` is int32[ns, Q, k], every slave's, and
    slave 0's merged best k is returned.  With a ``mesh``, ``cands`` is
    this rank's int32[Q, k]: each round exchanges it with the partner on
    ``axis`` and keeps the best k (one K2 launch on this rank's device
    under ``backend="kernel"``), so every rank ends with the same best k."""
    if ns & (ns - 1):
        raise ValueError(f"tournament merge needs power-of-two shards, got {ns}")
    k = cands.shape[-1]
    d = 1
    if mesh is None:
        while d < ns:
            partner = torch.arange(ns, device=cands.device) ^ d
            cands = _row_topk(torch.cat([cands, cands[partner]], dim=-1), k, backend)
            d *= 2
        return cands[0]
    group, i = _axis(mesh, axis, ns)
    while d < ns:
        other = exchange(cands, group, i ^ d)
        cands = _row_topk(torch.cat([cands, other], dim=-1), k, backend)
        d *= 2
    return cands


def allgather_merge(cands: torch.Tensor, *, backend: str = "kernel",
                    mesh: DeviceMesh | None = None,
                    axis: str = "data") -> torch.Tensor:
    """Paper-faithful centralized merge: every slave's candidates, one
    top-k.  ``cands`` is int32[ns, Q, k] with no ``mesh``; with a ``mesh``
    it is this rank's int32[Q, k], gathered over ``axis`` and merged on
    every rank (one K2 launch under ``backend="kernel"``)."""
    if mesh is None:
        ns, q_n, k = cands.shape
        return _row_topk(cands.permute(1, 0, 2).reshape(q_n, ns * k), k, backend)
    group = mesh.get_group(axis)
    return _row_topk(torch.cat(gather(cands, group), dim=-1), cands.shape[-1],
                     backend)


def rank_shard(stacked, s: int):
    """Slave ``s``'s shard of a stacked :class:`ShardedIndex` or
    :class:`ShardedDelta`, as a stack of leading dimension 1 (a copy, so
    that a rank holds its shard alone): what a rank passes to the mesh
    forms."""
    return type(stacked)(*(x[s:s + 1].clone() for x in stacked))


# ---------------------------------------------------------------------------
# The engine: one process, or one process a rank
# ---------------------------------------------------------------------------

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
    mesh: DeviceMesh | None = None,
    axis: str = "data",
) -> SearchResult:
    """Slave phase only: per-shard local top-k with no master merge.

    With no ``mesh`` it returns every slave's: ``docids`` int32[ns, Q, k]
    (already global) and ``n_hits`` int32[ns, Q].  With a ``mesh``,
    ``index`` (and ``delta``) hold this rank's shard alone (leading
    dimension 1), and it returns this rank's candidates, int32[1, Q, k]
    and int32[1, Q], globalised by its coordinate on ``axis``."""
    if mesh is not None:
        shard = _axis(mesh, axis, ns)[1]
        for what, x in (("index", index), ("delta", delta)):
            if x is not None and x.postings.shape[0] != 1:
                raise ValueError(f"a rank's {what} holds {x.postings.shape[0]} "
                                 "shards, not 1 (rank_shard cuts one)")
        with batch_span("odys.slave", "slave_launch"):
            d, h = query_topk(index.shard(0), batch,
                              delta=None if delta is None else delta.shard(0),
                              k=k, window=window, attr_strategy=attr_strategy,
                              backend=backend)
            return SearchResult(local_to_global_docids(d, shard, ns)[None], h[None])
    if index.postings.shape[0] != ns:
        raise ValueError(f"index holds {index.postings.shape[0]} shards, ns={ns}")
    if delta is not None and delta.postings.shape[0] != ns:
        raise ValueError(f"delta holds {delta.postings.shape[0]} shards, ns={ns}")
    docs, hits = [], []
    for s in range(ns):
        with batch_span("odys.slave", "slave_launch"):
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
    mesh: DeviceMesh | None = None,
    axis: str = "data",
) -> SearchResult:
    """Broadcast the batch to all slaves, local top-k, merge to the global
    top-k.  ``delta`` attaches the slaves' deltas (merge-on-read: live
    traffic sees every mutation of the snapshot).  ``backend`` selects the
    engine on both sides: K1 in every slave and K2 in the master merge under
    ``"kernel"``, plain PyTorch under ``"torch"``; the slaves run their
    staged K9 join and the master sorts plainly under ``"kernel_staged"``
    (any backend of :func:`~repro_torch.core.engine.query_topk` passes
    through).

    With a ``mesh``, every rank of ``axis`` calls it with its own shard
    (:func:`rank_shard`) and the same batch, and every rank gets the
    merged result; ``n_hits`` is summed over the axis."""
    if merge not in ("tournament", "allgather"):
        raise ValueError(f"unknown merge {merge!r}")
    local = slave_topk_unmerged(index, batch, delta, ns=ns, k=k, window=window,
                                attr_strategy=attr_strategy, backend=backend,
                                mesh=mesh, axis=axis)
    with batch_span("odys.merge", "merge_launch"):
        if mesh is not None:
            cands = local.docids[0]
            if merge == "tournament":
                merged = tournament_merge(cands, ns, backend=backend, mesh=mesh,
                                          axis=axis)
            else:
                merged = allgather_merge(cands, backend=backend, mesh=mesh, axis=axis)
            return SearchResult(merged, psum(local.n_hits[0], mesh.get_group(axis)))
        if merge == "tournament":
            merged = tournament_merge(local.docids, ns, backend=backend)
        else:
            merged = allgather_merge(local.docids, backend=backend)
        return SearchResult(merged, local.n_hits.sum(dim=0, dtype=torch.int32))


def replicated_query_topk(
    index: ShardedIndex,
    batch: QueryBatch,
    delta: ShardedDelta | None = None,
    *,
    mesh: DeviceMesh,
    ns: int,
    k: int = 10,
    window: int = 4096,
    attr_strategy: str = "embed",
    merge: str = "tournament",
    axis: str = "data",
    pod_axis: str = "pod",
    backend: str = "kernel",
) -> SearchResult:
    """Multi-pod serving: each pod is an independent ODYS set (replica).

    The index (and ``delta``) is replicated across pods, each rank holding
    its shard of ``axis``; the query stream is split over pods: pod ``p``
    of P answers rows ``[p*Q/P, (p+1)*Q/P)`` of the batch, and each rank
    returns its pod's rows.  No collective crosses ``pod_axis`` (the
    paper's ODYS-set isolation, which is what makes set-granular failover
    trivial)."""
    n_pods = mesh.size(mesh.mesh_dim_names.index(pod_axis))
    q_n = batch.n_queries
    if q_n % n_pods:
        raise ValueError(f"a batch of {q_n} queries does not split over "
                         f"{n_pods} pods")
    p = mesh.get_local_rank(pod_axis)
    rows = slice(p * q_n // n_pods, (p + 1) * q_n // n_pods)
    return distributed_query_topk(
        index, QueryBatch(*(x[rows] for x in batch)), delta, ns=ns, k=k,
        window=window, attr_strategy=attr_strategy, merge=merge,
        backend=backend, mesh=mesh, axis=axis)


def set_mesh_slices(n_sets: int, ns: int, ranks=None) -> list[DeviceMesh]:
    """Carve ``n_sets`` disjoint ``(1, ns)`` ``("pod", "data")`` meshes out
    of the world's slave ranks: one independent ODYS set per slice.

    This is the paper's §5.2 scale-out as process topology rather than
    time-sharing: each set serves its batches on its own ranks (through
    :func:`replicated_query_topk` with the slice as the mesh), so adding a
    set adds real concurrent capacity, and a set-granular fault quarantines
    exactly one slice.  Slices are contiguous runs of ``ranks``, by default
    every rank but rank 0, which is the front (the paper's master, with no
    shard: :class:`~repro_torch.serving.search.SearchService`).  A pool
    smaller than ``n_sets * ns`` raises rather than overlapping sets.

    Collective: every rank of the world calls it, with the same arguments,
    and gets every slice (a rank outside a slice has no coordinate in
    it).  The meshes' collectives carry host payloads unless the world runs
    ``nccl``.
    """
    if n_sets < 1 or ns < 1:
        raise ValueError(f"need n_sets >= 1 and ns >= 1, got {n_sets}x{ns}")
    pool = list(range(1, dist.get_world_size()) if ranks is None else ranks)
    need = n_sets * ns
    if len(pool) < need:
        raise ValueError(
            f"{n_sets} sets x {ns} shards need {need} slave ranks, have "
            f"{len(pool)} (rank 0 is the front: start a world of {need + 1})")
    device_type = wire_device(None, torch.device("cuda")).type
    return [
        DeviceMesh(device_type,
                   torch.tensor(pool[i * ns:(i + 1) * ns], dtype=torch.int32)
                   .reshape(1, ns), mesh_dim_names=("pod", "data"))
        for i in range(n_sets)
    ]


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
