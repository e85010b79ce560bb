"""Search serving front-end (port of ``repro.serving.search``).

A submitted ``(terms, site)`` query is admitted to a ``(t_max, k)``
bucket, checked against the LRU result cache, micro-batched (partial
batches padded with inert clones so device shapes never change), routed,
executed with :func:`repro_torch.core.parallel.distributed_query_topk` on
the service's device, and merged — the same pipeline
(:class:`~repro_torch.serving.scheduler.MasterScheduler`) for the
synchronous :meth:`SearchService.search` and the
:meth:`~SearchService.submit` / :meth:`~SearchService.drain` pair.

The service runs on ``cuda`` unless given ``device="cpu"``; with no card
and no device it raises.  ``backend="kernel"`` (the default) runs the
hand-written kernels on a card and their plain versions on the CPU;
``backend="torch"`` runs plain PyTorch ops; ``backend="kernel_staged"``
the staged comparator (K9 in every slave, a plain master merge).  The
backend passes through to :func:`distributed_query_topk`.

**Online updates**: ``updatable=True`` with the base ``corpus`` (or a
ready :class:`~repro_torch.indexing.delta.DeltaWriter` on the service's
device) attaches the write path.  :meth:`SearchService.insert` /
:meth:`~SearchService.delete` / :meth:`~SearchService.update` mutate the
delta; every executed batch runs merge-on-read against the writer's
current snapshot, so the next batch sees each mutation.  Every mutation
bumps the writer version, which is the result cache's stamp, so a cached
result is never served across a mutation.  A multi-master
:class:`~repro_torch.indexing.delta.ShardedDeltaWriter` may be attached
as ``writer``: its ingest threads mutate while the service serves, each
batch reads one published snapshot, and its ``VectorVersion`` is the
stamp.  :meth:`SearchService.compact`
(or ``auto_compact``) folds the delta into a fresh main index.

**Health-aware routing**: ``set_health`` (a
:class:`~repro_torch.core.faults.SetHealth` over ``n_sets``) wires a
:class:`~repro_torch.serving.router.HealthAwareRouter` into the scheduler:
a dead set receives no batches and takes them again once it recovers;
with every set dead, dispatch raises ``RuntimeError`` and the queued
tickets stay queued.  Without ``set_meshes`` the ``n_sets`` sets
time-share the service's one device (``set_id`` picks no device).

**Sets on their own ranks** (``set_meshes``, from
:func:`~repro_torch.core.parallel.set_mesh_slices`): the paper's §5.2
scale-out as process topology.  The world is one front rank (rank 0, the
paper's master, with no shard of its own) plus ``n_sets * ns`` slave
ranks; the service runs on the front, and every slave rank runs
:func:`serve_set`.  Each (front, set) pair has a process group of its
own, so two sets' batches can be in flight from two threads.  The front
places each set's shards on that set's ranks at start and after
:meth:`SearchService.compact`, places the writer's snapshot on a set when
a batch goes there after the version moved, and sends each batch the
router picked to that set, whose ranks answer through
:func:`~repro_torch.core.parallel.replicated_query_topk` on their slice
and return the merged result from the slice's first rank.  A set the
health mask marks dead gets no batch.  :meth:`SearchService.shutdown`
stops every set's loop.  The messages are host tensors under ``gloo``.
"""
from __future__ import annotations

import dataclasses
import threading
import time

import torch
import torch.distributed as dist

from repro_torch.core.engine import QueryBatch, make_query_batch
from repro_torch.core.index import INVALID_DOC, IndexMeta, ShardedIndex, resolve_device
from repro_torch.core.parallel import (
    SearchResult, distributed_query_topk, replicated_query_topk, wire_device)
from repro_torch.data.corpus import Corpus
from repro_torch.indexing.compaction import compact as _compact
from repro_torch.indexing.delta import DeltaWriter, ShardedDelta
from repro_torch.obs.registry import MetricsRegistry, get_registry
from repro_torch.obs.trace import close_batch, host_span, open_batch
from repro_torch.serving.router import HealthAwareRouter
from repro_torch.serving.scheduler import MasterScheduler, QueryTicket


@dataclasses.dataclass
class SearchHit:
    """One query's merged result: global docIDs in rank order."""

    docids: list[int]
    n_hits: int


def _search_hits(docs, hits) -> list[SearchHit]:
    """One batch's hits from its host result block (``docs`` int32[Q, k],
    ``hits`` int32[Q]).  A row ascends and ``INVALID_DOC`` sorts after
    every docID (:class:`~repro_torch.core.parallel.SearchResult`), so a
    row's hits are its prefix: the prefixes are counted for the whole
    block, and each becomes Python ints by one ``tolist`` of a slice of
    the flat block."""
    q_n, k = docs.shape
    counts = (docs != INVALID_DOC).sum(1).tolist()
    flat = memoryview(docs.reshape(-1))
    return [SearchHit(docids=flat[a:a + c].tolist(), n_hits=h)
            for a, c, h in zip(range(0, q_n * k, k), counts, hits.tolist())]


class SearchService:
    """Serve search queries over a sharded index on one device.

    Engine parameters mirror :func:`distributed_query_topk`; scheduler
    parameters (``batch_size``, ``t_max_buckets``, ``cache_size``,
    ``n_sets``, ``max_wait``, ``adaptive_wait``, ``capacity_qps``) are
    those of :class:`~repro_torch.serving.scheduler.MasterScheduler`.
    ``set_health`` makes the router health-aware (see the module doc).

    Online updates: pass ``updatable=True`` with the ``corpus`` the index
    was built from (a :class:`DeltaWriter` of ``term_capacity`` and
    ``doc_headroom`` is made on the service's device), or a ready
    ``writer``.  ``auto_compact`` (a fill fraction, or None) compacts when
    a mutation pushes the posting fill past it, and hands the writer a
    doubled ``doc_headroom`` when the document fill crosses it instead.

    ``set_meshes`` (one ``(pod=1, data=ns)`` mesh a set, ``n_sets`` of
    them) runs each routed batch on its set's own ranks (module doc); the
    service must then be built on rank 0, collectively with
    :func:`serve_set` on every other rank, and shut down with
    :meth:`shutdown`.
    """

    def __init__(
        self,
        index: ShardedIndex,
        meta: IndexMeta,
        *,
        ns: int,
        k: int = 10,
        window: int = 4096,
        t_max: int = 4,
        strategy: str = "embed",
        merge: str = "tournament",
        backend: str = "kernel",
        device=None,
        batch_size: int = 8,
        t_max_buckets: tuple[int, ...] | None = None,
        cache_size: int = 1024,
        n_sets: int = 1,
        max_wait: float = 0.0,
        adaptive_wait: bool = False,
        capacity_qps: float | None = None,
        registry: MetricsRegistry | None = None,
        span_sink=None,
        corpus: Corpus | None = None,
        updatable: bool = False,
        writer: DeltaWriter | None = None,
        term_capacity: int = 256,
        doc_headroom: int = 1024,
        auto_compact: float | None = None,
        set_health=None,
        set_meshes=None,
    ):
        if set_meshes is not None:
            set_meshes = list(set_meshes)
            if len(set_meshes) != n_sets:
                raise ValueError(
                    f"{len(set_meshes)} set_meshes for n_sets={n_sets}")
            for m in set_meshes:
                shape = dict(zip(m.mesh_dim_names, m.mesh.shape))
                if shape.get("data") != ns or shape.get("pod") != 1:
                    raise ValueError(
                        f"set mesh must be (pod=1, data={ns}), got {shape}")
        self.device = resolve_device(device)
        if index.postings.device != self.device:
            raise ValueError(f"index lives on {index.postings.device}, "
                             f"service on {self.device}")
        self.index = index
        self.meta = meta
        self.ns = ns
        self.k = k
        self.window = window
        self.t_max = t_max
        self.strategy = strategy
        self.merge = merge
        self.backend = backend
        self.auto_compact = auto_compact
        if writer is None and updatable:
            if corpus is None:
                raise ValueError("updatable=True needs the base corpus")
            writer = DeltaWriter(
                corpus, meta, ns, term_capacity=term_capacity,
                doc_headroom=doc_headroom, device=self.device,
            )
        if writer is not None:
            # A mismatched writer would stripe delta docIDs with the wrong
            # d % ns map (silently wrong results): fail loudly instead.
            if writer.ns != ns:
                raise ValueError(f"writer.ns={writer.ns} != service ns={ns}")
            if writer.n_terms != meta.n_terms:
                raise ValueError(
                    f"writer n_terms={writer.n_terms} != index {meta.n_terms}")
            if writer.device != self.device:
                raise ValueError(f"writer on {writer.device}, service on "
                                 f"{self.device}")
        self.writer = writer
        buckets = t_max_buckets if t_max_buckets is not None else (t_max,)
        if max(buckets) > t_max:
            raise ValueError(f"t_max_buckets {buckets} exceed t_max={t_max}")
        router = (None if set_health is None
                  else HealthAwareRouter(n_sets, set_health))
        self.registry = registry if registry is not None else get_registry()
        self._exec_phases: dict[str, float] | None = None
        self._links: list[_SetLink] = []
        if set_meshes is not None:
            if dist.get_rank() != FRONT:
                raise ValueError(f"the sliced service runs on rank {FRONT} (the "
                                 f"front), not rank {dist.get_rank()}")
            self._links = [_SetLink(g, m) for g, m in
                           zip(set_groups(set_meshes), set_meshes)]
            self._place_set_indexes()
        self.scheduler = MasterScheduler(
            self._execute,
            batch_size=batch_size,
            t_max_buckets=buckets,
            default_k=k,
            cache_size=cache_size,
            n_sets=n_sets,
            max_wait=max_wait,
            adaptive_wait=adaptive_wait,
            capacity_qps=capacity_qps,
            router=router,
            version_fn=self._snapshot_version,
            width_fn=self._query_width,
            registry=self.registry,
            exec_phases_fn=self._take_exec_phases,
            span_sink=span_sink,
        )

    # ------------------------------------------------------------------
    # write path
    # ------------------------------------------------------------------

    def _require_writer(self) -> DeltaWriter:
        if self.writer is None:
            raise RuntimeError("service is read-only (no DeltaWriter attached)")
        return self.writer

    def insert(self, docs) -> list[int]:
        """Insert ``(terms, site)`` documents; returns global docIDs."""
        gids = self._require_writer().insert_docs(docs)
        self._maybe_compact()
        return gids

    def delete(self, docids) -> None:
        self._require_writer().delete_docs(docids)
        self._maybe_compact()

    def update(self, updates) -> None:
        """Apply ``(docid, new_terms, new_site_or_None)`` updates."""
        self._require_writer().update_docs(updates)
        self._maybe_compact()

    def compact(
        self,
        *,
        verify: bool = False,
        term_capacity: int | None = None,
        doc_headroom: int | None = None,
    ) -> None:
        """Fold the delta into a fresh main index and swap it in;
        ``term_capacity``/``doc_headroom`` re-size the writer's next delta
        generation (:meth:`DeltaWriter.rebase`)."""
        self.index, self.meta = _compact(
            self._require_writer(), verify=verify,
            term_capacity=term_capacity, doc_headroom=doc_headroom,
        )
        if self._links:
            # the main index changed: every set re-places it, and the
            # writer's rebase moved its version, so no stale delta survives
            self._place_set_indexes()

    def _maybe_compact(self) -> None:
        w = self.writer
        if self.auto_compact is None or w is None:
            return
        grow = w.doc_fill() >= self.auto_compact
        if grow or w.needs_compaction(self.auto_compact):
            self.compact(doc_headroom=2 * w.doc_headroom if grow else None)

    # ------------------------------------------------------------------
    # read path
    # ------------------------------------------------------------------

    def _snapshot_version(self):
        """Cache stamp: the writer's version (every mutation and every
        compaction moves it; a :class:`VectorVersion` for a
        ``ShardedDeltaWriter``); 0 for a read-only service."""
        return 0 if self.writer is None else self.writer.version

    def _query_width(self, terms, site) -> int:
        """Effective padded width — the ``site_term`` strategy rewrites the
        site restriction into an extra join term."""
        extra = 1 if (site is not None and self.strategy == "site_term") else 0
        return len(terms) + extra

    def _place_set_indexes(self) -> None:
        """(Re)place the main index on every set: each rank of a set gets
        its shard, so each set holds a whole replica (the replication that
        makes sets independent failure and capacity domains)."""
        for link in self._links:
            with link.lock:
                link.place("index", self.index, dict(
                    ns=self.ns, window=self.window, strategy=self.strategy,
                    merge=self.merge, backend=self.backend))
                link.delta_version = None      # the set dropped its delta

    def _run_engine(self, queries, *, t_max: int, k: int,
                    set_id: int | None = None) -> SearchResult:
        """One batch end-to-end at the given padded shapes, merge-on-read
        against the writer's current snapshot if there is one: on the
        service's device, or with ``set_meshes`` and a ``set_id`` on that
        set's ranks."""
        batch = make_query_batch(
            queries, t_max=t_max, meta=self.meta, strategy=self.strategy,
            device=self.device,
        )
        if self._links and set_id is not None:
            link = self._links[set_id]
            with link.lock:
                if self.writer is not None:
                    version = self.writer.version
                    if link.delta_version != version:
                        link.place("delta", self.writer.device_delta(), {})
                        link.delta_version = version
                return link.run(batch, k)
        delta = None if self.writer is None else self.writer.device_delta()
        return distributed_query_topk(
            self.index, batch, delta, ns=self.ns, k=k, window=self.window,
            attr_strategy=self.strategy, merge=self.merge,
            backend=self.backend,
        )

    def _take_exec_phases(self) -> dict[str, float] | None:
        """Return-and-clear the last :meth:`_execute`'s phase breakdown."""
        phases, self._exec_phases = self._exec_phases, None
        return phases

    def _execute(self, queries, t_max: int, k: int, set_id: int) -> list[SearchHit]:
        """Scheduler executor: run one formed micro-batch.  ``set_id`` is
        the router's pick: with ``set_meshes`` the batch runs on that set's
        ranks; otherwise the sets time-share the one device.

        With a live registry the batch's service splits into host build +
        kernel launches (``slave_dispatch``, with the engine's spans inside
        it), the copy of the results to the host, which waits for the
        device (``master_merge``), and the host-side result extraction
        (``finalize``); see :mod:`repro_torch.obs.trace`."""
        timed = self.registry.enabled
        phases = open_batch() if timed else None
        try:
            w0 = time.perf_counter() if timed else 0.0
            res = self._run_engine(queries, t_max=t_max, k=k, set_id=set_id)
            if timed:
                phases["slave_dispatch"] = time.perf_counter() - w0
            with host_span("odys.device_wait", "master_merge", phases):
                docs = res.docids.cpu().numpy()
                hits = res.n_hits.cpu().numpy()
            with host_span("odys.finalize", "finalize", phases):
                out = _search_hits(docs, hits)
        finally:
            if timed:
                close_batch()
        self._exec_phases = phases
        return out

    def submit(
        self, terms, site: int | None = None, *, k: int | None = None
    ) -> QueryTicket:
        """Admit one query into the pipeline (async-style entry point)."""
        return self.scheduler.submit(terms, site, k=k)

    def drain(self) -> list[QueryTicket]:
        """Dispatch micro-batches until the admission queue is empty."""
        return self.scheduler.drain()

    def search_batch(
        self, queries: list[tuple[list[int], int | None]]
    ) -> SearchResult:
        """Run one pre-formed batch end-to-end (no admission or caching);
        returns device tensors."""
        return self._run_engine(queries, t_max=self.t_max, k=self.k)

    def search(
        self, queries: list[tuple[list[int], int | None]]
    ) -> list[SearchHit]:
        """Through the full pipeline: every query is admitted,
        cache-checked, micro-batched and routed; returns the merged hits in
        submission order."""
        tickets = [self.scheduler.submit(terms, site) for terms, site in queries]
        self.scheduler.drain()
        if not all(t.done for t in tickets):
            raise RuntimeError("drain() left queries unanswered")
        return [t.result for t in tickets]

    def stats(self) -> dict:
        """Scheduler/cache/router counters (see MasterScheduler.stats)."""
        return self.scheduler.stats()

    def shutdown(self) -> None:
        """Stop every set's :func:`serve_set` loop (with ``set_meshes``;
        a no-op otherwise, and on a second call)."""
        links, self._links = self._links, []
        for link in links:
            with link.lock:
                link.send_header("stop", None)


# ---------------------------------------------------------------------------
# Sets on their own ranks: the front's links and the slaves' loop
# ---------------------------------------------------------------------------

#: The front's rank: the paper's master, which holds no shard.
FRONT = 0


def set_groups(set_meshes) -> list:
    """One process group a set: the front and the set's ranks.  Collective:
    every rank of the world calls it, in the same order (the service's
    constructor on the front, :func:`serve_set` on the slaves)."""
    return [dist.new_group([FRONT, *m.mesh.flatten().tolist()])
            for m in set_meshes]


class _SetLink:
    """The front's end of one set: its group, its ranks in data order, and
    a lock that keeps one batch's messages together."""

    def __init__(self, group, mesh):
        self.group = group
        self.ranks = mesh.mesh.flatten().tolist()
        self.lock = threading.Lock()
        self.delta_version = None

    def send_header(self, kind: str, info) -> None:
        dist.broadcast_object_list([(kind, info)], src=FRONT, group=self.group)

    def place(self, kind: str, stacked, info: dict) -> None:
        """Send rank ``j`` of the set shard ``j`` of a stacked index or
        delta (its arrays' shapes go first, in the header)."""
        self.send_header(kind, {**info, "shapes": [tuple(x.shape[1:]) for x in stacked]})
        wire = wire_device(self.group, stacked[0].device)
        for j, rank in enumerate(self.ranks):
            for x in stacked:
                dist.send(x[j].to(wire).contiguous(), dst=rank, group=self.group)

    def run(self, batch: QueryBatch, k: int) -> SearchResult:
        """Send the batch, receive the merged result from the set's first
        rank."""
        self.send_header("batch", {"k": k, "shape": tuple(batch.terms.shape)})
        dev = batch.terms.device
        wire = wire_device(self.group, dev)
        for x in batch:
            dist.broadcast(x.to(wire).contiguous(), src=FRONT, group=self.group)
        q_n = batch.n_queries
        docids = torch.empty((q_n, k), dtype=torch.int32, device=wire)
        n_hits = torch.empty((q_n,), dtype=torch.int32, device=wire)
        dist.recv(docids, src=self.ranks[0], group=self.group)
        dist.recv(n_hits, src=self.ranks[0], group=self.group)
        return SearchResult(docids.to(dev), n_hits.to(dev))


def _recv_shard(cls, shapes, group, device):
    """This rank's shard from the front, as a stack of leading dimension 1
    on ``device``."""
    wire = wire_device(group, device)
    out = []
    for shape in shapes:
        buf = torch.empty(shape, dtype=torch.int32, device=wire)
        dist.recv(buf, src=FRONT, group=group)
        out.append(buf.to(device)[None])
    return cls(*out)


def serve_set(set_meshes, *, device=None) -> int:
    """A slave rank's loop: take the front's index, delta, batch and stop
    messages for this rank's set and answer each batch; returns the number
    of batches answered once stopped.  Collective with the front's
    :class:`SearchService` (``set_meshes`` the same slices); a rank in no
    slice only joins the groups and returns 0.  ``device`` is where this
    rank computes (``cuda`` unless named)."""
    dev = resolve_device(device)
    groups = set_groups(set_meshes)
    me = dist.get_rank()
    mine = [s for s, m in enumerate(set_meshes) if me in m.mesh.flatten().tolist()]
    if not mine:
        return 0
    mesh, group = set_meshes[mine[0]], groups[mine[0]]
    wire = wire_device(group, dev)
    index = delta = params = None
    served = 0
    while True:
        msg = [None]
        dist.broadcast_object_list(msg, src=FRONT, group=group)
        kind, info = msg[0]
        if kind == "stop":
            return served
        if kind == "index":
            index = _recv_shard(ShardedIndex, info["shapes"], group, dev)
            params = {key: info[key] for key in
                      ("ns", "window", "strategy", "merge", "backend")}
            delta = None
        elif kind == "delta":
            delta = _recv_shard(ShardedDelta, info["shapes"], group, dev)
        elif kind == "batch":
            parts = []
            for shape in (info["shape"], info["shape"][:1], info["shape"][:1]):
                buf = torch.empty(shape, dtype=torch.int32, device=wire)
                dist.broadcast(buf, src=FRONT, group=group)
                parts.append(buf.to(dev))
            res = replicated_query_topk(
                index, QueryBatch(*parts), delta, mesh=mesh, ns=params["ns"],
                k=info["k"], window=params["window"],
                attr_strategy=params["strategy"], merge=params["merge"],
                backend=params["backend"])
            if mesh.get_local_rank("data") == 0:
                dist.send(res.docids.to(wire).contiguous(), dst=FRONT, group=group)
                dist.send(res.n_hits.to(wire).contiguous(), dst=FRONT, group=group)
            served += 1
        else:
            raise ValueError(f"unknown message {kind!r}")
