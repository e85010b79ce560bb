"""Per-shard delta index: the online-update write path (port of
``repro.indexing.delta``).

**DeltaIndex** (one slave) is a fixed-capacity posting buffer with the main
index's CSR + skip-table layout, as torch tensors on a device:

- ``offsets[t] = t * term_capacity``: every term owns a BLOCK-aligned slab;
- ``postings``/``attrs``: local docIDs ascending per slab, the embedded
  siteId beside each; TILE-padded like the main flat arrays;
- ``block_max``: the skip table over the slabs, exact length
  ``n_terms * cap / BLOCK``, holding the max of the block's *valid*
  postings and ``INVALID_DOC`` for an empty block;
- ``doc_flags``: the tombstone bitmap over base and inserted docs
  (``DOC_DEAD``: every posting of the doc is dead; ``DOC_SUPERSEDED``: its
  main postings are stale, its live postings are in the delta);
- ``doc_site``: the authoritative local docID -> siteId table.

**DeltaWriter** is the host-side transaction manager: ``insert_docs`` /
``delete_docs`` / ``update_docs`` mutate per-shard numpy mirrors and a
monotone version; :meth:`DeltaWriter.device_delta` snapshots the mirrors
into a :class:`ShardedDelta` on the writer's device, cached per version.
New documents take the next global docIDs and stripe with ``d % ns``.

The writer's record of the mutated corpus (what a from-scratch rebuild
sees) keeps only the documents that changed, over the corpus the writer
was made with, where the reference copies every document of that corpus;
:meth:`DeltaWriter.mutated_corpus` returns the same arrays.

With ``codec="packed"``, :meth:`DeltaWriter.shard_deltas` gives each view
the block-codec twin of its slab, re-encoded per version on the writer's
device and cached like the snapshot; :meth:`DeltaWriter.device_delta`
stays raw, so one packed writer serves the raw service and the packed read
path.

**ShardedDeltaWriter** is the multi-master writer (the paper's deployment
shape, §6, where several masters feed one engine's write path): thread-safe
per-doc ops under one lock per shard, per-shard write queues drained by
workers, and publishes stamped with a :class:`VectorVersion` ``(epoch,
per-shard seqs)`` that re-copy to the device only the shards that moved.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
from collections import deque
from typing import Mapping, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.index import (
    BLOCK,
    DESC_PAD,
    DOC_DEAD,
    DOC_SUPERSEDED,
    INVALID_ATTR,
    INVALID_DOC,
    IndexMeta,
    PackedFlatArrays,
    export_index_bytes,
    flat_tile_pad,
    pack_flat_postings,
    packed_from_numpy,
    resolve_device,
)
from repro_torch.data.corpus import Corpus
from repro_torch.obs.registry import MetricsRegistry, get_registry


class DeltaFullError(RuntimeError):
    """The delta is out of posting or document capacity.

    Batches apply document by document: the earlier documents of a batch
    stay applied (and visible to the next snapshot); ``applied`` says how
    many, so a retry after compaction resumes from that offset.
    """

    def __init__(self, msg: str, *, applied: int = 0):
        super().__init__(msg)
        self.applied = applied


class DeltaIndex(NamedTuple):
    """One slave's delta on a device; every array an int32 tensor, plus the
    optional block-codec twin of ``postings`` (last, with a default, so
    that the seven :class:`ShardedDelta` arrays still build one)."""

    offsets: torch.Tensor    # int32[n_terms]   t * term_capacity
    lengths: torch.Tensor    # int32[n_terms]   valid postings per slab
    postings: torch.Tensor   # int32[flat_tile_pad(n_terms * cap)]
    attrs: torch.Tensor      # int32[flat_tile_pad(n_terms * cap)]
    block_max: torch.Tensor  # int32[n_terms * cap // BLOCK] (valid max)
    doc_flags: torch.Tensor  # int32[nd_cap]    tombstone bitmap
    doc_site: torch.Tensor   # int32[nd_cap]    docID -> siteId
    packed: PackedFlatArrays | None = None  # block-codec twin of ``postings``

    @property
    def term_capacity(self) -> int:
        # block_max is exact (never padded), so it records the slab width.
        return self.block_max.shape[-1] * BLOCK // self.offsets.shape[-1]


class ShardedDelta(NamedTuple):
    """ns per-slave deltas stacked on a leading dimension."""

    offsets: torch.Tensor    # int32[ns, n_terms]
    lengths: torch.Tensor    # int32[ns, n_terms]
    postings: torch.Tensor   # int32[ns, flat_tile_pad(n_terms * cap)]
    attrs: torch.Tensor      # int32[ns, flat_tile_pad(n_terms * cap)]
    block_max: torch.Tensor  # int32[ns, n_terms * cap // BLOCK]
    doc_flags: torch.Tensor  # int32[ns, nd_cap]
    doc_site: torch.Tensor   # int32[ns, nd_cap]

    def shard(self, s: int) -> DeltaIndex:
        """Slave ``s``'s delta (views, no copy)."""
        return DeltaIndex(*(x[s] for x in self))

    def nbytes(self) -> int:
        return sum(x.numel() * x.element_size() for x in self)


def local_delta(stacked: ShardedDelta) -> DeltaIndex:
    """The delta of a stack holding one slave."""
    return stacked.shard(0)


def delta_from_numpy(arrays: Mapping[str, np.ndarray], *, device) -> DeltaIndex:
    """The port's delta from the reference's arrays (``np.asarray`` of each
    array leaf of a JAX ``DeltaIndex``, and under ``packed`` its twin when
    it has one, carried over), so a test can run both on the very same
    snapshot."""
    dev = torch.device(device)
    packed = arrays.get("packed")
    return DeltaIndex(
        *(torch.from_numpy(np.require(arrays[f], np.int32, ["C", "W"])).to(dev)
          for f in ShardedDelta._fields),
        packed=None if packed is None else packed_from_numpy(packed, device=dev),
    )


def sharded_delta_from_numpy(
    arrays: Mapping[str, np.ndarray], *, device
) -> ShardedDelta:
    """The stacked twin of :func:`delta_from_numpy` (each array ``[ns, ...]``)."""
    dev = torch.device(device)
    return ShardedDelta(*(
        torch.from_numpy(np.require(arrays[f], np.int32, ["C", "W"])).to(dev)
        for f in ShardedDelta._fields
    ))


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _pad_block(n: int) -> int:
    return _ceil_div(n, BLOCK) * BLOCK


def overlay_corpus(
    base: Corpus,
    terms: Mapping[int, np.ndarray],
    sites: np.ndarray,
    *,
    n_docs: int,
) -> Corpus:
    """``corpus_from_docs`` over ``n_docs`` documents: document ``g`` has
    the terms ``terms[g]`` where given, else the base corpus's (none past
    the base).  The unchanged runs of the base are copied whole, so the
    cost follows the number of changed documents, not the corpus size."""
    nb = base.n_docs
    lens = np.zeros(n_docs, np.int64)
    lens[:nb] = np.diff(base.doc_offsets)
    for g, ts in terms.items():
        lens[g] = ts.shape[0]
    offsets = np.zeros(n_docs + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    out = np.empty(int(offsets[-1]), np.int32)

    def copy_base(lo: int, hi: int) -> None:
        if hi > lo:
            out[offsets[lo]:offsets[hi]] = base.doc_terms[
                base.doc_offsets[lo]:base.doc_offsets[hi]]

    prev = 0
    for g in sorted(terms):
        copy_base(prev, min(g, nb))
        out[offsets[g]:offsets[g + 1]] = terms[g]
        prev = max(prev, min(g + 1, nb))
    copy_base(prev, nb)
    return Corpus(
        doc_offsets=offsets,
        doc_terms=out,
        doc_site=np.asarray(sites, dtype=np.int32),
        n_docs=n_docs,
        vocab_size=base.vocab_size,
        n_sites=base.n_sites,
    )


@dataclasses.dataclass
class _ShardState:
    """Host-side numpy mirror of one shard's delta."""

    lengths: np.ndarray    # int32[n_terms]
    postings: np.ndarray   # int32[n_terms, cap]  (2-D host-side; flat on device)
    attrs: np.ndarray      # int32[n_terms, cap]
    doc_flags: np.ndarray  # int32[nd_cap]
    doc_site: np.ndarray   # int32[nd_cap]


class DeltaWriter:
    """Host-side write path over a sharded corpus, mirrored per shard.

    ``corpus`` is the corpus the current main index was built from, ``meta``
    that index's :class:`IndexMeta`, ``ns`` its shard count.
    ``term_capacity`` (rounded up to BLOCK) is the delta postings a term
    can hold; ``doc_headroom`` the inserted documents the generation can
    hold.  A full list or headroom raises :class:`DeltaFullError`; compact
    and retry.  Snapshots live on ``device`` (default ``cuda``).
    ``codec="packed"`` gives the views of :meth:`shard_deltas` their
    block-codec twins.
    """

    def __init__(
        self,
        corpus: Corpus,
        meta: IndexMeta,
        ns: int,
        *,
        term_capacity: int = 2 * BLOCK,
        doc_headroom: int = 1024,
        codec: str = "raw",
        device=None,
    ):
        if ns < 1:
            raise ValueError(f"need ns >= 1, got {ns}")
        if codec not in ("raw", "packed"):
            raise ValueError(f"unknown codec {codec!r}")
        self.codec = codec
        self._packed_cache: tuple[int, list[PackedFlatArrays]] | None = None
        self.device = resolve_device(device)
        self.ns = ns
        self.meta = meta
        self.include_site_terms = meta.include_site_terms
        self.vocab_size = meta.vocab_size
        self.n_sites = meta.n_sites
        self.n_terms = meta.n_terms
        self.term_capacity = _pad_block(max(term_capacity, 1))
        self._base = corpus

        n_base_local = _ceil_div(corpus.n_docs, ns)
        self._doc_cap_local = _ceil_div(doc_headroom, ns)
        self._n_base_local_init = n_base_local
        # Local-docID admission limit (exact headroom); nd_cap is the
        # BLOCK-padded array width and may exceed it.
        self._doc_limit_local = n_base_local + self._doc_cap_local
        self.nd_cap = _pad_block(self._doc_limit_local)

        self.generation = 0
        self._shards = [self._fresh_shard(corpus, s) for s in range(ns)]

        # The mutated corpus, kept apart from the delta structures so that
        # compaction can be verified against a rebuild: the term sets and
        # sites of the documents that differ from ``corpus``, which this
        # record keeps across rebases.
        self._origin = corpus
        self._terms_over: dict[int, np.ndarray] = {}
        self._sites_over: dict[int, int] = {}
        self.n_docs = corpus.n_docs            # total, including inserts
        self._delta_docs: set[int] = set()     # gids whose live postings are in delta
        self._version = 0
        self._snapshot: ShardedDelta | None = None
        self._snapshot_version = -1

    # ------------------------------------------------------------------
    # construction / rebase
    # ------------------------------------------------------------------

    def _fresh_shard(self, base: Corpus, s: int) -> _ShardState:
        st = _ShardState(
            lengths=np.zeros(self.n_terms, dtype=np.int32),
            # 2-D host-side write mirrors, flattened and TILE-padded only
            # at snapshot time in device_delta().
            # lint: allow(posting-alloc)
            postings=np.full(
                (self.n_terms, self.term_capacity), INVALID_DOC, dtype=np.int32
            ),
            # lint: allow(posting-alloc)
            attrs=np.full(
                (self.n_terms, self.term_capacity), INVALID_ATTR, dtype=np.int32
            ),
            doc_flags=np.zeros(self.nd_cap, dtype=np.int32),
            doc_site=np.full(self.nd_cap, INVALID_ATTR, dtype=np.int32),
        )
        base_sites = base.doc_site[s::self.ns]
        st.doc_site[: base_sites.shape[0]] = base_sites
        return st

    def rebase(
        self,
        folded: Corpus,
        *,
        term_capacity: int | None = None,
        doc_headroom: int | None = None,
    ) -> None:
        """Point the writer at a freshly compacted main index (``folded`` is
        the corpus it was built from) and empty the delta.

        ``term_capacity``/``doc_headroom`` start a new delta generation
        with re-sized shapes, whose headroom counts from the folded
        corpus."""
        if term_capacity is not None or doc_headroom is not None:
            if term_capacity is not None:
                self.term_capacity = _pad_block(max(term_capacity, 1))
            if doc_headroom is not None:
                self._doc_cap_local = _ceil_div(max(doc_headroom, 1), self.ns)
            self._n_base_local_init = _ceil_div(folded.n_docs, self.ns)
            self._doc_limit_local = self._n_base_local_init + self._doc_cap_local
            self.nd_cap = _pad_block(self._doc_limit_local)
            self.generation += 1
            self._snapshot = None
        if _ceil_div(folded.n_docs, self.ns) > self._doc_limit_local:
            raise DeltaFullError(
                "folded corpus exceeds the writer's fixed doc capacity"
            )
        self._base = folded
        self._shards = [self._fresh_shard(folded, s) for s in range(self.ns)]
        self._delta_docs = set()
        self._bump()

    # ------------------------------------------------------------------
    # low-level sorted posting ops (host numpy, per shard)
    # ------------------------------------------------------------------

    def _insert_posting(self, st: _ShardState, t: int, local: int, attr: int):
        ln = int(st.lengths[t])
        row, arow = st.postings[t], st.attrs[t]
        pos = int(np.searchsorted(row[:ln], local))
        row[pos + 1 : ln + 1] = row[pos:ln]
        arow[pos + 1 : ln + 1] = arow[pos:ln]
        row[pos] = local
        arow[pos] = attr
        st.lengths[t] = ln + 1

    def _remove_posting(self, st: _ShardState, t: int, local: int):
        ln = int(st.lengths[t])
        row, arow = st.postings[t], st.attrs[t]
        pos = int(np.searchsorted(row[:ln], local))
        if pos >= ln or row[pos] != local:
            return
        row[pos : ln - 1] = row[pos + 1 : ln]
        arow[pos : ln - 1] = arow[pos + 1 : ln]
        row[ln - 1] = INVALID_DOC
        arow[ln - 1] = INVALID_ATTR
        st.lengths[t] = ln - 1

    def _terms_of(self, gid: int) -> np.ndarray:
        ts = self._terms_over.get(gid)
        if ts is None:
            ts = self._origin.terms_of(gid) if gid < self._origin.n_docs else ()
        return ts

    def _site_of(self, gid: int) -> int:
        site = self._sites_over.get(gid)
        return int(self._origin.doc_site[gid]) if site is None else site

    def _posting_terms(self, gid: int) -> list[int]:
        """All term ids carrying postings for gid's *current* version."""
        ts = [int(t) for t in self._terms_of(gid)]
        if self.include_site_terms:
            ts.append(self.vocab_size + self._site_of(gid))
        return ts

    def _check_terms(self, terms: np.ndarray, site: int):
        if terms.size and (terms[0] < 0 or terms[-1] >= self.vocab_size):
            raise ValueError(f"term out of range: {terms}")
        if not (0 <= site < self.n_sites):
            raise ValueError(f"site out of range: {site}")

    def _shard_of(self, gid: int) -> tuple[_ShardState, int]:
        return self._shards[gid % self.ns], gid // self.ns

    def _bump(self, shard: int | None = None):
        """Count one change: a mutation of ``shard``, or (None) a rebase."""
        self._version += 1

    # ------------------------------------------------------------------
    # transactional ops
    # ------------------------------------------------------------------

    def insert_docs(
        self, docs: Sequence[tuple[Sequence[int], int]]
    ) -> list[int]:
        """Insert new documents; returns their global docIDs.

        docIDs are assigned monotonically (a new doc ranks below every
        existing one) and stripe with ``d % ns``.  Each document is
        admitted atomically and bumps the version as it lands, so a
        mid-batch :class:`DeltaFullError` leaves the earlier ones applied
        and visible (resume from its ``applied``)."""
        gids: list[int] = []
        for terms, site in docs:
            try:
                gids.append(self._insert_one(terms, site))
            except DeltaFullError as e:
                raise DeltaFullError(str(e), applied=len(gids)) from None
        return gids

    def _insert_one(self, terms: Sequence[int], site: int) -> int:
        terms_u = np.unique(np.asarray(terms, dtype=np.int64)).astype(np.int32)
        self._check_terms(terms_u, site)
        gid = self.n_docs
        st, local = self._shard_of(gid)
        if local >= self._doc_limit_local:
            raise DeltaFullError("document headroom exhausted")
        plist = [int(t) for t in terms_u]
        if self.include_site_terms:
            plist.append(self.vocab_size + site)
        for t in plist:
            if st.lengths[t] >= self.term_capacity:
                raise DeltaFullError(f"delta list full for term {t}")
        for t in plist:
            self._insert_posting(st, t, local, site)
        st.doc_site[local] = site
        self._terms_over[gid] = terms_u
        self._sites_over[gid] = int(site)
        self._delta_docs.add(gid)
        self.n_docs += 1
        self._bump(gid % self.ns)
        return gid

    def delete_docs(self, docids: Sequence[int]) -> None:
        """Tombstone documents.  Their delta postings are removed (which
        reclaims capacity); main postings are masked by ``DOC_DEAD`` until
        compaction folds them out."""
        for gid in docids:
            self._delete_one(int(gid))

    def _delete_one(self, gid: int) -> None:
        if not (0 <= gid < self.n_docs):
            raise KeyError(f"unknown docID {gid}")
        st, local = self._shard_of(gid)
        if st.doc_flags[local] & DOC_DEAD:
            return
        if gid in self._delta_docs:
            for t in self._posting_terms(gid):
                self._remove_posting(st, t, local)
            self._delta_docs.discard(gid)
        st.doc_flags[local] |= DOC_DEAD
        self._terms_over[gid] = np.zeros(0, dtype=np.int32)
        self._bump(gid % self.ns)

    def update_docs(
        self, updates: Sequence[tuple[int, Sequence[int], int | None]]
    ) -> None:
        """Replace documents in place: ``(docid, new_terms, new_site|None)``.

        The docID (= rank) stays.  The old main postings are masked by
        ``DOC_SUPERSEDED``, an older delta version is removed, and the new
        postings land in the delta.  Each update is atomic and versioned on
        its own (a mid-batch error leaves the earlier ones applied)."""
        applied = 0
        for gid, terms, site in updates:
            try:
                self._update_one(int(gid), terms, site)
            except DeltaFullError as e:
                raise DeltaFullError(str(e), applied=applied) from None
            applied += 1

    def _update_one(
        self, gid: int, terms: Sequence[int], site: int | None
    ) -> None:
        if not (0 <= gid < self.n_docs):
            raise KeyError(f"unknown docID {gid}")
        st, local = self._shard_of(gid)
        if st.doc_flags[local] & DOC_DEAD:
            raise KeyError(f"docID {gid} is deleted")
        new_site = self._site_of(gid) if site is None else int(site)
        terms_u = np.unique(np.asarray(terms, dtype=np.int64)).astype(np.int32)
        self._check_terms(terms_u, new_site)
        in_delta = gid in self._delta_docs
        old_plist = set(self._posting_terms(gid)) if in_delta else set()
        new_plist = [int(t) for t in terms_u]
        if self.include_site_terms:
            new_plist.append(self.vocab_size + new_site)
        for t in new_plist:
            drop = 1 if t in old_plist else 0
            if st.lengths[t] - drop >= self.term_capacity:
                raise DeltaFullError(f"delta list full for term {t}")
        if in_delta:
            for t in old_plist:
                self._remove_posting(st, t, local)
        else:
            st.doc_flags[local] |= DOC_SUPERSEDED
        for t in new_plist:
            self._insert_posting(st, t, local, new_site)
        st.doc_site[local] = new_site
        self._terms_over[gid] = terms_u
        self._sites_over[gid] = new_site
        self._delta_docs.add(gid)
        self._bump(gid % self.ns)

    def apply(self, mutations) -> None:
        """Apply a :func:`repro_torch.data.corpus.generate_mutations` stream."""
        for m in mutations:
            if m.op == "insert":
                self.insert_docs([(m.terms, m.site)])
            elif m.op == "delete":
                self.delete_docs([m.docid])
            elif m.op == "update":
                self.update_docs([(m.docid, m.terms, m.site)])
            else:
                raise ValueError(m.op)

    # ------------------------------------------------------------------
    # views
    # ------------------------------------------------------------------

    @property
    def version(self) -> int:
        return self._version

    @property
    def doc_headroom(self) -> int:
        """Total inserted-document capacity of the current generation."""
        return self._doc_cap_local * self.ns

    @property
    def base_corpus(self) -> Corpus:
        """The corpus the current main index was built from."""
        return self._base

    @property
    def delta_doc_ids(self) -> frozenset[int]:
        """Global docIDs whose live postings are in the delta."""
        return frozenset(self._delta_docs)

    def device_delta(self) -> ShardedDelta:
        """Snapshot the host mirrors into a :class:`ShardedDelta` on the
        writer's device, cached per version.  Shapes are fixed per
        generation.  The snapshot is a value: later mutations never write
        into it."""
        if self._snapshot is None or self._snapshot_version != self._version:
            self._publish([self._device_rows(st) for st in self._shards],
                          self._version)
        return self._snapshot

    def _device_rows(self, st: _ShardState) -> tuple[torch.Tensor, ...]:
        """One shard's mirror copied to the writer's device, in
        :class:`ShardedDelta` field order after ``offsets``.  The skip
        table is computed on the device from the copied slab: per block,
        the max of its valid postings, and ``INVALID_DOC`` for a block
        with none."""
        cap, n_terms, dev = self.term_capacity, self.n_terms, self.device
        flat = n_terms * cap
        i32 = torch.int32

        def copied(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(a).to(dev, copy=True)

        postings = torch.full((flat_tile_pad(flat),), int(INVALID_DOC),
                              dtype=i32, device=dev)
        attrs = torch.full_like(postings, int(INVALID_ATTR))
        postings[:flat].copy_(torch.from_numpy(st.postings.reshape(-1)))
        attrs[:flat].copy_(torch.from_numpy(st.attrs.reshape(-1)))
        lengths = copied(st.lengths)
        valid = torch.arange(cap, dtype=i32, device=dev) < lengths[:, None]
        m = torch.where(valid, postings[:flat].view(n_terms, cap), -1)
        m = m.view(n_terms, cap // BLOCK, BLOCK).amax(-1).view(-1)
        block_max = torch.where(m >= 0, m, int(INVALID_DOC))
        return (lengths, postings, attrs, block_max, copied(st.doc_flags),
                copied(st.doc_site))

    def _publish(self, rows, version) -> None:
        """Stack the shards' device rows into a new snapshot stamped
        ``version``."""
        n_terms, dev = self.n_terms, self.device
        offsets = (torch.arange(n_terms, dtype=torch.int32, device=dev)
                   * self.term_capacity).expand(len(rows), n_terms).contiguous()
        self._snapshot = ShardedDelta(offsets,
                                      *(torch.stack(col) for col in zip(*rows)))
        self._snapshot_version = version
        postings = self._snapshot.postings
        export_index_bytes(postings.numel() * postings.element_size(), None,
                           kind="delta")

    def shard_deltas(self) -> list[DeltaIndex]:
        """Per-shard views of the current snapshot.

        With ``codec="packed"`` each view carries the block-codec twin of
        its slab, packed on the writer's device with ``span_blocks`` the
        blocks of one slab (as the reference), re-encoded once per version
        and cached; the ``odys_index_bytes{kind="delta"}`` gauges then
        report both layouts' totals."""
        stacked = self.device_delta()
        shards = [stacked.shard(s) for s in range(self.ns)]
        if self.codec != "packed":
            return shards
        if self._packed_cache is None or self._packed_cache[0] != self._version:
            span = max(DESC_PAD, self.term_capacity // BLOCK)
            packs = [pack_flat_postings(d.postings, span_blocks=span)
                     for d in shards]
            export_index_bytes(
                sum(d.postings.numel() * d.postings.element_size()
                    for d in shards),
                sum(pk.nbytes() for pk in packs), kind="delta")
            self._packed_cache = (self._version, packs)
        return [d._replace(packed=pk)
                for d, pk in zip(shards, self._packed_cache[1])]

    def mutated_corpus(self) -> Corpus:
        """The authoritative post-mutation corpus (deleted docs become empty
        docs, so docIDs, and thus ranks, stay stable)."""
        sites = np.empty(self.n_docs, dtype=np.int32)
        sites[: self._origin.n_docs] = self._origin.doc_site
        for gid, site in self._sites_over.items():
            sites[gid] = site
        return overlay_corpus(self._origin, self._terms_over, sites,
                              n_docs=self.n_docs)

    # ------------------------------------------------------------------
    # fill / compaction triggers
    # ------------------------------------------------------------------

    def posting_fill(self) -> float:
        """Max posting-list fill fraction across shards and terms."""
        return max(
            float(s.lengths.max()) / self.term_capacity for s in self._shards
        )

    def doc_fill(self) -> float:
        """Inserted-document headroom consumed (whole writer lifetime)."""
        used = _ceil_div(self.n_docs, self.ns) - self._n_base_local_init
        return max(0.0, used / self._doc_cap_local)

    def fill(self) -> float:
        """Worst capacity dimension (reporting/monitoring)."""
        return max(self.posting_fill(), self.doc_fill())

    def needs_compaction(self, threshold: float = 0.5) -> bool:
        """True once the *posting* fill crosses ``threshold``.  Document
        headroom is consumed for the writer's lifetime (compaction cannot
        drain it), so it is not a trigger; its exhaustion surfaces as
        :class:`DeltaFullError` at insert time."""
        return self.posting_fill() >= threshold


# ---------------------------------------------------------------------------
# Multi-master ingest: concurrent streams, vector-versioned publish
# ---------------------------------------------------------------------------


class VectorVersion(NamedTuple):
    """Snapshot stamp of a :class:`ShardedDeltaWriter` publish.

    ``epoch`` counts structural transitions (rebase, compaction); ``seqs``
    is each shard's mutation sequence.  Hashable and compared by value, so
    the version-stamped result cache and the snapshot caches keyed on
    ``writer.version`` work unchanged: any shard's mutation (or an epoch
    bump) makes the stamp unequal, and a stale result is never served
    across it, with no global write lock imposing a total order first."""

    epoch: int
    seqs: tuple[int, ...]


class ShardedDeltaWriter(DeltaWriter):
    """Multi-master ingest over the per-shard delta.

    - ``insert_docs`` / ``delete_docs`` / ``update_docs`` are thread safe
      and may be called from concurrent ingest streams.  Allocating a
      docID is a short serial section under the alloc lock; every posting
      mutation runs under the lock of the doc's shard only, so streams on
      different shards proceed side by side.  Locks are always taken in
      the order alloc -> shard.
    - ``submit_insert`` / ``submit_delete`` / ``submit_update`` put ops on
      per-shard queues (deletes and updates by their docID's home shard
      ``gid % ns``; inserts round-robin, since their shard is fixed only
      when the docID is allocated at apply time).  :meth:`drain` applies
      them FIFO per shard and may run as one worker per shard.  A queued
      op that raises ``KeyError`` (unknown or deleted docID) or
      :class:`DeltaFullError` is dropped and counted on
      ``odys_ingest_conflicts_total`` instead of stopping the queue.
    - :meth:`device_delta` publishes under :meth:`frozen` and stamps the
      snapshot with the :class:`VectorVersion`.  Each shard's device rows
      are cached by ``(epoch, seq)``, so a publish copies host -> device
      only the shards that moved and stacks the new snapshot from the
      cached rows (a device-side copy: the snapshot stays a value, and a
      cached row is never written after a publish used it).

    Unlike the base writer, a concurrent insert reserves its docID before
    the capacity check (the shard is a function of the docID), so an
    insert that fails for capacity leaves a dead, empty placeholder doc;
    global docIDs stay dense either way.
    """

    def __init__(
        self,
        corpus: Corpus,
        meta: IndexMeta,
        ns: int,
        *,
        term_capacity: int = 2 * BLOCK,
        doc_headroom: int = 1024,
        codec: str = "raw",
        device=None,
        registry: MetricsRegistry | None = None,
    ):
        super().__init__(corpus, meta, ns, term_capacity=term_capacity,
                         doc_headroom=doc_headroom, codec=codec, device=device)
        self._alloc_lock = threading.RLock()
        self._shard_locks = [threading.RLock() for _ in range(ns)]
        self._count_lock = threading.Lock()    # counters and version bumps
        self._epoch = 0
        self._seqs = [0] * ns
        self._queues: list[deque] = [deque() for _ in range(ns)]
        self._rr = itertools.count()           # insert striping cursor
        # per-shard publish cache: ((epoch, seq), device rows)
        self._shard_rows: list[tuple | None] = [None] * ns
        reg = registry if registry is not None else get_registry()
        self._m_ops = {
            op: reg.counter("odys_ingest_ops_total",
                            help="ingest operations applied to the delta", op=op)
            for op in ("insert", "delete", "update")
        }
        self._m_conflicts = reg.counter(
            "odys_ingest_conflicts_total",
            help="queued ops dropped at apply time (cross-stream conflict "
                 "or capacity exhaustion)")
        self._m_depth = [
            reg.gauge("odys_ingest_queue_depth",
                      help="ops enqueued and not yet drained", shard=str(s))
            for s in range(ns)
        ]
        self._m_publish = [
            reg.gauge("odys_ingest_publish_seq",
                      help="per-shard mutation sequence at the last "
                           "published snapshot", shard=str(s))
            for s in range(ns)
        ]

    # ------------------------------------------------------------------
    # vector version
    # ------------------------------------------------------------------

    @property
    def version(self) -> VectorVersion:
        return VectorVersion(self._epoch, tuple(self._seqs))

    def _bump(self, shard: int | None = None):
        with self._count_lock:
            self._version += 1       # total change count (packed-cache key)
            if shard is None:
                self._epoch += 1     # structural: rebase / compaction
            else:
                self._seqs[shard] += 1

    def _count(self, counter) -> None:
        with self._count_lock:       # Counter.inc is not atomic
            counter.inc()

    @contextlib.contextmanager
    def frozen(self):
        """Exclusive section: allocation and every shard quiesced.

        Publish and compaction run under it so that they see a state
        consistent across shards.  The locks are re-entrant, so
        compaction's fold -> publish -> rebase nesting works.  Submissions
        still enqueue during a freeze; they drain once it lifts."""
        self._alloc_lock.acquire()
        for lock in self._shard_locks:
            lock.acquire()
        try:
            yield
        finally:
            for lock in reversed(self._shard_locks):
                lock.release()
            self._alloc_lock.release()

    # ------------------------------------------------------------------
    # thread-safe per-doc ops
    # ------------------------------------------------------------------

    def _insert_one(self, terms: Sequence[int], site: int) -> int:
        terms_u = np.unique(np.asarray(terms, dtype=np.int64)).astype(np.int32)
        self._check_terms(terms_u, site)
        with self._alloc_lock:
            gid = self.n_docs
            st, local = self._shard_of(gid)
            if local >= self._doc_limit_local:
                raise DeltaFullError("document headroom exhausted")
            shard = gid % self.ns
            lock = self._shard_locks[shard]
            # The shard lock is taken before the allocation is published:
            # a rebase (frozen) then never sees an allocated but unapplied
            # doc, which it would fold into the main index while the
            # insert still lands its delta postings afterwards.
            lock.acquire()
            self.n_docs += 1
            self._terms_over[gid] = terms_u
            self._sites_over[gid] = int(site)
        try:
            plist = [int(t) for t in terms_u]
            if self.include_site_terms:
                plist.append(self.vocab_size + int(site))
            for t in plist:
                if st.lengths[t] >= self.term_capacity:
                    # the docID is allocated: leave a dead, empty
                    # placeholder so that global docIDs stay dense
                    st.doc_flags[local] |= DOC_DEAD
                    self._terms_over[gid] = np.zeros(0, dtype=np.int32)
                    self._bump(shard)
                    raise DeltaFullError(f"delta list full for term {t}")
            for t in plist:
                self._insert_posting(st, t, local, site)
            st.doc_site[local] = site
            self._delta_docs.add(gid)
            self._bump(shard)
        finally:
            lock.release()
        self._count(self._m_ops["insert"])
        return gid

    def _delete_one(self, gid: int) -> None:
        with self._shard_locks[gid % self.ns]:
            super()._delete_one(gid)
        self._count(self._m_ops["delete"])

    def _update_one(self, gid: int, terms: Sequence[int],
                    site: int | None) -> None:
        with self._shard_locks[gid % self.ns]:
            super()._update_one(gid, terms, site)
        self._count(self._m_ops["update"])

    # ------------------------------------------------------------------
    # per-shard write queues
    # ------------------------------------------------------------------

    def submit_insert(self, terms: Sequence[int], site: int) -> None:
        """Enqueue an insert (applied at the next :meth:`drain`)."""
        self._enqueue(next(self._rr) % self.ns,
                      ("insert", tuple(int(t) for t in terms), int(site)))

    def submit_delete(self, docid: int) -> None:
        self._enqueue(int(docid) % self.ns, ("delete", int(docid)))

    def submit_update(self, docid: int, terms: Sequence[int],
                      site: int | None = None) -> None:
        self._enqueue(int(docid) % self.ns,
                      ("update", int(docid), tuple(int(t) for t in terms), site))

    def _enqueue(self, shard: int, op: tuple) -> None:
        q = self._queues[shard]
        q.append(op)                 # deque.append is atomic
        self._m_depth[shard].set(float(len(q)))

    def queue_depth(self, shard: int | None = None) -> int:
        qs = self._queues if shard is None else [self._queues[shard]]
        return sum(len(q) for q in qs)

    def drain(self, shard: int | None = None) -> int:
        """Apply queued ops FIFO per shard; returns how many applied.

        Safe to call concurrently (one worker per shard): ops pop
        atomically and apply under their shard's lock.  An op that raises
        ``KeyError`` or :class:`DeltaFullError` is dropped and counted."""
        shards = range(self.ns) if shard is None else (int(shard),)
        applied = 0
        for s in shards:
            q = self._queues[s]
            while True:
                try:
                    op = q.popleft()
                except IndexError:
                    break
                try:
                    self._apply_queued(op)
                    applied += 1
                except (KeyError, DeltaFullError):
                    self._count(self._m_conflicts)
                self._m_depth[s].set(float(len(q)))
        return applied

    def _apply_queued(self, op: tuple) -> None:
        kind = op[0]
        if kind == "insert":
            self._insert_one(list(op[1]), op[2])
        elif kind == "delete":
            self._delete_one(op[1])
        elif kind == "update":
            self._update_one(op[1], list(op[2]), op[3])
        else:
            raise ValueError(f"unknown queued op {kind!r}")

    # ------------------------------------------------------------------
    # vector-versioned publish
    # ------------------------------------------------------------------

    def rebase(self, folded: Corpus, **kw) -> None:
        with self.frozen():
            super().rebase(folded, **kw)
            self._shard_rows = [None] * self.ns

    def device_delta(self) -> ShardedDelta:
        """Publish: the snapshot of every shard's mirror, stamped with the
        :class:`VectorVersion`.  A shard whose ``(epoch, seq)`` did not
        move since the last publish reuses its cached device rows."""
        with self.frozen():
            ver = self.version
            if self._snapshot is not None and self._snapshot_version == ver:
                return self._snapshot
            rows = []
            for s, st in enumerate(self._shards):
                key = (self._epoch, self._seqs[s])
                cached = self._shard_rows[s]
                if cached is None or cached[0] != key:
                    cached = self._shard_rows[s] = (key, self._device_rows(st))
                rows.append(cached[1])
                self._m_publish[s].set(float(self._seqs[s]))
            self._publish(rows, ver)
            return self._snapshot

    def shard_deltas(self) -> list[DeltaIndex]:
        with self.frozen():
            return super().shard_deltas()

    def mutated_corpus(self) -> Corpus:
        with self.frozen():
            return super().mutated_corpus()
