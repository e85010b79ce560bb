"""ODYS slave query engine (PyTorch port of ``repro.core.engine``).

The per-slave query processor over the index of
:mod:`repro_torch.core.index`, for the paper's three query classes
(§4.1.1): single-keyword top-k, multiple-keyword top-k (ZigZag join of the
shortest list against every other list, first k in rank order), and
limited search (keyword + siteId) with three strategies:

- ``embed``     — fused predicate on the embedded attrs stream (Fig 4(b));
- ``gather``    — join against the doc->site table by gather (Fig 1(c));
- ``site_term`` — the site's own posting list as an extra join term
  (Fig 1(d)/4(a)), rewritten at query construction.

Shapes are fixed per batch: queries padded to ``t_max`` terms, windows of
``window`` postings, results of ``k``.  Other-term membership is against
each term's first ``window`` postings only, exactly as in the reference.

Four backends, the first three bit-identical to the reference's
``backend="jnp"``, the fourth to its ``backend="pallas_staged"``:

- ``"torch"``  — plain PyTorch ops: the port of the jnp branch, batched
  over queries instead of ``vmap``-ed;
- ``"kernel"`` — the port of the reference's ``_query_topk_batch_pallas``.
  On the static index: driver pick, driver span, the K1 join
  (:func:`repro_torch.kernels.ops.intersect_fullstream`), the ``gather``
  join on the device, then the first k.  Under merge-on-read (a
  :class:`~repro_torch.indexing.delta.DeltaIndex`): driver pick on the
  merged lengths, the *main* driver span, the K3 driver merge
  (:func:`~repro_torch.kernels.ops.merge_windows`), the tombstone flags
  and live stream, the K4 join against main and delta
  (:func:`~repro_torch.kernels.ops.intersect_streamed`), the ``gather``
  join on the delta's ``doc_site``, then the first k.  On CPU tensors the
  kernels run their plain versions, so this backend is tested here too;
- ``"kernel_compact"`` — the port of ``_query_topk_batch_pallas_compact``:
  the same path with each kernel run over a host-built work list of live
  items (K6 on the static index, K8 then K7 under merge-on-read), so inert
  padding queries (``live_q``), absent term slots and empty probe spans
  cost no thread block;
- ``"kernel_staged"`` — the port of the reference's legacy staged path
  (``backend="pallas_staged"``, ``_query_topk_batch_staged``), kept as the
  comparator that shows what the streamed path saves: every term slot's
  window is gathered into a ``(Q, T_MAX, window)`` buffer (under
  merge-on-read the merged windows, each a sort of main ∪ delta), then one
  K9 launch (:func:`repro_torch.kernels.ops.intersect_batched`) joins the
  driver window against them with the attribute predicate fused (for
  ``gather`` the driver's ``doc_site`` stream is the attribute stream).
  Under merge-on-read it joins against the first ``window`` postings of
  each merged list, so it equals the others only while the window covers
  the merged lists, as in the reference.

``codec="packed"`` reads the postings through the block codec: the index
(and the delta, when one is attached) must carry its packed twin.  The
``torch`` and ``kernel_staged`` backends decode the whole array first, as
the reference does for every backend but its streamed Pallas one; the
``kernel`` backend hands the twins to K1p, or to K3p and K4p
(``kernel_compact``: K6p, or K8p and K7p), which decode block by block on
the card, and reads no raw posting.

Merge-on-read (:class:`MergedPostingSource`): each term's logical list is
main ∪ delta.  A main posting is live unless its doc is DEAD or
SUPERSEDED, a delta posting unless it is DEAD, and equal docIDs order
main first.  Results equal a rebuild over the mutated corpus while the
window covers the merged lists.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.index import (
    DOC_DEAD,
    DOC_SUPERSEDED,
    INVALID_ATTR,
    INVALID_DOC,
    IndexMeta,
    InvertedIndex,
    resolve_device,
    site_term_id,
    unpack_flat_postings_torch,
)
from repro_torch.kernels.posting_intersect import _take_fill
from repro_torch.obs.trace import batch_span

NO_TERM = np.int32(-1)
NO_ATTR = np.int32(-1)
BACKENDS = ("torch", "kernel", "kernel_compact", "kernel_staged")
CODECS = ("raw", "packed")
STRATEGIES = ("embed", "gather", "site_term")
_INVALID = int(INVALID_DOC)


class QueryBatch(NamedTuple):
    """Fixed-shape batch of queries (padded to T_MAX terms)."""

    terms: torch.Tensor        # int32[Q, T_MAX]; NO_TERM padding
    n_terms: torch.Tensor      # int32[Q]
    attr_filter: torch.Tensor  # int32[Q]; NO_ATTR = unrestricted

    @property
    def n_queries(self) -> int:
        return self.terms.shape[0]


def make_query_batch(
    queries: list[tuple[list[int], int | None]],
    *,
    t_max: int = 4,
    meta: IndexMeta | None = None,
    strategy: str = "embed",
    device=None,
) -> QueryBatch:
    """Build a QueryBatch from ``(term_list, site_or_None)`` tuples, on
    ``device`` (default ``cuda``).

    With ``strategy='site_term'`` the site restriction is rewritten into an
    extra join term (Fig 1(d)) and ``attr_filter`` stays empty.  It runs
    on the host, inside the ``odys.batch_build`` span (phase
    ``batch_build``).
    """
    dev = resolve_device(device)
    with batch_span("odys.batch_build", "batch_build"):
        q = len(queries)
        terms = np.full((q, t_max), NO_TERM, dtype=np.int32)
        n_terms = np.zeros(q, dtype=np.int32)
        attr = np.full(q, NO_ATTR, dtype=np.int32)
        for i, (ts, site) in enumerate(queries):
            ts = list(ts)
            if site is not None and strategy == "site_term":
                if meta is None:
                    raise ValueError("strategy='site_term' needs the index meta")
                ts = ts + [site_term_id(meta, site)]
            elif site is not None:
                attr[i] = site
            if not 1 <= len(ts) <= t_max:
                raise ValueError(f"query {ts} needs 1..{t_max} terms")
            terms[i, : len(ts)] = ts
            n_terms[i] = len(ts)
        return QueryBatch(*(torch.from_numpy(x).to(dev)
                            for x in (terms, n_terms, attr)))


# ---------------------------------------------------------------------------
# Windowed posting access (batched over any leading shape of ``term``)
# ---------------------------------------------------------------------------

def _list_window(lists, term: torch.Tensor, width: int):
    """``(docids, attrs, valid)``, each ``[..., width]``, of each term's
    list in ``lists`` (an index or a delta: ``offsets``, ``lengths``,
    ``postings``, ``attrs``).  Reads past the flat arrays give INVALID_DOC /
    INVALID_ATTR, docIDs past the list's length are INVALID_DOC, and attrs
    are not masked (as in the reference)."""
    t = term.clamp(0, lists.offsets.shape[0] - 1).long()
    off = lists.offsets[t].long()
    ln = torch.where(term < 0, torch.zeros_like(term), lists.lengths[t])
    pos = torch.arange(width, dtype=torch.int64, device=term.device)
    idx = off[..., None] + pos
    inside = idx < lists.postings.shape[0]
    idx = idx.clamp(max=lists.postings.shape[0] - 1)
    docs = torch.where(inside, lists.postings[idx], _INVALID)
    attrs = torch.where(inside, lists.attrs[idx], int(INVALID_ATTR))
    valid = pos < ln[..., None]
    docs = torch.where(valid, docs, _INVALID).to(torch.int32)
    return docs, attrs.to(torch.int32), valid


def term_window(index: InvertedIndex, term: torch.Tensor, window: int):
    """``(docids, attrs, valid)``, each ``[..., window]``, for each term."""
    return _list_window(index, term, window)


def member_sorted(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """For each ``a[..., i]``, is it present in the sorted row ``b[...]``?"""
    idx = torch.searchsorted(b.contiguous(), a.contiguous(), right=False)
    probe = b.gather(-1, idx.clamp(max=b.shape[-1] - 1))
    return probe == a


def _first_k_by_rank(docids: torch.Tensor, mask: torch.Tensor, k: int):
    """The k smallest (= best-ranked) docids where mask holds, ascending and
    INVALID-padded, plus the number of matches."""
    key = torch.where(mask, docids, _INVALID)
    out = key.sort(dim=-1).values[..., :k].contiguous()
    return out, mask.sum(dim=-1, dtype=torch.int32)


# ---------------------------------------------------------------------------
# Merge-on-read: logical windows over main + delta with tombstone filtering
# ---------------------------------------------------------------------------

def delta_term_window(delta, term: torch.Tensor):
    """``(docids, attrs, valid)``, each ``[..., cap]``, of each term's delta
    list (the delta shares the main index's CSR layout, with a fixed
    per-term capacity)."""
    return _list_window(delta, term, delta.term_capacity)


def posting_live(delta, docs: torch.Tensor, *, from_delta: bool) -> torch.Tensor:
    """Per-posting tombstone predicate: a main posting is live iff its doc
    is neither DEAD nor SUPERSEDED, a delta posting iff it is not DEAD.
    INVALID and any docID past the bitmap read flag 0 (live) and are killed
    by the validity predicate instead."""
    flags = _take_fill(delta.doc_flags, docs, 0)
    kill = DOC_DEAD if from_delta else (DOC_DEAD | DOC_SUPERSEDED)
    return (flags & int(kill)) == 0


def merged_term_window(index: InvertedIndex, delta, term: torch.Tensor,
                       window: int, *, drop_dead: bool):
    """Merge-on-read window ``(docids, attrs, live)``, each ``[..., window]``.

    The main window and the term's delta list, concatenated main first and
    sorted stably, so equal docIDs keep main first.  ``drop_dead=True``
    turns tombstoned postings into INVALID before the merge;
    ``drop_dead=False`` keeps them in their rank slots with ``live=0``.
    This is the reference driver merge, the oracle for K3."""
    m_docs, m_attrs, m_valid = term_window(index, term, window)
    m_live = posting_live(delta, m_docs, from_delta=False) & m_valid
    d_docs, d_attrs, d_valid = delta_term_window(delta, term)
    d_live = posting_live(delta, d_docs, from_delta=True) & d_valid
    docs = torch.cat([m_docs, d_docs], dim=-1)
    attrs = torch.cat([m_attrs, d_attrs], dim=-1)
    live = torch.cat([m_live, d_live], dim=-1)
    if drop_dead:
        docs = torch.where(live, docs, _INVALID)
    docs, order = docs.sort(dim=-1, stable=True)
    docs, order = docs[..., :window], order[..., :window]
    live = live.gather(-1, order) & (docs != _INVALID)
    return docs.contiguous(), attrs.gather(-1, order), live.to(torch.int32)


# ---------------------------------------------------------------------------
# PostingSource: how the engine obtains per-(query, term) posting streams
# ---------------------------------------------------------------------------

class DriverSpan(NamedTuple):
    """Per-query placement of the driver window in the flat posting arrays:
    the window's start offset and how many of its slots are live."""

    off: torch.Tensor    # int32[Q]
    n_eff: torch.Tensor  # int32[Q] (<= window)


class StaticPostingSource:
    """Posting access over the read-only main index.

    The ``kernel`` backend never gathers a stream: the driver window is
    handed to K1 as a :class:`DriverSpan` and other-term lists are probed
    in place.  The ``torch`` backend materializes the driver window
    (:meth:`driver_window`) and probes windows with ``searchsorted``.
    """

    def __init__(self, index: InvertedIndex):
        self.index = index

    @property
    def doc_site(self) -> torch.Tensor:
        return self.index.doc_site

    def list_lengths(self, terms: torch.Tensor) -> torch.Tensor:
        tt = terms.clamp(0, self.index.offsets.shape[0] - 1).long()
        return self.index.lengths[tt]

    def driver_slot(self, terms: torch.Tensor, n_terms: torch.Tensor):
        """Per query, the FIRST slot of the shortest active list (the
        classic ZigZag driver; ``torch.argmin`` returns the first minimum,
        as ``jnp.argmin`` does)."""
        slots = torch.arange(terms.shape[-1], device=terms.device)
        lens = torch.where(slots < n_terms[..., None], self.list_lengths(terms),
                           _INVALID)
        return lens.argmin(dim=-1)

    def driver_window(self, term: torch.Tensor, window: int):
        """``(docs, attrs, valid)`` of the driver terms, each ``[Q, window]``."""
        return term_window(self.index, term, window)

    def driver_span(self, terms: torch.Tensor, window: int) -> DriverSpan:
        tt = terms.clamp(0, self.index.offsets.shape[0] - 1).long()
        off = self.index.offsets[tt]
        ln = torch.where(terms < 0, torch.zeros_like(terms), self.index.lengths[tt])
        return DriverSpan(off, ln.clamp(max=window))

    def driver_flags(self, a_docs: torch.Tensor) -> None:
        """No tombstones on the read-only index."""
        return None

    def member(self, a_docs: torch.Tensor, term: torch.Tensor, window: int):
        """Membership of each driver posting in the term's bounded window."""
        b_docs, _, _ = term_window(self.index, term, window)
        return member_sorted(a_docs, b_docs)


class MergedPostingSource(StaticPostingSource):
    """Merge-on-read posting access over main + delta.

    The driver stream is the merged window, tombstoned postings keeping
    their slots with ``live=0``.  The ``kernel`` backend builds it with K3
    from the inherited *main* :meth:`driver_span` and the delta slab, and
    :meth:`driver_live` turns K3's per-slot stream id into the live stream.
    Other-term membership never materializes a merged window: a driver
    posting joins the logical list iff it is in the main list and its doc
    is neither DEAD nor SUPERSEDED, or in the delta list and its doc is not
    DEAD; :meth:`driver_flags` gives the bits those probes key off.
    """

    def __init__(self, index: InvertedIndex, delta):
        super().__init__(index)
        self.delta = delta

    @property
    def doc_site(self) -> torch.Tensor:
        return self.delta.doc_site

    def list_lengths(self, terms: torch.Tensor) -> torch.Tensor:
        tt = terms.clamp(0, self.index.offsets.shape[0] - 1).long()
        return self.index.lengths[tt] + self.delta.lengths[tt]

    def driver_window(self, term: torch.Tensor, window: int):
        docs, attrs, live = merged_term_window(
            self.index, self.delta, term, window, drop_dead=False)
        return docs, attrs, live > 0

    def driver_flags(self, a_docs: torch.Tensor) -> torch.Tensor:
        """Tombstone bits of each driver posting's document."""
        return _take_fill(self.delta.doc_flags, a_docs, 0)

    def driver_live(self, docs, src, a_flags=None) -> torch.Tensor:
        """The live stream of a merged driver window, int32, from each
        slot's stream id (K3's ``src``: 0 = main, 1 = delta) and the
        tombstone bits."""
        if a_flags is None:
            a_flags = self.driver_flags(docs)
        main_ok = (a_flags & int(DOC_DEAD | DOC_SUPERSEDED)) == 0
        delta_ok = (a_flags & int(DOC_DEAD)) == 0
        live = (docs != _INVALID) & torch.where(src == 0, main_ok, delta_ok)
        return live.to(torch.int32)

    def member(self, a_docs, term, window: int, a_flags=None):
        if a_flags is None:
            a_flags = self.driver_flags(a_docs)
        m_docs, _, _ = term_window(self.index, term, window)
        d_docs, _, _ = delta_term_window(self.delta, term)
        main_ok = (a_flags & int(DOC_DEAD | DOC_SUPERSEDED)) == 0
        delta_ok = (a_flags & int(DOC_DEAD)) == 0
        return ((member_sorted(a_docs, m_docs) & main_ok)
                | (member_sorted(a_docs, d_docs) & delta_ok))


def make_posting_source(index: InvertedIndex, delta) -> StaticPostingSource:
    return (StaticPostingSource(index) if delta is None
            else MergedPostingSource(index, delta))


def _pick_drivers(source: StaticPostingSource, batch: QueryBatch):
    """Driver slot, driver term and the active (joined) slots per query."""
    slot = source.driver_slot(batch.terms, batch.n_terms)
    slots = torch.arange(batch.terms.shape[1], device=slot.device)
    active = (slots < batch.n_terms[:, None]) & (slots != slot[:, None])
    d_terms = batch.terms.gather(1, slot[:, None])[:, 0]
    return slot, d_terms, active


def _site_ok(source: StaticPostingSource, docs, attr_filter):
    """The ``gather`` strategy's doc->site join (mode "clip" reads)."""
    ds = source.doc_site
    site = ds[docs.clamp(0, ds.shape[0] - 1).long()]
    return (attr_filter[:, None] == NO_ATTR) | (site == attr_filter[:, None])


def _query_topk_torch(source, batch: QueryBatch, *, k, window, attr_strategy):
    """Port of the reference's jnp branch (``_query_topk_one``), batched."""
    _, d_terms, active = _pick_drivers(source, batch)
    docs, attrs, mask = source.driver_window(d_terms, window)
    a_flags = source.driver_flags(docs)
    flags_kw = {} if a_flags is None else {"a_flags": a_flags}
    for s in range(batch.terms.shape[1]):
        m = source.member(docs, batch.terms[:, s], window, **flags_kw)
        mask = mask & (m | ~active[:, s:s + 1])
    f = batch.attr_filter[:, None]
    if attr_strategy == "embed":
        mask = mask & ((f == NO_ATTR) | (attrs == f))
    elif attr_strategy == "gather":
        mask = mask & _site_ok(source, docs, batch.attr_filter)
    return _first_k_by_rank(docs, mask, k)


def _query_topk_kernel(source, batch: QueryBatch, *, k, window, attr_strategy,
                       use_packed=False, compact=False, live_q=None):
    """Port of the reference's ``_query_topk_batch_pallas``: plan + K1 on
    the static index, or K3 + K4 under merge-on-read; the gather join;
    first k.  ``use_packed`` runs K1p, or K3p and K4p, on the twins.

    ``compact`` ports ``_query_topk_batch_pallas_compact`` (whose stages
    ``_compact_prelude``, ``_compact_driver_state`` and ``_compact_finish``
    are the steps before, between and after the kernels here): each kernel
    runs over a host-built work list (:mod:`repro_torch.kernels.worklist`),
    K6 in place of K1, K8 and K7 in place of K3 and K4 (K6p, K8p, K7p with
    ``use_packed``), so inert queries (``live_q`` false), absent term slots
    and empty probe spans get no thread block; inert rows come back
    ``(INVALID_DOC, 0)`` and an all-inert batch launches nothing."""
    from repro_torch.kernels import ops

    if compact:
        join, merge, probe = (ops.intersect_fullstream_compact,
                              ops.merge_windows_compact,
                              ops.intersect_streamed_compact)
        kw = {"live_q": live_q}
    else:
        join, merge, probe = (ops.intersect_fullstream, ops.merge_windows,
                              ops.intersect_streamed)
        kw = {}
    index = source.index
    _, d_terms, active = _pick_drivers(source, batch)
    active = active.to(torch.int32)
    # The main list's span, also under merge-on-read (n_eff is the main
    # length clamped to the window; K3 adds the delta slab).
    span = source.driver_span(d_terms, window)
    # The kernels' fused predicate serves ``embed``; ``site_term`` has
    # rewritten the restriction into a term and ``gather`` joins doc_site
    # below.
    kernel_filter = (
        batch.attr_filter if attr_strategy == "embed"
        else torch.full_like(batch.attr_filter, int(NO_ATTR))
    )
    packed = index.packed if use_packed else None
    if not isinstance(source, MergedPostingSource):
        docs, mask = join(
            span.off, span.n_eff, batch.terms, active, kernel_filter,
            index.postings, index.attrs, index.offsets, index.lengths,
            index.block_max, window=window, packed=packed, **kw,
        )
    else:
        delta = source.delta
        d_packed = delta.packed if use_packed else None
        docs, attrs, src = merge(
            index.postings, index.attrs, span.off, span.n_eff,
            delta.postings, delta.attrs, delta.offsets, delta.lengths,
            delta.block_max, d_terms, window=window,
            packed=packed, d_packed=d_packed, **kw,
        )
        a_flags = source.driver_flags(docs)
        live = source.driver_live(docs, src, a_flags)
        mask = probe(
            docs, attrs, live, batch.terms, active, kernel_filter,
            index.postings, index.offsets, index.lengths, index.block_max,
            delta.postings, delta.offsets, delta.lengths, delta.block_max,
            a_flags, packed=packed, d_packed=d_packed, **kw,
        )
    mask = mask > 0
    if attr_strategy == "gather":
        mask = mask & _site_ok(source, docs, batch.attr_filter)
    return _first_k_by_rank(docs, mask, k)


def _query_windows(source, batch: QueryBatch, *, window, attr_strategy):
    """Stage the batch for K9 (port of the reference's ``_query_windows``):
    per query the driver window, its attribute stream and its live stream
    (None on the static index: all live), every term slot's window
    ``[Q, T_MAX, window]`` and the active slots.

    The driver's slot rides along as an inactive other-term slot.  On the
    static index the driver window is the driver slot's row.  Under
    merge-on-read every other-term window is the merged window with
    tombstones dropped, and the driver is the merged window that keeps them
    with ``live=0``, so K9 applies the tombstone predicate itself."""
    slot, d_terms, active = _pick_drivers(source, batch)
    index = source.index
    if isinstance(source, MergedPostingSource):
        delta = source.delta
        others = merged_term_window(index, delta, batch.terms, window,
                                    drop_dead=True)[0]
        docs, attrs, live = merged_term_window(index, delta, d_terms, window,
                                               drop_dead=False)
    else:
        others = term_window(index, batch.terms, window)[0]
        docs = others.gather(1, slot[:, None, None].expand(-1, 1, window))[:, 0]
        attrs, live = term_window(index, d_terms, window)[1], None
    if attr_strategy == "gather":
        ds = source.doc_site
        attrs = ds[docs.clamp(0, ds.shape[0] - 1).long()]
    return docs, attrs, live, others, active.to(torch.int32)


def _query_topk_staged(source, batch: QueryBatch, *, k, window, attr_strategy):
    """Port of the reference's ``_query_topk_batch_staged``: stage the
    windows (:func:`_query_windows`), one K9 launch, first k.  K9's fused
    predicate serves ``embed`` and ``gather`` (whose attribute stream is the
    driver's ``doc_site``), so no join follows it; ``site_term`` has
    rewritten the restriction into a term and turns the predicate off."""
    from repro_torch.kernels import ops

    docs, attrs, live, others, active = _query_windows(
        source, batch, window=window, attr_strategy=attr_strategy)
    attr_filter = (torch.full_like(batch.attr_filter, int(NO_ATTR))
                   if attr_strategy == "site_term" else batch.attr_filter)
    mask = ops.intersect_batched(docs, attrs, others, active, attr_filter,
                                 a_live=live)
    return _first_k_by_rank(docs, mask > 0, k)


def query_topk(
    index: InvertedIndex,
    batch: QueryBatch,
    *,
    delta=None,
    k: int = 10,
    window: int = 4096,
    attr_strategy: str = "embed",
    backend: str = "kernel",
    codec: str = "raw",
    live_q=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched local top-k on the index's device.  Returns ``(docids[Q, k],
    n_hits[Q])``: local docids ascending (= rank order), INVALID_DOC-padded
    when fewer than k documents match inside the window.

    ``delta`` (a :class:`~repro_torch.indexing.delta.DeltaIndex` on the
    same device) turns on merge-on-read: inserts, updates and deletes are
    visible without touching the main index.

    ``backend="kernel"`` runs K1, or K3 and K4 with a delta (see the module
    docstring); ``"torch"`` runs plain PyTorch ops.  Both equal the
    reference's jnp backend.  ``codec="packed"`` reads the postings from
    the index's (and the delta's) block-codec twin: decoded whole first on
    ``"torch"``, block by block in K1p, K3p and K4p on ``"kernel"``.

    ``backend="kernel_compact"`` runs the same data path through work-list
    compaction (K6, or K8 and K7; their packed modes with ``codec=
    "packed"``): kernel work follows live work instead of the batch's
    shape.  ``live_q`` (bool[Q] on the host, this backend only) marks the
    inert padding queries: their rows come back ``(INVALID_DOC, 0)``
    without a thread block, and an all-inert batch launches nothing.  Equal
    to ``"kernel"`` on live rows.

    ``backend="kernel_staged"`` runs the reference's staged comparator:
    every term slot's window gathered into ``[Q, T_MAX, window]`` (merged
    windows under merge-on-read), then K9; packed postings are decoded
    whole first, as on ``"torch"``.
    """
    if backend != "kernel_compact" and live_q is not None:
        raise ValueError(
            "live_q needs backend='kernel_compact' (the dense kernels "
            "already mask inert queries)")
    if codec not in CODECS:
        raise ValueError(f"unknown codec {codec!r}")
    if codec == "packed":
        if index.packed is None:
            raise ValueError(
                "codec='packed' needs an index carrying its packed twin "
                "(build_index(codec='packed') or pack_index)")
        if delta is not None and delta.packed is None:
            raise ValueError(
                "codec='packed' needs a delta snapshot with a packed twin "
                "(DeltaWriter(codec='packed'))")
    if attr_strategy not in STRATEGIES:
        raise ValueError(f"unknown attr_strategy {attr_strategy!r}")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    if batch.terms.device != index.postings.device:
        raise ValueError(f"batch on {batch.terms.device}, index on "
                         f"{index.postings.device}")
    if delta is not None and delta.postings.device != index.postings.device:
        raise ValueError(f"delta on {delta.postings.device}, index on "
                         f"{index.postings.device}")
    if not 1 <= k <= window:
        raise ValueError(f"need 1 <= k <= window, got k={k}, window={window}")
    if codec == "packed" and backend in ("torch", "kernel_staged"):
        index = index._replace(postings=unpack_flat_postings_torch(index.packed))
        if delta is not None:
            delta = delta._replace(
                postings=unpack_flat_postings_torch(delta.packed))
    source = make_posting_source(index, delta)
    if backend == "torch":
        return _query_topk_torch(source, batch, k=k, window=window,
                                 attr_strategy=attr_strategy)
    if backend == "kernel_staged":
        return _query_topk_staged(source, batch, k=k, window=window,
                                  attr_strategy=attr_strategy)
    return _query_topk_kernel(
        source, batch, k=k, window=window, attr_strategy=attr_strategy,
        use_packed=codec == "packed", compact=backend == "kernel_compact",
        live_q=live_q)


def single_keyword_topk(
    index: InvertedIndex, terms: torch.Tensor, *, k: int = 10
) -> torch.Tensor:
    """The paper's headline fast path: top-k of a single keyword is a
    k-prefix read of the rank-ordered posting list — no join, no sort."""
    docs, _, valid = term_window(index, terms, k)
    return torch.where(valid, docs, _INVALID)


# ---------------------------------------------------------------------------
# Host-side brute-force oracle (for property tests)
# ---------------------------------------------------------------------------

def brute_force_topk(
    corpus, queries: list[tuple[list[int], int | None]], k: int
) -> list[list[int]]:
    """Ground truth by Python set intersection over the raw corpus."""
    docs_of: dict[int, set[int]] = {}
    for d in range(corpus.n_docs):
        for t in corpus.terms_of(d):
            docs_of.setdefault(int(t), set()).add(d)
    out = []
    for ts, site in queries:
        sets = [docs_of.get(int(t), set()) for t in ts]
        docs = set.intersection(*sets) if sets else set()
        if site is not None:
            docs = {d for d in docs if corpus.doc_site[d] == site}
        out.append(sorted(docs)[:k])
    return out
