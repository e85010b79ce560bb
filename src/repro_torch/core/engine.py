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

Two backends, both bit-identical to the reference's ``backend="jnp"``:

- ``"torch"``  — plain PyTorch ops: the port of the jnp branch, batched
  over queries instead of ``vmap``-ed;
- ``"kernel"`` — the port of the static branch of the reference's
  ``_query_topk_batch_pallas``: driver pick, driver span, the K1 join
  (:func:`repro_torch.kernels.ops.intersect_fullstream`), the ``gather``
  join on the device, then the first k.  On a CPU tensor K1 runs its plain
  version, so this backend is tested here too.

The merge-on-read path (a delta index) comes with its own slice.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.index import (
    INVALID_ATTR,
    INVALID_DOC,
    IndexMeta,
    InvertedIndex,
    resolve_device,
    site_term_id,
)
from repro_torch.obs.registry import get_registry

NO_TERM = np.int32(-1)
NO_ATTR = np.int32(-1)
BACKENDS = ("torch", "kernel")
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
    extra join term (Fig 1(d)) and ``attr_filter`` stays empty.  This runs
    host-side, so it is where the engine's batch-construction counters live.
    """
    dev = resolve_device(device)
    reg = get_registry()
    reg.counter(
        "odys_engine_batches_built_total",
        help="query batches constructed for the device",
    ).inc()
    reg.counter(
        "odys_engine_batch_queries_total",
        help="query slots (incl. padding) across built batches",
    ).inc(len(queries))
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
    return QueryBatch(*(torch.from_numpy(x).to(dev) for x in (terms, n_terms, attr)))


# ---------------------------------------------------------------------------
# Windowed posting access (batched over any leading shape of ``term``)
# ---------------------------------------------------------------------------

def term_window(index: InvertedIndex, term: torch.Tensor, window: int):
    """``(docids, attrs, valid)``, each ``[..., window]``, for each term.

    Reads past the flat arrays give INVALID_DOC / INVALID_ATTR, docIDs past
    the list's length are INVALID_DOC, and attrs are not masked (as in the
    reference)."""
    t = term.clamp(0, index.offsets.shape[0] - 1).long()
    off = index.offsets[t].long()
    ln = torch.where(term < 0, torch.zeros_like(term), index.lengths[t])
    pos = torch.arange(window, dtype=torch.int64, device=term.device)
    idx = off[..., None] + pos
    inside = idx < index.postings.shape[0]
    idx = idx.clamp(max=index.postings.shape[0] - 1)
    docs = torch.where(inside, index.postings[idx], _INVALID)
    attrs = torch.where(inside, index.attrs[idx], int(INVALID_ATTR))
    valid = pos < ln[..., None]
    docs = torch.where(valid, docs, _INVALID).to(torch.int32)
    return docs, attrs.to(torch.int32), valid


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

    def member(self, a_docs: torch.Tensor, term: torch.Tensor, window: int):
        """Membership of each driver posting in the term's bounded window."""
        b_docs, _, _ = term_window(self.index, term, window)
        return member_sorted(a_docs, b_docs)


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
    for s in range(batch.terms.shape[1]):
        m = source.member(docs, batch.terms[:, s], window)
        mask = mask & (m | ~active[:, s:s + 1])
    f = batch.attr_filter[:, None]
    if attr_strategy == "embed":
        mask = mask & ((f == NO_ATTR) | (attrs == f))
    elif attr_strategy == "gather":
        mask = mask & _site_ok(source, docs, batch.attr_filter)
    return _first_k_by_rank(docs, mask, k)


def _query_topk_kernel(source, batch: QueryBatch, *, k, window, attr_strategy):
    """Port of the static branch of the reference's
    ``_query_topk_batch_pallas``: plan + K1, the gather join, first k."""
    from repro_torch.kernels import ops

    index = source.index
    _, d_terms, active = _pick_drivers(source, batch)
    span = source.driver_span(d_terms, window)
    # K1's fused predicate serves ``embed``; ``site_term`` has rewritten the
    # restriction into a term and ``gather`` joins doc_site below.
    kernel_filter = (
        batch.attr_filter if attr_strategy == "embed"
        else torch.full_like(batch.attr_filter, int(NO_ATTR))
    )
    docs, mask = ops.intersect_fullstream(
        span.off, span.n_eff, batch.terms, active.to(torch.int32),
        kernel_filter, index.postings, index.attrs, index.offsets,
        index.lengths, index.block_max, window=window,
    )
    mask = mask > 0
    if attr_strategy == "gather":
        mask = mask & _site_ok(source, docs, batch.attr_filter)
    return _first_k_by_rank(docs, mask, k)


def query_topk(
    index: InvertedIndex,
    batch: QueryBatch,
    *,
    k: int = 10,
    window: int = 4096,
    attr_strategy: str = "embed",
    backend: str = "kernel",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched local top-k on the index's device.  Returns ``(docids[Q, k],
    n_hits[Q])``: local docids ascending (= rank order), INVALID_DOC-padded
    when fewer than k documents match inside the window.

    ``backend="kernel"`` runs K1 (see the module docstring); ``"torch"``
    runs plain PyTorch ops.  Both equal the reference's jnp backend.
    """
    if attr_strategy not in STRATEGIES:
        raise ValueError(f"unknown attr_strategy {attr_strategy!r}")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    if batch.terms.device != index.postings.device:
        raise ValueError(f"batch on {batch.terms.device}, index on "
                         f"{index.postings.device}")
    if not 1 <= k <= window:
        raise ValueError(f"need 1 <= k <= window, got k={k}, window={window}")
    fn = _query_topk_kernel if backend == "kernel" else _query_topk_torch
    return fn(StaticPostingSource(index), batch, k=k, window=window,
              attr_strategy=attr_strategy)


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
