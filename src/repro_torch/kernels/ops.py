"""Public entry points for the port's kernels, as in ``repro.kernels.ops``.

Each takes its tensors where they lie: a CUDA tensor launches the
hand-written kernel (or raises), a CPU tensor runs the kernel's plain
PyTorch version.  Nothing falls back from one to the other.
"""
from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.delta_merge import (
    merge_delta_windows,
    merge_delta_windows_compact,
)
from repro_torch.kernels.posting_intersect import (
    compute_skip_map,
    driver_tile_spans,
    intersect_batched_block_skip,
    intersect_batched_driver_streamed,
    intersect_batched_driver_streamed_compact,
    intersect_batched_streamed,
    intersect_batched_streamed_compact,
    intersect_block_skip,
    skip_fraction,
    window_tile_spans,
)
from repro_torch.kernels.topk_merge import bitonic_sort, merge_topk, merge_topk_rows


def intersect(a_docs, a_attrs, b_docs, attr_filter=-1):
    """Single-query membership mask of ``a_docs`` in the ascending
    ``b_docs`` with block skipping (K10), fused with validity and the
    attribute predicate (``attr_filter`` >= 0).  Returns int32[len(a_docs)]."""
    return intersect_block_skip(a_docs, a_attrs, b_docs, attr_filter)


def intersect_batched(a_docs, a_attrs, b_docs, active, attr_filter, *,
                      a_live=None):
    """Batched ZigZag join over staged windows (K9): driver windows
    ``a_docs``/``a_attrs`` [Q, W_a], other-term windows ``b_docs`` [Q, T,
    W_b], ``active`` [Q, T], ``attr_filter`` [Q]; ``a_live`` is the
    optional tombstone stream of the driver windows (omitted: all live).
    Returns the mask, int32[Q, W_a]."""
    return intersect_batched_block_skip(a_docs, a_attrs, b_docs, active,
                                        attr_filter, a_live=a_live)


def intersect_fullstream(d_off, d_neff, terms, active, attr_filter,
                         postings, attrs, offsets, lengths, block_max, *,
                         window, packed=None):
    """Fully-streamed batched ZigZag join (K1): the driver window reads
    straight from the flat arrays; with ``packed`` (K1p) every posting read
    comes from the block-codec twin, decoded on the card.  Returns
    ``(docs, mask)``, the driver window plus the join mask, int32[Q, window]."""
    return intersect_batched_driver_streamed(
        d_off, d_neff, terms, active, attr_filter,
        postings, attrs, offsets, lengths, block_max, window=window,
        packed=packed,
    )


def intersect_streamed(a_docs, a_attrs, a_live, terms, active, attr_filter,
                       postings, offsets, lengths, block_max,
                       d_postings=None, d_offsets=None, d_lengths=None,
                       d_block_max=None, a_flags=None, *,
                       packed=None, d_packed=None):
    """Batched ZigZag join over a materialized driver window (K4), other-term
    lists probed in place from the flat arrays; with ``packed`` (and
    ``d_packed`` under merge-on-read: K4p) the probes read the twins.  Pass
    the ``d_*`` delta arrays and ``a_flags`` for merge-on-read; without
    them only the main lists are probed.  Returns the mask, int32[Q, W]."""
    return intersect_batched_streamed(
        a_docs, a_attrs, a_live, terms, active, attr_filter,
        postings, offsets, lengths, block_max,
        d_postings, d_offsets, d_lengths, d_block_max, a_flags,
        packed=packed, d_packed=d_packed,
    )


def merge_windows(postings, attrs, m_off, m_neff, d_postings, d_attrs,
                  d_offsets, d_lengths, d_block_max, terms, *, window,
                  packed=None, d_packed=None):
    """Merge of the main driver windows with the driver terms' delta slabs
    (K3), both read from their flat arrays, or from their twins with
    ``packed`` and ``d_packed`` (K3p; both or neither).  Returns ``(docs,
    attrs, src)``, int32[Q, window]; ``src`` is each slot's stream id, from
    which the caller derives the live stream with the ``doc_flags`` bits."""
    return merge_delta_windows(
        postings, attrs, m_off, m_neff, d_postings, d_attrs,
        d_offsets, d_lengths, d_block_max, terms, window=window,
        packed=packed, d_packed=d_packed,
    )


def intersect_streamed_compact(a_docs, a_attrs, a_live, terms, active,
                               attr_filter, postings, offsets, lengths,
                               block_max, d_postings=None, d_offsets=None,
                               d_lengths=None, d_block_max=None, a_flags=None,
                               *, packed=None, d_packed=None, live_q=None):
    """Work-list compacted :func:`intersect_streamed` (K7, or K7p with the
    twins; static without the delta arrays): one thread block per live
    (query, driver tile) over its probe tiles only.  ``live_q`` is the
    host-side bool[Q] liveness vector (None: every query live); inert rows
    come back 0, and an all-inert batch launches nothing.  Equal to the
    dense join on live rows."""
    return intersect_batched_streamed_compact(
        a_docs, a_attrs, a_live, terms, active, attr_filter,
        postings, offsets, lengths, block_max,
        d_postings, d_offsets, d_lengths, d_block_max, a_flags,
        packed=packed, d_packed=d_packed, live_q=live_q,
    )


def intersect_fullstream_compact(d_off, d_neff, terms, active, attr_filter,
                                 postings, attrs, offsets, lengths, block_max,
                                 *, window, packed=None, live_q=None):
    """Work-list compacted :func:`intersect_fullstream` (K6, or K6p with
    ``packed``).  Inert queries come back as (INVALID_DOC, 0)."""
    return intersect_batched_driver_streamed_compact(
        d_off, d_neff, terms, active, attr_filter,
        postings, attrs, offsets, lengths, block_max,
        window=window, packed=packed, live_q=live_q,
    )


def merge_windows_compact(postings, attrs, m_off, m_neff, d_postings, d_attrs,
                          d_offsets, d_lengths, d_block_max, terms, *, window,
                          packed=None, d_packed=None, live_q=None):
    """Work-list compacted :func:`merge_windows` (K8, or K8p with both
    twins): the merge runs for live queries only, reading the main-window
    tiles their work-list rows name.  Inert queries come back as the empty
    merged window (INVALID_DOC, INVALID_ATTR, src=1)."""
    return merge_delta_windows_compact(
        postings, attrs, m_off, m_neff, d_postings, d_attrs,
        d_offsets, d_lengths, d_block_max, terms,
        window=window, packed=packed, d_packed=d_packed, live_q=live_q,
    )


def sort(x):
    """Ascending sort of a 1-D int32 or float32 vector (K11), padded as the
    reference pads (see :mod:`repro_torch.kernels.topk_merge`)."""
    return bitonic_sort(x)


def topk_merge(cands, k):
    """The global best k of stacked ``(ns, k)`` candidates (K11)."""
    return merge_topk(cands, k)


def topk_merge_rows(cands, k):
    """Row-wise (per-query) top-k merge (K2) — the batched master merge."""
    return merge_topk_rows(cands, k)


__all__ = [
    "intersect",
    "intersect_batched",
    "intersect_streamed",
    "intersect_streamed_compact",
    "intersect_fullstream",
    "intersect_fullstream_compact",
    "merge_windows",
    "merge_windows_compact",
    "window_tile_spans",
    "driver_tile_spans",
    "sort",
    "topk_merge",
    "topk_merge_rows",
    "compute_skip_map",
    "skip_fraction",
    "ref",
]
