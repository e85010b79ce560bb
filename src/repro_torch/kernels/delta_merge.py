"""The merge-on-read driver merge (K3): the main window merged with the
driver term's delta slab.

Replaces the TPU kernel ``repro/kernels/delta_merge.py:merge_delta_windows``
(``pallas_call`` at line 394, body ``_merge_kernel`` at 165).

What it computes, per query ``q``: the main stream is the ``window`` slots
at ``m_off[q]`` of the flat main ``postings``/``attrs``, of which the first
``m_neff[q]`` are live; the delta stream is the first ``d_lengths[t]``
postings of term ``t = terms[q]``'s slab at ``d_offsets[t]`` (``t < 0`` is
an empty slab).  The output is the first ``window`` entries of the
ascending merge, equal docIDs main first (an updated doc has a dead main
posting and a live delta posting under one docID, and the dead one takes
the earlier slot):

- ``docs``: the merged docIDs, INVALID_DOC past the merged length;
- ``attrs``: each posting's embedded attribute, INVALID_ATTR on INVALID
  slots;
- ``src``: 0 = main, 1 = delta, and 0 on every INVALID slot (the main
  stream's INVALID pads sort first among equal keys, and there are at
  least as many of them as INVALID output slots).

The caller turns ``src`` and the tombstone bits into the live stream
(:meth:`repro_torch.core.engine.MergedPostingSource.driver_live`).

K3p is its packed mode (K5, the reference's ``packed=`` / ``d_packed=``,
which go together): both posting streams are read from block-codec twins
and decoded on the card; the attrs stay raw.

:func:`merge_delta_windows_torch` is the plain version (a stable sort over
main then delta), :func:`merge_delta_windows_cuda` wraps K3 in
``csrc/delta_merge.cu``; :func:`merge_delta_windows_packed_torch` (the
full-array decodes, then the plain merge) and
:func:`merge_delta_windows_packed_cuda` are K3p's.
:func:`merge_delta_windows` picks by mode and device.

K8 and K8p are the work-list twins (the reference's
``_merge_compact_call``, ``pallas_call`` at line 650): one table row per
main-window tile a live query reads (:mod:`repro_torch.kernels.worklist`),
K3's merge for the live queries only (``csrc/merge_compact.cu``), and
``(INVALID_DOC, INVALID_ATTR, 1)`` on the rows of inert queries, as the
reference gives them; :func:`merge_delta_windows_compact` plans and picks.
"""
from __future__ import annotations

import torch

from repro_torch.core.index import (
    BLOCK,
    INVALID_ATTR,
    INVALID_DOC,
    TILE,
    PackedFlatArrays,
    unpack_flat_postings_torch,
)
from repro_torch.kernels.worklist import (
    build_merge_worklist,
    live_rows,
    output_rows,
    plan_to_host,
    table_items,
    table_to_device,
)

_INVALID = int(INVALID_DOC)


def _slab(terms, d_offsets, d_lengths, cap):
    """Each query's delta slab: start offset and live length (int64)."""
    tt = terms.clamp(0, d_offsets.shape[0] - 1).long()
    start = d_offsets[tt].long()
    ln = torch.where(terms < 0, torch.zeros_like(terms), d_lengths[tt])
    return start, ln.clamp(max=cap).long()


def _stream(flat_docs, flat_attrs, start, n_live, width):
    """``width`` slots of each query's stream at ``start``, masked by
    position to the first ``n_live``; no read leaves that live range."""
    pos = torch.arange(width, dtype=torch.int64, device=flat_docs.device)
    live = pos < n_live[:, None]
    idx = torch.where(live, start[:, None] + pos, 0)
    docs = torch.where(live, flat_docs[idx], _INVALID)
    attrs = torch.where(live, flat_attrs[idx], int(INVALID_ATTR))
    return docs, attrs


def merge_delta_windows_torch(postings, attrs, m_off, m_neff, d_postings,
                              d_attrs, d_offsets, d_lengths, terms, *,
                              window: int, cap: int):
    """Plain PyTorch version: ``torch.sort(stable=True)`` over the main
    window followed by the delta slab.  Returns ``(docs, attrs, src)``,
    each int32[Q, window]."""
    m_docs, m_attrs = _stream(postings, attrs, m_off.long(), m_neff.long(), window)
    start, d_len = _slab(terms, d_offsets, d_lengths, cap)
    d_docs, d_attrs_ = _stream(d_postings, d_attrs, start, d_len, cap)
    return _merge_rows(m_docs, m_attrs, d_docs, d_attrs_)


def _merge_rows(m_docs, m_attrs, d_docs, d_attrs):
    """The first ``W`` slots of the stable merge of the main rows (``W``
    wide) followed by the delta rows: ``(docs, attrs, src)``."""
    window = m_docs.shape[1]
    docs, order = torch.cat([m_docs, d_docs], dim=-1).sort(dim=-1, stable=True)
    order = order[:, :window]
    out_attrs = torch.cat([m_attrs, d_attrs], dim=-1).gather(-1, order)
    src = (order >= window).to(torch.int32)
    return (docs[:, :window].contiguous(), out_attrs.contiguous(),
            src.contiguous())


def merge_delta_windows_cuda(postings, attrs, m_off, m_neff, d_postings,
                             d_attrs, d_offsets, d_lengths, terms, *,
                             window: int, cap: int):
    """Launch ``csrc/delta_merge.cu`` (one thread per output slot) on the
    current stream.  Same signature and result as
    :func:`merge_delta_windows_torch`."""
    from repro_torch.kernels import _build

    q_n = terms.shape[0]
    _build.check_args(
        q_n, postings=(postings, None), attrs=(attrs, postings.shape),
        m_off=(m_off, (q_n,)), m_neff=(m_neff, (q_n,)),
        d_postings=(d_postings, None), d_attrs=(d_attrs, d_postings.shape),
        d_offsets=(d_offsets, None), d_lengths=(d_lengths, d_offsets.shape),
        terms=(terms, (q_n,)))
    launch = _build.kernel("delta_merge")
    docs = torch.empty((q_n, window), dtype=torch.int32, device=postings.device)
    out_attrs = torch.empty_like(docs)
    src = torch.empty_like(docs)
    if q_n == 0:
        return docs, out_attrs, src
    ptr = [x.data_ptr() for x in (postings, attrs, m_off, m_neff, d_postings,
                                  d_attrs, d_offsets, d_lengths, terms, docs,
                                  out_attrs, src)]
    stream = torch.cuda.current_stream(postings.device).cuda_stream
    err = launch(*ptr, q_n, window, d_offsets.shape[0], cap, stream)
    merge_delta_windows_cuda.launches += 1
    _build.check(err, "delta_merge_launch")
    return docs, out_attrs, src


merge_delta_windows_cuda.launches = 0


def merge_delta_windows_packed_torch(packed, attrs, m_off, m_neff, d_packed,
                                     d_attrs, d_offsets, d_lengths, terms, *,
                                     window: int, cap: int):
    """Plain version of K3p: the full-array decodes of both twins, then the
    plain merge (:func:`merge_delta_windows_torch`)."""
    return merge_delta_windows_torch(
        unpack_flat_postings_torch(packed), attrs, m_off, m_neff,
        unpack_flat_postings_torch(d_packed), d_attrs, d_offsets, d_lengths,
        terms, window=window, cap=cap)


def k3p_row(window: int, cap: int) -> tuple[int, int]:
    """``(m_room, row)``: K3p's per-query decode row in ints, the main
    window's blocks (one block more than the window, for a start inside a
    block) and then the delta slab's (likewise)."""
    m_room = (-(-window // BLOCK) + 1) * BLOCK
    return m_room, m_room + cap + BLOCK


def merge_delta_windows_packed_cuda(packed, attrs, m_off, m_neff, d_packed,
                                    d_attrs, d_offsets, d_lengths, terms, *,
                                    window: int, cap: int):
    """Launch ``delta_merge_packed_kernel`` of ``csrc/delta_merge.cu`` (K3p:
    one block per query) on the current stream: its decode row in dynamic
    shared memory when it fits, else in a global scratch allocated here
    (the kernel's second form).  Same signature and result as
    :func:`merge_delta_windows_packed_torch`."""
    from repro_torch.kernels import _build

    q_n = terms.shape[0]
    _build.check_args(
        q_n, **_build.packed_args(packed), attrs=(attrs, (packed.n_blocks * BLOCK,)),
        m_off=(m_off, (q_n,)), m_neff=(m_neff, (q_n,)),
        **_build.packed_args(d_packed, "d_"),
        d_attrs=(d_attrs, (d_packed.n_blocks * BLOCK,)),
        d_offsets=(d_offsets, None), d_lengths=(d_lengths, d_offsets.shape),
        terms=(terms, (q_n,)))
    launch = _build.kernel("delta_merge_packed")
    dev = attrs.device
    docs = torch.empty((q_n, window), dtype=torch.int32, device=dev)
    out_attrs = torch.empty_like(docs)
    src = torch.empty_like(docs)
    if q_n == 0:
        return docs, out_attrs, src
    m_room, row = k3p_row(window, cap)
    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    scratch = (None if row * 4 <= optin
               else torch.empty((q_n, row), dtype=torch.int32, device=dev))
    ptr = [x.data_ptr() for x in (*packed.arrays(), attrs, m_off, m_neff,
                                  *d_packed.arrays(), d_attrs, d_offsets,
                                  d_lengths, terms, docs, out_attrs, src)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = launch(*ptr, None if scratch is None else scratch.data_ptr(), q_n,
                 window, d_offsets.shape[0], cap, packed.n_blocks,
                 d_packed.n_blocks, m_room, row, stream)
    merge_delta_windows_packed_cuda.launches += 1
    _build.check(err, "delta_merge_packed_launch")
    return docs, out_attrs, src


merge_delta_windows_packed_cuda.launches = 0


def merge_delta_windows(
    postings: torch.Tensor,     # int32[P] flat main postings
    attrs: torch.Tensor,        # int32[P] flat main attrs
    m_off: torch.Tensor,        # int32[Q] driver window start (BLOCK-aligned)
    m_neff: torch.Tensor,       # int32[Q] live main postings (<= window)
    d_postings: torch.Tensor,   # int32[D] flat delta postings
    d_attrs: torch.Tensor,      # int32[D] flat delta attrs
    d_offsets: torch.Tensor,    # int32[n_terms]
    d_lengths: torch.Tensor,    # int32[n_terms]
    d_block_max: torch.Tensor,  # int32[n_terms * cap / BLOCK] (gives cap)
    terms: torch.Tensor,        # int32[Q] driver term per query
    *,
    window: int,
    packed: PackedFlatArrays | None = None,
    d_packed: PackedFlatArrays | None = None,
):
    """Merged ``(docs, attrs, src)`` driver windows, each int32[Q, window]:
    the kernel on CUDA tensors, the plain version on CPU tensors.  With
    ``packed`` and ``d_packed`` (both or neither) the postings are read
    from the twins (K3p), and ``postings`` and ``d_postings`` are not
    read."""
    if (packed is None) != (d_packed is None):
        raise ValueError("merge_delta_windows: packed and d_packed go together")
    cap = d_block_max.shape[0] * BLOCK // d_offsets.shape[0]
    if packed is None:
        fn = (merge_delta_windows_cuda if postings.is_cuda
              else merge_delta_windows_torch)
        m_src, d_src = postings, d_postings
    else:
        fn = (merge_delta_windows_packed_cuda if packed.words.is_cuda
              else merge_delta_windows_packed_torch)
        m_src, d_src = packed, d_packed
    return fn(m_src, attrs, m_off.to(torch.int32).contiguous(),
              m_neff.to(torch.int32).contiguous(), d_src, d_attrs,
              d_offsets, d_lengths, terms.to(torch.int32).contiguous(),
              window=window, cap=cap)


# ---------------------------------------------------------------------------
# K8: the merge over a work list (work-list compaction)
# ---------------------------------------------------------------------------

_INERT = (_INVALID, int(INVALID_ATTR), 1)   # an inert query's (docs, attrs, src)


def merge_compact_torch(desc, heads, postings, attrs, m_off, m_neff, d_postings,
                        d_attrs, d_offsets, d_lengths, terms, *, window: int,
                        cap: int):
    """Plain version of K8, executing the descriptor table: each live
    query's main window assembled from the tiles its rows name (masked to
    its live range), then the plain merge with its delta slab.  Inert rows
    are ``(INVALID_DOC, INVALID_ATTR, 1)``.  Returns ``(docs, attrs,
    src)``, each int32[Q, window]."""
    items, group, gq, _ = table_items(desc, heads)
    dev = postings.device
    n_groups, s_w = gq.shape[0], -(-window // TILE)
    q = items[:, 0]
    pos = items[:, 1:2] * TILE + torch.arange(TILE, device=dev)
    live = pos < m_neff[q].long().clamp(0, window)[:, None]
    idx = torch.where(live, m_off[q].long()[:, None] + pos, 0)
    m_docs = torch.full((n_groups, s_w * TILE), _INVALID, dtype=torch.int32,
                        device=dev)
    m_attrs = torch.full_like(m_docs, int(INVALID_ATTR))
    m_docs[group[:, None], pos] = torch.where(live, postings[idx], _INVALID)
    m_attrs[group[:, None], pos] = torch.where(live, attrs[idx], int(INVALID_ATTR))
    start, d_len = _slab(terms[gq], d_offsets, d_lengths, cap)
    d_docs, d_attrs_ = _stream(d_postings, d_attrs, start, d_len, cap)
    merged = _merge_rows(m_docs[:, :window], m_attrs[:, :window], d_docs, d_attrs_)
    out = output_rows(terms.shape[0], window, False, _INERT, dev)
    for o, m in zip(out, merged):
        o[gq] = m
    return tuple(out)


def merge_compact_cuda(desc, heads, postings, attrs, m_off, m_neff, d_postings,
                       d_attrs, d_offsets, d_lengths, terms, *, window: int,
                       cap: int):
    """Launch ``csrc/merge_compact.cu`` (K8: one thread per output slot of
    each live query) on the current stream.  Same signature and result as
    :func:`merge_compact_torch`."""
    from repro_torch.kernels import _build

    q_n = terms.shape[0]
    n_groups = heads.shape[0] - 1
    _build.check_args(
        q_n, desc=(desc, (desc.shape[0], 8)), heads=(heads, None),
        postings=(postings, None), attrs=(attrs, postings.shape),
        m_off=(m_off, (q_n,)), m_neff=(m_neff, (q_n,)),
        d_postings=(d_postings, None), d_attrs=(d_attrs, d_postings.shape),
        d_offsets=(d_offsets, None), d_lengths=(d_lengths, d_offsets.shape),
        terms=(terms, (q_n,)))
    launch = _build.kernel("merge_compact")
    out = output_rows(q_n, window, n_groups == q_n, _INERT, postings.device)
    ptr = [x.data_ptr() for x in (desc, heads, postings, attrs, m_off, m_neff,
                                  d_postings, d_attrs, d_offsets, d_lengths,
                                  terms, *out)]
    stream = torch.cuda.current_stream(postings.device).cuda_stream
    err = launch(*ptr, n_groups, window, d_offsets.shape[0], cap, stream)
    merge_compact_cuda.launches += 1
    _build.check(err, "merge_compact_launch")
    return tuple(out)


merge_compact_cuda.launches = 0


def merge_compact_packed_torch(desc, heads, packed, attrs, m_off, m_neff,
                               d_packed, d_attrs, d_offsets, d_lengths, terms,
                               *, window: int, cap: int):
    """Plain version of K8p: the full-array decodes of both twins, then the
    raw plain version (:func:`merge_compact_torch`)."""
    return merge_compact_torch(
        desc, heads, unpack_flat_postings_torch(packed), attrs, m_off, m_neff,
        unpack_flat_postings_torch(d_packed), d_attrs, d_offsets, d_lengths,
        terms, window=window, cap=cap)


def merge_compact_packed_cuda(desc, heads, packed, attrs, m_off, m_neff,
                              d_packed, d_attrs, d_offsets, d_lengths, terms,
                              *, window: int, cap: int):
    """Launch ``merge_compact_packed_kernel`` of ``csrc/merge_compact.cu``
    (K8p: K3p's decode row, one block per live query) on the current
    stream: the row in dynamic shared memory when it fits, else in a global
    scratch row per live query.  Same signature and result as
    :func:`merge_compact_packed_torch`."""
    from repro_torch.kernels import _build

    q_n = terms.shape[0]
    n_groups = heads.shape[0] - 1
    _build.check_args(
        q_n, desc=(desc, (desc.shape[0], 8)), heads=(heads, None),
        **_build.packed_args(packed), attrs=(attrs, (packed.n_blocks * BLOCK,)),
        m_off=(m_off, (q_n,)), m_neff=(m_neff, (q_n,)),
        **_build.packed_args(d_packed, "d_"),
        d_attrs=(d_attrs, (d_packed.n_blocks * BLOCK,)),
        d_offsets=(d_offsets, None), d_lengths=(d_lengths, d_offsets.shape),
        terms=(terms, (q_n,)))
    launch = _build.kernel("merge_compact_packed")
    dev = attrs.device
    out = output_rows(q_n, window, n_groups == q_n, _INERT, dev)
    m_room, row = k3p_row(window, cap)
    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    scratch = (None if row * 4 <= optin
               else torch.empty((n_groups, row), dtype=torch.int32, device=dev))
    ptr = [x.data_ptr() for x in (desc, heads, *packed.arrays(), attrs, m_off,
                                  m_neff, *d_packed.arrays(), d_attrs, d_offsets,
                                  d_lengths, terms, *out)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = launch(*ptr, None if scratch is None else scratch.data_ptr(), n_groups,
                 window, d_offsets.shape[0], cap, packed.n_blocks,
                 d_packed.n_blocks, m_room, row, stream)
    merge_compact_packed_cuda.launches += 1
    _build.check(err, "merge_compact_packed_launch")
    return tuple(out)


merge_compact_packed_cuda.launches = 0


def merge_delta_windows_compact(
    postings, attrs, m_off, m_neff, d_postings, d_attrs, d_offsets, d_lengths,
    d_block_max, terms, *,
    window: int,
    packed: PackedFlatArrays | None = None,
    d_packed: PackedFlatArrays | None = None,
    live_q=None,                # bool[Q] on the host; None = every query live
):
    """Work-list compacted :func:`merge_delta_windows`: the same ``(docs,
    attrs, src)`` on live rows, ``(INVALID_DOC, INVALID_ATTR, 1)`` on the
    rows of inert queries.  ``m_neff`` is pulled to the host, compiled into
    one row per live main-window tile
    (:func:`~repro_torch.kernels.worklist.build_merge_worklist`), uploaded
    in one copy, and K8 (K8p with ``packed`` and ``d_packed``, both or
    neither) runs over it.  An all-inert batch launches nothing."""
    if (packed is None) != (d_packed is None):
        raise ValueError("merge_delta_windows_compact: packed and d_packed go together")
    q_n = terms.shape[0]
    dev = attrs.device
    wl = plan_merge_compact(m_neff, window=window, live_q=live_q,
                            packed=packed is not None)
    if wl.n_items == 0:
        return tuple(output_rows(q_n, window, False, _INERT, dev))
    desc, heads = table_to_device(wl, dev)
    cap = d_block_max.shape[0] * BLOCK // d_offsets.shape[0]
    if packed is None:
        fn = merge_compact_cuda if postings.is_cuda else merge_compact_torch
        m_src, d_src = postings, d_postings
    else:
        fn = (merge_compact_packed_cuda if packed.words.is_cuda
              else merge_compact_packed_torch)
        m_src, d_src = packed, d_packed
    return fn(desc, heads, m_src, attrs, m_off.to(torch.int32).contiguous(),
              m_neff.to(torch.int32).contiguous(), d_src, d_attrs, d_offsets,
              d_lengths, terms.to(torch.int32).contiguous(), window=window,
              cap=cap)


def plan_merge_compact(m_neff, *, window: int, live_q=None, packed: bool = False):
    """K8's work list: ``m_neff`` pulled to the host and compiled into one
    row per live main-window tile by
    :func:`~repro_torch.kernels.worklist.build_merge_worklist` (metrics
    named for K8p when ``packed``)."""
    q_n = m_neff.shape[0]
    s_w = -(-window // TILE)
    (m_neff_h,) = plan_to_host(m_neff)
    return build_merge_worklist(
        m_neff_h, tile=TILE, s_w=s_w, live_q=live_rows(live_q, q_n),
        kernel="merge_delta_windows_compact" + ("_packed" if packed else ""),
        dense_steps=q_n * s_w,
    )
