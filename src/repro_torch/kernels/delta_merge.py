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
"""
from __future__ import annotations

import torch

from repro_torch.core.index import (
    BLOCK,
    INVALID_ATTR,
    INVALID_DOC,
    PackedFlatArrays,
    unpack_flat_postings_torch,
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
    keys = torch.cat([m_docs, d_docs], dim=-1)
    docs, order = keys.sort(dim=-1, stable=True)
    order = order[:, :window]
    out_attrs = torch.cat([m_attrs, d_attrs_], dim=-1).gather(-1, order)
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
