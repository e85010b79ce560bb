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

:func:`merge_delta_windows_torch` is the plain version (a stable sort over
main then delta), :func:`merge_delta_windows_cuda` wraps
``csrc/delta_merge.cu``, and :func:`merge_delta_windows` picks by device.
"""
from __future__ import annotations

import torch

from repro_torch.core.index import BLOCK, INVALID_ATTR, INVALID_DOC

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
):
    """Merged ``(docs, attrs, src)`` driver windows, each int32[Q, window]:
    the kernel on CUDA tensors, the plain version on CPU tensors."""
    cap = d_block_max.shape[0] * BLOCK // d_offsets.shape[0]
    fn = merge_delta_windows_cuda if postings.is_cuda else merge_delta_windows_torch
    return fn(postings, attrs, m_off.to(torch.int32).contiguous(),
              m_neff.to(torch.int32).contiguous(), d_postings, d_attrs,
              d_offsets, d_lengths, terms.to(torch.int32).contiguous(),
              window=window, cap=cap)
