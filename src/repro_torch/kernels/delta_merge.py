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
:func:`merge_delta_windows` picks by mode and device.  Both kernels give
each block a chunk of output slots and merge out of shared memory
(``csrc/merge_path.cuh``); :func:`chunk_ranges`, :func:`range_blocks`,
:func:`chunk_rooms` and :func:`merge_chunks_replay` replay their
arithmetic on the host, so that the CPU tests hold it against the plain
version.

K8 and K8p are the work-list twins (the reference's
``_merge_compact_call``, ``pallas_call`` at line 650): one table row per
main-window tile a live query reads (:mod:`repro_torch.kernels.worklist`),
K3's merge for the live queries only (``csrc/merge_compact.cu``: K3's and
K3p's block bodies with a block row a group of the table, the query's
main stream clipped to the group's tiles; K8p's large-cap form is K3p's),
and ``(INVALID_DOC, INVALID_ATTR, 1)`` on the rows of inert queries, as
the reference gives them; :func:`merge_delta_windows_compact` plans and
picks.  :func:`merge_chunks_replay` with ``desc`` and ``heads`` replays
their chunk grid.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.index import (
    BLOCK,
    DESC_PAD,
    INVALID_ATTR,
    INVALID_DOC,
    TILE,
    PackedFlatArrays,
    flat_tile_pad,
    pack_flat_postings,
    unpack_flat_postings_torch,
)
from repro_torch.kernels import registry as _reg
from repro_torch.kernels import work as _wk
from repro_torch.kernels.registry import Access, Work
from repro_torch.kernels.worklist import (
    DESC_COLS,
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
    """Launch K3 (``csrc/delta_merge.cu``) on the current stream: a block
    a chunk of :data:`K3_CHUNK` output slots, one a thread, merging out of
    its staged ranges where they fit the card's shared memory
    (:func:`chunk_fits`), else out of the global streams.  Same signature
    and result as :func:`merge_delta_windows_torch`."""
    from repro_torch.kernels import _build

    q_n = terms.shape[0]
    _build.check_args(
        q_n, postings=(postings, None), attrs=(attrs, postings.shape),
        m_off=(m_off, (q_n,)), m_neff=(m_neff, (q_n,)),
        d_postings=(d_postings, None), d_attrs=(d_attrs, d_postings.shape),
        d_offsets=(d_offsets, None), d_lengths=(d_lengths, d_offsets.shape),
        terms=(terms, (q_n,)))
    dev = postings.device
    docs = torch.empty((q_n, window), dtype=torch.int32, device=dev)
    out_attrs = torch.empty_like(docs)
    src = torch.empty_like(docs)
    if q_n == 0:
        return docs, out_attrs, src
    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    stage = int(chunk_fits(window, cap, optin, packed=False))
    ptr = [x.data_ptr() for x in (postings, attrs, m_off, m_neff, d_postings,
                                  d_attrs, d_offsets, d_lengths, terms, docs,
                                  out_attrs, src)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _build.kernel("delta_merge")(*ptr, q_n, window, d_offsets.shape[0], cap,
                                       stage, stream)
    merge_delta_windows_cuda.launches += 1
    _build.check(err, "delta_merge_launch")
    return docs, out_attrs, src


merge_delta_windows_cuda.launches = 0


#: ``csrc/delta_merge.cu``'s output slots a block for K3 and K3p (one a
#: thread).
K3_CHUNK = K3P_CHUNK = 256
#: ``csrc/merge_compact.cu``'s for K8 and K8p (the same bodies).
K8_CHUNK = K8P_CHUNK = 256


def chunk_ranges(na: int, nb: int, k0: int, chunk: int = K3_CHUNK):
    """The positions the chunk of slots ``[k0, k0 + chunk)`` can read (its
    slots' co-ranks lie in ``[max(0, k - nb), min(k, na)]``), which K3 and
    K3p stage: main ``[max(0, k0 - nb), min(na, k0 + chunk))`` and delta
    ``[max(0, k0 - na), min(nb, k0 + chunk))``."""
    return max(0, k0 - nb), min(na, k0 + chunk), max(0, k0 - na), min(nb, k0 + chunk)


def staged_main(na: int, k0: int, cap: int, chunk: int = K3_CHUNK) -> tuple[int, int]:
    """The main range a chunk at ``k0`` stages before it knows the slab's
    length ``nb`` (so the loads overlap its lookup): every main position
    a slab of at most ``cap`` postings lets it read, ``[max(0, k0 - cap),
    min(na, k0 + chunk))``, which holds :func:`chunk_ranges`' main range."""
    return max(0, k0 - cap), min(na, k0 + chunk)


def range_blocks(p0: int, lo: int, hi: int) -> tuple[int, int]:
    """The codec blocks that hold flat positions ``[p0 + lo, p0 + hi)``:
    ``(first block, count)``, count 0 for an empty range."""
    first = (p0 + lo) // BLOCK
    return first, ((p0 + hi - 1) // BLOCK - first + 1 if hi > lo else 0)


def chunk_rooms(window: int, cap: int, *, packed: bool) -> tuple[int, int]:
    """Ints a block of the chunk form stages a stream, ``(m_room,
    d_room)``: a main range of at most ``min(window, cap + chunk)``
    postings and a delta range of at most ``min(cap, window + chunk)``,
    for K3p the codec blocks that hold such a range starting anywhere.  A
    block uses ``2 * (m_room + d_room)`` ints of shared memory (the
    postings and their attrs)."""
    chunk = K3P_CHUNK if packed else K3_CHUNK
    widths = min(window, cap + chunk), min(cap, window + chunk)
    if packed:
        return tuple((-(-w // BLOCK) + 1) * BLOCK for w in widths)
    return widths


def chunk_fits(window: int, cap: int, optin: int, *, packed: bool) -> bool:
    """Whether the staged ranges of K3 (K3p with ``packed``) fit ``optin``
    bytes of shared memory a block; else K3 merges out of the global
    streams and K3p takes its large-cap form."""
    return 8 * sum(chunk_rooms(window, cap, packed=packed)) <= optin


def staging_check(ranges, na: int, nb: int) -> None:
    """Raise unless the staged main range ``[ilo, ihi)`` and delta range
    ``[jlo, jhi)`` lie inside the live ranges ``[0, na)`` and ``[0, nb)``."""
    ilo, ihi, jlo, jhi = ranges
    if not (0 <= ilo <= ihi <= na and 0 <= jlo <= jhi <= nb):
        raise ValueError(f"staged ranges main [{ilo}, {ihi}) delta [{jlo}, {jhi}) "
                         f"leave the live ranges [0, {na}) and [0, {nb})")


def _merge_staged(a, aa, b, ba, ranges, ks):
    """Host replay of ``merge_staged_slot`` for the slots ``ks`` of one
    chunk, vectorised: ``a``/``aa`` and ``b``/``ba`` are the streams'
    docIDs and attrs, of which only the staged positions ``[ilo, ihi)``
    and ``[jlo, jhi)`` may be read (raises otherwise)."""
    ilo, ihi, jlo, jhi = ranges

    def at(x, pos, lo, hi):
        if pos.size and (pos.min() < lo or pos.max() >= hi):
            raise IndexError(f"a read at {pos.min()}..{pos.max()} leaves the "
                             f"staged range [{lo}, {hi})")
        return x[pos]

    lo = np.maximum(ilo, ks - jhi)
    hi = np.minimum(ihi, ks - jlo)
    while True:
        act = np.nonzero(lo < hi)[0]
        if not act.size:
            break
        mid = (lo[act] + hi[act]) >> 1
        le = at(a, mid, ilo, ihi) <= at(b, ks[act] - mid - 1, jlo, jhi)
        lo[act] = np.where(le, mid + 1, lo[act])
        hi[act] = np.where(le, hi[act], mid)
    i, j = lo, ks - lo
    main = j >= jhi
    both = ~main & (i < ihi)
    main[both] = at(a, i[both], ilo, ihi) <= at(b, j[both], jlo, jhi)
    docs, attrs = np.empty(ks.size, np.int64), np.empty(ks.size, np.int64)
    docs[main], attrs[main] = at(a, i[main], ilo, ihi), at(aa, i[main], ilo, ihi)
    docs[~main] = at(b, j[~main], jlo, jhi)
    attrs[~main] = at(ba, j[~main], jlo, jhi)
    return docs, attrs, (~main).astype(np.int64)


def merge_chunks_replay(postings, attrs, m_off, m_neff, d_postings, d_attrs,
                        d_offsets, d_lengths, terms, *, window: int, cap: int,
                        packed: bool = False, desc=None, heads=None):
    """Host replay of K3 (``packed``: K3p) chunk by chunk: for each query
    and each chunk of slots that starts below ``na + nb``, the staged
    ranges (main :func:`staged_main`, delta :func:`chunk_ranges`), checked
    to stay inside the live ranges (:func:`staging_check`), to hold
    :func:`chunk_ranges` and, as staged (K3p: whole codec blocks), to fit
    the rooms of :func:`chunk_rooms`; then every slot merged reading only
    :func:`chunk_ranges`' positions; slots past ``na + nb`` are ``(INVALID_DOC,
    INVALID_ATTR, 0)``.  The arguments are
    :func:`merge_delta_windows_torch`'s, on any device (for K3p, the twins'
    decodes: the decode itself is the codec's, tested on its own); each
    query's live ranges are copied to the host.

    With a work list's ``desc`` and ``heads`` (both or neither) it replays
    K8 (K8p) instead: the chunk grid over the table's groups, group ``g``
    the query of its head row ``desc[heads[g], 0]``, whose ``na`` is
    clipped to the group's tiles, ``(heads[g + 1] - heads[g]) * TILE``;
    the rows of queries in no group are ``(INVALID_DOC, INVALID_ATTR, 1)``,
    as :func:`merge_compact_torch` gives them.

    Returns ``((docs, attrs, src), stats)``, the outputs int32[Q, window]
    equal to the plain version's, ``stats`` the chunks that read postings,
    the largest staged ranges and (K3p) blocks of any chunk, and the blocks
    decoded in all."""
    if (desc is None) != (heads is None):
        raise ValueError("merge_chunks_replay: desc and heads go together")
    if desc is None:
        chunk = K3P_CHUNK if packed else K3_CHUNK
    else:
        chunk = K8P_CHUNK if packed else K8_CHUNK
    rooms = chunk_rooms(window, cap, packed=packed)
    q_n = terms.shape[0]
    m_off_h, m_neff_h, terms_h, d_off_h, d_len_h = (
        x.cpu().numpy().astype(np.int64)
        for x in (m_off, m_neff, terms, d_offsets, d_lengths))
    n_terms = d_off_h.shape[0]

    def live(flat, start, n):
        return flat[start:start + n].cpu().numpy().astype(np.int64)

    # the [Q, window] outputs, not a flat posting layout
    docs = np.full((q_n, window), _INVALID, np.int64)
    # lint: allow(posting-alloc)
    out_attrs = np.full((q_n, window), int(INVALID_ATTR), np.int64)
    src = np.zeros((q_n, window), np.int64)
    if desc is None:
        blocks = [(q, window) for q in range(q_n)]     # (query, m_cap)
    else:
        heads_h = heads.cpu().numpy().astype(np.int64)
        first_q = desc.cpu().numpy()[heads_h[:-1], 0].astype(np.int64)
        blocks = list(zip(first_q.tolist(), (np.diff(heads_h) * TILE).tolist()))
        src[:] = 1          # inert rows; a group's row is written whole below
    stats = dict(chunks=0, main=0, delta=0, main_blocks=0, delta_blocks=0, blocks=0)
    for q, m_cap in blocks:
        src[q] = 0
        t = int(terms_h[q])
        tt = min(max(t, 0), n_terms - 1)
        na = min(max(int(m_neff_h[q]), 0), window, m_cap)
        nb = 0 if t < 0 else min(max(int(d_len_h[tt]), 0), cap)
        m0, d0 = int(m_off_h[q]), int(d_off_h[tt])
        # the live ranges alone: any read past them raises
        a, aa = live(postings, m0, na), live(attrs, m0, na)
        b, ba = live(d_postings, d0, nb), live(d_attrs, d0, nb)
        for k0 in range(0, min(window, na + nb), chunk):
            ranges = chunk_ranges(na, nb, k0, chunk)
            mlo, mhi = staged_main(na, k0, cap, chunk)
            staged = (mlo, max(mlo, mhi)) + ranges[2:]
            staging_check(staged, na, nb)
            if not (mlo <= ranges[0] and ranges[1] <= max(mlo, mhi)):
                raise ValueError(f"chunk {k0}: main range {ranges[:2]} not staged "
                                 f"in [{mlo}, {mhi})")
            if packed:
                used = (range_blocks(m0, *staged[:2])[1] * BLOCK,
                        range_blocks(d0, *ranges[2:])[1] * BLOCK)
                stats["main_blocks"] = max(stats["main_blocks"], used[0] // BLOCK)
                stats["delta_blocks"] = max(stats["delta_blocks"], used[1] // BLOCK)
                stats["blocks"] += sum(used) // BLOCK
            else:
                used = staged[1] - staged[0], staged[3] - staged[2]
            if used[0] > rooms[0] or used[1] > rooms[1]:
                raise ValueError(f"chunk {k0}: {used} ints overflow the rooms {rooms}")
            stats["chunks"] += 1
            stats["main"] = max(stats["main"], staged[1] - staged[0])
            stats["delta"] = max(stats["delta"], staged[3] - staged[2])
            ks = np.arange(k0, min(k0 + chunk, window, na + nb), dtype=np.int64)
            got = _merge_staged(a, aa, b, ba, ranges, ks)
            for out, g in zip((docs, out_attrs, src), got):
                out[q, ks] = g
    as32 = [torch.from_numpy(x.astype(np.int32)) for x in (docs, out_attrs, src)]
    return tuple(as32), stats


def merge_edge_inputs(window: int, cap: int, *, seed: int = 0, device="cpu"):
    """Synthetic K3/K3p inputs at the chunks' edges, one query a case, each
    with its own main list and its own delta term: equal docIDs of the two
    streams at output slots ``k0 - 1`` (main) and ``k0`` (delta) for the
    chunk starts ``k0`` of :data:`K3_CHUNK` below the window (as far as the
    cap allows); merged lengths ending one slot before, at and inside a
    chunk; ``na = 0`` with a full slab; a full window with no slab; a full
    window and a full slab interleaved at random with ties; an inert
    driver (term -1); ``m_neff`` past the window.  Returns ``(raw, twins)``:
    :func:`merge_delta_windows_torch`'s positional arguments, and the main
    and delta block-codec twins (for K3p: ``(twins[0],) + raw[1:4] +
    (twins[1],) + raw[5:]``)."""
    rng = np.random.default_rng(seed)
    s = K3_CHUNK
    evens = lambda n: 2 * np.arange(n, dtype=np.int64)
    cases = []                      # (main docs, delta docs, m_neff, term live)
    for k0 in range(s, min(window - 1, 4 * s) + 1, s):
        c_d = min(cap - 2, k0 // 3)
        c_m = k0 - 1 - c_d
        if c_m < c_d or c_m >= window:
            continue
        v = 2 * c_m
        tail = v + 1 + evens(min(cap - c_d - 1, 40))
        cases.append((evens(min(window, c_m + 300)),
                      np.r_[evens(c_d) + 1, v, tail], None, True))
    for n in (s - 1, s, s + 81):
        nb = min(cap, n // 3)
        if n - nb <= window:
            cases.append((evens(n - nb), evens(nb) + 1, None, True))
    pick = lambda n, hi: np.sort(rng.choice(hi, n, replace=False))
    cases += [(evens(0), pick(cap, 4 * cap), None, True),
              (evens(window), evens(0), None, True),
              (pick(window, 4 * window), pick(cap, 4 * max(window, cap)), None, True),
              (evens(window // 2), evens(cap // 2), None, False),
              (evens(window), pick(cap // 2, 2 * window), window + 7, True)]
    q_n = len(cases)
    stride = flat_tile_pad(window + BLOCK)
    post = np.full(q_n * stride, _INVALID, np.int32)
    att = np.full(q_n * stride, int(INVALID_ATTR), np.int32)
    d_post = np.full(flat_tile_pad(q_n * cap), _INVALID, np.int32)
    d_att = np.full(d_post.shape[0], int(INVALID_ATTR), np.int32)
    m_off, m_neff, d_len, terms = (np.zeros(q_n, np.int32) for _ in range(4))
    for q, (main, delta, neff, live) in enumerate(cases):
        m_off[q], m_neff[q] = q * stride, len(main) if neff is None else neff
        post[q * stride:q * stride + len(main)] = main
        att[q * stride:q * stride + len(main)] = rng.integers(0, 8, len(main))
        d_post[q * cap:q * cap + len(delta)] = delta
        d_att[q * cap:q * cap + len(delta)] = rng.integers(0, 8, len(delta))
        d_len[q], terms[q] = len(delta), q if live else -1
    d_off = np.arange(q_n, dtype=np.int32) * cap
    raw = tuple(torch.from_numpy(x).to(device) for x in (
        post, att, m_off, m_neff, d_post, d_att, d_off, d_len, terms))
    twins = (pack_flat_postings(raw[0]),
             pack_flat_postings(raw[4], span_blocks=max(DESC_PAD, cap // BLOCK)))
    return raw, twins


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
    """``(m_room, row)``: the per-query decode row of K3p's large-cap form
    (and of K8p) in ints, the main window's blocks (one block more than the
    window, for a start inside a block) and then the delta slab's
    (likewise)."""
    m_room = (-(-window // BLOCK) + 1) * BLOCK
    return m_room, m_room + cap + BLOCK


def merge_delta_windows_packed_cuda(packed, attrs, m_off, m_neff, d_packed,
                                    d_attrs, d_offsets, d_lengths, terms, *,
                                    window: int, cap: int):
    """Launch K3p (``csrc/delta_merge.cu``) on the current stream: the
    chunk form (``delta_merge_packed_kernel``, a block a chunk of
    :data:`K3P_CHUNK` slots) where its staged blocks fit the card's
    shared memory (:func:`chunk_fits`), else the large-cap form
    (``delta_merge_packed_row_kernel``, one block a query, its decode row
    in shared memory or in a global scratch allocated here).  Same
    signature and result as :func:`merge_delta_windows_packed_torch`."""
    from repro_torch.kernels import _build

    q_n = terms.shape[0]
    _build.check_args(
        q_n, **_build.packed_args(packed), attrs=(attrs, (packed.n_blocks * BLOCK,)),
        m_off=(m_off, (q_n,)), m_neff=(m_neff, (q_n,)),
        **_build.packed_args(d_packed, "d_"),
        d_attrs=(d_attrs, (d_packed.n_blocks * BLOCK,)),
        d_offsets=(d_offsets, None), d_lengths=(d_lengths, d_offsets.shape),
        terms=(terms, (q_n,)))
    dev = attrs.device
    docs = torch.empty((q_n, window), dtype=torch.int32, device=dev)
    out_attrs = torch.empty_like(docs)
    src = torch.empty_like(docs)
    if q_n == 0:
        return docs, out_attrs, src
    ptr = [x.data_ptr() for x in (*packed.arrays(), attrs, m_off, m_neff,
                                  *d_packed.arrays(), d_attrs, d_offsets,
                                  d_lengths, terms, docs, out_attrs, src)]
    sizes = (q_n, window, d_offsets.shape[0], cap, packed.n_blocks, d_packed.n_blocks)
    stream = torch.cuda.current_stream(dev).cuda_stream
    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    if chunk_fits(window, cap, optin, packed=True):
        name = "delta_merge_packed"
        err = _build.kernel(name)(*ptr, *sizes, stream)
    else:
        name = "delta_merge_packed_row"
        m_room, row = k3p_row(window, cap)
        scratch = (None if row * 4 <= optin
                   else torch.empty((q_n, row), dtype=torch.int32, device=dev))
        err = _build.kernel(name)(*ptr, None if scratch is None else scratch.data_ptr(),
                                  *sizes, m_room, row, stream)
    merge_delta_windows_packed_cuda.launches += 1
    _build.check(err, name + "_launch")
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
    args = (m_src, attrs, m_off.to(torch.int32).contiguous(),
            m_neff.to(torch.int32).contiguous(), d_src, d_attrs, d_offsets,
            d_lengths, terms.to(torch.int32).contiguous())
    # the packed wrapper's chunk and row forms do the same work
    with _reg.dispatched("delta_merge" if packed is None else "delta_merge_packed", *args,
                         window=window, cap=cap):
        return fn(*args, window=window, cap=cap)


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
    """Launch ``merge_compact_kernel`` of ``csrc/merge_compact.cu`` (K8: a
    block a chunk of :data:`K8_CHUNK` output slots of a live group, merging
    out of its staged ranges where they fit the card's shared memory
    (:func:`chunk_fits`), else out of the global streams) on the current
    stream.  Same signature and result as :func:`merge_compact_torch`."""
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
    dev = postings.device
    out = output_rows(q_n, window, n_groups == q_n, _INERT, dev)
    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    stage = int(chunk_fits(window, cap, optin, packed=False))
    ptr = [x.data_ptr() for x in (desc, heads, postings, attrs, m_off, m_neff,
                                  d_postings, d_attrs, d_offsets, d_lengths,
                                  terms, *out)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = launch(*ptr, n_groups, window, d_offsets.shape[0], cap, stage, stream)
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
    """Launch K8p (``csrc/merge_compact.cu``) on the current stream: the
    chunk form (``merge_compact_packed_kernel``, a block a chunk of
    :data:`K8P_CHUNK` slots of a live group) where its staged blocks fit
    the card's shared memory (:func:`chunk_fits`), else the large-cap form
    (``merge_compact_packed_row_kernel``, one block a live group, its
    decode row in shared memory or in a global scratch allocated here), as
    :func:`merge_delta_windows_packed_cuda` chooses.  Same signature and
    result as :func:`merge_compact_packed_torch`."""
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
    dev = attrs.device
    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    chunked = chunk_fits(window, cap, optin, packed=True)
    name = "merge_compact_packed" if chunked else "merge_compact_packed_row"
    launch = _build.kernel(name)
    out = output_rows(q_n, window, n_groups == q_n, _INERT, dev)
    ptr = [x.data_ptr() for x in (desc, heads, *packed.arrays(), attrs, m_off,
                                  m_neff, *d_packed.arrays(), d_attrs, d_offsets,
                                  d_lengths, terms, *out)]
    sizes = (n_groups, window, d_offsets.shape[0], cap, packed.n_blocks,
             d_packed.n_blocks)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if chunked:
        err = launch(*ptr, *sizes, stream)
    else:
        m_room, row = k3p_row(window, cap)
        scratch = (None if row * 4 <= optin
                   else torch.empty((n_groups, row), dtype=torch.int32, device=dev))
        err = launch(*ptr, None if scratch is None else scratch.data_ptr(), *sizes,
                     m_room, row, stream)
    merge_compact_packed_cuda.launches += 1
    _build.check(err, name + "_launch")
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
    args = (desc, heads, m_src, attrs, m_off.to(torch.int32).contiguous(),
            m_neff.to(torch.int32).contiguous(), d_src, d_attrs, d_offsets,
            d_lengths, terms.to(torch.int32).contiguous())
    with _reg.dispatched("merge_compact" if packed is None else "merge_compact_packed",
                         *args, window=window, cap=cap):
        return fn(*args, window=window, cap=cap)


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


# ---------------------------------------------------------------------------
# Launch contracts (repro_torch.kernels.registry) and the merges' work
# ---------------------------------------------------------------------------
#
# The canonical instances are merge_edge_inputs' chunk-edge cases: at
# window 4096 and cap 256 (the chunk forms, staged), at window 65536 and
# cap 16384 (K3 unstaged, K3p's row form with a global scratch) and at
# window 16384 and cap 16384 (K3p's row form in shared memory).

#: (window, cap) of the canonical merges.
_MAIN, _LARGE, _ROW_SMEM = (4096, 256), (65536, 16384), (16384, 16384)


def _host(x) -> np.ndarray:
    return x.long().reshape(-1).cpu().numpy()


def merge_work(m_src, attrs, m_off, m_neff, d_src, d_attrs, d_offsets, d_lengths,
               terms, *, window: int, cap: int, n_groups: int | None = None,
               table_rows: int = 0) -> Work:
    """K3's (K3p's, with twins) least work: each query's postings that
    reach the output (docID and attr, or their blocks and attrs), five
    int32 a query, three outputs; each output slot's co-rank search
    (``log2(min(na, nb) + 1) + 1`` compares), and four operations a
    decoded posting.  With ``n_groups`` (K8/K8p) the table's bytes too."""
    q_n = terms.shape[0]
    na = m_neff.long().clamp(max=window).cpu()
    start, d_len = _slab(terms, d_offsets, d_lengths, cap)
    nb = d_len.cpu()
    read = int((na + nb).clamp(max=window).sum())
    small = 5 * q_n * 4 + (0 if n_groups is None else 32 * table_rows + 4 * (n_groups + 1))
    out = 3 * q_n * window * 4
    ops = int(sum(min(a + b, window) * (math.ceil(math.log2(min(a, b) + 1)) + 1)
                  for a, b in zip(na.tolist(), nb.tolist())))
    if isinstance(m_src, PackedFlatArrays):
        m_meta = m_src.blk_meta[:m_src.n_blocks].cpu().numpy()
        d_meta = d_src.blk_meta[:d_src.n_blocks].cpu().numpy()
        m_b, m_blk = _wk.span_block_cost(m_off, na, m_meta)
        d_b, d_blk = _wk.span_block_cost(start, d_len, d_meta)
        return Work(m_b + d_b + read * 4 + small + out, ops + 4 * BLOCK * (m_blk + d_blk),
                    "int32")
    return Work(read * 8 + small + out, ops, "int32")


def merge_compact_work(desc, heads, *args, window: int, cap: int) -> Work:
    """K8's (K8p's) least work: K3's on the same streams, and the table."""
    return merge_work(*args, window=window, cap=cap, n_groups=heads.numel() - 1,
                      table_rows=int(heads[-1]))


def _merge_inputs(window: int, cap: int, packed: bool):
    raw, twins = merge_edge_inputs(window, cap)
    if packed:
        return (twins[0],) + raw[1:4] + (twins[1],) + raw[5:]
    return raw


def _merge_operands(args, packed: bool, q_n: int, window: int) -> list:
    """Operands of a merge launch: the flat streams (padded by
    ``flat_tile_pad`` per query slot and per slab array), the query and
    slab arrays, three outputs."""
    m_src, attrs, m_off, m_neff, d_src, d_attrs, d_offsets, d_lengths, terms = args
    ends = _host(m_off) + np.minimum(_host(m_neff), window)
    live = int(-(-ends.max() // BLOCK) * BLOCK) if ends.size else 0
    d_live = int((_host(d_offsets) + _host(d_lengths)).max())
    ops = []
    for prefix, src, a_name, a, lv in (("", m_src, "attrs", attrs, live),
                                       ("d_", d_src, "d_attrs", d_attrs, d_live)):
        if packed:
            ops += _reg.packed_operands(prefix, src)
        else:
            ops.append(_reg.flat_operand(f"{prefix}postings", src, lv))
        ops.append(_reg.flat_operand(a_name, a, lv))
    ops += [_reg.operand(n, x) for n, x in (("m_off", m_off), ("m_neff", m_neff),
                                            ("d_offsets", d_offsets),
                                            ("d_lengths", d_lengths), ("terms", terms))]
    ops += [_reg.Operand(n, "int32", q_n * window)
            for n in ("out_docs", "out_attrs", "out_src")]
    return ops


def _stream_reads(prefix: str, woff, lo: int, hi: int, attrs: str) -> list:
    """A staged range of a stream: its docIDs (raw, or the codec blocks
    that hold them) and its attrs."""
    if hi <= lo:
        return []
    docs = ([Access(f"{prefix}postings", lo, hi)] if woff is None
            else _reg.packed_read(prefix, woff, lo, hi, bulk=False))
    return docs + [Access(attrs, lo, hi)]


class _Queries:
    """Each query's streams on the host, as ``main_stream`` and
    ``delta_length`` of ``csrc/merge_path.cuh`` read them."""

    def __init__(self, args, window: int, cap: int):
        m_src, _, m_off, m_neff, d_src, _, d_offsets, d_lengths, terms = args
        self.m_off, self.m_neff, self.terms = _host(m_off), _host(m_neff), _host(terms)
        self.d_off, self.d_len = _host(d_offsets), _host(d_lengths)
        self.n_terms, self.window, self.cap = self.d_off.size, window, cap
        packed = isinstance(m_src, PackedFlatArrays)
        self.woff = (_host(m_src.blk_woff), _host(d_src.blk_woff)) if packed else (None, None)

    def stream(self, q: int, m_cap: int):
        """``(meta reads, m0, na, d0, nb)`` of query ``q``."""
        t = int(self.terms[q])
        tt = min(max(t, 0), self.n_terms - 1)
        na = min(max(int(self.m_neff[q]), 0), self.window, m_cap)
        nb = 0 if t < 0 else min(max(int(self.d_len[tt]), 0), self.cap)
        meta = [Access("m_off", q, q + 1), Access("m_neff", q, q + 1),
                Access("terms", q, q + 1), Access("d_lengths", tt, tt + 1),
                Access("d_offsets", tt, tt + 1)]
        return meta, int(self.m_off[q]), na, int(self.d_off[tt]), nb


def _chunk_launch(kernel, *, grid, chunk, smem, stage, qs, locate, window, cap):
    """A chunk-form merge launch (``merge_chunk_body`` /
    ``merge_chunk_packed_body``): block (x, y) the chunk of slots ``[x *
    chunk, ...)`` of its row's query; it reads the query's streams, the
    staged main range (``staged_main``, before it knows the slab's
    length), the delta range of ``chunk_ranges`` and, with no slab, its
    slots of the window; it writes its slots of the three outputs."""
    m_woff, d_woff = qs.woff

    def reads(b):
        q, m_cap, extra = locate(b)
        meta, m0, na, d0, nb = qs.stream(q, m_cap)
        k0 = b[0] * chunk
        mlo, mhi = staged_main(na, k0, cap, chunk)
        out = extra + meta
        if stage or m_woff is not None:
            out += _stream_reads("", m_woff, m0 + mlo, m0 + mhi, "attrs")
        n = na + nb
        if k0 >= n:
            return out
        if nb == 0:
            return out + _stream_reads("", m_woff, m0 + k0, m0 + min(k0 + chunk, n), "attrs")
        ilo, ihi, jlo, jhi = chunk_ranges(na, nb, k0, chunk)
        out += _stream_reads("d_", d_woff, d0 + jlo, d0 + jhi, "d_attrs")
        if not stage and m_woff is None:
            out += _stream_reads("", None, m0 + ilo, m0 + ihi, "attrs")
        return out

    def writes(b):
        q, _, _ = locate(b)
        k0 = b[0] * chunk
        hi = min(k0 + chunk, window)
        return [Access(o, q * window + k0, q * window + hi)
                for o in ("out_docs", "out_attrs", "out_src")]

    return _reg.Launch(kernel, grid, chunk, smem, smem > _reg.SMEM_STATIC_LIMIT,
                       reads, writes)


def _row_launch(kernel, *, n_rows, qs, locate, window, cap, scratch):
    """The large-cap form (``packed_merge_row``): one block of
    ``ROW_THREADS`` a query, its whole main window's and slab's blocks
    decoded into a row of shared memory or, past the opt-in limit, of a
    global scratch; it writes the query's three output rows."""
    m_room, row = k3p_row(window, cap)
    m_woff, d_woff = qs.woff

    def reads(b):
        q, m_cap, extra = locate(b)
        meta, m0, na, d0, nb = qs.stream(q, m_cap)
        return (extra + meta + _stream_reads("", m_woff, m0, m0 + na, "attrs")
                + _stream_reads("d_", d_woff, d0, d0 + nb, "d_attrs")
                + ([Access("scratch", b[0] * row, (b[0] + 1) * row)] if scratch else []))

    def writes(b):
        q, _, _ = locate(b)
        out = [Access(o, q * window, (q + 1) * window)
               for o in ("out_docs", "out_attrs", "out_src")]
        return out + ([Access("scratch", b[0] * row, (b[0] + 1) * row)] if scratch else [])

    smem = 0 if scratch else row * 4
    return _reg.Launch(kernel, (n_rows, 1, 1), _reg.ROW_THREADS, smem,
                       smem > _reg.SMEM_STATIC_LIMIT, reads, writes)


def _dense_rows(window):
    return lambda b: (b[1], window, [])


def _dense_row_form(window):
    return lambda b: (b[0], window, [])


def _table_rows(desc, heads, by):
    desc_h, heads_h = desc.long().numpy(), _host(heads)

    def locate(b):
        g = b[by]
        r0 = int(heads_h[g])
        return (int(desc_h[r0, 0]), int(heads_h[g + 1] - r0) * TILE,
                [Access("heads", g, g + 2), Access("desc", 8 * r0, 8 * r0 + 1)])
    return locate


def _merge_instances(name: str):
    """The canonical instances of one merge entry."""
    packed = "packed" in name
    compact = name.startswith("merge_compact")
    row = name.endswith("_row")
    cases = ((_LARGE, _ROW_SMEM) if row else ((_MAIN, _LARGE) if not packed else (_MAIN,)))
    out = []
    for window, cap in cases:
        args = _merge_inputs(window, cap, packed)
        q_n = args[8].numel()
        qs = _Queries(args, window, cap)
        operands = _merge_operands(args, packed, q_n, window)
        call = args
        if compact:
            live_q, wl = (_pow2_merge_live(args[3], window) if (window, cap) == _MAIN
                          else (np.ones(q_n, bool), plan_merge_compact(args[3], window=window)))
            desc, heads = table_to_device(wl, "cpu")
            operands = [_reg.operand("desc", desc, padding_from=wl.n_items * DESC_COLS,
                                     pad="worklist_entry", spare=DESC_COLS),
                        _reg.operand("heads", heads)] + operands
            call = (desc, heads) + args
            n_rows = heads.numel() - 1
        else:
            n_rows = q_n
        chunk = K8_CHUNK if compact else K3_CHUNK
        if row:
            m_room, row_ints = k3p_row(window, cap)
            scratch = row_ints * 4 > _reg.SMEM_OPTIN
            if scratch:
                operands.append(_reg.Operand("scratch", "int32", n_rows * row_ints))
            locate = _table_rows(desc, heads, 0) if compact else _dense_row_form(window)
            launch = _row_launch(f"{'merge_compact' if compact else 'delta_merge'}_packed_row_kernel",
                                 n_rows=n_rows, qs=qs, locate=locate, window=window,
                                 cap=cap, scratch=scratch)
            label = f"window {window}, cap {cap}, row in {'a global scratch' if scratch else 'shared memory'}"
        else:
            stage = chunk_fits(window, cap, _reg.SMEM_OPTIN, packed=packed)
            rooms = (chunk_rooms(window, cap, packed=packed) if stage or packed else (0, 0))
            smem = 8 * sum(rooms)
            locate = _table_rows(desc, heads, 1) if compact else _dense_rows(window)
            kernel = ("merge_compact" if compact else "delta_merge") + (
                "_packed_kernel" if packed else "_kernel")
            launch = _chunk_launch(kernel, grid=(-(-window // chunk), n_rows, 1), chunk=chunk,
                                   smem=smem, stage=stage, qs=qs, locate=locate,
                                   window=window, cap=cap)
            label = f"window {window}, cap {cap}, {'staged' if stage else 'unstaged'}"
        if compact:
            label += f", {wl.n_items} items, live {live_q.tolist()}"
        out.append(_reg.Instance(label, tuple(operands), (launch,), call,
                                 {"window": window, "cap": cap}))
    return out


def _pow2_merge_live(m_neff, window: int):
    """The first ``live_q`` pattern (dropping queries from the front) whose
    merge work list has a power-of-two item count, else all live."""
    q_n = m_neff.numel()
    first = None
    for drop in range(q_n):
        live_q = np.arange(q_n) >= drop
        wl = plan_merge_compact(m_neff, window=window, live_q=live_q)
        first = first or (live_q, wl)
        if wl.n_items & (wl.n_items - 1) == 0:
            return live_q, wl
    return first


def _merge_contract(name, kid, kernels, wrapper, plain, work):
    @_reg.launch_contract(name, kid=kid, kernels=kernels, wrapper=wrapper, plain=plain,
                          work=work)
    def builder():
        return _merge_instances(name)
    return builder


_merge_contract("delta_merge", "K3", ("delta_merge_kernel",), merge_delta_windows_cuda,
                merge_delta_windows_torch, merge_work)
_merge_contract("delta_merge_packed", "K3p", ("delta_merge_packed_kernel",),
                merge_delta_windows_packed_cuda, merge_delta_windows_packed_torch,
                merge_work)
_merge_contract("delta_merge_packed_row", "K3p", ("delta_merge_packed_row_kernel",),
                merge_delta_windows_packed_cuda, merge_delta_windows_packed_torch,
                merge_work)
_merge_contract("merge_compact", "K8", ("merge_compact_kernel",), merge_compact_cuda,
                merge_compact_torch, merge_compact_work)
_merge_contract("merge_compact_packed", "K8p", ("merge_compact_packed_kernel",),
                merge_compact_packed_cuda, merge_compact_packed_torch, merge_compact_work)
_merge_contract("merge_compact_packed_row", "K8p", ("merge_compact_packed_row_kernel",),
                merge_compact_packed_cuda, merge_compact_packed_torch, merge_compact_work)
