"""The slave joins: ZigZag posting-list intersection with posting
skipping, K1 on the static index and K4 under merge-on-read.

K1 replaces the TPU kernel
``repro/kernels/posting_intersect.py:intersect_batched_driver_streamed``
(``pallas_call`` at line 1207, body ``_driver_streamed_kernel`` at 996).

What it computes, per query ``q``: the driver window is the ``window``
slots that start at ``d_off[q]`` in the flat ``postings``/``attrs`` arrays,
of which the first ``d_neff[q]`` are live.  A live driver posting survives
(``mask = 1``) when it is a member of every active other term's *bounded*
window (that term's first ``window`` postings) and, when
``attr_filter[q] >= 0``, its embedded attribute equals the filter.

Posting skipping: before the launch, the probe plan (:func:`_probe_plan`,
plain torch on the device, as JAX computes it outside its kernel) derives
from the BLOCK skip table, for every (query, term, 1024-posting driver
tile), the run of physical tiles ``b_tile .. b_tile + n_b - 1`` whose docID
span can overlap the driver tile; ``bounds`` clips them to the term's
window.  Only those postings are ever read.

K4 replaces ``repro/kernels/posting_intersect.py:intersect_batched_streamed``
(``pallas_call`` at line 958, body ``_streamed_kernel`` at 699).  Its
driver is materialized: the merged window K3 emits, with its attrs, live
stream and tombstone flags.  The plans come from the exact spans of the
driver tiles (:func:`_a_tile_spans`), one over the main lists at
``window`` and one over the delta slabs at ``cap``.  A live driver slot
joins a term when it is in the main probe range and its doc is neither
DEAD nor SUPERSEDED, or in the delta probe range and its doc is not DEAD.

K1p and K4p are their packed modes (K5, the reference's ``packed=`` /
``d_packed=``): the same joins, with every posting read (K1p's driver and
probes, K4p's main and delta probes) taken from a block-codec twin
(:class:`~repro_torch.core.index.PackedFlatArrays`) that the kernel decodes
block by block on the card (``csrc/decode.cuh``).  The plans are the raw
modes', from the raw skip tables.  A packed kernel's entry point takes no
raw posting array.

K6 and K7 are their work-list twins (the reference's
``_driver_compact_call``, ``pallas_call`` at line 1762, and
``_streamed_compact_call``, at line 1500), K6p and K7p their packed
modes: the plan is pulled to the host in one copy, compiled into a
descriptor table of live work items (:mod:`repro_torch.kernels.worklist`)
and uploaded in one copy, and each (query, driver tile) group of the table
runs K1's (K4's) block body over its driver tile, its streams derived from
the group's rows on the card (:func:`table_streams` states that
derivation).  Inert queries (``live_q`` false) have no group and come back
as ``(INVALID_DOC, 0)`` (K6) or 0 (K7); an all-inert batch launches
nothing.  Their plain versions execute the same table.

K4 and K7 also run without the delta arrays (their static mode, as the
reference's ``has_delta = d_postings is not None``): a driver slot then
joins a term when it is in the term's main window, and only the main
probe runs.  This is a switch of the same kernels, not a second kernel.

K9 and K10 replace the staged joins
``repro/kernels/posting_intersect.py:intersect_batched_block_skip``
(``pallas_call`` at line 533, body ``_intersect_batched_kernel`` at 409)
and ``intersect_block_skip`` (``pallas_call`` at line 396, body
``_intersect_kernel`` at 92).  Their B operand is a materialized window
(K9: ``[Q, T, W_b]``, staged by the engine's ``kernel_staged`` backend;
K10: one list), and :func:`compute_skip_map` gives each driver tile the
run of B tiles whose docID span can overlap it, on the device.  K9 runs
``csrc/staged_join.cu``: K4's static block body and asynchronous probe,
each term's one stream its skip range in the flat windows
(:func:`skip_streams` states them on the host); K10 runs the same body at
Q = T = 1 from the same source.

For each kernel the module holds the plan helpers, the plain PyTorch join
(:func:`driver_streamed_join_torch`, :func:`streamed_join_torch`, and for
the packed modes the full-array decode followed by those: what the CPU
runs, and the reference the card's kernel is held against) and the
wrapper of its CUDA source (:func:`driver_streamed_join_cuda` and
:func:`driver_streamed_join_packed_cuda` of ``csrc/driver_streamed.cu``,
:func:`streamed_join_cuda` and :func:`streamed_join_packed_cuda` of
``csrc/streamed_join.cu``, and so on for K6, K7, K9 and K10).  The
dispatchers pick by the device of the tensors they are given; there is no
fallback.  K1, K4, K6, K7 and K9 (and their packed and static modes)
stage their probe ranges with bulk copies of whole 16-byte chunks, each
range's ends rounded out to them: the wrappers refuse an array that does
not start on 16 bytes or hold whole chunks, and :func:`probe_staging_check` checks
that a plan's ranges (:func:`ranges_staging_check`: a work list's or
K9's streams) start on 16 bytes and end, rounded, inside their arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.index import (
    BLOCK,
    DOC_DEAD,
    DOC_SUPERSEDED,
    INVALID_ATTR,
    INVALID_DOC,
    TILE,
    PackedFlatArrays,
    pack_flat_postings,
    unpack_flat_postings_torch,
)
from repro_torch.kernels import registry as _reg
from repro_torch.kernels import work as _wk
from repro_torch.kernels.registry import Access, Work
from repro_torch.kernels.worklist import (
    FLAG_TERM_START,
    build_intersect_worklist,
    live_rows,
    output_rows,
    plan_to_host,
    table_items,
    table_to_device,
)

_NEG = -(2**31)  # below every docID; span sentinel
_INVALID = int(INVALID_DOC)


def _take_fill(flat: torch.Tensor, idx: torch.Tensor, fill: int) -> torch.Tensor:
    """``jnp.take(flat, idx, mode="fill", fill_value=fill)``: out-of-range
    indices read ``fill`` (torch has no fill mode: clamp, then ``where``)."""
    ok = (idx >= 0) & (idx < flat.shape[0])
    vals = flat[idx.clamp(0, max(flat.shape[0] - 1, 0)).long()]
    return torch.where(ok, vals, torch.full_like(vals, fill))


def window_tile_spans(
    block_max: torch.Tensor, off: torch.Tensor, n_eff: torch.Tensor,
    *, s_tiles: int,
):
    """Physical-tile spans of the logical windows ``[off, off + n_eff)``.

    Batched over any leading shape of ``off``/``n_eff``.  Returns
    ``(tile0, n_tiles, tile_min[..., s_tiles], tile_max[..., s_tiles])``:
    the first TILE-aligned tile touching the window, how many tiles it
    spans, and conservative per-tile docID bounds (ascending, INVALID past
    the window).  ``tile_min[s]`` is the previous tile's max.
    """
    bpt = TILE // BLOCK
    dev = off.device
    hi = off + n_eff
    tile0 = off // TILE
    n_tiles = torch.where(n_eff > 0, (hi + TILE - 1) // TILE - tile0,
                          torch.zeros_like(off))
    blk = (
        (tile0[..., None, None]
         + torch.arange(s_tiles, dtype=torch.int32, device=dev)[:, None]) * bpt
        + torch.arange(bpt, dtype=torch.int32, device=dev)
    )
    blo = (off // BLOCK)[..., None, None]
    bhi = ((hi + BLOCK - 1) // BLOCK)[..., None, None]
    inside = (blk >= blo) & (blk < bhi)
    bm = _take_fill(block_max, blk, _INVALID)
    tmax = torch.where(inside, bm, torch.full_like(bm, _NEG)).amax(-1)
    tile_max = torch.where(inside.any(-1), tmax, torch.full_like(tmax, _INVALID))
    tile_min = torch.cat(
        [torch.full_like(tile_max[..., :1], _NEG), tile_max[..., :-1]], dim=-1
    )
    return tile0, n_tiles, tile_min, tile_max


def _pad_to_tile(x: torch.Tensor, fill: int) -> torch.Tensor:
    """``x`` [Q, W] padded with ``fill`` to a multiple of TILE columns."""
    pad = -x.shape[-1] % TILE
    return torch.nn.functional.pad(x, (0, pad), value=fill) if pad else x


def _ptr(x) -> int:
    """A tensor's device pointer for a kernel's C entry point; 0 for an
    array a mode of the kernel does not read."""
    return 0 if x is None else x.data_ptr()


def _int32(x):
    return None if x is None else x.to(torch.int32).contiguous()


def _delta_given(*arrays) -> bool:
    """Whether the merge-on-read arrays of a join are given: all or none."""
    given = [x is not None for x in arrays]
    if any(given) and not all(given):
        raise ValueError("pass all of d_postings, d_offsets, d_lengths, "
                         "d_block_max and a_flags (merge-on-read) or none")
    return all(given)


def _a_tile_spans(a: torch.Tensor):
    """``(a_min, a_max, a_any)``, each ``[Q, num_a]``: exact docID spans of
    the tiles of a materialized, TILE-padded driver window ``a`` [Q, W]
    (ascending, INVALID past its live slots)."""
    at = a.view(a.shape[0], -1, TILE)
    valid = at != _INVALID
    a_min = at[:, :, 0]
    a_max = torch.where(valid, at, -1).amax(-1)
    return a_min, a_max, valid.any(-1)


def driver_tile_spans(
    block_max: torch.Tensor, off: torch.Tensor, n_eff: torch.Tensor,
    *, s_tiles: int,
):
    """``(a_min, a_max, a_any)``, each ``[..., s_tiles]``: conservative docID
    spans of the window-aligned driver tiles ``[off + i*TILE, off +
    (i+1)*TILE)``, from the skip table.  ``off`` is BLOCK-aligned."""
    bpt = TILE // BLOCK
    dev = off.device
    blk0 = (off // BLOCK)[..., None, None]
    n_live_blk = ((n_eff + BLOCK - 1) // BLOCK)[..., None, None]
    rel = (
        torch.arange(s_tiles, dtype=torch.int32, device=dev)[:, None] * bpt
        + torch.arange(bpt, dtype=torch.int32, device=dev)
    )
    inside = rel < n_live_blk
    bm = _take_fill(block_max, blk0 + rel, _INVALID)
    tmax = torch.where(inside, bm, torch.full_like(bm, _NEG)).amax(-1)
    a_any = inside.any(-1)
    a_max = torch.where(a_any, tmax, torch.full_like(tmax, -1))
    a_min = torch.cat(
        [torch.full_like(a_max[..., :1], _NEG), a_max[..., :-1]], dim=-1
    )
    return a_min, a_max, a_any


def _probe_plan(
    a_spans,                   # (a_min, a_max, a_any), each (Q, num_a_tiles)
    terms: torch.Tensor,       # (Q, T)
    offsets: torch.Tensor, lengths: torch.Tensor, block_max: torch.Tensor,
    *, window: int, s_tiles: int,
):
    """Per-(query, term, driver-tile) streaming plan ``(b_tile, n_b,
    bounds)``: the first overlapping physical tile, how many consecutive
    tiles to read, and the logical ``[lo, hi)`` posting range of the
    term's window, each int32."""
    tt = terms.clamp(0, offsets.shape[0] - 1).long()
    off = offsets[tt]
    ln = torch.where(terms < 0, torch.zeros_like(terms), lengths[tt])
    n_eff = torch.clamp(ln, max=window)
    tile0, n_tiles, tile_min, tile_max = window_tile_spans(
        block_max, off, n_eff, s_tiles=s_tiles
    )
    a_min, a_max, a_any = a_spans
    t_n = terms.shape[1]
    a_min = a_min[:, None, :].expand(-1, t_n, -1).contiguous()
    a_max = a_max[:, None, :].expand(-1, t_n, -1).contiguous()
    start = torch.searchsorted(tile_max.contiguous(), a_min, right=False)
    end = torch.searchsorted(tile_min.contiguous(), a_max, right=True)
    n_tiles = n_tiles[:, :, None].long()
    start = torch.minimum(start, n_tiles)
    end = torch.minimum(end, n_tiles)
    n_b = (end - start).clamp(min=0) * a_any[:, None, :].long()
    b_tile = tile0[:, :, None] + start.to(torch.int32)
    bounds = torch.stack([off, off + n_eff], dim=-1)
    return b_tile, n_b.to(torch.int32), bounds


# ---------------------------------------------------------------------------
# The join: plain PyTorch version and the CUDA kernel, same signature
# ---------------------------------------------------------------------------

def driver_streamed_join_torch(
    d_off, d_neff, active, attr_filter, postings, attrs, b_tile, n_b, bounds,
    *, window: int,
):
    """Plain PyTorch version of the kernel, on the same inputs: the driver
    window read by position and masked, each driver tile probed in every
    active term's planned range (:func:`_probe_member`).  Returns ``(docs,
    mask)``, int32[Q, window].
    """
    q_n = d_off.shape[0]
    num_a = -(-window // TILE)
    dev = postings.device
    pos = torch.arange(num_a * TILE, dtype=torch.int64, device=dev)
    in_win = pos[None, :] < d_neff[:, None]
    idx = (d_off[:, None].long() + pos).clamp(max=postings.shape[0] - 1)
    a = torch.where(in_win, postings[idx], torch.full_like(idx, _INVALID,
                                                          dtype=torch.int32))
    aa = torch.where(in_win, attrs[idx], torch.full_like(
        idx, int(INVALID_ATTR), dtype=torch.int32))
    keep = (a != _INVALID) & (
        (attr_filter[:, None] < 0) | (aa == attr_filter[:, None])
    )

    member = _probe_member(a.view(q_n, num_a, TILE), postings, b_tile, n_b,
                           bounds, window)
    member = member | (active == 0)[:, :, None, None]
    mask = keep & member.all(dim=1).reshape(q_n, num_a * TILE)
    return a[:, :window].contiguous(), mask[:, :window].to(torch.int32)


def _probe_member(a_tiles, postings, b_tile, n_b, bounds, width: int):
    """Membership ``[Q, T, A, TILE]`` of the driver tiles ``a_tiles``
    ``[Q, A, TILE]`` in each (term, tile)'s planned range of ``postings``.

    The range ``[max(b_tile*TILE, lo), min((b_tile + n_b)*TILE, hi))`` is a
    contiguous piece of one ascending list inside the term's window ``[lo,
    hi)``, at most ``width`` long.  It is gathered with ``_NEG`` below and
    ``INVALID_DOC`` above, which keeps each row sorted, and probed with
    ``searchsorted``."""
    lo = bounds[..., 0].long()                              # [Q, T]
    hi = bounds[..., 1].long()
    rlo = torch.maximum(b_tile.long() * TILE, lo[..., None])       # [Q, T, A]
    rhi = torch.minimum((b_tile.long() + n_b.long()) * TILE, hi[..., None])
    rhi = torch.where(n_b > 0, rhi, rlo)
    j = torch.arange(width, dtype=torch.int64, device=postings.device)
    p = lo[..., None, None] + j                             # [Q, T, 1, width]
    bw = postings[p.clamp(max=postings.shape[0] - 1)]
    b = torch.where(p < rlo[..., None], torch.full_like(bw, _NEG),
                    torch.where(p < rhi[..., None], bw,
                                torch.full_like(bw, _INVALID)))  # [Q, T, A, width]
    a_t = a_tiles[:, None].expand(-1, b.shape[1], -1, -1)
    hit = torch.searchsorted(b, a_t.contiguous()).clamp(max=width - 1)
    return b.gather(-1, hit) == a_t


def driver_streamed_join_cuda(
    d_off, d_neff, active, attr_filter, postings, attrs, b_tile, n_b, bounds,
    *, window: int,
):
    """Launch ``csrc/driver_streamed.cu`` (one block per query and 256
    driver slots) on the current stream.  Same signature and result as
    :func:`driver_streamed_join_torch`."""
    from repro_torch.kernels import _build

    q_n, t_n = active.shape
    plan = (q_n, t_n, -(-window // TILE))
    _build.check_args(
        q_n, d_off=(d_off, (q_n,)), d_neff=(d_neff, (q_n,)),
        active=(active, None), attr_filter=(attr_filter, (q_n,)),
        postings=(postings, None), attrs=(attrs, postings.shape),
        b_tile=(b_tile, plan), n_b=(n_b, plan), bounds=(bounds, (q_n, t_n, 2)))
    _build.check_aligned(postings=postings)
    launch = _build.kernel("driver_streamed")
    docs = torch.empty((q_n, window), dtype=torch.int32, device=postings.device)
    mask = torch.empty_like(docs)
    if q_n == 0:
        return docs, mask
    ptr = [x.data_ptr() for x in (d_off, d_neff, active, attr_filter, postings,
                                  attrs, b_tile, n_b, bounds, docs, mask)]
    stream = torch.cuda.current_stream(postings.device).cuda_stream
    err = launch(*ptr, q_n, t_n, window, stream)
    driver_streamed_join_cuda.launches += 1
    _build.check(err, "driver_streamed_launch")
    return docs, mask


driver_streamed_join_cuda.launches = 0


def driver_streamed_join(d_off, d_neff, active, attr_filter, postings, attrs,
                         b_tile, n_b, bounds, *, window: int):
    """The kernel on a CUDA tensor, its plain version on a CPU tensor."""
    fn = (driver_streamed_join_cuda if postings.is_cuda
          else driver_streamed_join_torch)
    args = (d_off, d_neff, active, attr_filter, postings, attrs, b_tile, n_b, bounds)
    with _reg.dispatched("driver_streamed", *args, window=window):
        return fn(*args, window=window)


def driver_streamed_join_packed_torch(
    d_off, d_neff, active, attr_filter, packed, attrs, b_tile, n_b, bounds,
    *, window: int,
):
    """Plain version of K1p: the full-array decode of ``packed``, then the
    raw plain join (:func:`driver_streamed_join_torch`)."""
    return driver_streamed_join_torch(
        d_off, d_neff, active, attr_filter, unpack_flat_postings_torch(packed),
        attrs, b_tile, n_b, bounds, window=window)


def driver_streamed_join_packed_cuda(
    d_off, d_neff, active, attr_filter, packed, attrs, b_tile, n_b, bounds,
    *, window: int,
):
    """Launch ``driver_streamed_packed_kernel`` of ``csrc/driver_streamed.cu``
    (K1p: one block per query and 256 driver slots, blocks decoded on the
    card) on the current stream.  Same signature and result as
    :func:`driver_streamed_join_packed_torch`."""
    from repro_torch.kernels import _build

    q_n, t_n = active.shape
    plan = (q_n, t_n, -(-window // TILE))
    _build.check_args(
        q_n, d_off=(d_off, (q_n,)), d_neff=(d_neff, (q_n,)),
        active=(active, None), attr_filter=(attr_filter, (q_n,)),
        **_build.packed_args(packed), attrs=(attrs, (packed.n_blocks * BLOCK,)),
        b_tile=(b_tile, plan), n_b=(n_b, plan), bounds=(bounds, (q_n, t_n, 2)))
    _build.check_aligned(words=packed.words)
    launch = _build.kernel("driver_streamed_packed")
    docs = torch.empty((q_n, window), dtype=torch.int32, device=attrs.device)
    mask = torch.empty_like(docs)
    if q_n == 0:
        return docs, mask
    ptr = [x.data_ptr() for x in (d_off, d_neff, active, attr_filter,
                                  *packed.arrays(), attrs, b_tile, n_b, bounds,
                                  docs, mask)]
    stream = torch.cuda.current_stream(attrs.device).cuda_stream
    err = launch(*ptr, q_n, t_n, window, packed.n_blocks, stream)
    driver_streamed_join_packed_cuda.launches += 1
    _build.check(err, "driver_streamed_packed_launch")
    return docs, mask


driver_streamed_join_packed_cuda.launches = 0


def driver_streamed_join_packed(d_off, d_neff, active, attr_filter, packed,
                                attrs, b_tile, n_b, bounds, *, window: int):
    """K1p on a CUDA twin, its plain version on a CPU twin."""
    fn = (driver_streamed_join_packed_cuda if packed.words.is_cuda
          else driver_streamed_join_packed_torch)
    args = (d_off, d_neff, active, attr_filter, packed, attrs, b_tile, n_b, bounds)
    with _reg.dispatched("driver_streamed_packed", *args, window=window):
        return fn(*args, window=window)


def _driver_plan(d_off, d_neff, terms, active, offsets, lengths, block_max,
                 *, window: int):
    """``(a_any, b_tile, n_b, bounds)``: the driver tiles that hold live
    postings (``a_any`` [Q, A], which the work list of K6 needs) and K1's
    probe plan, ``n_b`` zeroed for inactive slots."""
    num_a = -(-window // TILE)
    a_spans = driver_tile_spans(block_max, d_off, d_neff, s_tiles=num_a)
    b_tile, n_b, bounds = _probe_plan(
        a_spans, terms, offsets, lengths, block_max,
        window=window, s_tiles=num_a + 1,
    )
    return a_spans[2], b_tile, n_b * active[:, :, None], bounds


def plan_driver_streamed(d_off, d_neff, terms, active, offsets, lengths,
                         block_max, *, window: int):
    """The probe plan the join consumes: ``(b_tile, n_b, bounds)``, with
    ``n_b`` zeroed for inactive slots."""
    return _driver_plan(d_off, d_neff, terms, active, offsets, lengths,
                        block_max, window=window)[1:]


def intersect_batched_driver_streamed(
    d_off: torch.Tensor,        # int32[Q]  driver window start (BLOCK-aligned)
    d_neff: torch.Tensor,       # int32[Q]  live driver postings (<= window)
    terms: torch.Tensor,        # int32[Q, T]  term ids per slot (NO_TERM pad)
    active: torch.Tensor,       # int32[Q, T]  1 iff slot t joins query q
    attr_filter: torch.Tensor,  # int32[Q]     NO_ATTR(-1) = unrestricted
    postings: torch.Tensor,     # int32[P]  flat postings (TILE-pad + spare)
    attrs: torch.Tensor,        # int32[P]  flat embedded attrs (same layout)
    offsets: torch.Tensor, lengths: torch.Tensor, block_max: torch.Tensor,
    *,
    window: int,
    packed: PackedFlatArrays | None = None,
):
    """Batched ZigZag join with the driver window streamed from the index:
    plan, then the join (K1, or K1p reading ``packed`` in place of
    ``postings``, which it then never reads).  Returns ``(docs, mask)``,
    int32[Q, window]."""
    active = active.to(torch.int32)
    b_tile, n_b, bounds = plan_driver_streamed(
        d_off, d_neff, terms, active, offsets, lengths, block_max,
        window=window,
    )
    join = driver_streamed_join if packed is None else driver_streamed_join_packed
    return join(
        d_off.contiguous(), d_neff.contiguous(), active.contiguous(),
        attr_filter.to(torch.int32).contiguous(),
        postings if packed is None else packed, attrs,
        b_tile.contiguous(), n_b.contiguous(), bounds.contiguous(),
        window=window,
    )



# ---------------------------------------------------------------------------
# K4: the join over a materialized driver, main and delta probes
# ---------------------------------------------------------------------------

def streamed_join_torch(
    a_docs, a_attrs, a_live, a_flags, active, attr_filter,
    postings, b_tile, n_b, bounds, d_postings, d_tile, n_d, d_bounds, *,
    cap: int,
):
    """Plain PyTorch version of K4, on the same inputs.

    A driver slot survives when it is valid, live, passes the attribute
    filter, and for every active term is in the term's main probe range
    with its flags free of DEAD and SUPERSEDED, or in its delta probe range
    with its flags free of DEAD.  In the static mode (``d_postings`` None,
    and with it ``a_flags`` and the delta plan) only the main probe runs
    and no flag is read.  Returns the mask, int32[Q, W].
    """
    q_n, window = a_docs.shape
    a = _pad_to_tile(a_docs, _INVALID)
    num_a = a.shape[1] // TILE
    aa = _pad_to_tile(a_attrs, int(INVALID_ATTR))
    al = _pad_to_tile(a_live, 0)
    keep = (a != _INVALID) & (al != 0) & (
        (attr_filter[:, None] < 0) | (aa == attr_filter[:, None])
    )
    a_tiles = a.view(q_n, num_a, TILE)
    member = _probe_member(a_tiles, postings, b_tile, n_b, bounds, window)
    if d_postings is not None:
        in_delta = _probe_member(a_tiles, d_postings, d_tile, n_d, d_bounds, cap)
        flags = _pad_to_tile(a_flags, 0).view(q_n, 1, num_a, TILE)
        main_ok = (flags & int(DOC_DEAD | DOC_SUPERSEDED)) == 0
        delta_ok = (flags & int(DOC_DEAD)) == 0
        member = (member & main_ok) | (in_delta & delta_ok)
    member = member | (active == 0)[:, :, None, None]
    mask = keep & member.all(dim=1).reshape(q_n, num_a * TILE)
    return mask[:, :window].to(torch.int32).contiguous()


def streamed_join_cuda(
    a_docs, a_attrs, a_live, a_flags, active, attr_filter,
    postings, b_tile, n_b, bounds, d_postings, d_tile, n_d, d_bounds, *,
    cap: int,
):
    """Launch ``csrc/streamed_join.cu`` (one block per query and 256
    driver slots) on the current stream; the static mode (``d_postings``
    None) launches the same kernel with its delta probe switched off.  Same
    signature and result as :func:`streamed_join_torch`."""
    from repro_torch.kernels import _build

    q_n, window = a_docs.shape
    t_n = active.shape[1]
    drv, plan, span = (q_n, window), (q_n, t_n, -(-window // TILE)), (q_n, t_n, 2)
    has_delta = d_postings is not None
    delta = dict(a_flags=(a_flags, drv), d_postings=(d_postings, None),
                 d_tile=(d_tile, plan), n_d=(n_d, plan),
                 d_bounds=(d_bounds, span)) if has_delta else {}
    _build.check_args(
        q_n, a_docs=(a_docs, drv), a_attrs=(a_attrs, drv), a_live=(a_live, drv),
        active=(active, (q_n, t_n)), attr_filter=(attr_filter, (q_n,)),
        postings=(postings, None), b_tile=(b_tile, plan), n_b=(n_b, plan),
        bounds=(bounds, span), **delta)
    _build.check_aligned(postings=postings, d_postings=d_postings)
    launch = _build.kernel("streamed_join")
    mask = torch.empty((q_n, window), dtype=torch.int32, device=a_docs.device)
    if q_n == 0:
        return mask
    stream = torch.cuda.current_stream(a_docs.device).cuda_stream
    ptr = [_ptr(x) for x in (a_docs, a_attrs, a_live, a_flags, active,
                             attr_filter, postings, b_tile, n_b, bounds,
                             d_postings, d_tile, n_d, d_bounds, mask)]
    err = launch(*ptr, q_n, t_n, window, int(has_delta), stream)
    streamed_join_cuda.launches += 1
    _build.check(err, "streamed_join_launch")
    return mask


streamed_join_cuda.launches = 0


def streamed_join(*args, cap: int):
    """K4 on CUDA tensors, its plain version on CPU tensors (arguments as
    :func:`streamed_join_torch`)."""
    fn = streamed_join_cuda if args[0].is_cuda else streamed_join_torch
    with _reg.dispatched("streamed_join", *args, cap=cap):
        return fn(*args, cap=cap)


def streamed_join_packed_torch(
    a_docs, a_attrs, a_live, a_flags, active, attr_filter,
    packed, b_tile, n_b, bounds, d_packed, d_tile, n_d, d_bounds, *,
    cap: int,
):
    """Plain version of K4p: the full-array decodes of ``packed`` and
    ``d_packed`` (None in the static mode), then the raw plain join
    (:func:`streamed_join_torch`)."""
    return streamed_join_torch(
        a_docs, a_attrs, a_live, a_flags, active, attr_filter,
        unpack_flat_postings_torch(packed), b_tile, n_b, bounds,
        None if d_packed is None else unpack_flat_postings_torch(d_packed),
        d_tile, n_d, d_bounds, cap=cap)


def streamed_join_packed_cuda(
    a_docs, a_attrs, a_live, a_flags, active, attr_filter,
    packed, b_tile, n_b, bounds, d_packed, d_tile, n_d, d_bounds, *,
    cap: int,
):
    """Launch ``streamed_join_packed_kernel`` of ``csrc/streamed_join.cu``
    (K4p: one block per query and 256 driver slots, probe blocks decoded on
    the card) on the current stream.  Same signature and result as
    :func:`streamed_join_packed_torch`."""
    from repro_torch.kernels import _build

    q_n, window = a_docs.shape
    t_n = active.shape[1]
    drv, plan, span = (q_n, window), (q_n, t_n, -(-window // TILE)), (q_n, t_n, 2)
    has_delta = d_packed is not None
    delta = dict(a_flags=(a_flags, drv), **_build.packed_args(d_packed, "d_"),
                 d_tile=(d_tile, plan), n_d=(n_d, plan),
                 d_bounds=(d_bounds, span)) if has_delta else {}
    _build.check_args(
        q_n, a_docs=(a_docs, drv), a_attrs=(a_attrs, drv), a_live=(a_live, drv),
        active=(active, (q_n, t_n)), attr_filter=(attr_filter, (q_n,)),
        **_build.packed_args(packed), b_tile=(b_tile, plan), n_b=(n_b, plan),
        bounds=(bounds, span), **delta)
    _build.check_aligned(words=packed.words,
                         d_words=d_packed.words if has_delta else None)
    launch = _build.kernel("streamed_join_packed")
    mask = torch.empty((q_n, window), dtype=torch.int32, device=a_docs.device)
    if q_n == 0:
        return mask
    d_arrays = d_packed.arrays() if has_delta else (None,) * 4
    ptr = [_ptr(x) for x in (
        a_docs, a_attrs, a_live, a_flags, active, attr_filter,
        *packed.arrays(), b_tile, n_b, bounds, *d_arrays, d_tile, n_d,
        d_bounds, mask)]
    stream = torch.cuda.current_stream(a_docs.device).cuda_stream
    err = launch(*ptr, q_n, t_n, window, packed.n_blocks,
                 d_packed.n_blocks if has_delta else 0, int(has_delta), stream)
    streamed_join_packed_cuda.launches += 1
    _build.check(err, "streamed_join_packed_launch")
    return mask


streamed_join_packed_cuda.launches = 0


def streamed_join_packed(*args, cap: int):
    """K4p on CUDA tensors, its plain version on CPU tensors (arguments as
    :func:`streamed_join_packed_torch`)."""
    fn = streamed_join_packed_cuda if args[0].is_cuda else streamed_join_packed_torch
    with _reg.dispatched("streamed_join_packed", *args, cap=cap):
        return fn(*args, cap=cap)


def _streamed_plans(a_docs, terms, active, offsets, lengths, block_max,
                    d_offsets=None, d_lengths=None, d_block_max=None):
    """``(a_any, main, delta, cap)``: the driver tiles of ``a_docs`` that
    hold a valid slot (``a_any`` [Q, A], which the work list of K7 needs)
    and K4's plans, as :func:`plan_streamed` returns them."""
    a_spans = _a_tile_spans(_pad_to_tile(a_docs, _INVALID))

    def plan(offs, lens, bmax, width):
        # A BLOCK-aligned list start can straddle one more physical tile
        # than the window spans.
        b_tile, n_b, bounds = _probe_plan(
            a_spans, terms, offs, lens, bmax,
            window=width, s_tiles=-(-width // TILE) + 1,
        )
        return (b_tile.contiguous(), (n_b * active[:, :, None]).contiguous(),
                bounds.contiguous())

    main = plan(offsets, lengths, block_max, a_docs.shape[1])
    if d_offsets is None:
        return a_spans[2], main, None, 0
    cap = d_block_max.shape[0] * BLOCK // d_offsets.shape[0]
    return a_spans[2], main, plan(d_offsets, d_lengths, d_block_max, cap), cap


def plan_streamed(a_docs, terms, active, offsets, lengths, block_max,
                  d_offsets=None, d_lengths=None, d_block_max=None):
    """K4's probe plans from the exact spans of the materialized driver
    ``a_docs`` [Q, W]: ``(main, delta, cap)``, where ``main`` is ``(b_tile,
    n_b, bounds)`` over the main lists at the window ``W``, ``delta`` the
    same over the delta slabs at their capacity ``cap``, and ``n_b`` is
    zeroed for inactive slots.  Without the delta's arrays (the static
    mode) ``delta`` is None and ``cap`` 0."""
    return _streamed_plans(a_docs, terms, active, offsets, lengths, block_max,
                           d_offsets, d_lengths, d_block_max)[1:]


def probe_staging_check(b_tile, n_b, bounds, *, n_postings: int | None = None,
                        packed: PackedFlatArrays | None = None) -> int:
    """Check a probe plan ``(b_tile, n_b, bounds)`` of K1 or K4 against the
    kernels' bulk copies (``csrc/probe_async.cuh``), which round a range's
    ends out to 16 bytes: every non-empty planned range ``[max(b_tile*TILE,
    lo), min((b_tile + n_b)*TILE, hi))`` starts on 16 bytes (a multiple of 4
    postings, so its copy reads nothing before it) and, with
    ``n_postings``, ends inside a raw array of that length once rounded up;
    with ``packed``, the words of its blocks, ``[blk_woff[b0], blk_woff[b1 +
    1])``, start and end on 16 bytes inside ``packed.words``.  The index's
    and the delta writer's layouts meet it.  Returns the number of ranges
    checked; raises ``ValueError`` on the first that fails."""
    lo = bounds[..., 0:1].long()
    hi = bounds[..., 1:2].long()
    bt = b_tile.long() * TILE
    rlo = torch.maximum(bt, lo)
    rhi = torch.minimum(bt + n_b.long() * TILE, hi)
    live = n_b > 0
    return ranges_staging_check(rlo[live], rhi[live], n_postings=n_postings,
                                packed=packed)


def ranges_staging_check(rlo, rhi, *, n_postings: int | None = None,
                         packed: PackedFlatArrays | None = None) -> int:
    """:func:`probe_staging_check` of the ranges ``[rlo, rhi)`` themselves
    (any shape; empty ones are skipped): those of a plan, or the streams of
    a work list (:func:`table_streams`).  Returns the number of non-empty
    ranges checked; raises ``ValueError`` on the first that fails."""
    rlo, rhi = rlo.long().reshape(-1), rhi.long().reshape(-1)
    live = rhi > rlo
    rlo, rhi = rlo[live], rhi[live]
    bad = rlo % 4 != 0
    if n_postings is not None:
        bad |= (rhi + 3) // 4 * 4 > n_postings
    if packed is not None:
        woff = packed.blk_woff.long()
        b0, b1 = rlo // BLOCK, (rhi - 1) // BLOCK
        past = b1 + 1 >= woff.shape[0]
        w0 = woff[b0.clamp(max=woff.shape[0] - 1)]
        w1 = woff[(b1 + 1).clamp(max=woff.shape[0] - 1)]
        bad |= past | (w0 % 4 != 0) | (w1 % 4 != 0) | (w1 > packed.words.shape[0])
    if bool(bad.any()):
        k = int(torch.nonzero(bad)[0, 0])
        raise ValueError(f"probe range [{int(rlo[k])}, {int(rhi[k])}) cannot be "
                         "staged by 16-byte bulk copies inside its array")
    return int(rlo.numel())


def intersect_batched_streamed(
    a_docs: torch.Tensor,       # int32[Q, W]  driver windows
    a_attrs: torch.Tensor,      # int32[Q, W]  driver attribute streams
    a_live: torch.Tensor,       # int32[Q, W]  driver tombstone stream
    terms: torch.Tensor,        # int32[Q, T]  term ids per slot (NO_TERM pad)
    active: torch.Tensor,       # int32[Q, T]  1 iff slot t joins query q
    attr_filter: torch.Tensor,  # int32[Q]     NO_ATTR(-1) = unrestricted
    postings: torch.Tensor,     # int32[P]     main flat postings
    offsets: torch.Tensor, lengths: torch.Tensor, block_max: torch.Tensor,
    d_postings=None, d_offsets=None, d_lengths=None, d_block_max=None,
    a_flags=None,               # int32[Q, W]  driver doc_flags
    *,
    packed: PackedFlatArrays | None = None,
    d_packed: PackedFlatArrays | None = None,
):
    """Batched ZigZag join over a materialized driver window, other-term
    lists probed in place: plans, then K4, or K4p when ``packed`` (and, as
    in the reference, then also ``d_packed`` under merge-on-read) is
    given, which probes the twins and never reads ``postings`` or
    ``d_postings``.  The delta arrays and ``a_flags`` (all or none) turn on
    merge-on-read; without them a driver slot joins a term when it is in
    the term's main window ``[offset, offset + min(len, W))``, and only the
    main probe runs.  Returns int32[Q, W] in {0, 1}."""
    has_delta = _delta_given(d_postings, d_offsets, d_lengths, d_block_max,
                             a_flags)
    if packed is not None and has_delta and d_packed is None:
        raise ValueError("packed codec needs d_packed when delta arrays are given")
    active = active.to(torch.int32).contiguous()
    main, delta, cap = plan_streamed(a_docs, terms, active, offsets, lengths,
                                     block_max, d_offsets, d_lengths,
                                     d_block_max)
    join, m_src, d_src = ((streamed_join, postings, d_postings) if packed is None
                          else (streamed_join_packed, packed, d_packed))
    return join(
        a_docs.contiguous(), a_attrs.to(torch.int32).contiguous(),
        a_live.to(torch.int32).contiguous(), _int32(a_flags),
        active, attr_filter.to(torch.int32).contiguous(), m_src, *main,
        d_src if has_delta else None, *(delta or (None,) * 3), cap=cap,
    )


# ---------------------------------------------------------------------------
# K6 / K7: the joins over a work list (work-list compaction)
# ---------------------------------------------------------------------------

def _tile_member(a_it, flat, tile, lo, hi):
    """Membership ``[N, TILE]`` of each row's driver slots ``a_it`` in its
    probe tile of ``flat``: the positions ``[tile*TILE, (tile+1)*TILE)``
    clipped to ``[lo, hi)``, gathered with ``_NEG`` below and INVALID above
    (so the row stays sorted) and probed with ``searchsorted``.  A row with
    ``tile < 0`` probes nothing."""
    p = tile[:, None] * TILE + torch.arange(TILE, device=flat.device)
    b = flat[p.clamp(0, flat.shape[0] - 1)]
    b = torch.where(p < lo[:, None], _NEG,
                    torch.where(p < hi[:, None], b, _INVALID)).contiguous()
    hit = torch.searchsorted(b, a_it.contiguous()).clamp(max=TILE - 1)
    return (b.gather(-1, hit) == a_it) & (tile >= 0)[:, None]


def _fold_groups(member, items, group, n_groups: int):
    """``[G, TILE]``: per group, the AND over its term runs (``TERM_START``
    .. ``TERM_END``) of the OR of the run's rows' ``member``; a group with
    no run keeps every slot.  Rows before any run probe nothing."""
    starts = (items[:, 4] & FLAG_TERM_START) != 0
    run = torch.cumsum(starts, 0) - 1
    rows = run >= 0
    dev = member.device
    found = torch.zeros((int(starts.sum()), TILE), dtype=torch.int32, device=dev)
    found.index_add_(0, run[rows], member[rows].to(torch.int32))
    run_group = group[starts]
    folded = torch.zeros((n_groups, TILE), dtype=torch.int32, device=dev)
    folded.index_add_(0, run_group, (found > 0).to(torch.int32))
    return folded == torch.bincount(run_group, minlength=n_groups)[:, None]


def _group_driver_tiles(gq, gi, *rows):
    """The ``[G, TILE]`` driver tiles of the groups from each of ``rows``
    ([Q, W], padded here with its fill to a multiple of TILE), given as
    ``(row, fill)`` pairs."""
    return tuple(_pad_to_tile(x, fill).view(x.shape[0], -1, TILE)[gq, gi]
                 for x, fill in rows)


def table_streams(desc, heads, bounds, d_bounds=None):
    """The stream table that the producer warp of K6 and K7 derives from a
    work list (``TablePlan`` in ``csrc/slave_join.cuh``), per group ``g``
    and stream ``j = t * spt + kind``: ``spt`` is 2 with ``d_bounds`` (kind
    1: the delta tiles of column 5), else 1 (kind 0: the main tiles of
    column 3).  ``act`` is 1 where a row of slot ``t`` carries
    ``FLAG_TERM_START``; ``[lo, hi)`` is the planned range of the kind's
    least tile and its number of tiles, clipped to the term's bounds, or
    ``(0, 0)`` where the slot is not active or has no tile of the kind.
    That range is the union of the tiles, clipped, only when they are
    consecutive: a (group, slot, kind) whose tiles are not raises
    ``ValueError``.  Returns ``(lo, hi, act)``, int64 ``[G, T * spt]``."""
    items, group, gq, _ = table_items(desc, heads)
    n_groups, t_n = gq.shape[0], bounds.shape[1]
    n_cells = n_groups * t_n
    dev = desc.device
    cell = group * t_n + items[:, 2]
    act = torch.zeros(n_cells, dtype=torch.int64, device=dev)
    act[cell[(items[:, 4] & FLAG_TERM_START) != 0]] = 1
    cell_q = gq.repeat_interleave(t_n)
    cell_t = torch.arange(t_n, device=dev).repeat(n_groups)
    kinds = [(3, bounds)] + ([] if d_bounds is None else [(5, d_bounds)])
    lo = torch.zeros((n_cells, len(kinds)), dtype=torch.int64, device=dev)
    hi = torch.zeros_like(lo)
    for kind, (col, bnd) in enumerate(kinds):
        has = items[:, col] >= 0
        c, tile = cell[has], items[has, col]
        n = torch.bincount(c, minlength=n_cells)
        first = torch.full((n_cells,), 2**40, dtype=torch.int64, device=dev)
        first = first.scatter_reduce(0, c, tile, "amin")
        last = torch.full_like(first, -1).scatter_reduce(0, c, tile, "amax")
        distinct = torch.bincount(torch.unique(c * 2**32 + tile) // 2**32,
                                  minlength=n_cells)
        bad = (n > 0) & ((last - first + 1 != n) | (distinct != n))
        if bool(bad.any()):
            k = int(torch.nonzero(bad)[0, 0])
            raise ValueError(f"group {k // t_n} slot {k % t_n}: its "
                             f"{('main', 'delta')[kind]} tiles are not consecutive")
        b = bnd[cell_q, cell_t].long()
        rlo = torch.maximum(first * TILE, b[:, 0])
        rhi = torch.maximum(torch.minimum((first + n) * TILE, b[:, 1]), rlo)
        on = (act > 0) & (n > 0)
        lo[:, kind] = torch.where(on, rlo, 0)
        hi[:, kind] = torch.where(on, rhi, 0)
    shape = (n_groups, t_n * len(kinds))
    return (lo.view(shape), hi.view(shape),
            act.repeat_interleave(len(kinds)).view(shape))


def driver_compact_join_torch(desc, heads, d_off, d_neff, attr_filter, postings,
                              attrs, bounds, *, window: int):
    """Plain PyTorch version of K6, executing the descriptor table: per
    group, K1's driver tile read by position; per row, its probe tile
    (:func:`_tile_member`); the OR over each term run and the AND over the
    runs (:func:`_fold_groups`); the validity and filter predicate.  Inert
    rows are ``(INVALID_DOC, 0)``.  Returns ``(docs, mask)``, int32[Q,
    window]."""
    items, group, gq, gi = table_items(desc, heads)
    q_n, num_a = d_off.shape[0], -(-window // TILE)
    pos = gi[:, None] * TILE + torch.arange(TILE, device=postings.device)
    in_win = pos < d_neff[gq][:, None]
    idx = (d_off[gq][:, None].long() + pos).clamp(max=postings.shape[0] - 1)
    a = torch.where(in_win, postings[idx], _INVALID)
    aa = torch.where(in_win, attrs[idx], int(INVALID_ATTR))
    filt = attr_filter[gq][:, None]
    keep = (a != _INVALID) & ((filt < 0) | (aa == filt))
    q, t = items[:, 0], items[:, 2]
    member = _tile_member(a[group], postings, items[:, 3],
                          bounds[q, t, 0].long(), bounds[q, t, 1].long())
    keep &= _fold_groups(member, items, group, gq.shape[0])
    docs, mask = output_rows(q_n, num_a * TILE, False, (_INVALID, 0),
                                  postings.device)
    docs.view(q_n, num_a, TILE)[gq, gi] = a
    mask.view(q_n, num_a, TILE)[gq, gi] = keep.to(torch.int32)
    return docs[:, :window].contiguous(), mask[:, :window].contiguous()


def driver_compact_join_cuda(desc, heads, d_off, d_neff, attr_filter, postings,
                             attrs, bounds, *, window: int):
    """Launch ``csrc/driver_compact.cu`` (K6: one block per 256 driver
    slots of each (query, driver tile) group of the table) on the current
    stream.  Same signature and result as :func:`driver_compact_join_torch`."""
    from repro_torch.kernels import _build

    q_n, t_n = bounds.shape[:2]
    n_groups = heads.shape[0] - 1
    _build.check_args(
        q_n, desc=(desc, (desc.shape[0], 8)), heads=(heads, None),
        d_off=(d_off, (q_n,)), d_neff=(d_neff, (q_n,)),
        attr_filter=(attr_filter, (q_n,)), postings=(postings, None),
        attrs=(attrs, postings.shape), bounds=(bounds, (q_n, t_n, 2)))
    _build.check_aligned(postings=postings)
    launch = _build.kernel("driver_compact")
    docs, mask = output_rows(q_n, window, n_groups == q_n * -(-window // TILE),
                                  (_INVALID, 0), postings.device)
    ptr = [x.data_ptr() for x in (desc, heads, d_off, d_neff, attr_filter,
                                  postings, attrs, bounds, docs, mask)]
    stream = torch.cuda.current_stream(postings.device).cuda_stream
    err = launch(*ptr, n_groups, t_n, window, stream)
    driver_compact_join_cuda.launches += 1
    _build.check(err, "driver_compact_launch")
    return docs, mask


driver_compact_join_cuda.launches = 0


def driver_compact_join(desc, heads, d_off, d_neff, attr_filter, postings,
                        attrs, bounds, *, window: int):
    """K6 on CUDA tensors, its plain version on CPU tensors."""
    fn = driver_compact_join_cuda if postings.is_cuda else driver_compact_join_torch
    args = (desc, heads, d_off, d_neff, attr_filter, postings, attrs, bounds)
    with _reg.dispatched("driver_compact", *args, window=window):
        return fn(*args, window=window)


def driver_compact_join_packed_torch(desc, heads, d_off, d_neff, attr_filter,
                                     packed, attrs, bounds, *, window: int):
    """Plain version of K6p: the full-array decode of ``packed``, then the
    raw plain version (:func:`driver_compact_join_torch`)."""
    return driver_compact_join_torch(
        desc, heads, d_off, d_neff, attr_filter,
        unpack_flat_postings_torch(packed), attrs, bounds, window=window)


def driver_compact_join_packed_cuda(desc, heads, d_off, d_neff, attr_filter,
                                    packed, attrs, bounds, *, window: int):
    """Launch ``driver_compact_packed_kernel`` of ``csrc/driver_compact.cu``
    (K6p: K6 with every posting decoded on the card) on the current
    stream.  Same signature and result as
    :func:`driver_compact_join_packed_torch`."""
    from repro_torch.kernels import _build

    q_n, t_n = bounds.shape[:2]
    n_groups = heads.shape[0] - 1
    _build.check_args(
        q_n, desc=(desc, (desc.shape[0], 8)), heads=(heads, None),
        d_off=(d_off, (q_n,)), d_neff=(d_neff, (q_n,)),
        attr_filter=(attr_filter, (q_n,)), **_build.packed_args(packed),
        attrs=(attrs, (packed.n_blocks * BLOCK,)), bounds=(bounds, (q_n, t_n, 2)))
    _build.check_aligned(words=packed.words)
    launch = _build.kernel("driver_compact_packed")
    docs, mask = output_rows(q_n, window, n_groups == q_n * -(-window // TILE),
                                  (_INVALID, 0), attrs.device)
    ptr = [x.data_ptr() for x in (desc, heads, d_off, d_neff, attr_filter,
                                  *packed.arrays(), attrs, bounds, docs, mask)]
    stream = torch.cuda.current_stream(attrs.device).cuda_stream
    err = launch(*ptr, n_groups, t_n, window, packed.n_blocks, stream)
    driver_compact_join_packed_cuda.launches += 1
    _build.check(err, "driver_compact_packed_launch")
    return docs, mask


driver_compact_join_packed_cuda.launches = 0


def driver_compact_join_packed(desc, heads, d_off, d_neff, attr_filter, packed,
                               attrs, bounds, *, window: int):
    """K6p on a CUDA twin, its plain version on a CPU twin."""
    fn = (driver_compact_join_packed_cuda if packed.words.is_cuda
          else driver_compact_join_packed_torch)
    args = (desc, heads, d_off, d_neff, attr_filter, packed, attrs, bounds)
    with _reg.dispatched("driver_compact_packed", *args, window=window):
        return fn(*args, window=window)


def intersect_batched_driver_streamed_compact(
    d_off: torch.Tensor,        # int32[Q]  driver window start (BLOCK-aligned)
    d_neff: torch.Tensor,       # int32[Q]  live driver postings (<= window)
    terms: torch.Tensor,        # int32[Q, T]  term ids per slot (NO_TERM pad)
    active: torch.Tensor,       # int32[Q, T]  1 iff slot t joins query q
    attr_filter: torch.Tensor,  # int32[Q]     NO_ATTR(-1) = unrestricted
    postings: torch.Tensor,     # int32[P]  flat postings (TILE-pad + spare)
    attrs: torch.Tensor,        # int32[P]  flat embedded attrs (same layout)
    offsets: torch.Tensor, lengths: torch.Tensor, block_max: torch.Tensor,
    *,
    window: int,
    packed: PackedFlatArrays | None = None,
    live_q=None,                # bool[Q] on the host; None = every query live
):
    """Work-list compacted :func:`intersect_batched_driver_streamed`: the
    same ``(docs, mask)`` on live rows, ``(INVALID_DOC, 0)`` on the rows of
    inert queries (``live_q`` false).  K1's plan is pulled to the host in
    one copy, compiled into a descriptor table
    (:func:`~repro_torch.kernels.worklist.build_intersect_worklist`),
    uploaded in one copy, and K6 (K6p with ``packed``) runs over it.  An
    all-inert batch launches nothing."""
    dev = attrs.device
    q_n = terms.shape[0]
    wl, bounds = plan_driver_compact(
        d_off, d_neff, terms, active, offsets, lengths, block_max,
        window=window, live_q=live_q, packed=packed is not None)
    if wl.n_items == 0:
        return (torch.full((q_n, window), _INVALID, dtype=torch.int32, device=dev),
                torch.zeros((q_n, window), dtype=torch.int32, device=dev))
    desc, heads = table_to_device(wl, dev)
    join = driver_compact_join if packed is None else driver_compact_join_packed
    return join(
        desc, heads, d_off.contiguous(), d_neff.contiguous(),
        attr_filter.to(torch.int32).contiguous(),
        postings if packed is None else packed, attrs, bounds,
        window=window,
    )


def plan_driver_compact(d_off, d_neff, terms, active, offsets, lengths,
                        block_max, *, window: int, live_q=None,
                        packed: bool = False):
    """K6's work list and the term bounds it is read with: K1's plan
    (:func:`_driver_plan`) pulled to the host in one copy and compiled by
    :func:`~repro_torch.kernels.worklist.build_intersect_worklist` (whose
    metrics name K6p's call when ``packed``).  Returns ``(wl, bounds)``."""
    q_n, t_slots = terms.shape
    num_a = -(-window // TILE)
    active = active.to(torch.int32)
    a_any, b_tile, n_b, bounds = _driver_plan(
        d_off, d_neff, terms, active, offsets, lengths, block_max, window=window)
    # The reference clamps n_b to ``s_max``, whose default is the plan's own
    # tile bound (``_clamp_s_max``); the cap was not ported, so no clamp.
    active_h, n_b_h, b_tile_h, a_any_h = plan_to_host(active, n_b, b_tile, a_any)
    wl = build_intersect_worklist(
        n_b_h, b_tile_h, active_h, a_any_h, live_q=live_rows(live_q, q_n),
        kernel="intersect_batched_driver_streamed_compact"
        + ("_packed" if packed else ""),
        dense_steps=q_n * num_a * t_slots * (num_a + 1),
    )
    return wl, bounds.contiguous()


def streamed_compact_join_torch(desc, heads, a_docs, a_attrs, a_live, a_flags,
                                attr_filter, postings, bounds, d_postings,
                                d_bounds):
    """Plain PyTorch version of K7, executing the descriptor table: per
    group, K4's driver tile and predicates; per row, its main tile (slots
    whose doc is neither DEAD nor SUPERSEDED) and its delta tile (slots
    whose doc is not DEAD), clipped to the term's bounds; the OR over each
    term run and the AND over the runs.  In the static mode (``d_postings``,
    ``a_flags`` and ``d_bounds`` None) only the main tiles are probed and
    no flag is read.  Inert rows are 0.  Returns the mask, int32[Q, W]."""
    items, group, gq, gi = table_items(desc, heads)
    q_n, window = a_docs.shape
    num_a = -(-window // TILE)
    a, aa, al = _group_driver_tiles(gq, gi, (a_docs, _INVALID),
                                    (a_attrs, int(INVALID_ATTR)), (a_live, 0))
    filt = attr_filter[gq][:, None]
    keep = (a != _INVALID) & (al != 0) & ((filt < 0) | (aa == filt))
    q, t = items[:, 0], items[:, 2]
    a_it = a[group]
    member = _tile_member(a_it, postings, items[:, 3], bounds[q, t, 0].long(),
                          bounds[q, t, 1].long())
    if d_postings is not None:
        f_it = _group_driver_tiles(gq, gi, (a_flags, 0))[0][group]
        in_delta = _tile_member(a_it, d_postings, items[:, 5],
                                d_bounds[q, t, 0].long(), d_bounds[q, t, 1].long())
        member = ((member & ((f_it & int(DOC_DEAD | DOC_SUPERSEDED)) == 0))
                  | (in_delta & ((f_it & int(DOC_DEAD)) == 0)))
    keep &= _fold_groups(member, items, group, gq.shape[0])
    (mask,) = output_rows(q_n, num_a * TILE, False, (0,), a_docs.device)
    mask.view(q_n, num_a, TILE)[gq, gi] = keep.to(torch.int32)
    return mask[:, :window].contiguous()


def streamed_compact_join_cuda(desc, heads, a_docs, a_attrs, a_live, a_flags,
                               attr_filter, postings, bounds, d_postings,
                               d_bounds):
    """Launch ``csrc/streamed_compact.cu`` (K7: one block per 256 driver
    slots of each (query, driver tile) group of the table) on the current
    stream.  Same signature and result as
    :func:`streamed_compact_join_torch`."""
    from repro_torch.kernels import _build

    q_n, window = a_docs.shape
    t_n = bounds.shape[1]
    n_groups = heads.shape[0] - 1
    drv, span = (q_n, window), (q_n, t_n, 2)
    has_delta = d_postings is not None
    delta = dict(a_flags=(a_flags, drv), d_postings=(d_postings, None),
                 d_bounds=(d_bounds, span)) if has_delta else {}
    _build.check_args(
        q_n, desc=(desc, (desc.shape[0], 8)), heads=(heads, None),
        a_docs=(a_docs, drv), a_attrs=(a_attrs, drv), a_live=(a_live, drv),
        attr_filter=(attr_filter, (q_n,)), postings=(postings, None),
        bounds=(bounds, span), **delta)
    _build.check_aligned(postings=postings, d_postings=d_postings)
    launch = _build.kernel("streamed_compact")
    (mask,) = output_rows(q_n, window, n_groups == q_n * -(-window // TILE),
                               (0,), a_docs.device)
    ptr = [_ptr(x) for x in (desc, heads, a_docs, a_attrs, a_live, a_flags,
                             attr_filter, postings, bounds, d_postings,
                             d_bounds, mask)]
    stream = torch.cuda.current_stream(a_docs.device).cuda_stream
    err = launch(*ptr, n_groups, t_n, window, int(has_delta), stream)
    streamed_compact_join_cuda.launches += 1
    _build.check(err, "streamed_compact_launch")
    return mask


streamed_compact_join_cuda.launches = 0


def streamed_compact_join(*args):
    """K7 on CUDA tensors, its plain version on CPU tensors (arguments as
    :func:`streamed_compact_join_torch`)."""
    fn = streamed_compact_join_cuda if args[2].is_cuda else streamed_compact_join_torch
    with _reg.dispatched("streamed_compact", *args):
        return fn(*args)


def streamed_compact_join_packed_torch(desc, heads, a_docs, a_attrs, a_live,
                                       a_flags, attr_filter, packed, bounds,
                                       d_packed, d_bounds):
    """Plain version of K7p: the full-array decodes of ``packed`` and
    ``d_packed`` (None in the static mode), then the raw plain version
    (:func:`streamed_compact_join_torch`)."""
    return streamed_compact_join_torch(
        desc, heads, a_docs, a_attrs, a_live, a_flags, attr_filter,
        unpack_flat_postings_torch(packed), bounds,
        None if d_packed is None else unpack_flat_postings_torch(d_packed),
        d_bounds)


def streamed_compact_join_packed_cuda(desc, heads, a_docs, a_attrs, a_live,
                                      a_flags, attr_filter, packed, bounds,
                                      d_packed, d_bounds):
    """Launch ``streamed_compact_packed_kernel`` of
    ``csrc/streamed_compact.cu`` (K7p: K7 with the probe blocks decoded on
    the card) on the current stream.  Same signature and result as
    :func:`streamed_compact_join_packed_torch`."""
    from repro_torch.kernels import _build

    q_n, window = a_docs.shape
    t_n = bounds.shape[1]
    n_groups = heads.shape[0] - 1
    drv, span = (q_n, window), (q_n, t_n, 2)
    has_delta = d_packed is not None
    delta = dict(a_flags=(a_flags, drv), **_build.packed_args(d_packed, "d_"),
                 d_bounds=(d_bounds, span)) if has_delta else {}
    _build.check_args(
        q_n, desc=(desc, (desc.shape[0], 8)), heads=(heads, None),
        a_docs=(a_docs, drv), a_attrs=(a_attrs, drv), a_live=(a_live, drv),
        attr_filter=(attr_filter, (q_n,)), **_build.packed_args(packed),
        bounds=(bounds, span), **delta)
    _build.check_aligned(words=packed.words,
                         d_words=d_packed.words if has_delta else None)
    launch = _build.kernel("streamed_compact_packed")
    (mask,) = output_rows(q_n, window, n_groups == q_n * -(-window // TILE),
                               (0,), a_docs.device)
    d_arrays = d_packed.arrays() if has_delta else (None,) * 4
    ptr = [_ptr(x) for x in (desc, heads, a_docs, a_attrs, a_live, a_flags,
                             attr_filter, *packed.arrays(), bounds, *d_arrays,
                             d_bounds, mask)]
    stream = torch.cuda.current_stream(a_docs.device).cuda_stream
    err = launch(*ptr, n_groups, t_n, window, packed.n_blocks,
                 d_packed.n_blocks if has_delta else 0, int(has_delta), stream)
    streamed_compact_join_packed_cuda.launches += 1
    _build.check(err, "streamed_compact_packed_launch")
    return mask


streamed_compact_join_packed_cuda.launches = 0


def streamed_compact_join_packed(*args):
    """K7p on CUDA tensors, its plain version on CPU tensors (arguments as
    :func:`streamed_compact_join_packed_torch`)."""
    fn = (streamed_compact_join_packed_cuda if args[2].is_cuda
          else streamed_compact_join_packed_torch)
    with _reg.dispatched("streamed_compact_packed", *args):
        return fn(*args)


def intersect_batched_streamed_compact(
    a_docs: torch.Tensor,       # int32[Q, W]  driver windows
    a_attrs: torch.Tensor,      # int32[Q, W]  driver attribute streams
    a_live: torch.Tensor,       # int32[Q, W]  driver tombstone stream
    terms: torch.Tensor,        # int32[Q, T]  term ids per slot (NO_TERM pad)
    active: torch.Tensor,       # int32[Q, T]  1 iff slot t joins query q
    attr_filter: torch.Tensor,  # int32[Q]     NO_ATTR(-1) = unrestricted
    postings: torch.Tensor,     # int32[P]     main flat postings
    offsets: torch.Tensor, lengths: torch.Tensor, block_max: torch.Tensor,
    d_postings=None, d_offsets=None, d_lengths=None, d_block_max=None,
    a_flags=None,               # int32[Q, W]  driver doc_flags
    *,
    packed: PackedFlatArrays | None = None,
    d_packed: PackedFlatArrays | None = None,
    live_q=None,                # bool[Q] on the host; None = every query live
):
    """Work-list compacted :func:`intersect_batched_streamed`: the same mask
    on live rows, 0 on the rows of inert queries.  K4's two plans are pulled
    to the host in one copy, compiled into one descriptor table (main and
    delta tiles in lockstep), uploaded in one copy, and K7 (K7p with
    ``packed``, and ``d_packed`` under merge-on-read) runs over it.  Without
    the delta arrays (the static mode) the table holds main tiles only.  An
    all-inert batch launches nothing."""
    has_delta = _delta_given(d_postings, d_offsets, d_lengths, d_block_max,
                             a_flags)
    if packed is not None and has_delta and d_packed is None:
        raise ValueError("packed codec needs d_packed when delta arrays are given")
    wl, bounds, d_bounds = plan_streamed_compact(
        a_docs, terms, active, offsets, lengths, block_max, d_offsets,
        d_lengths, d_block_max, live_q=live_q, packed=packed is not None)
    if wl.n_items == 0:
        return torch.zeros(a_docs.shape, dtype=torch.int32, device=a_docs.device)
    desc, heads = table_to_device(wl, a_docs.device)
    join, m_src, d_src = ((streamed_compact_join, postings, d_postings)
                          if packed is None else
                          (streamed_compact_join_packed, packed, d_packed))
    return join(
        desc, heads, a_docs.contiguous(), a_attrs.to(torch.int32).contiguous(),
        a_live.to(torch.int32).contiguous(), _int32(a_flags),
        attr_filter.to(torch.int32).contiguous(), m_src, bounds,
        d_src if has_delta else None, d_bounds,
    )


def plan_streamed_compact(a_docs, terms, active, offsets, lengths, block_max,
                          d_offsets=None, d_lengths=None, d_block_max=None, *,
                          live_q=None, packed: bool = False):
    """K7's work list and the bounds it is read with: K4's two plans
    (:func:`_streamed_plans`) pulled to the host in one copy and compiled
    into one table, main and delta tiles in lockstep (metrics named for
    K7p when ``packed``).  Without the delta's arrays the table holds the
    main plan alone and ``d_bounds`` is None.  Returns ``(wl, bounds,
    d_bounds)``."""
    q_n, n_a = a_docs.shape
    t_slots = terms.shape[1]
    num_a = -(-n_a // TILE)
    active = active.to(torch.int32).contiguous()
    a_any, (b_tile, n_b, bounds), delta, cap = _streamed_plans(
        a_docs, terms, active, offsets, lengths, block_max, d_offsets,
        d_lengths, d_block_max)
    d_tile, n_d, d_bounds = delta or (None,) * 3
    active_h, n_b_h, b_tile_h, a_any_h, *delta_h = plan_to_host(
        active, n_b, b_tile, a_any, *(() if delta is None else (n_d, d_tile)))
    n_d_h, d_tile_h = delta_h or (None, None)
    wl = build_intersect_worklist(
        n_b_h, b_tile_h, active_h, a_any_h, n_d=n_d_h, d_tile=d_tile_h,
        live_q=live_rows(live_q, q_n),
        kernel="intersect_batched_streamed_compact" + ("_packed" if packed else ""),
        dense_steps=q_n * num_a * t_slots * max(
            num_a + 1, 0 if delta is None else -(-cap // TILE) + 1),
    )
    return wl, bounds, d_bounds


# ---------------------------------------------------------------------------
# K9 / K10: the joins over staged windows, with block skipping
# ---------------------------------------------------------------------------

def _tile_spans(x: torch.Tensor):
    """``(first, max valid, any valid)`` of each TILE of the TILE-padded
    rows ``x`` [..., n], each ``[..., n // TILE]``."""
    t = x.reshape(*x.shape[:-1], -1, TILE)
    valid = t != _INVALID
    return t[..., 0], torch.where(valid, t, -1).amax(-1), valid.any(-1)


def compute_skip_map(a_docs: torch.Tensor, b_docs: torch.Tensor):
    """Per A tile, the run of B tiles ``[b_start, b_start + n_b)`` whose
    docID span can overlap it: the sub-index lookup of the paper, the port
    of the reference's ``compute_skip_map`` (``searchsorted`` over the B
    tiles' ``[first, max valid]`` spans; all-pad B tiles span ``[INVALID,
    INVALID]``, an A tile with no valid posting gets ``n_b = 0``).

    ``a_docs`` [..., n_a] and ``b_docs`` [..., n_b] are TILE-padded; their
    leading shapes broadcast (the reference nests ``vmap`` for this, one
    driver window against each of its term slots).  Returns ``(b_start,
    n_b)``, int32 [lead..., n_a // TILE]."""
    if a_docs.shape[-1] % TILE or b_docs.shape[-1] % TILE:
        raise ValueError(f"need TILE-padded rows, got {a_docs.shape[-1]} and "
                         f"{b_docs.shape[-1]}")
    a_min, a_max, a_any = _tile_spans(a_docs)
    b_min, b_max, b_any = _tile_spans(b_docs)
    b_max = torch.where(b_any, b_max, _INVALID)
    lead = torch.broadcast_shapes(a_docs.shape[:-1], b_docs.shape[:-1])
    num_a, num_b = a_min.shape[-1], b_min.shape[-1]

    def full(x, n):
        return x.expand(*lead, n).contiguous()

    start = torch.searchsorted(full(b_max, num_b), full(a_min, num_a)).clamp(max=num_b)
    end = torch.searchsorted(full(b_min, num_b), full(a_max, num_a), right=True)
    n_b = torch.where(full(a_any, num_a), (end - start).clamp(0, num_b), 0)
    return start.to(torch.int32), n_b.to(torch.int32)


def skip_fraction(a_docs: torch.Tensor, b_docs: torch.Tensor) -> torch.Tensor:
    """Diagnostic: the fraction of B tiles that posting skipping never
    reads, for 1-D ``a_docs`` against ``b_docs`` (float32 0-d tensor)."""
    a = _pad_to_tile(a_docs, _INVALID)
    b = _pad_to_tile(b_docs, _INVALID)
    _, n_b = compute_skip_map(a, b)
    return 1.0 - n_b.sum() / ((a.shape[-1] // TILE) * (b.shape[-1] // TILE))


def batched_block_skip_join_torch(a_docs, a_attrs, a_live, b_docs, active,
                                  attr_filter, b_start, n_b):
    """Plain PyTorch version of K9, on TILE-padded inputs: driver windows
    ``a_docs``, ``a_attrs`` and ``a_live`` [Q, W_a] (``a_live`` None: all
    live), other-term windows ``b_docs`` [Q, T, W_b] (each row ascending,
    INVALID-padded), ``active`` [Q, T], ``attr_filter`` [Q], and the skip
    map ``b_start``, ``n_b`` [Q, T, W_a // TILE] (``n_b`` zero for inactive
    slots).

    A driver slot survives when it is valid, live, passes the attribute
    predicate (``attr_filter >= 0``), and for every active slot occurs in
    that slot's window inside its skip range: the positions ``[b_start *
    TILE, (b_start + n_b) * TILE)``.  The row is sorted, so the first
    occurrence at or past the range's start decides.  Returns the mask,
    int32[Q, W_a]."""
    q_n, w_a = a_docs.shape
    t_n, w_b = b_docs.shape[1:]
    filt = attr_filter[:, None]
    keep = (a_docs != _INVALID) & ((filt < 0) | (a_attrs == filt))
    if a_live is not None:
        keep &= a_live != 0
    a = a_docs[:, None].expand(q_n, t_n, w_a).contiguous()
    first = torch.searchsorted(b_docs.contiguous(), a)
    rlo = (b_start.long() * TILE).repeat_interleave(TILE, dim=-1)
    rhi = ((b_start.long() + n_b.long()) * TILE).clamp(max=w_b).repeat_interleave(
        TILE, dim=-1)
    pos = torch.maximum(first, rlo)
    hit = (pos < rhi) & (b_docs.gather(-1, pos.clamp(max=max(w_b - 1, 0))) == a)
    member = hit | (active == 0)[:, :, None]
    return (keep & member.all(dim=1)).to(torch.int32)


def skip_streams(b_start, n_b, active, w_b: int):
    """The streams that K9's producer warp derives from the skip map
    (``SkipPlan`` in ``csrc/slave_join.cuh``): per (query ``q``, term slot
    ``t``, driver tile ``i``), positions ``[lo, hi)`` of the flat other-term
    windows ``b_docs`` [Q, T, ``w_b``], the planned range of tiles
    ``b_start .. b_start + n_b - 1`` clipped to ``[0, w_b)`` (empty, ``hi ==
    lo``, where ``n_b <= 0``), offset by ``(q * T + t) * w_b``; ``(0, 0)``
    where the slot is not active (``act`` 0; ``active`` None: all active).
    Returns ``(lo, hi, act)``, int64 ``[Q, T, A]`` like ``b_start``."""
    q_n, t_n = b_start.shape[:2]
    dev = b_start.device
    bs, nb = b_start.long(), n_b.long()
    rlo = (bs * TILE).clamp(min=0)
    rhi = ((bs + nb) * TILE).clamp(max=w_b)
    rhi = torch.where((nb <= 0) | (rhi < rlo), rlo, rhi)
    act = (torch.ones((q_n, t_n), dtype=torch.int64, device=dev) if active is None
           else (active != 0).long())[:, :, None].expand_as(bs)
    row = (torch.arange(q_n * t_n, dtype=torch.int64, device=dev) * w_b).view(
        q_n, t_n, 1)
    lo = torch.where(act > 0, row + rlo, 0)
    hi = torch.where(act > 0, row + rhi, 0)
    return lo, hi, act.contiguous()


def batched_block_skip_join_cuda(a_docs, a_attrs, a_live, b_docs, active,
                                 attr_filter, b_start, n_b):
    """Launch ``staged_join_kernel`` of ``csrc/staged_join.cu`` (K9: K4's
    static body, a block a 256-slot sub-tile of a driver tile and query
    plus a producer warp that stages each term's skip range by bulk
    copies, :func:`skip_streams`) on the current stream.  ``b_docs`` must
    start on 16 bytes (:func:`_build.check_aligned`).  Same signature and
    result as :func:`batched_block_skip_join_torch`."""
    from repro_torch.kernels import _build

    q_n, w_a = a_docs.shape
    t_n, w_b = b_docs.shape[1:]
    if w_a % TILE or w_b % TILE:
        raise ValueError(f"need TILE-padded windows, got {w_a} and {w_b}")
    drv, plan = (q_n, w_a), (q_n, t_n, w_a // TILE)
    _build.check_args(
        q_n, a_docs=(a_docs, drv), a_attrs=(a_attrs, drv),
        **({} if a_live is None else {"a_live": (a_live, drv)}),
        b_docs=(b_docs, (q_n, t_n, w_b)), active=(active, (q_n, t_n)),
        attr_filter=(attr_filter, (q_n,)), b_start=(b_start, plan),
        n_b=(n_b, plan))
    _build.check_aligned(b_docs=b_docs)
    launch = _build.kernel("batched_block_skip")
    mask = torch.empty(drv, dtype=torch.int32, device=a_docs.device)
    if q_n == 0 or w_a == 0:
        return mask
    ptr = [_ptr(x) for x in (a_docs, a_attrs, a_live, b_docs, active,
                             attr_filter, b_start, n_b, mask)]
    stream = torch.cuda.current_stream(a_docs.device).cuda_stream
    err = launch(*ptr, q_n, t_n, w_a // TILE, w_b, stream)
    batched_block_skip_join_cuda.launches += 1
    _build.check(err, "batched_block_skip_launch")
    return mask


batched_block_skip_join_cuda.launches = 0


def batched_block_skip_join(a_docs, a_attrs, a_live, b_docs, active,
                            attr_filter, b_start, n_b):
    """K9 on CUDA tensors, its plain version on CPU tensors."""
    fn = (batched_block_skip_join_cuda if a_docs.is_cuda
          else batched_block_skip_join_torch)
    args = (a_docs, a_attrs, a_live, b_docs, active, attr_filter, b_start, n_b)
    with _reg.dispatched("batched_block_skip", *args):
        return fn(*args)


def intersect_batched_block_skip(
    a_docs: torch.Tensor,       # int32[Q, W_a]    driver windows
    a_attrs: torch.Tensor,      # int32[Q, W_a]    driver attribute streams
    b_docs: torch.Tensor,       # int32[Q, T, W_b] other-term windows
    active: torch.Tensor,       # int32[Q, T]      1 iff slot t joins query q
    attr_filter: torch.Tensor,  # int32[Q]         NO_ATTR(-1) = unrestricted
    *,
    a_live: torch.Tensor | None = None,  # int32[Q, W_a]; None = all live
):
    """Batched ZigZag join over staged windows (K9): the mask of each
    query's driver postings that occur in every active other-term window,
    fused with validity, the attribute predicate and ``a_live``.  The
    operands (:func:`batched_block_skip_args`), then the join.  Returns
    int32[Q, W_a] in {0, 1}."""
    return batched_block_skip_join(*batched_block_skip_args(
        a_docs, a_attrs, b_docs, active, attr_filter, a_live))[:, :a_docs.shape[1]]


def batched_block_skip_args(a_docs, a_attrs, b_docs, active, attr_filter,
                            a_live=None):
    """K9's operands as its join takes them: each window padded to TILE
    (INVALID_DOC, attrs -1, live 0), and the skip map computed on the
    device (:func:`compute_skip_map`), zeroed for inactive slots."""
    a = _pad_to_tile(a_docs.to(torch.int32), _INVALID).contiguous()
    b = _pad_to_tile(b_docs.to(torch.int32), _INVALID).contiguous()
    active = active.to(torch.int32).contiguous()
    b_start, n_b = compute_skip_map(a[:, None], b)
    return (a, _pad_to_tile(a_attrs.to(torch.int32), int(INVALID_ATTR)).contiguous(),
            None if a_live is None else _pad_to_tile(a_live.to(torch.int32), 0).contiguous(),
            b, active, attr_filter.to(torch.int32).contiguous(), b_start,
            (n_b * active[:, :, None]).contiguous())


def block_skip_join_torch(a_docs, a_attrs, b_docs, attr_filter, b_start, n_b):
    """Plain PyTorch version of K10, on TILE-padded 1-D inputs (``b_docs``
    ascending, INVALID-padded), ``attr_filter`` int32[1] and the skip map
    ``b_start``, ``n_b`` [n_a // TILE]: K9's plain version for one query
    and one active slot, with no live stream.  Returns int32[n_a]."""
    one = torch.ones((1, 1), dtype=torch.int32, device=a_docs.device)
    return batched_block_skip_join_torch(
        a_docs[None], a_attrs[None], None, b_docs[None, None], one,
        attr_filter.reshape(1), b_start[None, None], n_b[None, None])[0]


def block_skip_join_cuda(a_docs, a_attrs, b_docs, attr_filter, b_start, n_b):
    """Launch ``skip_join_kernel`` of ``csrc/staged_join.cu`` (K10: K9's body
    at one query and one term slot, a block a 256-slot sub-tile of a driver
    tile plus a producer warp that stages the tile's skip range by bulk
    copies, :func:`skip_streams` at Q = T = 1) on the current stream.
    ``b_docs`` must start on 16 bytes (:func:`_build.check_aligned`).  Same
    signature and result as :func:`block_skip_join_torch`."""
    from repro_torch.kernels import _build

    (w_a,), (w_b,) = a_docs.shape, b_docs.shape
    if w_a % TILE or w_b % TILE:
        raise ValueError(f"need TILE-padded lists, got {w_a} and {w_b}")
    _build.check_args(
        1, a_docs=(a_docs, (w_a,)), a_attrs=(a_attrs, (w_a,)),
        b_docs=(b_docs, (w_b,)), attr_filter=(attr_filter, (1,)),
        b_start=(b_start, (w_a // TILE,)), n_b=(n_b, (w_a // TILE,)))
    _build.check_aligned(b_docs=b_docs)
    launch = _build.kernel("block_skip")
    mask = torch.empty(w_a, dtype=torch.int32, device=a_docs.device)
    if w_a == 0:
        return mask
    ptr = [x.data_ptr() for x in (a_docs, a_attrs, b_docs, attr_filter,
                                  b_start, n_b, mask)]
    stream = torch.cuda.current_stream(a_docs.device).cuda_stream
    err = launch(*ptr, w_a // TILE, w_b, stream)
    block_skip_join_cuda.launches += 1
    _build.check(err, "block_skip_launch")
    return mask


block_skip_join_cuda.launches = 0


def block_skip_join(a_docs, a_attrs, b_docs, attr_filter, b_start, n_b):
    """K10 on CUDA tensors, its plain version on CPU tensors."""
    fn = block_skip_join_cuda if a_docs.is_cuda else block_skip_join_torch
    args = (a_docs, a_attrs, b_docs, attr_filter, b_start, n_b)
    with _reg.dispatched("block_skip", *args):
        return fn(*args)


def intersect_block_skip(a_docs: torch.Tensor, a_attrs: torch.Tensor,
                         b_docs: torch.Tensor, attr_filter=-1) -> torch.Tensor:
    """Membership mask of ``a_docs`` in the ascending ``b_docs`` (K10), fused
    with validity and the attribute predicate (``attr_filter``, an int or a
    0-d tensor, on when >= 0).  The operands (:func:`block_skip_args`),
    then the join.  Returns int32[len(a_docs)] in {0, 1}."""
    return block_skip_join(*block_skip_args(
        a_docs, a_attrs, b_docs, attr_filter))[:a_docs.shape[0]]


def block_skip_args(a_docs, a_attrs, b_docs, attr_filter=-1):
    """K10's operands as its join takes them: each list padded to TILE
    (INVALID_DOC, attrs -1), ``b`` copied where it does not start on 16
    bytes (a view into a flat postings array, say: the kernel's bulk copies
    need it), the filter as int32[1] on the lists' device, and the skip map
    computed on the device."""
    a = _pad_to_tile(a_docs.to(torch.int32), _INVALID).contiguous()
    b = _pad_to_tile(b_docs.to(torch.int32), _INVALID).contiguous()
    if b.data_ptr() % 16:
        b = b.clone()
    b_start, n_b = compute_skip_map(a, b)
    filt = torch.as_tensor(attr_filter, dtype=torch.int32,
                           device=a.device).reshape(1)
    return (a, _pad_to_tile(a_attrs.to(torch.int32), int(INVALID_ATTR)).contiguous(),
            b, filt, b_start, n_b)


# ---------------------------------------------------------------------------
# Launch contracts (repro_torch.kernels.registry) and the joins' work
# ---------------------------------------------------------------------------
#
# The canonical instances: two tiny indexes through the port's builder,
# one whose last list's live extent ends exactly on a TILE (an empty list
# among them), one ending inside a tile; three queries each, a NO_TERM
# slot, an empty driver, filters on and off.  The packed instances widen
# the last live block of the inner index to 32-bit gaps.

#: List lengths of the canonical indexes (tile edge, inner).
_EDGE_LISTS = (1024, 500, 512, 0, 1900)
_INNER_LISTS = (1500, 700, 300, 2100, 0)
#: Their queries: driver terms, other terms (-1: NO_TERM), filters.
_EDGE_Q = ((4, 0, 1), ((0, 2), (4, 3), (-1, -1)), (-1, 1, -1))
_INNER_Q = ((3, 0, 4), ((0, 1), (2, -1), (1, 3)), (-1, 0, 1))
#: K1's window (two driver tiles) and K4's (a partial tile and sub-tile).
_K1_WINDOW, _K4_WINDOW = 2048, 1500
_K4_CAP = 256
#: ``csrc/probe_async.cuh``'s driver slots a block.
JOIN_SUB = _reg.JOIN_SUB


def _host(x) -> np.ndarray:
    return x.long().reshape(-1).cpu().numpy()


def _small_bytes(*xs) -> int:
    return sum(x.numel() * 4 for x in xs if x is not None)


def _meta(pk: PackedFlatArrays) -> np.ndarray:
    return pk.blk_meta[:pk.n_blocks].cpu().numpy()


def canonical_index(lists, *, widen: bool = False):
    """``(tensors, live)``: a canonical index
    (:func:`~repro_torch.kernels.registry.synthetic_flat_index`) as CPU
    int32 tensors; with ``widen`` the last live block holds gaps of 2**17
    (a width-32 block of the codec)."""
    arrays, live = _reg.synthetic_flat_index(lists)
    arrays = {k: arrays[k].copy() for k in ("postings", "attrs", "offsets",
                                             "lengths", "block_max")}
    if widen:
        p, ends = arrays["postings"], arrays["offsets"] + arrays["lengths"]
        t = int(np.argmax(np.where(arrays["lengths"] > 0, ends, -1)))
        end = int(ends[t])
        first = end - 1 - (end - 1) % BLOCK
        base = int(p[first - 1]) + 1 if first > arrays["offsets"][t] else int(p[first])
        p[first:end] = base + np.arange(end - first, dtype=np.int64) * 2**17
        arrays["block_max"] = p.reshape(-1, BLOCK).max(axis=1)
    return _reg.tensors(arrays), live


def canonical_batch(t, drivers, others, filters, *, window: int):
    """``(d_off, d_neff, terms, active, attr_filter)`` of a query batch on a
    canonical index."""
    drv = torch.tensor(drivers, dtype=torch.int32)
    idx = drv.clamp(min=0).long()
    d_off = torch.where(drv >= 0, t["offsets"][idx], 0).to(torch.int32)
    d_neff = torch.where(drv >= 0, t["lengths"][idx].clamp(max=window), 0).to(torch.int32)
    terms = torch.tensor(others, dtype=torch.int32)
    return (d_off, d_neff, terms, (terms >= 0).to(torch.int32),
            torch.tensor(filters, dtype=torch.int32))


def canonical_driver(t, d_off, d_neff, *, window: int):
    """A materialized driver of ``window`` slots per query from a
    canonical batch: docIDs and attrs of the driver lists (INVALID past
    them), a live stream with every seventh valid slot dead and tombstone
    flags cycling DEAD / SUPERSEDED / none.  Returns ``(a_docs, a_attrs,
    a_live, a_flags)``."""
    pos = torch.arange(window, dtype=torch.int64)
    valid = pos[None, :] < d_neff[:, None]
    idx = (d_off[:, None].long() + pos).clamp(max=t["postings"].numel() - 1)
    a_docs = torch.where(valid, t["postings"][idx], _INVALID)
    a_attrs = torch.where(valid, t["attrs"][idx], int(INVALID_ATTR))
    a_live = (valid & (pos % 7 != 3)).to(torch.int32)
    cyc = torch.tensor([0, int(DOC_DEAD), 0, int(DOC_SUPERSEDED), 0])[pos % 5]
    a_flags = torch.where(valid, cyc, 0).to(torch.int32)
    return a_docs, a_attrs, a_live, a_flags


def _canonical(packed: bool):
    """Both canonical indexes with their batches at K1's window: ``(label,
    tensors, live, batch, twin)``, ``twin`` None unless ``packed``."""
    out = []
    for label, lists, q in (("tile edge", _EDGE_LISTS, _EDGE_Q),
                            ("inner", _INNER_LISTS, _INNER_Q)):
        t, live = canonical_index(lists, widen=packed and label == "inner")
        batch = canonical_batch(t, *q, window=_K1_WINDOW)
        twin = pack_flat_postings(t["postings"], device="cpu") if packed else None
        out.append((label, t, live, batch, twin))
    return out


def _canonical_delta(n_terms: int):
    """The delta of the canonical instances: slabs of ``_K4_CAP``, full,
    empty, partial, one short of full and short."""
    fills = (_K4_CAP, 0, 100, _K4_CAP - 1, 17)[:n_terms]
    arrays = _reg.synthetic_delta_arrays(n_terms, _K4_CAP, fills)
    return _reg.tensors(arrays), n_terms * _K4_CAP


def _src_operands(prefix: str, src, live: int) -> list:
    """The operands of a posting source: a raw flat array or a twin."""
    if isinstance(src, PackedFlatArrays):
        return _reg.packed_operands(prefix, src)
    return [_reg.flat_operand(f"{prefix}postings", src, live)]


def _stream_table(rlo, rhi, act) -> tuple[np.ndarray, np.ndarray]:
    """Streams zeroed where their term is not active (``set_term``)."""
    act = act > 0
    return np.where(act, rlo, 0), np.where(act, rhi, 0)


def _stream_reads(lo_row, hi_row, sources) -> list:
    """Reads of one block's streams: stream ``j`` from ``sources[j %
    len(sources)]``, a raw name (bulk copies) or ``(prefix, woff)`` of a
    twin (its blocks' descriptors and words)."""
    out = []
    for j, (lo, hi) in enumerate(zip(lo_row.tolist(), hi_row.tolist())):
        src = sources[j % len(sources)]
        if isinstance(src, str):
            out += _reg.bulk_read(src, lo, hi)
        else:
            out += _reg.packed_read(src[0], src[1], lo, hi)
    return out


def _join_launch(kernel, *, grid, nstr, packed, locate, meta, driver, st_lo,
                 st_hi, sources, outs, window):
    """A join launch of ``csrc/slave_join.cuh``'s bodies: ``JOIN_SUB + 32``
    threads, ``probe_layout(nstr, packed)`` bytes of shared memory (opted
    in above 48 KB), a block's reads its location's, its driver slots' and
    its streams' (rows of ``st_lo``/``st_hi``), its writes the slots
    ``[t0, min(t0 + JOIN_SUB, window))`` of row ``q`` of each output."""
    smem = _reg.probe_smem(nstr, packed)

    def reads(b):
        q, t0, loc, extra = locate(b)
        return (extra + meta(q, t0) + driver(q, t0)
                + _stream_reads(st_lo[loc], st_hi[loc], sources))

    def writes(b):
        q, t0, _, _ = locate(b)
        hi = min(t0 + JOIN_SUB, window)
        return [Access(o, q * window + t0, q * window + hi) for o in outs] if hi > t0 else []

    return _reg.Launch(kernel, grid, JOIN_SUB + 32, smem,
                       smem > _reg.SMEM_STATIC_LIMIT, reads, writes)


def _dense_locate(num_a: int):
    def locate(b):
        x, q, _ = b
        i = x // _reg.NSUB
        return q, i * TILE + (x % _reg.NSUB) * JOIN_SUB, q * num_a + i, []
    return locate


def _table_locate(desc, heads):
    desc_h, heads_h = desc.long().numpy(), _host(heads)

    def locate(b):
        g = b[0] // _reg.NSUB
        r0, r1 = int(heads_h[g]), int(heads_h[g + 1])
        q, i = int(desc_h[r0, 0]), int(desc_h[r0, 1])
        extra = [Access("heads", g, g + 2), Access("desc", 8 * r0, 8 * r1)]
        return q, i * TILE + (b[0] % _reg.NSUB) * JOIN_SUB, g, extra
    return locate


def _flat_driver(d_off, d_neff, src):
    """K1's and K6's driver slots: read by position from the flat arrays,
    the first ``n_sub`` of the block's (raw), or decoded from the blocks
    that hold them (packed)."""
    off_h, neff_h = _host(d_off), _host(d_neff)
    woff = _host(src.blk_woff) if isinstance(src, PackedFlatArrays) else None

    def driver(q, t0):
        lo = int(off_h[q]) + t0
        n = max(0, min(int(neff_h[q]) - t0, JOIN_SUB))
        out = [Access("attrs", lo, lo + n)] if n else []
        if woff is None:
            return out + ([Access("postings", lo, lo + n)] if n else [])
        return out + _reg.packed_read("", woff, lo, lo + n, bulk=False)
    return driver


def _window_driver(names, window):
    """K4's, K7's and K9's driver: ``window`` slots a query of each of the
    materialized rows ``names``."""
    def driver(q, t0):
        hi = min(t0 + JOIN_SUB, window)
        return [Access(n, q * window + t0, q * window + hi) for n in names] if hi > t0 else []
    return driver


def _dense_meta(t_n, num_a, per_q, plans):
    """Reads of a dense plan at (q, i): one int of each ``per_q`` array,
    the query's ``[Q, T]`` row of ``active``, its ``[Q, T, A]`` plan
    entries at tile i (a strided read) and its ``[Q, T, 2]`` bounds."""
    def meta(q, t0):
        i = t0 // TILE
        out = [Access(n, q, q + 1) for n in per_q]
        for name, kind in plans:
            if kind == "qt":
                out.append(Access(name, q * t_n, (q + 1) * t_n))
            elif kind == "qta":
                base = q * t_n * num_a + i
                out.append(Access(name, base, base + 1, stride=num_a, count=t_n))
            else:
                out.append(Access(name, 2 * q * t_n, 2 * (q + 1) * t_n))
        return out
    return meta


def _operands(names_tensors) -> list:
    return [_reg.operand(n, x) for n, x in names_tensors if x is not None]


def driver_streamed_work(d_off, d_neff, active, attr_filter, src, attrs, b_tile,
                         n_b, bounds, *, window: int) -> Work:
    """K1's (K1p's, with a twin) least work: the plan and query arrays, the
    live driver postings (their docIDs, or the blocks that hold them, and
    their attrs), the probed postings (the union of each (query, term)'s
    planned ranges, or their blocks), the two outputs; one compare per
    binary-search step, per live driver posting and active other term,
    and four operations a decoded posting."""
    q_n = d_off.shape[0]
    small = _small_bytes(d_off, d_neff, active, attr_filter, b_tile, n_b, bounds)
    drv, out = int(d_neff.sum()), 2 * q_n * window * 4
    ops = int((d_neff.long() * active.long().sum(1)).sum()) * _wk.log2_ceil(window + TILE)
    if isinstance(src, PackedFlatArrays):
        meta = _meta(src)
        drv_b, drv_blk = _wk.span_block_cost(d_off, d_neff, meta)
        prb_b, prb_blk = _wk.probe_block_cost(b_tile, n_b, bounds, TILE, meta)
        return Work(small + drv_b + prb_b + drv * 4 + out,
                    ops + 4 * BLOCK * (drv_blk + prb_blk), "int32")
    probe = _wk.probed_postings(b_tile, n_b, bounds, TILE)
    return Work(small + drv * 8 + probe * 4 + out, ops, "int32")


def _k1_instances(packed: bool):
    out = []
    for label, t, live, (d_off, d_neff, terms, active, filt), twin in _canonical(packed):
        window = _K1_WINDOW
        b_tile, n_b, bounds = plan_driver_streamed(
            d_off, d_neff, terms, active, t["offsets"], t["lengths"], t["block_max"],
            window=window)
        q_n, t_n, num_a = b_tile.shape
        src = twin if packed else t["postings"]
        args = (d_off, d_neff, active, filt, src, t["attrs"], b_tile, n_b, bounds)
        rlo, rhi = _wk.probed_ranges(b_tile, n_b, bounds, TILE)
        act = np.broadcast_to(active.numpy()[:, :, None], rlo.shape)
        lo, hi = _stream_table(rlo, rhi, act)
        # (q, t, i) -> row q * A + i, stream t
        lo, hi = (x.transpose(0, 2, 1).reshape(q_n * num_a, t_n) for x in (lo, hi))
        operands = (_operands([("d_off", d_off), ("d_neff", d_neff), ("active", active),
                          ("attr_filter", filt), ("b_tile", b_tile), ("n_b", n_b),
                          ("bounds", bounds)])
                    + _src_operands("", src, live)
                    + [_reg.flat_operand("attrs", t["attrs"], live),
                       _reg.Operand("out_docs", "int32", q_n * window),
                       _reg.Operand("out_mask", "int32", q_n * window)])
        launch = _join_launch(
            "driver_streamed_packed_kernel" if packed else "driver_streamed_kernel",
            grid=(num_a * _reg.NSUB, q_n, 1), nstr=t_n, packed=packed,
            locate=_dense_locate(num_a),
            meta=_dense_meta(t_n, num_a, ("d_off", "d_neff", "attr_filter"),
                             (("active", "qt"), ("b_tile", "qta"), ("n_b", "qta"),
                              ("bounds", "qt2"))),
            driver=_flat_driver(d_off, d_neff, src), st_lo=lo, st_hi=hi,
            sources=[("", _host(src.blk_woff)) if packed else "postings"],
            outs=("out_docs", "out_mask"), window=window)
        out.append(_reg.Instance(label, tuple(operands), (launch,), args,
                                 {"window": window}))
    return out


@_reg.launch_contract("driver_streamed", kid="K1", kernels=("driver_streamed_kernel",),
                      wrapper=driver_streamed_join_cuda,
                      plain=driver_streamed_join_torch, work=driver_streamed_work)
def _driver_streamed_contract():
    return _k1_instances(False)


@_reg.launch_contract("driver_streamed_packed", kid="K1p",
                      kernels=("driver_streamed_packed_kernel",),
                      wrapper=driver_streamed_join_packed_cuda,
                      plain=driver_streamed_join_packed_torch, work=driver_streamed_work)
def _driver_streamed_packed_contract():
    return _k1_instances(True)


def _probe_cost(src, b_tile, n_b, bounds):
    """``(bytes, blocks)`` a probe plan reads from ``src`` (raw: 4 bytes a
    probed posting, no block)."""
    if isinstance(src, PackedFlatArrays):
        return _wk.probe_block_cost(b_tile, n_b, bounds, TILE, _meta(src))
    return _wk.probed_postings(b_tile, n_b, bounds, TILE) * 4, 0


def streamed_join_work(a_docs, a_attrs, a_live, a_flags, active, attr_filter, src,
                       b_tile, n_b, bounds, d_src, d_tile, n_d, d_bounds, *,
                       cap: int) -> Work:
    """K4's (K4p's, with twins) least work.  Under merge-on-read: every
    driver docID, the live stream of valid slots, the flags of live slots
    of queries that join a term, the attrs of valid slots of filtered
    queries, the plans, the probed postings (or blocks) of both probes,
    the mask; two binary searches per live slot and active term.  In the
    static mode: the docIDs, the live stream of valid slots and their
    attrs where filtered, the main plan, one search per valid slot and
    active term."""
    q_n, window = a_docs.shape
    t_n = active.shape[1]
    valid = (a_docs != _INVALID).long().sum(1)
    filtered = int(valid[attr_filter >= 0].sum())
    out = q_n * window * 4
    m_b, m_blk = _probe_cost(src, b_tile, n_b, bounds)
    if d_src is None:
        slots = q_n * window + int(valid.sum()) * 2 + filtered
        small = _small_bytes(b_tile, n_b, bounds) + 4 * q_n * (1 + t_n)
        ops = int((valid * active.long().sum(1)).sum()) * _wk.log2_ceil(window + TILE)
        return Work(small + slots * 4 + m_b + out, ops + 4 * BLOCK * m_blk, "int32")
    d_b, d_blk = _probe_cost(d_src, d_tile, n_d, d_bounds)
    live = (a_live != 0).long().sum(1)
    joins = active.long().sum(1) > 0
    slots = q_n * window + int(valid.sum()) + int(live[joins].sum()) + filtered
    small = _small_bytes(active, b_tile, n_b, bounds, d_tile, n_d, d_bounds) + q_n * 4
    ops = int((live * active.long().sum(1)).sum()) * (
        _wk.log2_ceil(window + TILE) + _wk.log2_ceil(cap + TILE))
    return Work(small + (slots + q_n * window) * 4 + m_b + d_b,
                ops + 4 * BLOCK * (m_blk + d_blk), "int32")


def _k4_setup(packed: bool, has_delta: bool):
    """K4's canonical inputs on both indexes: ``(label, t, live, batch,
    twin, driver, delta, d_twin, d_live, plans)``."""
    out = []
    for label, t, live, batch, twin in _canonical(packed):
        d_off, d_neff, terms, active, filt = batch
        drv = canonical_driver(t, d_off, d_neff, window=_K4_WINDOW)
        delta, d_live = _canonical_delta(t["offsets"].numel())
        d_twin = (pack_flat_postings(delta["d_postings"], span_blocks=_K4_CAP // BLOCK,
                                     device="cpu") if packed and has_delta else None)
        d = (delta["d_offsets"], delta["d_lengths"], delta["d_block_max"]) \
            if has_delta else (None,) * 3
        a_any, main, dplan, cap = _streamed_plans(
            drv[0], terms, active, t["offsets"], t["lengths"], t["block_max"], *d)
        out.append((label, t, live, batch, twin, drv, delta, d_twin, d_live,
                    (a_any, main, dplan, cap)))
    return out


def _k4_instances(packed: bool):
    out = []
    for has_delta in (True, False):
        for (label, t, live, (d_off, d_neff, terms, active, filt), twin, drv,
             delta, d_twin, d_live, (_, main, dplan, cap)) in _k4_setup(packed, has_delta):
            a_docs, a_attrs, a_live, a_flags = drv
            q_n, window = a_docs.shape
            t_n = active.shape[1]
            num_a = -(-window // TILE)
            src = twin if packed else t["postings"]
            d_src = (d_twin if packed else delta["d_postings"]) if has_delta else None
            args = (a_docs, a_attrs, a_live, a_flags if has_delta else None, active,
                    filt, src, *main, d_src, *(dplan or (None,) * 3))
            spt = 2 if has_delta else 1
            act = np.broadcast_to(active.numpy()[:, :, None], (q_n, t_n, num_a))
            tables = [_stream_table(*_wk.probed_ranges(*main, TILE), act)]
            if has_delta:
                tables.append(_stream_table(*_wk.probed_ranges(*dplan, TILE), act))
            # (q, t, i, kind) -> row q * A + i, stream t * spt + kind
            lo, hi = (np.stack([tb[k] for tb in tables], -1).transpose(0, 2, 1, 3)
                      .reshape(q_n * num_a, t_n * spt) for k in (0, 1))
            sources = [("", _host(src.blk_woff)) if packed else "postings"]
            if has_delta:
                sources.append(("d_", _host(d_src.blk_woff)) if packed else "d_postings")
            rows = ("a_docs", "a_attrs", "a_live") + (("a_flags",) if has_delta else ())
            plan_names = (("active", "qt"), ("b_tile", "qta"), ("n_b", "qta"),
                          ("bounds", "qt2"))
            if has_delta:
                plan_names += (("d_tile", "qta"), ("n_d", "qta"), ("d_bounds", "qt2"))
            operands = (_operands([("a_docs", a_docs), ("a_attrs", a_attrs), ("a_live", a_live),
                              ("a_flags", args[3]), ("active", active),
                              ("attr_filter", filt), ("b_tile", main[0]),
                              ("n_b", main[1]), ("bounds", main[2])]
                             + ([("d_tile", dplan[0]), ("n_d", dplan[1]),
                                 ("d_bounds", dplan[2])] if has_delta else []))
                        + _src_operands("", src, live)
                        + (_src_operands("d_", d_src, d_live) if has_delta else [])
                        + [_reg.Operand("out_mask", "int32", q_n * window)])
            launch = _join_launch(
                "streamed_join_packed_kernel" if packed else "streamed_join_kernel",
                grid=(num_a * _reg.NSUB, q_n, 1), nstr=t_n * spt, packed=packed,
                locate=_dense_locate(num_a),
                meta=_dense_meta(t_n, num_a, ("attr_filter",), plan_names),
                driver=_window_driver(rows, window), st_lo=lo, st_hi=hi,
                sources=sources, outs=("out_mask",), window=window)
            out.append(_reg.Instance(
                f"{label}, {'merge-on-read' if has_delta else 'static'}",
                tuple(operands), (launch,), args, {"cap": cap}))
    return out


@_reg.launch_contract("streamed_join", kid="K4", kernels=("streamed_join_kernel",),
                      wrapper=streamed_join_cuda, plain=streamed_join_torch,
                      work=streamed_join_work)
def _streamed_join_contract():
    return _k4_instances(False)


@_reg.launch_contract("streamed_join_packed", kid="K4p",
                      kernels=("streamed_join_packed_kernel",),
                      wrapper=streamed_join_packed_cuda, plain=streamed_join_packed_torch,
                      work=streamed_join_work)
def _streamed_join_packed_contract():
    return _k4_instances(True)


def _pow2_live(plan_fn, q_n: int):
    """The first ``live_q`` pattern (all live, then fewer) whose work list
    has a power-of-two item count (the edge where the table's spare entry
    is all its padding), else all live; returns ``(live_q, result)``."""
    first = None
    for mask in range((1 << q_n) - 1, 0, -1):
        live_q = np.array([(mask >> q) & 1 for q in range(q_n)], bool)
        res = plan_fn(live_q)
        n = res[0].n_items
        if first is None:
            first = (live_q, res)
        if n and n & (n - 1) == 0:
            return live_q, res
    return first


def _desc_operands(desc, heads, n_items: int) -> list:
    from repro_torch.kernels.worklist import DESC_COLS

    return [_reg.operand("desc", desc, padding_from=n_items * DESC_COLS,
                         pad="worklist_entry", spare=DESC_COLS),
            _reg.operand("heads", heads)]


def _table_groups(desc, heads):
    heads_h = _host(heads)
    first = desc.long().cpu().numpy()[heads_h[:-1]]
    return first[:, 0], first[:, 1], heads_h


def driver_compact_work(desc, heads, d_off, d_neff, attr_filter, src, attrs, bounds,
                        *, window: int) -> Work:
    """K6's (K6p's) least work: the table (32 bytes a row, 4 a head), the
    query arrays and bounds, each group's live driver slots (docIDs and
    attrs, or blocks and attrs), the probed postings per (query, term) of
    the table's rows (or their blocks), both outputs; a search per live
    driver slot per probe row."""
    q_n, t_n = bounds.shape[:2]
    q6, i6, heads_h = _table_groups(desc, heads)
    n_items = int(heads_h[-1])
    live6 = np.clip(_host(d_neff)[q6] - i6 * TILE, 0, TILE)
    desc_h = desc.cpu().numpy()
    rows = desc_h[:n_items]
    bounds_h = bounds.long().cpu().numpy()
    small = 32 * n_items + 4 * (len(q6) + 1) + 12 * q_n + 8 * q_n * t_n
    out = 2 * q_n * window * 4
    row_group = np.cumsum(rows[:, 4] & 1) - 1
    ops = int(live6[row_group[rows[:, 3] >= 0]].sum()) * int(np.log2(TILE))
    if isinstance(src, PackedFlatArrays):
        meta = _meta(src)
        d_b, d_blk = _wk.span_block_cost(_host(d_off)[q6] + i6 * TILE, live6, meta)
        p_b, p_blk = _wk.table_probe_cost(desc_h, n_items, bounds_h, 3, TILE, meta)
        return Work(small + d_b + p_b + int(live6.sum()) * 4 + out,
                    ops + 4 * BLOCK * (d_blk + p_blk), "int32")
    probe = _wk.table_probe_cost(desc_h, n_items, bounds_h, 3, TILE)
    return Work(small + int(live6.sum()) * 8 + probe * 4 + out, ops, "int32")


def _k6_instances(packed: bool):
    from repro_torch.kernels.worklist import table_to_device

    out = []
    for label, t, live, (d_off, d_neff, terms, active, filt), twin in _canonical(packed):
        window = _K1_WINDOW
        live_q, (wl, bounds) = _pow2_live(lambda lq: plan_driver_compact(
            d_off, d_neff, terms, active, t["offsets"], t["lengths"], t["block_max"],
            window=window, live_q=lq, packed=packed), d_off.shape[0])
        desc, heads = table_to_device(wl, "cpu")
        q_n, t_n = bounds.shape[:2]
        n_groups = heads.numel() - 1
        src = twin if packed else t["postings"]
        args = (desc, heads, d_off, d_neff, filt, src, t["attrs"], bounds)
        lo, hi, act = (x.numpy() for x in table_streams(desc, heads, bounds))
        lo, hi = _stream_table(lo, hi, act)
        operands = (_desc_operands(desc, heads, wl.n_items)
                    + _operands([("d_off", d_off), ("d_neff", d_neff), ("attr_filter", filt),
                            ("bounds", bounds)])
                    + _src_operands("", src, live)
                    + [_reg.flat_operand("attrs", t["attrs"], live),
                       _reg.Operand("out_docs", "int32", q_n * window),
                       _reg.Operand("out_mask", "int32", q_n * window)])
        launch = _join_launch(
            "driver_compact_packed_kernel" if packed else "driver_compact_kernel",
            grid=(n_groups * _reg.NSUB, 1, 1), nstr=t_n, packed=packed,
            locate=_table_locate(desc, heads),
            meta=_dense_meta(t_n, 1, ("d_off", "d_neff", "attr_filter"),
                             (("bounds", "qt2"),)),
            driver=_flat_driver(d_off, d_neff, src), st_lo=lo, st_hi=hi,
            sources=[("", _host(src.blk_woff)) if packed else "postings"],
            outs=("out_docs", "out_mask"), window=window)
        out.append(_reg.Instance(f"{label}, {wl.n_items} items, live {live_q.tolist()}",
                                 tuple(operands), (launch,), args, {"window": window}))
    return out


@_reg.launch_contract("driver_compact", kid="K6", kernels=("driver_compact_kernel",),
                      wrapper=driver_compact_join_cuda, plain=driver_compact_join_torch,
                      work=driver_compact_work)
def _driver_compact_contract():
    return _k6_instances(False)


@_reg.launch_contract("driver_compact_packed", kid="K6p",
                      kernels=("driver_compact_packed_kernel",),
                      wrapper=driver_compact_join_packed_cuda,
                      plain=driver_compact_join_packed_torch, work=driver_compact_work)
def _driver_compact_packed_contract():
    return _k6_instances(True)


def streamed_compact_work(desc, heads, a_docs, a_attrs, a_live, a_flags, attr_filter,
                          src, bounds, d_src, d_bounds) -> Work:
    """K7's (K7p's) least work: K4's driver reads (a query joins a term
    where a row of its groups starts a term run), the table, the probed
    postings per (query, term) of its rows (or their blocks), the mask; a
    search per live slot of a group per probe of each row."""
    q_n, window = a_docs.shape
    t_n = bounds.shape[1]
    q7, i7, heads_h = _table_groups(desc, heads)
    n_items = int(heads_h[-1])
    desc_h = desc.cpu().numpy()
    rows = desc_h[:n_items]
    rg = np.cumsum(rows[:, 4] & 1) - 1
    joins = np.zeros(q_n, bool)
    joins[q7[rg[(rows[:, 4] & FLAG_TERM_START) != 0]]] = True
    joins = torch.from_numpy(joins).to(a_live.device)
    valid = (a_docs != _INVALID).long().sum(1)
    live = (a_live != 0).long().sum(1)
    filtered = int(valid[attr_filter >= 0].sum())
    table = 32 * n_items + 4 * (len(q7) + 1)
    out = q_n * window * 4
    slots_g = np.clip(_pad_to_tile((a_live != 0).int(), 0).long().view(q_n, -1, TILE)
                      .sum(-1).cpu().numpy()[q7, i7], 0, TILE)
    has_delta = d_src is not None
    probes = (rows[:, 3] >= 0).astype(np.int64) + (
        (rows[:, 5] >= 0) if has_delta else 0)
    ops = int((slots_g[rg] * probes).sum()) * int(np.log2(TILE))

    def cost(s, b, col):
        b_h = b.long().cpu().numpy()
        if isinstance(s, PackedFlatArrays):
            return _wk.table_probe_cost(desc_h, n_items, b_h, col, TILE, _meta(s))
        return _wk.table_probe_cost(desc_h, n_items, b_h, col, TILE) * 4, 0

    m_b, m_blk = cost(src, bounds, 3)
    if not has_delta:
        slots = q_n * window + int(valid.sum()) * 2 + filtered
        return Work(table + slots * 4 + m_b + out, ops + 4 * BLOCK * m_blk, "int32")
    d_b, d_blk = cost(d_src, d_bounds, 5)
    slots = q_n * window + int(valid.sum()) + int(live[joins].sum()) + filtered
    small = table + 4 * q_n + 16 * q_n * t_n
    return Work(small + slots * 4 + out + m_b + d_b, ops + 4 * BLOCK * (m_blk + d_blk),
                "int32")


def _k7_instances(packed: bool):
    from repro_torch.kernels.worklist import table_to_device

    out = []
    for has_delta in (True, False):
        for (label, t, live, (d_off, d_neff, terms, active, filt), twin, drv, delta,
             d_twin, d_live, _) in _k4_setup(packed, has_delta):
            a_docs, a_attrs, a_live, a_flags = drv
            d = ((delta["d_offsets"], delta["d_lengths"], delta["d_block_max"])
                 if has_delta else (None,) * 3)
            live_q, (wl, bounds, d_bounds) = _pow2_live(lambda lq: plan_streamed_compact(
                a_docs, terms, active, t["offsets"], t["lengths"], t["block_max"], *d,
                live_q=lq, packed=packed), a_docs.shape[0])
            desc, heads = table_to_device(wl, "cpu")
            q_n, window = a_docs.shape
            t_n = bounds.shape[1]
            n_groups = heads.numel() - 1
            src = twin if packed else t["postings"]
            d_src = (d_twin if packed else delta["d_postings"]) if has_delta else None
            args = (desc, heads, a_docs, a_attrs, a_live, a_flags if has_delta else None,
                    filt, src, bounds, d_src, d_bounds)
            spt = 2 if has_delta else 1
            lo, hi, act = (x.numpy() for x in table_streams(desc, heads, bounds, d_bounds))
            lo, hi = _stream_table(lo, hi, act)
            sources = [("", _host(src.blk_woff)) if packed else "postings"]
            if has_delta:
                sources.append(("d_", _host(d_src.blk_woff)) if packed else "d_postings")
            rows = ("a_docs", "a_attrs", "a_live") + (("a_flags",) if has_delta else ())
            plan_names = (("bounds", "qt2"),) + ((("d_bounds", "qt2"),) if has_delta else ())
            operands = (_desc_operands(desc, heads, wl.n_items)
                        + _operands([("a_docs", a_docs), ("a_attrs", a_attrs),
                                ("a_live", a_live), ("a_flags", args[5]),
                                ("attr_filter", filt), ("bounds", bounds),
                                ("d_bounds", d_bounds)])
                        + _src_operands("", src, live)
                        + (_src_operands("d_", d_src, d_live) if has_delta else [])
                        + [_reg.Operand("out_mask", "int32", q_n * window)])
            launch = _join_launch(
                "streamed_compact_packed_kernel" if packed else "streamed_compact_kernel",
                grid=(n_groups * _reg.NSUB, 1, 1), nstr=t_n * spt, packed=packed,
                locate=_table_locate(desc, heads),
                meta=_dense_meta(t_n, 1, ("attr_filter",), plan_names),
                driver=_window_driver(rows, window), st_lo=lo, st_hi=hi,
                sources=sources, outs=("out_mask",), window=window)
            out.append(_reg.Instance(
                f"{label}, {'merge-on-read' if has_delta else 'static'}, "
                f"{wl.n_items} items, live {live_q.tolist()}",
                tuple(operands), (launch,), args, {}))
    return out


@_reg.launch_contract("streamed_compact", kid="K7", kernels=("streamed_compact_kernel",),
                      wrapper=streamed_compact_join_cuda,
                      plain=streamed_compact_join_torch, work=streamed_compact_work)
def _streamed_compact_contract():
    return _k7_instances(False)


@_reg.launch_contract("streamed_compact_packed", kid="K7p",
                      kernels=("streamed_compact_packed_kernel",),
                      wrapper=streamed_compact_join_packed_cuda,
                      plain=streamed_compact_join_packed_torch, work=streamed_compact_work)
def _streamed_compact_packed_contract():
    return _k7_instances(True)


def batched_block_skip_work(a_docs, a_attrs, a_live, b_docs, active, attr_filter,
                            b_start, n_b) -> Work:
    """K9's least work: the driver docIDs, attrs of valid slots of
    filtered queries, the live stream of valid slots (when given), the
    active flags, filters and skip map, the postings in the skip ranges,
    the mask; a search over the other-term window per valid slot and
    active term."""
    q_n, w_b = a_docs.shape[0], b_docs.shape[-1]
    valid = (a_docs != _INVALID).long().sum(1)
    span = torch.tensor([0, w_b], dtype=torch.int32).expand(*active.shape, 2)
    probed = _wk.probed_postings(b_start, n_b, span, TILE)
    n_bytes = (a_docs.numel() + int(valid[attr_filter >= 0].sum())
               + (0 if a_live is None else int(valid.sum()))
               + active.numel() + q_n + 2 * b_start.numel() + probed
               + a_docs.numel()) * 4
    ops = int((valid * active.long().sum(1)).sum()) * _wk.log2_ceil(w_b)
    return Work(n_bytes, ops, "int32")


def block_skip_work(a_docs, a_attrs, b_docs, attr_filter, b_start, n_b) -> Work:
    """K10's least work: K9's at one query and one active term."""
    valid = int((a_docs != _INVALID).sum())
    span = torch.tensor([[[0, b_docs.shape[0]]]], dtype=torch.int32)
    probed = _wk.probed_postings(b_start[None, None], n_b[None, None], span, TILE)
    n_bytes = (a_docs.numel() + (valid if int(attr_filter) >= 0 else 0) + 2
               + 2 * b_start.numel() + probed + a_docs.numel()) * 4
    return Work(n_bytes, valid * _wk.log2_ceil(max(b_docs.shape[0], 2)), "int32")


def _skip_launch(kernel, *, q_n, t_n, num_a, w_b, b_start, n_b, active, rows, meta):
    lo, hi, act = (x.numpy() for x in skip_streams(b_start, n_b, active, w_b))
    lo, hi = _stream_table(lo, hi, act)
    lo, hi = (x.transpose(0, 2, 1).reshape(q_n * num_a, t_n) for x in (lo, hi))
    window = num_a * TILE
    return _join_launch(kernel, grid=(num_a * _reg.NSUB, q_n, 1), nstr=t_n,
                        packed=False, locate=_dense_locate(num_a), meta=meta,
                        driver=_window_driver(rows, window), st_lo=lo, st_hi=hi,
                        sources=["b_docs"], outs=("out_mask",), window=window)


def _term_windows(t, terms, w_b: int):
    """``[Q, T, w_b]``: the first ``w_b`` postings of each slot's list
    (INVALID past it and for NO_TERM)."""
    pos = torch.arange(w_b, dtype=torch.int64)
    tt = terms.clamp(min=0).long()
    n = torch.where(terms >= 0, t["lengths"][tt], 0)[..., None]
    idx = (t["offsets"][tt][..., None].long() + pos).clamp(max=t["postings"].numel() - 1)
    return torch.where(pos < n, t["postings"][idx], _INVALID).to(torch.int32)


@_reg.launch_contract("batched_block_skip", kid="K9", kernels=("staged_join_kernel",),
                      wrapper=batched_block_skip_join_cuda,
                      plain=batched_block_skip_join_torch, work=batched_block_skip_work)
def _batched_block_skip_contract():
    out = []
    for label, t, _, (d_off, d_neff, terms, active, filt), _ in _canonical(False):
        a_docs, a_attrs, a_live, _ = canonical_driver(t, d_off, d_neff, window=_K4_WINDOW)
        b_docs = _term_windows(t, terms, 2000)
        for with_live in (True, False):
            args = batched_block_skip_args(a_docs, a_attrs, b_docs, active, filt,
                                           a_live if with_live else None)
            a, aa, al, b, act, f, b_start, n_b = args
            q_n, t_n, w_b = b.shape
            num_a = a.shape[1] // TILE
            rows = ("a_docs", "a_attrs") + (("a_live",) if with_live else ())
            launch = _skip_launch(
                "staged_join_kernel", q_n=q_n, t_n=t_n, num_a=num_a, w_b=w_b,
                b_start=b_start, n_b=n_b, active=act, rows=rows,
                meta=_dense_meta(t_n, num_a, ("attr_filter",),
                                 (("active", "qt"), ("b_start", "qta"), ("n_b", "qta"))))
            operands = _operands([("a_docs", a), ("a_attrs", aa), ("a_live", al),
                             ("b_docs", b), ("active", act), ("attr_filter", f),
                             ("b_start", b_start), ("n_b", n_b)]) + [
                _reg.Operand("out_mask", "int32", a.numel())]
            out.append(_reg.Instance(f"{label}, a_live {'given' if with_live else 'null'}",
                                     tuple(operands), (launch,), args, {}))
    return out


@_reg.launch_contract("block_skip", kid="K10", kernels=("skip_join_kernel",),
                      wrapper=block_skip_join_cuda, plain=block_skip_join_torch,
                      work=block_skip_work)
def _block_skip_contract():
    out = []
    t, _ = canonical_index(_INNER_LISTS)
    lists = [t["postings"][int(o):int(o) + int(n)]
             for o, n in zip(t["offsets"], t["lengths"])]
    for label, a_t, b_t, filt in (("lists 3 and 0", 3, 0, -1), ("list 1 and 3", 1, 3, 1),
                                  ("against an empty list", 0, 4, -1)):
        a_attrs = t["attrs"][int(t["offsets"][a_t]):][:lists[a_t].numel()]
        # an empty list as the kernel takes it: one tile of INVALID
        b_list = lists[b_t] if lists[b_t].numel() else torch.full((TILE,), _INVALID)
        args = block_skip_args(lists[a_t], a_attrs, b_list.to(torch.int32), filt)
        a, aa, b, f, b_start, n_b = args
        num_a, w_b = a.numel() // TILE, b.numel()
        launch = _skip_launch(
            "skip_join_kernel", q_n=1, t_n=1, num_a=num_a, w_b=w_b,
            b_start=b_start[None, None], n_b=n_b[None, None], active=None,
            rows=("a_docs", "a_attrs"),
            meta=lambda q, t0: [Access("attr_filter", 0, 1),
                                Access("b_start", t0 // TILE, t0 // TILE + 1),
                                Access("n_b", t0 // TILE, t0 // TILE + 1)])
        operands = _operands([("a_docs", a), ("a_attrs", aa), ("b_docs", b),
                         ("attr_filter", f), ("b_start", b_start), ("n_b", n_b)]) + [
            _reg.Operand("out_mask", "int32", a.numel())]
        out.append(_reg.Instance(label, tuple(operands), (launch,), args, {}))
    return out
