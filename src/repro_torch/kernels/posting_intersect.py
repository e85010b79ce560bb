"""The static slave join (K1): ZigZag posting-list intersection with
posting skipping, driver window streamed from the flat index arrays.

Replaces the TPU kernel
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

The module holds three things: the plan helpers, the plain PyTorch join
:func:`driver_streamed_join_torch` (what the CPU runs, and the reference the
card's kernel is held against), and :func:`driver_streamed_join_cuda`, the
wrapper of ``csrc/driver_streamed.cu``.  :func:`driver_streamed_join`
picks by the device of the tensors it is given; there is no fallback.
"""
from __future__ import annotations

import torch

from repro_torch.core.index import BLOCK, INVALID_ATTR, INVALID_DOC, TILE

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
    """Plain PyTorch version of the kernel, on the same inputs.

    For query ``q``, driver tile ``i`` and active term ``t``, the postings
    probed are the contiguous positions ``[max(b_tile*TILE, lo),
    min((b_tile + n_b)*TILE, hi))`` of one ascending list.  They are
    gathered from the term's bounded window with ``_NEG`` below the range
    and ``INVALID_DOC`` above it, which keeps each row sorted, and probed
    with ``searchsorted``.  Returns ``(docs, mask)``, int32[Q, window].
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

    lo = bounds[..., 0].long()                              # [Q, T]
    hi = bounds[..., 1].long()
    rlo = torch.maximum(b_tile.long() * TILE, lo[..., None])       # [Q, T, A]
    rhi = torch.minimum((b_tile.long() + n_b.long()) * TILE, hi[..., None])
    rhi = torch.where(n_b > 0, rhi, rlo)
    j = torch.arange(window, dtype=torch.int64, device=dev)
    p = lo[..., None, None] + j                             # [Q, T, 1, W]
    bw = postings[p.clamp(max=postings.shape[0] - 1)]
    b = torch.where(p < rlo[..., None], torch.full_like(bw, _NEG),
                    torch.where(p < rhi[..., None], bw,
                                torch.full_like(bw, _INVALID)))  # [Q, T, A, W]
    a_tiles = a.view(q_n, 1, num_a, TILE).expand(-1, b.shape[1], -1, -1)
    hit = torch.searchsorted(b, a_tiles.contiguous()).clamp(max=window - 1)
    member = b.gather(-1, hit) == a_tiles                   # [Q, T, A, TILE]
    member = member | (active == 0)[:, :, None, None]
    mask = keep & member.all(dim=1).reshape(q_n, num_a * TILE)
    return a[:, :window].contiguous(), mask[:, :window].to(torch.int32)


def _check_join_inputs(d_off, d_neff, active, attr_filter, postings, attrs,
                       b_tile, n_b, bounds, window):
    q_n, t_n = active.shape
    num_a = -(-window // TILE)
    shapes = dict(
        d_off=(d_off, (q_n,)), d_neff=(d_neff, (q_n,)),
        attr_filter=(attr_filter, (q_n,)), b_tile=(b_tile, (q_n, t_n, num_a)),
        n_b=(n_b, (q_n, t_n, num_a)), bounds=(bounds, (q_n, t_n, 2)),
        postings=(postings, postings.shape[:1]), attrs=(attrs, postings.shape[:1]),
    )
    for name, (x, shape) in shapes.items():
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")
    for name, x in dict(shapes, active=(active, None)).items():
        x = x[0]
        if x.dtype != torch.int32 or not x.is_cuda or not x.is_contiguous():
            raise ValueError(f"{name}: need a contiguous int32 CUDA tensor, "
                             f"got {x.dtype} on {x.device}")
    if postings.shape[0] >= 2**31:
        raise ValueError("flat arrays past 2**31 postings need int64 offsets")
    if q_n >= 65536:
        raise ValueError(f"{q_n} queries exceed the grid's y extent (65535)")


def driver_streamed_join_cuda(
    d_off, d_neff, active, attr_filter, postings, attrs, b_tile, n_b, bounds,
    *, window: int,
):
    """Launch ``csrc/driver_streamed.cu`` (one block per query and driver
    tile) on the current stream.  Same signature and result as
    :func:`driver_streamed_join_torch`."""
    from repro_torch.kernels import _build

    _check_join_inputs(d_off, d_neff, active, attr_filter, postings, attrs,
                       b_tile, n_b, bounds, window)
    launch = _build.kernel("driver_streamed")
    q_n, t_n = active.shape
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
    return fn(d_off, d_neff, active, attr_filter, postings, attrs,
              b_tile, n_b, bounds, window=window)


def plan_driver_streamed(d_off, d_neff, terms, active, offsets, lengths,
                         block_max, *, window: int):
    """The probe plan the join consumes: ``(b_tile, n_b, bounds)``, with
    ``n_b`` zeroed for inactive slots."""
    num_a = -(-window // TILE)
    a_spans = driver_tile_spans(block_max, d_off, d_neff, s_tiles=num_a)
    b_tile, n_b, bounds = _probe_plan(
        a_spans, terms, offsets, lengths, block_max,
        window=window, s_tiles=num_a + 1,
    )
    return b_tile, n_b * active[:, :, None], bounds


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
):
    """Batched ZigZag join with the driver window streamed from the index:
    plan, then the join.  Returns ``(docs, mask)``, int32[Q, window]."""
    active = active.to(torch.int32)
    b_tile, n_b, bounds = plan_driver_streamed(
        d_off, d_neff, terms, active, offsets, lengths, block_max,
        window=window,
    )
    return driver_streamed_join(
        d_off.contiguous(), d_neff.contiguous(), active.contiguous(),
        attr_filter.to(torch.int32).contiguous(), postings, attrs,
        b_tile.contiguous(), n_b.contiguous(), bounds.contiguous(),
        window=window,
    )

