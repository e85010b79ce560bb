"""Counting helpers of the kernels' work: what a launch's data needs.

The launch contracts' ``work`` functions (:mod:`repro_torch.kernels.registry`)
are built from these: the postings a probe plan reads (the union of its
planned ranges), the packed blocks and descriptor bytes a packed kernel
decodes, the compares of a binary search, and the (row, key) pairs an
attention forward keeps.  :mod:`repro_torch.roofline` prices the counts
at the card's rates.
"""
from __future__ import annotations

import math

import numpy as np


def window_keys(S: int, W: int) -> int:
    """Keys a causal row sees under window W, summed over S rows:
    sum of min(i + 1, W)."""
    full = min(S, W)
    return full * (full + 1) // 2 + (S - full) * W


def attention_keys(S: int, T: int, *, causal: bool, window: int = 0) -> int:
    """(row, key) pairs an attention forward computes: a causal row ``i``
    sees keys ``[0, i]`` (with ``window``, the last ``window`` of them), cut
    at ``T``; otherwise every row sees all ``T`` keys."""
    if not causal:
        return S * T
    i = np.arange(S, dtype=np.int64)
    lo = np.maximum(0, i - window + 1) if window else 0
    return int(np.maximum(np.minimum(i + 1, T) - lo, 0).sum())


def _np(x) -> np.ndarray:
    return x.long().cpu().numpy() if hasattr(x, "cpu") else np.asarray(x, np.int64)


def union_length(lo: np.ndarray, hi: np.ndarray) -> int:
    """Total length of the union of the intervals [lo, hi) (non-empty ones)."""
    keep = hi > lo
    lo, hi = lo[keep], hi[keep]
    order = np.argsort(lo, kind="stable")
    total, cur_lo, cur_hi = 0, None, None
    for a, b in zip(lo[order].tolist(), hi[order].tolist()):
        if cur_hi is None or a > cur_hi:
            if cur_hi is not None:
                total += cur_hi - cur_lo
            cur_lo, cur_hi = a, b
        else:
            cur_hi = max(cur_hi, b)
    if cur_hi is not None:
        total += cur_hi - cur_lo
    return total


def probed_ranges(b_tile, n_b, bounds, tile):
    """The planned probe ranges [rlo, rhi) of a plan, each [Q, T, A]."""
    lo, hi = _np(bounds[..., 0]), _np(bounds[..., 1])
    bt = _np(b_tile) * tile
    nb = _np(n_b)
    rlo = np.maximum(bt, lo[..., None])
    rhi = np.where(nb > 0, np.minimum(bt + nb * tile, hi[..., None]), rlo)
    return rlo, rhi


def probed_postings(b_tile, n_b, bounds, tile) -> int:
    """Postings a probe plan reads: per (query, term) the union of its
    planned ranges [max(b_tile*TILE, lo), min((b_tile+n_b)*TILE, hi))."""
    rlo, rhi = probed_ranges(b_tile, n_b, bounds, tile)
    return sum(union_length(rlo[q, t], rhi[q, t])
               for q in range(rlo.shape[0]) for t in range(rlo.shape[1]))


def range_blocks(lo: np.ndarray, hi: np.ndarray, block: int) -> np.ndarray:
    """The distinct blocks that hold the positions of the ranges [lo, hi)."""
    keep = hi > lo
    firsts, lasts = lo[keep] // block, (hi[keep] - 1) // block
    if firsts.size == 0:
        return np.zeros(0, np.int64)
    return np.unique(np.concatenate([np.arange(a, b + 1)
                                     for a, b in zip(firsts.tolist(), lasts.tolist())]))


def packed_block_cost(blocks: np.ndarray, meta_host: np.ndarray) -> tuple[int, int]:
    """``(bytes, blocks)`` a packed kernel must read to decode ``blocks``:
    each block's packed words (4 * width words of 4 bytes) and its 12
    descriptor bytes.  ``meta_host`` is the twin's ``blk_meta`` up to
    ``n_blocks``."""
    blocks = blocks[blocks < meta_host.shape[0]]
    widths = meta_host[blocks] & 63
    return int((widths.astype(np.int64) * 16).sum()) + 12 * int(blocks.size), int(blocks.size)


def probe_block_cost(b_tile, n_b, bounds, tile, meta_host) -> tuple[int, int]:
    """``packed_block_cost`` of a probe plan: per (query, term) the blocks
    of the union of its planned ranges (the convention of
    ``probed_postings``), summed."""
    rlo, rhi = probed_ranges(b_tile, n_b, bounds, tile)
    costs = [packed_block_cost(range_blocks(rlo[q, t], rhi[q, t], 128), meta_host)
             for q in range(rlo.shape[0]) for t in range(rlo.shape[1])]
    return sum(c[0] for c in costs), sum(c[1] for c in costs)


def span_block_cost(start, length, meta_host) -> tuple[int, int]:
    """``packed_block_cost`` of each row's span [start, start + length),
    summed over rows (int tensors or arrays of one shape)."""
    lo = _np(start).reshape(-1)
    hi = lo + _np(length).reshape(-1)
    costs = [packed_block_cost(range_blocks(lo[i:i + 1], hi[i:i + 1], 128), meta_host)
             for i in range(lo.shape[0])]
    return sum(c[0] for c in costs), sum(c[1] for c in costs)


def table_probe_cost(desc_h, n_items, bounds_h, col, tile, meta_host=None):
    """What a work list's probe tiles in column ``col`` (3 main, 5 delta)
    read: per (query, term) the union of its rows' tiles clipped to the
    term's bounds, as postings, or with the twin's ``meta_host`` as the
    ``packed_block_cost`` of the blocks that hold them."""
    it = desc_h[:n_items].astype(np.int64)
    it = it[it[:, col] >= 0]
    b = bounds_h[it[:, 0], it[:, 2]].astype(np.int64)
    lo = np.maximum(it[:, col] * tile, b[:, 0])
    hi = np.minimum((it[:, col] + 1) * tile, b[:, 1])
    keys = it[:, 0] * 64 + it[:, 2]
    postings, n_bytes, n_blocks = 0, 0, 0
    for key in np.unique(keys):
        m = keys == key
        if meta_host is None:
            postings += union_length(lo[m], hi[m])
        else:
            c = packed_block_cost(range_blocks(lo[m], hi[m], 128), meta_host)
            n_bytes, n_blocks = n_bytes + c[0], n_blocks + c[1]
    return postings if meta_host is None else (n_bytes, n_blocks)


def log2_ceil(n: int) -> int:
    """``ceil(log2(n))`` for n >= 1: the compares of a binary search."""
    return math.ceil(math.log2(n))
