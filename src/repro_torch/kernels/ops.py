"""Public entry points for the port's kernels, as in ``repro.kernels.ops``.

Each takes its tensors where they lie: a CUDA tensor launches the
hand-written kernel (or raises), a CPU tensor runs the kernel's plain
PyTorch version.  Nothing falls back from one to the other.
"""
from __future__ import annotations

from repro_torch.kernels.posting_intersect import intersect_batched_driver_streamed
from repro_torch.kernels.topk_merge import merge_topk_rows


def intersect_fullstream(d_off, d_neff, terms, active, attr_filter,
                         postings, attrs, offsets, lengths, block_max, *,
                         window):
    """Fully-streamed batched ZigZag join (K1): the driver window reads
    straight from the flat arrays.  Returns ``(docs, mask)``, the driver
    window plus the join mask, int32[Q, window]."""
    return intersect_batched_driver_streamed(
        d_off, d_neff, terms, active, attr_filter,
        postings, attrs, offsets, lengths, block_max, window=window,
    )


def topk_merge_rows(cands, k):
    """Row-wise (per-query) top-k merge (K2) — the batched master merge."""
    return merge_topk_rows(cands, k)
