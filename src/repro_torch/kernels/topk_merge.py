"""The master merge (K2): row-wise best-k of concatenated slave candidates.

Replaces the TPU kernel ``repro/kernels/topk_merge.py:merge_topk_rows``
(``pallas_call`` at line 122).  Each row of ``cands`` int32[Q, m] is padded
with ``INVALID_DOC`` to ``max(256, next_pow2(m))``, sorted ascending
(docID order is rank order), and its first ``k`` values are kept.  On the
main path ``m`` is ``2k`` for a tournament round and ``ns*k`` for the
all-gather merge.

:func:`merge_topk_rows_torch` is the plain version (the CPU path and the
reference for the card), :func:`merge_topk_rows_cuda` wraps
``csrc/topk_merge_rows.cu`` (one block per row, bitonic sort in shared
memory), and :func:`merge_topk_rows` picks by device.
"""
from __future__ import annotations

import torch

from repro_torch.core.index import INVALID_DOC

#: Shared memory one block may use on Hopper (227 KB).
MAX_SMEM_BYTES = 232_448


def _padded_width(m: int) -> int:
    return max(256, 1 << max(0, m - 1).bit_length())


def merge_topk_rows_torch(cands: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch version: pad, sort, keep the first ``k``."""
    q_n, m = cands.shape
    mpad = _padded_width(m)
    padded = torch.full((q_n, mpad), int(INVALID_DOC), dtype=cands.dtype,
                        device=cands.device)
    padded[:, :m] = cands
    return padded.sort(dim=-1).values[:, :k].contiguous()


def merge_topk_rows_cuda(cands: torch.Tensor, k: int) -> torch.Tensor:
    """Launch ``csrc/topk_merge_rows.cu`` on the current stream."""
    from repro_torch.kernels import _build

    if cands.dtype != torch.int32 or not cands.is_cuda or cands.dim() != 2:
        raise ValueError(f"need an int32 [Q, m] CUDA tensor, got {cands.dtype} "
                         f"{tuple(cands.shape)} on {cands.device}")
    cands = cands.contiguous()
    q_n, m = cands.shape
    mpad = _padded_width(m)
    if mpad * 4 > MAX_SMEM_BYTES:
        raise ValueError(
            f"a padded row of {mpad} int32 ({mpad * 4} bytes) does not fit "
            f"in one block's {MAX_SMEM_BYTES} bytes of shared memory"
        )
    k = min(k, mpad)
    out = torch.empty((q_n, k), dtype=torch.int32, device=cands.device)
    if q_n == 0 or k == 0:
        return out
    launch = _build.kernel("topk_merge_rows")
    stream = torch.cuda.current_stream(cands.device).cuda_stream
    err = launch(cands.data_ptr(), out.data_ptr(), q_n, m, mpad, k, stream)
    merge_topk_rows_cuda.launches += 1
    _build.check(err, "topk_merge_rows_launch")
    return out


merge_topk_rows_cuda.launches = 0


def merge_topk_rows(cands: torch.Tensor, k: int) -> torch.Tensor:
    """``(Q, m)`` candidate ids -> ``(Q, k)`` best, ascending per row: the
    kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if cands.is_cuda:
        return merge_topk_rows_cuda(cands, k)
    return merge_topk_rows_torch(cands, k)
