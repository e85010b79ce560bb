"""The master merge (K2): row-wise best-k of concatenated slave candidates;
and the flat sort (K11) behind ``ops.sort`` and ``ops.topk_merge``.

Replaces the TPU kernel ``repro/kernels/topk_merge.py:merge_topk_rows``
(``pallas_call`` at line 122).  Each row of ``cands`` int32[Q, m] is padded
with ``INVALID_DOC`` to ``max(256, next_pow2(m))``, sorted ascending
(docID order is rank order), and its first ``k`` values are kept.  On the
main path ``m`` is ``2k`` for a tournament round and ``ns*k`` for the
all-gather merge.

:func:`merge_topk_rows_torch` is the plain version (the CPU path and the
reference for the card), :func:`merge_topk_rows_cuda` wraps
``csrc/topk_merge_rows.cu`` (a warp sorts 256 keys in registers; past 256
keys a row, one block a row merges the sorted runs in truncated merge-path
rounds), and :func:`merge_topk_rows` picks by device.
:func:`warp_sort_run`, :func:`merge_rounds` and
:func:`merge_topk_rows_replay` replay the kernel on the host, network step
by step and round by round, so that the CPU tests hold its index
arithmetic against the plain version.

K11 replaces ``repro/kernels/topk_merge.py:bitonic_sort`` (``pallas_call``
at line 79, body ``_sort_kernel`` / ``_bitonic_sort_flat`` at 51 and 28)
and its wrapper ``merge_topk`` (line 89).  A 1-D int32 or float32 vector
of length n is padded with ``INVALID_DOC`` cast to its dtype (2147483648.0
in float32) to ``max(256, next_pow2(n))``, sorted ascending, and its first
n values are kept: as in the reference, a float value above the pad (inf,
3e9) comes back as the pad.  NaN is outside the contract (the reference's
min/max network spreads it).  :func:`bitonic_sort_torch` is the plain
version (``torch.sort`` of the padded vector, equal to the network for
every non-NaN input), :func:`bitonic_sort_cuda` wraps
``csrc/flat_sort.cu`` (a merge-path merge sort: any correct sort of the
padded vector gives the same bits), and :func:`bitonic_sort` picks by
device; the names are the reference's.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.index import INVALID_DOC
from repro_torch.kernels import registry as _reg
from repro_torch.kernels.registry import Access, Work

_INVALID = int(INVALID_DOC)

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


#: ``csrc/topk_merge_rows.cu``'s constants: keys a warp sorts in registers,
#: merged keys a thread a chunk, chunks a thread a round, threads a block.
RUN, ITEMS, MAX_CHUNKS, MAX_THREADS = 256, 8, 4, 1024


class MergeRound(NamedTuple):
    """One merge round of ``csrc/topk_merge_rows.cu`` on a row: ``groups``
    pairs of runs of length ``length`` (the last pair ``last_a`` and
    ``last_b`` long, ``last_b`` 0 for a run without a partner) merged into
    runs of ``glen`` (the last ``last_len``), ``chunks`` chunks of
    :data:`ITEMS` keys in all."""
    groups: int
    length: int
    last_a: int
    last_b: int
    glen: int
    last_len: int
    chunks: int


def merge_rounds(m: int, k: int) -> tuple[int, list[MergeRound]]:
    """The runs kernel's threads and rounds for rows of ``m > RUN`` keys
    and ``k`` outputs: ``ceil(m / RUN)`` sorted runs (the last padded with
    ``INVALID_DOC``), merged in pairs until one is left, each merged run
    cut to its first ``min(k, length)`` keys."""
    n = -(-m // RUN)
    threads = min(MAX_THREADS, 32 * n)
    length, last, rounds = RUN, RUN, []
    while n > 1:
        groups = (n + 1) // 2
        glen = min(k, 2 * length)
        last_a, last_b = (last, 0) if n % 2 else (length, last)
        last_len = min(k, last_a + last_b)
        rounds.append(MergeRound(groups, length, last_a, last_b, glen, last_len,
                                 groups * -(-glen // ITEMS)))
        n, length, last = groups, glen, last_len
    return threads, rounds


def _merge_chunk(a, b, pos0: int) -> list[int]:
    """Keys ``pos0 .. pos0 + ITEMS - 1`` of the merge of the sorted lists
    ``a`` and ``b``, ``a`` first on ties, ``INVALID_DOC`` past their end:
    the co-rank search, then ``ITEMS`` sequential steps (``merge_chunk``)."""
    la, lb = len(a), len(b)
    lo, hi = max(0, pos0 - lb), min(pos0, la)
    while lo < hi:
        mid = (lo + hi) // 2
        if a[mid] <= b[pos0 - mid - 1]:
            lo = mid + 1
        else:
            hi = mid
    i, j, out = lo, pos0 - lo, []
    for _ in range(ITEMS):
        take_a = i < la and (j >= lb or a[i] <= b[j])
        out.append(a[i] if take_a else (b[j] if j < lb else _INVALID))
        i, j = i + take_a, j + (not take_a)
    return out


def warp_sort_run(keys: np.ndarray) -> np.ndarray:
    """Host replay of ``load_run`` and ``warp_sort_run``: the keys loaded
    as the kernel's warp loads them (key ``32 r + lane`` in lane ``lane``'s
    register ``r``), then the bitonic network over network position ``lane
    * 8 + r``: strides below 8 between a lane's registers, strides 8 .. 128
    as ``__shfl_xor_sync`` with ``lane ^ (stride / 8)``.  Returns the keys
    ascending (network position order)."""
    x = np.asarray(keys, np.int64).reshape(8, 32).T.copy()
    lane = np.arange(32)
    for ls in range(1, 9):
        size = 1 << ls
        for lt in range(ls - 1, -1, -1):
            stride = 1 << lt
            if stride >= 8:
                lx = stride // 8
                y = x[lane ^ lx]
                keep_min = ((lane & lx) != 0) == (((lane * 8) & size) != 0)
                x = np.where(keep_min[:, None], np.minimum(x, y), np.maximum(x, y))
                continue
            for r in range(8):
                if r & stride == 0:
                    h = r | stride
                    desc = ((lane * 8 + r) & size) != 0
                    lo, hi = np.minimum(x[:, r], x[:, h]), np.maximum(x[:, r], x[:, h])
                    x[:, r], x[:, h] = np.where(desc, hi, lo), np.where(desc, lo, hi)
    return x.reshape(-1)


def merge_topk_rows_replay(cands: torch.Tensor, k: int) -> torch.Tensor:
    """Host replay of ``csrc/topk_merge_rows.cu``: each run of :data:`RUN`
    keys (the last padded with ``INVALID_DOC``) through
    :func:`warp_sort_run`; past one run, every round of
    :func:`merge_rounds` chunk by chunk as the kernel's threads merge it,
    and ``INVALID_DOC`` past the last run.  Equal to
    :func:`merge_topk_rows_torch`."""
    q_n, m = cands.shape
    k = min(k, _padded_width(m))
    n = max(1, -(-m // RUN))
    rounds = merge_rounds(m, k)[1] if n > 1 else []
    keys = np.full((q_n, n * RUN), _INVALID, np.int64)
    keys[:, :m] = cands.cpu().numpy()
    out = np.full((q_n, k), _INVALID, np.int64)
    for r in range(q_n):
        runs = [warp_sort_run(keys[r, i * RUN:(i + 1) * RUN]).tolist()
                for i in range(n)]
        for rd in rounds:
            nxt = []
            for g in range(rd.groups):
                a, b = runs[2 * g], runs[2 * g + 1] if 2 * g + 1 < len(runs) else []
                olen = rd.last_len if g == rd.groups - 1 else rd.glen
                merged = []
                for pos0 in range(0, olen, ITEMS):
                    merged += _merge_chunk(a, b, pos0)
                nxt.append(merged[:olen])
            runs = nxt
        got = runs[0][:k]
        out[r, :len(got)] = got
    return torch.from_numpy(out.astype(np.int32))


def merge_topk_rows_cuda(cands: torch.Tensor, k: int) -> torch.Tensor:
    """Launch ``csrc/topk_merge_rows.cu`` on the current stream: the warp
    kernel for rows of at most :data:`RUN` keys, else the runs kernel."""
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
    fn = merge_topk_rows_cuda if cands.is_cuda else merge_topk_rows_torch
    with _reg.dispatched("topk_merge_rows", cands, k):
        return fn(cands, k)


# ---------------------------------------------------------------------------
# K11: the flat sort
# ---------------------------------------------------------------------------

#: The largest padded length the CUDA sort takes (its lengths are int).
MAX_SORT = 1 << 30
#: Keys one block of the CUDA sort sorts on its own (``csrc/flat_sort.cu``).
SORT_TILE = 4096


def _padded(x: torch.Tensor) -> torch.Tensor:
    """``x`` padded with ``INVALID_DOC`` (cast to its dtype) to
    :func:`_padded_width`."""
    padded = torch.full((_padded_width(x.shape[0]),), int(INVALID_DOC),
                        dtype=x.dtype, device=x.device)
    padded[:x.shape[0]] = x
    return padded


def bitonic_sort_torch(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K11: pad, sort, keep the first n."""
    return _padded(x).sort().values[:x.shape[0]]


def bitonic_sort_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/flat_sort.cu`` on the current stream: a merge sort
    with merge-path partitions, one block a tile of :data:`SORT_TILE` keys
    and then one merge pass per doubling of the sorted runs (1 +
    log2(m / SORT_TILE) launches; one for m <= SORT_TILE).  Same result as
    :func:`bitonic_sort_torch`; the result is a prefix of the padded
    output, and past one tile the passes alternate with a scratch vector
    of the padded length."""
    from repro_torch.kernels import _build

    names = {torch.int32: "flat_sort_i32", torch.float32: "flat_sort_f32"}
    if x.dim() != 1 or x.dtype not in names or not x.is_cuda:
        raise ValueError(f"need a 1-D int32 or float32 CUDA tensor, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    x = x.contiguous()
    n = x.shape[0]
    m = _padded_width(n)
    if m > MAX_SORT:
        raise ValueError(f"{n} keys pad to {m} > {MAX_SORT}")
    out = torch.empty(m, dtype=x.dtype, device=x.device)
    scratch = torch.empty(m, dtype=x.dtype, device=x.device) if m > SORT_TILE else None
    launch = _build.kernel(names[x.dtype])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = launch(x.data_ptr(), n, out.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), m, stream)
    bitonic_sort_cuda.launches += 1
    _build.check(err, names[x.dtype] + "_launch")
    return out[:n]


bitonic_sort_cuda.launches = 0


def bitonic_sort(x: torch.Tensor) -> torch.Tensor:
    """Ascending sort of a 1-D int32 or float32 vector, with the
    reference's padding: the kernel on a CUDA tensor, the plain version on
    a CPU tensor."""
    fn = bitonic_sort_cuda if x.is_cuda else bitonic_sort_torch
    entry = "flat_sort_f32" if x.dtype == torch.float32 else "flat_sort_i32"
    with _reg.dispatched(entry, x):
        return fn(x)


def merge_topk(cands: torch.Tensor, k: int) -> torch.Tensor:
    """The global best ``k`` (smallest ids) of the stacked candidates
    ``cands`` [ns, k'], ascending: the first k of :func:`bitonic_sort` of
    the flattened array (the loser tree's output)."""
    return bitonic_sort(cands.reshape(-1))[:k]


# ---------------------------------------------------------------------------
# Launch contracts (repro_torch.kernels.registry) and the sorts' work
# ---------------------------------------------------------------------------

#: ``csrc/flat_sort.cu``'s keys a merge-pass block.
SORT_BLOCK_KEYS = _reg.KPT * _reg.TILE_THREADS


def topk_merge_work(cands: torch.Tensor, k: int) -> Work:
    """K2's least work: the candidates in, ``k`` a row out; a selection of
    ``k`` of ``m`` keys takes about ``m * ceil(log2 k)`` compares a row
    (the function, not the network)."""
    return Work(cands.numel() * 4 + cands.shape[0] * k * 4,
                cands.numel() * math.ceil(math.log2(k)), "int32")


def _topk_instance(label: str, q_n: int, m: int, k: int, seed: int):
    rng = np.random.default_rng(seed)
    cands = torch.from_numpy(rng.integers(0, 1 << 20, (q_n, m)).astype(np.int32))
    cands[:, ::7] = _INVALID
    mpad = _padded_width(m)
    kk = min(k, mpad)
    if mpad <= RUN:
        rpb = _reg.ROWS_PER_BLOCK

        def rows(b):
            return range(b[0] * rpb, min((b[0] + 1) * rpb, q_n))

        launch = _reg.Launch(
            "topk_merge_warp_kernel", (-(-q_n // rpb), 1, 1), 32 * rpb, 0, False,
            lambda b: [Access("cands", r * m, (r + 1) * m) for r in rows(b)],
            lambda b: [Access("out", r * kk, (r + 1) * kk) for r in rows(b)])
    else:
        threads, _ = merge_rounds(m, kk)
        keys = -(-m // RUN) * RUN
        smem = (keys + keys // 32) * 4
        launch = _reg.Launch(
            "topk_merge_runs_kernel", (q_n, 1, 1), threads, smem,
            smem > _reg.SMEM_STATIC_LIMIT,
            lambda b: [Access("cands", b[0] * m, (b[0] + 1) * m)],
            lambda b: [Access("out", b[0] * kk, (b[0] + 1) * kk)])
    operands = (_reg.operand("cands", cands), _reg.Operand("out", "int32", q_n * kk))
    return _reg.Instance(label, operands, (launch,), (cands, k), {})


@_reg.launch_contract("topk_merge_rows", kid="K2",
                      kernels=("topk_merge_warp_kernel", "topk_merge_runs_kernel"),
                      wrapper=merge_topk_rows_cuda, plain=merge_topk_rows_torch,
                      work=topk_merge_work)
def _topk_merge_rows_contract():
    return [_topk_instance("warp, 5 rows of 200, k 10", 5, 200, 10, 0),
            _topk_instance("warp, k past m (100, k 300)", 4, 100, 300, 1),
            _topk_instance("runs, 3 rows of 5000, k 100", 3, 5000, 100, 2),
            _topk_instance("runs past 48 KB, 2 rows of 12000, k 1000", 2, 12000, 1000, 3)]


def sort_work(x: torch.Tensor) -> Work:
    """K11's least work: the keys in and out, ``n ceil(log2 n)`` compares."""
    n = x.numel()
    return Work(8 * n, n * math.ceil(math.log2(max(n, 2))), "int32")


def _sort_instance(label: str, x: torch.Tensor):
    n = x.numel()
    m = _padded_width(n)
    tile = min(m, SORT_TILE)
    passes = max(0, (m // tile).bit_length() - 1)
    bufs = ("out", "scratch")
    cur = bufs[passes & 1]
    launches = [_reg.Launch(
        f"flat_sort_tile", (m // tile, 1, 1), tile // _reg.KPT, 0, False,
        lambda b, t=tile: [Access("x", b[0] * t, min((b[0] + 1) * t, n))]
        if b[0] * t < n else [],
        lambda b, t=tile, c=cur: [Access(c, b[0] * t, (b[0] + 1) * t)])]
    run = tile
    while run < m:
        nxt = bufs[1] if cur == bufs[0] else bufs[0]
        launches.append(_reg.Launch(
            "flat_sort_merge", (m // SORT_BLOCK_KEYS, 1, 1), _reg.TILE_THREADS, 0, False,
            # a block's merge-path partition lies in its pair of runs
            lambda b, c=cur, L=run: [Access(c, b[0] * SORT_BLOCK_KEYS // (2 * L) * 2 * L,
                                            (b[0] * SORT_BLOCK_KEYS // (2 * L) + 1) * 2 * L,
                                            consumed=True)],
            lambda b, c=nxt: [Access(c, b[0] * SORT_BLOCK_KEYS,
                                     (b[0] + 1) * SORT_BLOCK_KEYS)]))
        cur, run = nxt, run * 2
    dtype = str(x.dtype).replace("torch.", "")
    operands = [_reg.operand("x", x), _reg.Operand("out", dtype, m)]
    if m > SORT_TILE:
        operands.append(_reg.Operand("scratch", dtype, m))
    return _reg.Instance(label, tuple(operands), tuple(launches), (x,), {})


def _sort_instances(dtype):
    rng = np.random.default_rng(11)

    def keys(n):
        if dtype == torch.float32:
            return torch.from_numpy(rng.normal(size=n).astype(np.float32))
        return torch.from_numpy(rng.integers(0, 1 << 30, n).astype(np.int32))

    return [_sort_instance(f"n {n}", keys(n)) for n in (300, 3000, 4096 * 2 + 1, 20000)]


@_reg.launch_contract("flat_sort_i32", kid="K11",
                      kernels=("flat_sort_tile", "flat_sort_merge"),
                      wrapper=bitonic_sort_cuda, plain=bitonic_sort_torch, work=sort_work)
def _flat_sort_i32_contract():
    return _sort_instances(torch.int32)


@_reg.launch_contract("flat_sort_f32", kid="K11",
                      kernels=("flat_sort_tile", "flat_sort_merge"),
                      wrapper=bitonic_sort_cuda, plain=bitonic_sort_torch, work=sort_work)
def _flat_sort_f32_contract():
    return _sort_instances(torch.float32)
