"""Launch-contract registry: every CUDA entry point of the port, stated in
Python (the port's copy of ``repro.kernels.registry``).

The reference states each ``pallas_call``'s BlockSpecs and index maps so
that a checker can prove them without a TPU.  A hand-written CUDA kernel
has no BlockSpec: what it reads and writes follows from its grid, its
block's arithmetic and the host plans it is handed.  So each entry of
``_build.KERNELS`` registers, beside its wrapper, a builder of a
:class:`LaunchContract` on small canonical instances made through the
port's real layout helpers (:func:`synthetic_flat_index`,
:func:`synthetic_delta_arrays`, the probe plans, the work-list builders),
at check time, so that a change to a helper (or a monkeypatched one)
reaches the contracts.  A contract carries:

- the ``__global__`` launches of each instance: grid, threads a block,
  dynamic shared memory, and whether the launch code opts in above 48 KB
  (``cudaFuncSetAttribute``).  This is a second statement of the C launch
  formulas; its constants are the sources' ``#define``\\ s (a test reads
  them);
- each pointer operand: dtype, allocated elements, live extent
  (``padding_from``), the pad it declares (``"tile"`` for
  :func:`~repro_torch.core.index.flat_tile_pad`, ``"packed_chunk"`` for
  :func:`~repro_torch.core.index.packed_word_pad`, ``"worklist_entry"``
  for :func:`~repro_torch.kernels.worklist.worklist_pad`) and the spare
  that pad promises;
- ``reads(block)`` and ``writes(block)`` of each launch, as flat element
  ranges (:class:`Access`), built from the host replays the port already
  has (probe plans, ``table_streams``, ``skip_streams``,
  ``chunk_ranges``, ``merge_rounds``, K12's tile loop);
- ``work(*args)``: the least bytes and operations the launch's function
  needs on the wrapper's arguments (:mod:`repro_torch.roofline` reads it);
- the wrapper and its plain version, so that the card can launch each
  instance and hold it against the plain result.

What a Pallas contract declares and a Hopper one does not: block shapes
and index maps (there are none: a kernel computes its addresses),
``intended_map``/clamps (no kernel clamps a read onto live data; reads
past a live extent are stated as reads), revisit dimensions (no kernel
accumulates into an output across blocks), VMEM (replaced by the launch's
shared memory) and ``interpret=``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import inspect
import os
import re
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

#: ``csrc/probe_async.cuh`` and ``slave_join.cuh``: driver slots a plan
#: tile, slots a block, round-buffer and decode capacities.
TILE, JOIN_SUB = 1024, 256
NSUB = TILE // JOIN_SUB
RAW_CAP, WORD_CAP, DEC_BLKS, PBLOCK, MAX_SEG = 4096, 4096, 32, 128, 16
#: ``delta_merge.cu`` / ``merge_compact.cu``: K3's/K8's large-cap threads.
ROW_THREADS = 512
#: ``topk_merge_rows.cu``: rows a block of the warp kernel.
ROWS_PER_BLOCK = 4
#: ``flat_sort.cu``: keys a thread, threads a tile block.
KPT, TILE_THREADS = 16, 256
#: ``flash_attention.cu``: the bf16 kernel's q rows and threads a block.
TC_BQ, TC_THREADS = 128, 384
F_STAGES = 2

#: Dynamic shared memory a launch may take without opting in, and H100's
#: per-block opt-in maximum (227 KB).
SMEM_STATIC_LIMIT = 48 * 1024
SMEM_OPTIN = 232_448
MAX_THREADS, MAX_GRID_X, MAX_GRID_YZ = 1024, 2**31 - 1, 65535

_ITEMSIZE = {"int32": 4, "uint32": 4, "float32": 4, "bfloat16": 2, "int64": 8}

# sizeof(ProbeHead) and sizeof(StreamRange) of csrc/probe_async.cuh:
# bar[2] (16) + Round[2] (2 * (4 ints + MAX_SEG Segs of 32 bytes)) +
# red[3][32] (384); two long longs and five ints, padded to 8.
_PROBE_HEAD = 16 + 2 * (16 + MAX_SEG * 32) + 3 * 32 * 4
_STREAM_RANGE = 40


def probe_smem(nstr: int, packed: bool) -> int:
    """``probe_layout(nstr, packed).total`` of ``csrc/probe_async.cuh``:
    the dynamic shared memory of a K1/K4/K6/K7/K9/K10 block with ``nstr``
    streams."""
    st = (_PROBE_HEAD + 15) & ~15
    buf = (st + nstr * _STREAM_RANGE + 127) & ~127
    dec = buf + 2 * (WORD_CAP if packed else RAW_CAP) * 4
    return dec + (DEC_BLKS * PBLOCK * 4 if packed else 0)


class Access(NamedTuple):
    """One range of flat elements ``[lo, hi)`` of an operand a block reads
    or writes, ``count`` times at ``stride`` (a strided row read).
    ``consumed``: the values can reach the output (a rounded copy's edges
    and masked positions cannot).  ``bulk``: a ``cp.async.bulk`` copy or a
    TMA box, which needs 16-byte ends."""

    operand: str
    lo: int
    hi: int
    consumed: bool = True
    bulk: bool = False
    stride: int = 0
    count: int = 1


@dataclasses.dataclass(frozen=True)
class Operand:
    """One pointer argument of a launch."""

    name: str
    dtype: str
    elems: int                       # allocated elements
    padding_from: int | None = None  # live extent; None: all live
    pad: str | None = None           # "tile", "packed_chunk", "worklist_entry"
    spare: int = 0                   # elements past the live extent the pad promises
    sentinel: int | None = None      # pad value a kernel reads on purpose
    host: np.ndarray | None = None   # contents, for the sentinel check
    strides: tuple[int, ...] = ()    # TMA global strides in bytes

    @property
    def itemsize(self) -> int:
        return _ITEMSIZE[self.dtype]


def operand(name: str, x, **kw) -> Operand:
    """An :class:`Operand` of tensor ``x`` (its dtype and size; its
    contents kept when a sentinel is declared)."""
    dtype = str(x.dtype).replace("torch.", "")
    host = x.reshape(-1).numpy() if kw.get("sentinel") is not None else None
    return Operand(name, dtype, int(x.numel()), host=host, **kw)


def flat_operand(name: str, x, live: int) -> Operand:
    """A flat posting/attr array padded by ``flat_tile_pad``."""
    return operand(name, x, padding_from=int(live), pad="tile", spare=TILE)


@dataclasses.dataclass(frozen=True)
class Launch:
    """One ``__global__`` launch: its geometry and its blocks' accesses."""

    kernel: str
    grid: tuple[int, int, int]
    threads: int
    smem: int                       # dynamic shared memory bytes
    opt_in: bool                    # the launch code opts in (cudaFuncSetAttribute)
    reads: Callable[[tuple[int, int, int]], list[Access]]
    writes: Callable[[tuple[int, int, int]], list[Access]]

    @property
    def n_blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    def blocks(self):
        gx, gy, gz = self.grid
        for z in range(gz):
            for y in range(gy):
                for x in range(gx):
                    yield (x, y, z)


@dataclasses.dataclass(frozen=True)
class Instance:
    """A canonical instance: the wrapper's arguments (CPU tensors) and the
    launches the wrapper makes on them, in order."""

    label: str
    operands: tuple[Operand, ...]
    launches: tuple[Launch, ...]
    args: tuple
    kwargs: dict

    def operand(self, name: str) -> Operand:
        return next(op for op in self.operands if op.name == name)


class Work(NamedTuple):
    """The least bytes and operations a launch's function needs, and the
    operations' kind (``"int32"``, ``"float32"``, ``"tf32x3"``,
    ``"bf16"``): :mod:`repro_torch.roofline` takes each kind's peak."""

    bytes: int
    ops: int
    unit: str


@dataclasses.dataclass(frozen=True)
class LaunchContract:
    """Everything the checker and the card know of one entry point."""

    name: str                       # _build.KERNELS entry
    kid: str                        # the kernel id it replaces (K1 .. K12)
    site: str                       # csrc/<source>.cu:line of the extern "C" function
    wrapper_site: str               # file:line of the *_cuda wrapper
    kernels: tuple[str, ...]        # the __global__ names it launches
    instances: tuple[Instance, ...]
    wrapper: Callable
    plain: Callable
    work: Callable[..., Work]

    @property
    def where(self) -> str:
        return f"{self.site} ({self.wrapper_site})"


class _Spec(NamedTuple):
    kid: str
    kernels: tuple[str, ...]
    wrapper: Callable
    plain: Callable
    work: Callable
    builder: Callable[[], list[Instance]]


_REGISTRY: dict[str, _Spec] = {}

#: Modules whose import registers the contracts.
_KERNEL_MODULES = (
    "repro_torch.kernels.posting_intersect",
    "repro_torch.kernels.delta_merge",
    "repro_torch.kernels.topk_merge",
    "repro_torch.kernels.flash_attention",
)


def launch_contract(name: str, *, kid: str, kernels, wrapper, plain, work):
    """Decorator: register ``builder`` (returning the entry's canonical
    :class:`Instance`\\ s) as the contract of ``_build.KERNELS[name]``."""

    def deco(builder):
        if name in _REGISTRY:
            raise ValueError(f"duplicate launch contract {name!r}")
        _REGISTRY[name] = _Spec(kid, tuple(kernels), wrapper, plain, work, builder)
        return builder

    return deco


def _rel(path: str) -> str:
    parts = path.replace(os.sep, "/").rsplit("src/repro_torch/", 1)
    return "src/repro_torch/" + parts[1] if len(parts) == 2 else path


def site_of(fn) -> str:
    """Repo-relative ``file:line`` of a function."""
    try:
        return f"{_rel(inspect.getsourcefile(fn))}:{inspect.getsourcelines(fn)[1]}"
    except (OSError, TypeError):
        return f"{getattr(fn, '__module__', '<unknown>')}:0"


def launch_site(name: str) -> str:
    """``csrc/<source>.cu:line`` of entry ``name``'s ``extern "C"``
    function (0 when the source lacks it)."""
    from repro_torch.kernels import _build

    source, entry, _ = _build.KERNELS[name]
    path = _build.CSRC / f"{source}.cu"
    text = path.read_text()
    m = re.search(rf'^extern "C" int {entry}\(', text, re.MULTILINE)
    line = text.count("\n", 0, m.start()) + 1 if m else 0
    return f"{_rel(str(path))}:{line}"


def _import_kernels() -> None:
    for mod in _KERNEL_MODULES:
        importlib.import_module(mod)


def load_contracts(names: Sequence[str] | None = None) -> list[LaunchContract]:
    """Import the kernel modules and build the registered contracts (all,
    or the named entries) on their canonical instances."""
    _import_kernels()
    out = []
    for name in sorted(_REGISTRY):
        if names is not None and name not in names:
            continue
        s = _REGISTRY[name]
        out.append(LaunchContract(
            name, s.kid, launch_site(name), site_of(s.wrapper), s.kernels,
            tuple(s.builder()), s.wrapper, s.plain, s.work))
    return out


def work(name: str, *args, **kwargs) -> Work:
    """Entry ``name``'s :class:`Work` on its wrapper's arguments."""
    _import_kernels()
    return _REGISTRY[name].work(*args, **kwargs)


#: The active cost counters (``repro_torch.roofline.op_cost``), innermost last.
COUNTERS: list = []

_UNCOUNTED = contextlib.nullcontext()


def dispatched(entry: str, *args, **kwargs):
    """The context a dispatcher calls entry ``entry``'s wrapper or plain
    version in (on the wrapper's arguments).  Under an active cost counter
    it reports the entry's :class:`Work` once and suspends the counting of
    the ops inside (the plain version's, or the wrapper's allocations), so
    that the count is the same whichever implementation runs; else it is a
    shared no-op context."""
    if not COUNTERS or COUNTERS[-1].suspended:
        return _UNCOUNTED
    return _counted(COUNTERS[-1], entry, args, kwargs)


@contextlib.contextmanager
def _counted(counter, entry: str, args, kwargs):
    counter.suspended += 1
    try:
        counter.add_kernel(entry, work(entry, *args, **kwargs))
        yield
    finally:
        counter.suspended -= 1


# ---------------------------------------------------------------------------
# Access helpers
# ---------------------------------------------------------------------------


def bulk_read(name: str, lo: int, hi: int) -> list[Access]:
    """A range ``[lo, hi)`` of int32 staged by a bulk copy: the copy
    ``[lo, round_up(hi, 4))`` (its end rounded out to 16 bytes, the excess
    not consumed), the range itself consumed."""
    if hi <= lo:
        return []
    return [Access(name, lo, -(-hi // 4) * 4, False, True), Access(name, lo, hi)]


def packed_read(prefix: str, woff: np.ndarray, lo: int, hi: int,
                *, bulk: bool = True) -> list[Access]:
    """The reads of a block-codec twin that decode flat positions ``[lo,
    hi)``: the descriptors of the blocks that hold them and their words
    (a bulk copy when ``bulk``)."""
    if hi <= lo:
        return []
    b0, b1 = lo // PBLOCK, (hi - 1) // PBLOCK
    return [Access(f"{prefix}blk_base", b0, b1 + 1),
            Access(f"{prefix}blk_meta", b0, b1 + 1),
            Access(f"{prefix}blk_woff", b0, b1 + 2),
            Access(f"{prefix}words", int(woff[b0]), int(woff[b1 + 1]), True, bulk)]


def packed_operands(prefix: str, pk, *, n_words: int | None = None) -> list[Operand]:
    """The four operands of a block-codec twin: words padded by
    ``packed_word_pad`` (live up to the last block's words), descriptors
    with their ``DESC_PAD`` entries (live up to ``n_blocks``)."""
    from repro_torch.core.index import BLOCK

    nb = pk.n_blocks
    live_w = int(pk.blk_woff[nb]) if n_words is None else n_words
    return [operand(f"{prefix}words", pk.words.view(torch.int32).to(torch.int32),
                    padding_from=live_w, pad="packed_chunk",
                    spare=TILE + pk.chunk_rows * BLOCK),
            operand(f"{prefix}blk_base", pk.blk_base, padding_from=nb),
            operand(f"{prefix}blk_meta", pk.blk_meta, padding_from=nb),
            operand(f"{prefix}blk_woff", pk.blk_woff, padding_from=nb + 1)]


# ---------------------------------------------------------------------------
# Canonical fixtures: tiny indexes with the production flat-array layout
# ---------------------------------------------------------------------------


def synthetic_flat_index(list_lengths: Sequence[int], *, n_sites: int = 2):
    """CSR flat-posting fixture built through the port's index builder
    (``core.index._build_numpy``): ``list_lengths[t]`` postings per term,
    docIDs ascending per list, lists BLOCK-aligned, flat arrays padded by
    ``flat_tile_pad`` (looked up on the module at call time, so a patched
    helper reaches every contract).  Returns ``(arrays, live_extent)``."""
    from repro_torch.core import index as core_index
    from repro_torch.data.corpus import Corpus

    counts = [int(c) for c in list_lengths]
    n_docs = max(counts)
    doc_terms: list[int] = []
    doc_offsets = [0]
    for d in range(n_docs):
        doc_terms.extend(t for t, c in enumerate(counts) if d < c)
        doc_offsets.append(len(doc_terms))
    corpus = Corpus(
        doc_offsets=np.asarray(doc_offsets, np.int64),
        doc_terms=np.asarray(doc_terms, np.int32),
        doc_site=(np.arange(n_docs) % n_sites).astype(np.int32),
        n_docs=n_docs,
        vocab_size=len(counts),
        n_sites=n_sites,
    )
    arrays, _meta = core_index._build_numpy(corpus, False)
    live = core_index.flat_live_extent(arrays["offsets"], arrays["lengths"])
    return arrays, live


def synthetic_delta_arrays(
    n_terms: int, cap: int, fills: Sequence[int], *, doc_base: int = 10_000
):
    """Delta flat-array fixture with the :mod:`repro_torch.indexing.delta`
    layout: per-term slabs of ``cap`` postings, flat arrays
    ``flat_tile_pad``'ed, a per-BLOCK ``block_max`` skip table (INVALID
    where a block is empty)."""
    from repro_torch.core import index as core_index

    BLOCK = core_index.BLOCK
    assert cap % BLOCK == 0
    flat_len = core_index.flat_tile_pad(n_terms * cap)
    d_postings = np.full(flat_len, core_index.INVALID_DOC, np.int32)
    d_attrs = np.full(flat_len, core_index.INVALID_ATTR, np.int32)
    d_offsets = (np.arange(n_terms, dtype=np.int32) * cap).astype(np.int32)
    d_lengths = np.zeros(n_terms, np.int32)
    for t, fill in enumerate(fills):
        fill = min(int(fill), cap)
        docs = doc_base + np.arange(fill, dtype=np.int32) * (t + 2)
        d_postings[t * cap : t * cap + fill] = docs
        d_attrs[t * cap : t * cap + fill] = t % 2
        d_lengths[t] = fill
    d_block_max = (
        d_postings[: n_terms * cap].reshape(-1, BLOCK).max(axis=1).astype(np.int32)
    )
    return {
        "d_postings": d_postings,
        "d_attrs": d_attrs,
        "d_offsets": d_offsets,
        "d_lengths": d_lengths,
        "d_block_max": d_block_max,
    }


def tensors(arrays: dict) -> dict:
    """numpy fixture arrays as CPU int32 tensors."""
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.int32))
            for k, v in arrays.items()}
