"""ODYS IR index for the PyTorch port: the same bytes as the JAX package's.

The layout is the reference's (``repro.core.index``), so that a kernel or a
test can hold the two against each other array for array:

- **CSR term table**: ``offsets[t] .. offsets[t] + lengths[t]`` addresses
  term ``t``'s postings in one flat array.  Every list starts on a
  ``BLOCK = 128`` boundary; an empty list still owns one block.
- **Postings**: docIDs ascending per list.  docIDs are assigned in rank
  order, so ascending docID order is rank order.
- **Skip table**: ``block_max[b]`` is the largest docID of aligned block
  ``b`` (``INVALID_DOC`` for a block holding padding).
- **Attribute embedding**: ``attrs[p]`` is the siteId of ``postings[p]``.
- **Site terms**: with ``include_site_terms`` each site also owns a list
  under term id ``vocab_size + site``.
- The flat arrays are padded by :func:`flat_tile_pad` to a multiple of
  ``TILE = 1024`` postings plus one whole spare ``INVALID`` tile.  The CUDA
  join reads the driver window by position and masks it, so it never reads
  past a list's live range; the padding stays so that the bytes equal the
  reference's.
- **Block codec** (packed postings): the flat posting array may carry a
  compressed twin, :class:`PackedFlatArrays`: per BLOCK, the docID gaps
  bit-packed at one power-of-two width, with a per-block descriptor (first
  docID, width and count, word offset).  :func:`pack_flat_postings` encodes
  main indexes, delta snapshots and compacted indexes alike; the packed
  kernels (K1p, K3p, K4p) decode blocks on the card and read no raw
  posting.  The layout, ``chunk_rows`` and the word padding included, is
  the reference's bit for bit, so a reference twin carries over.

The index lives on a torch device as :class:`InvertedIndex` (one slave) or
:class:`ShardedIndex` (``ns`` slaves stacked on a leading dimension, one
card).  :func:`index_from_numpy` carries the reference's arrays over.
The host-side build is numpy, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, NamedTuple

import numpy as np
import torch

from repro_torch.data.corpus import Corpus
from repro_torch.obs.registry import get_registry

BLOCK = 128                      # postings per skip-table block
TILE = 8 * BLOCK                 # postings per join tile of the flat arrays
INVALID_DOC = np.int32(2**31 - 1)  # padding docID; sorts after every real doc
INVALID_ATTR = np.int32(-1)

# Tombstone bits of the online-update doc_flags bitmap
# (repro_torch.indexing): DEAD masks a doc's postings in main and delta;
# SUPERSEDED masks its *main* postings only (its live version is in the
# delta).
DOC_DEAD = np.int32(1)
DOC_SUPERSEDED = np.int32(2)


def export_index_bytes(
    raw_nbytes: int, packed_nbytes: int | None, *, kind: str
) -> None:
    """Export the ``odys_index_bytes{layout, kind}`` gauges on the port's
    metrics registry: resident posting-structure bytes of the raw flat
    array and, when a packed twin exists, of that.  No-op unless metrics
    are enabled."""
    reg = get_registry()
    help_ = "resident posting-structure bytes by layout and index kind"
    reg.gauge("odys_index_bytes", help=help_, layout="raw", kind=kind).set(
        int(raw_nbytes)
    )
    if packed_nbytes is not None:
        reg.gauge(
            "odys_index_bytes", help=help_, layout="packed", kind=kind
        ).set(int(packed_nbytes))


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  With no card and no explicit device this raises; the port
    never falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def flat_tile_pad(n: int) -> int:
    """Padded length of a flat posting/attr array holding ``n`` postings:
    TILE-aligned (ceil), plus one whole spare INVALID tile."""
    return (-(-n // TILE) + 1) * TILE


def _np_int(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def flat_live_extent(offsets, lengths) -> int:
    """First flat offset past every list's BLOCK-aligned slot: everything
    at or beyond it is INVALID fill (the live side of the padding
    contract)."""
    offsets, lengths = _np_int(offsets), _np_int(lengths)
    if offsets.size == 0:
        return 0
    padded = np.maximum(((lengths + BLOCK - 1) // BLOCK) * BLOCK, BLOCK)
    return int(np.max(offsets.astype(np.int64) + padded.astype(np.int64)))


class FlatPadding(NamedTuple):
    """Checkable form of the flat-array padding contract: ``live_extent``
    (see :func:`flat_live_extent`) and the array's padded length."""

    live_extent: int
    padded_len: int

    def spare_tile_ok(self, read_elems: int = TILE) -> bool:
        """True iff a ``read_elems``-sized read ending at the array's end
        lies entirely past the live extent."""
        return self.padded_len - read_elems >= self.live_extent


def padding_contract(offsets, lengths, padded_len: int) -> FlatPadding:
    """The padding contract of a flat posting/attr array."""
    return FlatPadding(flat_live_extent(offsets, lengths), int(padded_len))


# ---------------------------------------------------------------------------
# Block codec: per-BLOCK delta-encoded, bit-packed postings
# ---------------------------------------------------------------------------
#
# Every BLOCK (128 postings) compresses on its own:
#
#   base  = first docID of the block (list starts are BLOCK-aligned, so a
#           block never straddles two lists)
#   gaps  = docID[l] - docID[l-1]  (gap[0] = 0; base carries the level)
#   width = the smallest of PACK_WIDTHS whose range covers the block's max
#           gap; the widths divide 32, so a w-bit field never straddles a
#           32-bit word: lane l's field sits at word (l*w) >> 5, shift
#           (l*w) & 31 of the block's 4*w words
#
# Decode: docID[l] = base + (inclusive prefix sum of the gaps), lanes at or
# past the block's count are INVALID_DOC.  A 32-bit field may have its sign
# bit set, so every shift is logical.

#: Legal per-block bit widths: 0 for blocks with <= 1 posting, 32 the
#: exact fallback.
PACK_WIDTHS = (0, 1, 2, 4, 8, 16, 32)

#: The descriptor arrays carry this many trailing zero entries (a padding
#: descriptor decodes to all-INVALID).  The port's kernels take
#: ``n_blocks`` and never read a descriptor past it.
DESC_PAD = 8


def packed_word_pad(n_words: int, chunk_rows: int) -> int:
    """Padded length of a packed-words array holding ``n_words`` words:
    ``flat_tile_pad(n_words + chunk_rows * BLOCK)``.  The reference reads
    words as fixed (``chunk_rows``, 128) chunks from unaligned starts and
    needs that slack; the port's kernels read only the words of the blocks
    they decode, and keep the length so that the twin equals the
    reference's."""
    return flat_tile_pad(n_words + chunk_rows * BLOCK)


class PackedFlatArrays:
    """Compressed twin of a flat posting array.  Every array is an int32
    tensor on one device:

    - ``words``:    int32[W]  bit-packed gap fields, 4*width words per
      block, in block order; zero padding per :func:`packed_word_pad`
    - ``blk_base``: int32[n_blocks + DESC_PAD]  first docID per block
    - ``blk_meta``: int32[n_blocks + DESC_PAD]  ``width | (count << 6)``
    - ``blk_woff``: int32[n_blocks + DESC_PAD + 1]  word offset of each
      block (constant past the live range: padding blocks pack to zero
      words)

    ``chunk_rows`` is the reference's fixed (rows, 128) word read covering
    any ``span_blocks`` consecutive blocks; the port only carries it.
    """

    def __init__(self, words, blk_base, blk_meta, blk_woff, *, chunk_rows):
        self.words = words
        self.blk_base = blk_base
        self.blk_meta = blk_meta
        self.blk_woff = blk_woff
        self.chunk_rows = int(chunk_rows)

    def arrays(self) -> tuple[torch.Tensor, ...]:
        return (self.words, self.blk_base, self.blk_meta, self.blk_woff)

    @property
    def n_blocks(self) -> int:
        """Block count of the flat array this packs."""
        return self.blk_base.shape[0] - DESC_PAD

    @property
    def device(self) -> torch.device:
        return self.words.device

    def nbytes(self) -> int:
        """Resident bytes of the packed structure (words + descriptors)."""
        return sum(x.numel() * x.element_size() for x in self.arrays())

    def padding(self) -> FlatPadding:
        """The packed-space padding contract: live words vs padded words."""
        return FlatPadding(int(self.blk_woff[-1]), int(self.words.shape[0]))

    def to(self, device) -> "PackedFlatArrays":
        return PackedFlatArrays(*(x.to(device) for x in self.arrays()),
                                chunk_rows=self.chunk_rows)


def pack_flat_postings(
    flat, *, span_blocks: int = DESC_PAD, device=None
) -> PackedFlatArrays:
    """Encode a TILE-padded flat posting array into packed-word form, bit
    for bit the reference's encoding.

    ``flat`` is a tensor (packed on its own device unless ``device`` names
    another) or a numpy array (packed on ``device``, default ``cuda``).
    ``span_blocks`` is the widest run of blocks the reference decodes from
    one chunk read (8 for tiles; a delta passes its blocks per slab); it
    sets ``chunk_rows`` and so the word padding.  Raises ``ValueError`` on
    an array that is not TILE-padded, on valid postings that are not a
    prefix of their block, and on postings that do not ascend.
    """
    if isinstance(flat, torch.Tensor):
        flat = flat.to(flat.device if device is None else torch.device(device))
    else:
        flat = torch.from_numpy(np.require(flat, np.int32, ["C"])).to(
            resolve_device(device))
    flat = flat.to(torch.int32)
    if flat.dim() != 1 or flat.shape[0] % TILE:
        raise ValueError("pack_flat_postings needs a TILE-padded flat array")
    dev = flat.device
    i32, i64 = torch.int32, torch.int64
    n_blocks = flat.shape[0] // BLOCK
    blocks = flat.view(n_blocks, BLOCK)
    lane = torch.arange(BLOCK, dtype=i32, device=dev)

    valid = blocks != int(INVALID_DOC)
    cnt = valid.sum(dim=1, dtype=i32)
    live = lane[None, :] < cnt[:, None]
    if not torch.equal(valid, live):
        raise ValueError("valid postings must be a prefix of every BLOCK")
    base = torch.where(cnt > 0, blocks[:, 0], 0).to(i32)

    gaps = torch.zeros_like(blocks)
    gaps[:, 1:] = blocks[:, 1:] - blocks[:, :-1]   # int32, wraps as numpy
    gaps = torch.where(live, gaps, 0)
    gaps[:, 0] = 0
    if n_blocks and int(gaps.min()) < 0:
        raise ValueError("postings must ascend within every BLOCK")
    maxgap = gaps.amax(dim=1) if n_blocks else cnt

    widths = torch.full((n_blocks,), 32, dtype=i32, device=dev)
    for w in (16, 8, 4, 2, 1):
        widths = torch.where(maxgap <= (1 << w) - 1, w, widths)
    widths = torch.where(maxgap == 0, 0, widths).to(i32)

    # Cumulative word offsets; padding blocks pack to zero words.
    woff = torch.zeros(n_blocks + DESC_PAD + 1, dtype=i64, device=dev)
    woff[1:n_blocks + 1] = torch.cumsum(widths.to(i64) * (BLOCK // 32), 0)
    total_words = int(woff[n_blocks])
    woff[n_blocks + 1:] = total_words

    # The reference's chunk read: over every start block, the words of
    # span_blocks consecutive blocks, rounded out to whole 128-word rows
    # from the start block's row, then up to a multiple of 8 rows.
    span = max(DESC_PAD, int(span_blocks))
    b0 = torch.arange(n_blocks, dtype=i64, device=dev)
    end = torch.clamp(b0 + span, max=n_blocks)
    r0 = woff[b0] // BLOCK
    rows_needed = (woff[end] - r0 * BLOCK + BLOCK - 1) // BLOCK
    chunk_rows = max(1, int(rows_needed.max()) if n_blocks else 1)
    sub = TILE // BLOCK
    chunk_rows = -(-chunk_rows // sub) * sub

    # Words as int64 holding uint32 values; fields are disjoint, so the sum
    # of the shifted fields is their bitwise or.
    words = torch.zeros(packed_word_pad(total_words, chunk_rows), dtype=i64,
                        device=dev)
    for w in PACK_WIDTHS[1:]:
        sel = torch.nonzero(widths == w).flatten()
        if sel.numel() == 0:
            continue
        per_word = 32 // w
        nw = BLOCK // per_word                      # 4*w words per block
        g3 = gaps[sel].to(i64).view(-1, nw, per_word)
        sh = torch.arange(per_word, dtype=i64, device=dev) * w
        dst = woff[sel][:, None] + torch.arange(nw, dtype=i64, device=dev)
        words[dst] = (g3 << sh).sum(dim=-1)
    words = torch.where(words >= 2**31, words - 2**32, words).to(i32)

    desc = n_blocks + DESC_PAD
    blk_base = torch.zeros(desc, dtype=i32, device=dev)
    blk_base[:n_blocks] = base
    blk_meta = torch.zeros(desc, dtype=i32, device=dev)
    blk_meta[:n_blocks] = widths | (cnt << 6)
    return PackedFlatArrays(words, blk_base, blk_meta, woff.to(i32),
                            chunk_rows=chunk_rows)


def unpack_flat_postings(packed: PackedFlatArrays) -> np.ndarray:
    """Host-side (numpy) decode, the round-trip reference of the codec:
    the raw TILE-padded flat array, bit for bit."""
    words = _np_int(packed.words).view(np.uint32)
    n_blocks = packed.n_blocks
    meta = _np_int(packed.blk_meta)[:n_blocks].astype(np.int64)
    woff = _np_int(packed.blk_woff).astype(np.int64)[:n_blocks]
    base = _np_int(packed.blk_base)[:n_blocks].astype(np.int64)
    w = meta & 63
    cnt = meta >> 6
    lane = np.arange(BLOCK, dtype=np.int64)
    idx = woff[:, None] + ((lane[None, :] * w[:, None]) >> 5)
    lane_word = words[np.minimum(idx, words.shape[0] - 1)].astype(np.uint64)
    shift = ((lane[None, :] * w[:, None]) & 31).astype(np.uint64)
    mask = (np.uint64(1) << w.astype(np.uint64)[:, None]) - np.uint64(1)
    gaps = (lane_word >> shift) & mask
    docs = base[:, None] + np.cumsum(gaps.astype(np.int64), axis=1)
    out = np.where(lane[None, :] < cnt[:, None], docs, int(INVALID_DOC))
    return out.astype(np.int32).reshape(-1)


def unpack_flat_postings_torch(packed: PackedFlatArrays) -> torch.Tensor:
    """Full-array decode on the twin's device (the port of the reference's
    ``unpack_flat_postings_jnp``): the ``torch`` backend's packed read and
    the first half of every packed kernel's plain version.  Fields are read
    as unsigned 32-bit values in int64, so the shifts are logical and the
    width-32 mask is exact."""
    i64 = torch.int64
    n_blocks = packed.n_blocks
    meta = packed.blk_meta[:n_blocks].to(i64)
    w = meta & 63
    cnt = meta >> 6
    lane = torch.arange(BLOCK, dtype=i64, device=packed.device)
    bit = lane[None, :] * w[:, None]
    idx = packed.blk_woff[:n_blocks, None].to(i64) + (bit >> 5)
    n_words = packed.words.shape[0]
    inside = idx < n_words
    lane_word = packed.words[idx.clamp(max=max(n_words - 1, 0))].to(i64)
    lane_word = torch.where(inside, lane_word & 0xFFFFFFFF, 0)
    gaps = (lane_word >> (bit & 31)) & ((1 << w[:, None]) - 1)
    docs = packed.blk_base[:n_blocks, None].to(i64) + torch.cumsum(gaps, dim=1)
    out = torch.where(lane[None, :] < cnt[:, None], docs, int(INVALID_DOC))
    return out.to(torch.int32).reshape(-1)


def packed_from_numpy(packed: Any, *, device) -> PackedFlatArrays:
    """The port's twin from a reference twin: ``packed`` is a mapping or an
    object with ``words``, ``blk_base``, ``blk_meta``, ``blk_woff`` and
    ``chunk_rows`` (the JAX package's ``PackedFlatArrays``)."""
    get = (packed.__getitem__ if isinstance(packed, Mapping)
           else lambda k: getattr(packed, k))
    dev = torch.device(device)
    return PackedFlatArrays(
        *(torch.from_numpy(np.require(np.asarray(get(f)), np.int32,
                                      ["C", "W"])).to(dev)
          for f in ("words", "blk_base", "blk_meta", "blk_woff")),
        chunk_rows=int(get("chunk_rows")),
    )


class InvertedIndex(NamedTuple):
    """One slave's index on a device; every array an int32 tensor, plus the
    optional block-codec twin of ``postings``."""

    offsets: torch.Tensor    # int32[n_terms]   start of each list (BLOCK-aligned)
    lengths: torch.Tensor    # int32[n_terms]   valid postings per list
    postings: torch.Tensor   # int32[P]         docIDs, ascending per list
    attrs: torch.Tensor      # int32[P]         embedded attribute per posting
    block_max: torch.Tensor  # int32[P//BLOCK]  skip table (max docID per block)
    doc_site: torch.Tensor   # int32[n_docs_pad] docID -> siteId (gather strategy)
    packed: PackedFlatArrays | None = None  # block-codec twin of ``postings``

    @property
    def n_terms(self) -> int:
        return self.offsets.shape[0]


class ShardedIndex(NamedTuple):
    """``ns`` per-slave indexes stacked on a leading dimension, padded to
    common shapes (stacking only widens the spare padding).  Its fields are
    the index's arrays; it carries no packed twin, as in the reference."""

    offsets: torch.Tensor    # int32[ns, n_terms]
    lengths: torch.Tensor    # int32[ns, n_terms]
    postings: torch.Tensor   # int32[ns, P]
    attrs: torch.Tensor      # int32[ns, P]
    block_max: torch.Tensor  # int32[ns, P//BLOCK]
    doc_site: torch.Tensor   # int32[ns, nd_pad]

    def shard(self, s: int) -> InvertedIndex:
        """Slave ``s``'s index (views, no copy)."""
        return InvertedIndex(*(x[s] for x in self))

    def nbytes(self) -> int:
        return sum(x.numel() * x.element_size() for x in self)


@dataclasses.dataclass(frozen=True)
class IndexMeta:
    """Static metadata for an index."""

    n_docs: int
    vocab_size: int
    n_sites: int
    n_terms: int           # vocab_size (+ n_sites when site terms included)
    include_site_terms: bool


def site_term_id(meta: IndexMeta, site: int) -> int:
    """Term id of the Fig 1(d) site-text posting list for ``site``."""
    if not meta.include_site_terms:
        raise ValueError("the index was built without site terms")
    return meta.vocab_size + site


def _build_numpy(
    corpus: Corpus, include_site_terms: bool
) -> tuple[dict[str, np.ndarray], IndexMeta]:
    """Invert the corpus CSR into the term CSR, host-side.

    The reference ``lexsort``s (docid, term); here one int64 key
    ``term * n_docs + doc`` is sorted, which yields the same order.
    """
    n_docs, vocab = corpus.n_docs, corpus.vocab_size
    lens = np.diff(corpus.doc_offsets)
    terms = corpus.doc_terms.astype(np.int64)
    doc_ids = np.repeat(np.arange(n_docs, dtype=np.int64), lens)
    if include_site_terms:
        # Each doc also "contains" the pseudo-term for its site.
        terms = np.concatenate([terms, vocab + corpus.doc_site.astype(np.int64)])
        doc_ids = np.concatenate([doc_ids, np.arange(n_docs, dtype=np.int64)])
        n_terms = vocab + corpus.n_sites
    else:
        n_terms = vocab

    stride = max(n_docs, 1)
    key = terms * stride + doc_ids
    del terms, doc_ids
    key.sort()
    s_terms = key // stride
    s_docs = (key - s_terms * stride).astype(np.int32)
    del key
    lengths = np.bincount(s_terms, minlength=n_terms).astype(np.int32)

    # BLOCK-align every list start; empty lists still own one block.
    padded = np.maximum(((lengths.astype(np.int64) + BLOCK - 1) // BLOCK) * BLOCK,
                        BLOCK)
    offsets = np.zeros(n_terms, dtype=np.int64)
    np.cumsum(padded[:-1], out=offsets[1:])
    total = flat_tile_pad(int(offsets[-1] + padded[-1]))

    postings = np.full(total, INVALID_DOC, dtype=np.int32)
    attrs = np.full(total, INVALID_ATTR, dtype=np.int32)
    src_off = np.zeros(n_terms + 1, dtype=np.int64)
    np.cumsum(lengths, out=src_off[1:])
    # Scatter each list into its aligned slot.
    dst = offsets[s_terms] + (np.arange(s_terms.shape[0]) - src_off[s_terms])
    postings[dst] = s_docs
    attrs[dst] = corpus.doc_site[s_docs]

    block_max = postings.reshape(-1, BLOCK).max(axis=1)

    # doc -> site lookup table, padded to a multiple of BLOCK.
    nd_pad = ((n_docs + BLOCK - 1) // BLOCK) * BLOCK
    doc_site = np.full(nd_pad, INVALID_ATTR, dtype=np.int32)
    doc_site[:n_docs] = corpus.doc_site

    arrays = dict(
        offsets=offsets.astype(np.int32),
        lengths=lengths,
        postings=postings,
        attrs=attrs,
        block_max=block_max,
        doc_site=doc_site,
    )
    meta = IndexMeta(
        n_docs=n_docs,
        vocab_size=vocab,
        n_sites=corpus.n_sites,
        n_terms=n_terms,
        include_site_terms=include_site_terms,
    )
    return arrays, meta


def index_from_numpy(
    arrays: Mapping[str, np.ndarray], *, device
) -> InvertedIndex:
    """The port's index from the reference's arrays.

    ``arrays`` maps each array field name to a numpy array (``np.asarray``
    of the JAX index's leaf of that name) and may map ``packed`` to the
    reference's twin, which is carried over (:func:`packed_from_numpy`).
    This is how a test runs the reference and the port over the very same
    index bytes.
    """
    dev = torch.device(device)
    packed = arrays.get("packed")
    return InvertedIndex(
        *(torch.from_numpy(np.require(arrays[f], np.int32, ["C", "W"])).to(dev)
          for f in ShardedIndex._fields),
        packed=None if packed is None else packed_from_numpy(packed, device=dev),
    )


def sharded_index_from_numpy(
    arrays: Mapping[str, np.ndarray], *, device
) -> ShardedIndex:
    """The sharded twin of :func:`index_from_numpy` (each array ``[ns, ...]``)."""
    dev = torch.device(device)
    return ShardedIndex(*(
        torch.from_numpy(np.require(arrays[f], np.int32, ["C", "W"])).to(dev)
        for f in ShardedIndex._fields
    ))


def pack_index(index: InvertedIndex) -> InvertedIndex:
    """Attach the block-codec twin to an index (e.g. a shard of a freshly
    compacted :class:`ShardedIndex`), packed on the index's device."""
    return index._replace(packed=pack_flat_postings(index.postings))


def build_index(
    corpus: Corpus, *, include_site_terms: bool = True, codec: str = "raw",
    device=None,
) -> tuple[InvertedIndex, IndexMeta]:
    """One slave's index on ``device`` (default ``cuda``); ``codec="packed"``
    attaches its block-codec twin.  Exports the ``odys_index_bytes``
    gauges of kind ``main``."""
    if codec not in ("raw", "packed"):
        raise ValueError(f"unknown codec {codec!r}")
    arrays, meta = _build_numpy(corpus, include_site_terms)
    idx = index_from_numpy(arrays, device=resolve_device(device))
    if codec == "packed":
        idx = pack_index(idx)
    export_index_bytes(
        arrays["postings"].nbytes,
        None if idx.packed is None else idx.packed.nbytes(),
        kind="main",
    )
    return idx, meta


# ---------------------------------------------------------------------------
# Document partitioning (paper §3.1: "partitioning by documents")
# ---------------------------------------------------------------------------

def partition_corpus(corpus: Corpus, ns: int) -> list[Corpus]:
    """Stripe docs round-robin by rank: global doc d -> shard d % ns, local
    docID d // ns (so global = local * ns + shard)."""
    lens = np.diff(corpus.doc_offsets)
    posting_doc = np.repeat(np.arange(corpus.n_docs, dtype=np.int64), lens)
    shards = []
    for s in range(ns):
        sel = np.arange(s, corpus.n_docs, ns)
        offs = np.zeros(sel.shape[0] + 1, dtype=np.int64)
        np.cumsum(lens[sel], out=offs[1:])
        shards.append(
            Corpus(
                doc_offsets=offs,
                doc_terms=corpus.doc_terms[posting_doc % ns == s],
                doc_site=corpus.doc_site[sel],
                n_docs=int(sel.shape[0]),
                vocab_size=corpus.vocab_size,
                n_sites=corpus.n_sites,
            )
        )
    return shards


def _stack_shards(arrays: list[dict[str, np.ndarray]]) -> dict[str, np.ndarray]:
    """Pad every shard's arrays to the widest shard's and stack them.  Each
    shard's postings/attrs are already padded by :func:`flat_tile_pad` and
    its doc_site to a BLOCK multiple, so the widest keeps both alignments
    and stacking only widens a shard's spare INVALID padding."""
    pads = dict(offsets=0, lengths=0, postings=INVALID_DOC, attrs=INVALID_ATTR,
                block_max=INVALID_DOC, doc_site=INVALID_ATTR)
    out = {}
    for key, pad_value in pads.items():
        ms = [a[key] for a in arrays]
        width = max(m.shape[0] for m in ms)
        stacked = np.full((len(ms), width), pad_value, dtype=ms[0].dtype)
        for i, m in enumerate(ms):
            stacked[i, : m.shape[0]] = m
        out[key] = stacked
    return out


def build_sharded_index(
    corpus: Corpus, ns: int, *, include_site_terms: bool = True, device=None
) -> tuple[ShardedIndex, IndexMeta]:
    dev = resolve_device(device)
    built = [_build_numpy(p, include_site_terms) for p in partition_corpus(corpus, ns)]
    sharded = sharded_index_from_numpy(
        _stack_shards([a for a, _ in built]), device=dev
    )
    meta = IndexMeta(
        n_docs=corpus.n_docs,
        vocab_size=corpus.vocab_size,
        n_sites=corpus.n_sites,
        n_terms=built[0][1].n_terms,
        include_site_terms=include_site_terms,
    )
    return sharded, meta


def local_to_global_docids(
    local: torch.Tensor, shard: int, ns: int
) -> torch.Tensor:
    """Invert the striping map; INVALID stays INVALID."""
    g = (local.to(torch.int64) * ns + shard).to(torch.int32)
    return torch.where(local == int(INVALID_DOC), local, g)
