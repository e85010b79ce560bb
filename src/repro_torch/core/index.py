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

The index lives on a torch device as :class:`InvertedIndex` (one slave) or
:class:`ShardedIndex` (``ns`` slaves stacked on a leading dimension, one
card).  :func:`index_from_numpy` carries the reference's arrays over.
The host-side build is numpy, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, NamedTuple

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


class InvertedIndex(NamedTuple):
    """One slave's index on a device; every field an int32 tensor."""

    offsets: torch.Tensor    # int32[n_terms]   start of each list (BLOCK-aligned)
    lengths: torch.Tensor    # int32[n_terms]   valid postings per list
    postings: torch.Tensor   # int32[P]         docIDs, ascending per list
    attrs: torch.Tensor      # int32[P]         embedded attribute per posting
    block_max: torch.Tensor  # int32[P//BLOCK]  skip table (max docID per block)
    doc_site: torch.Tensor   # int32[n_docs_pad] docID -> siteId (gather strategy)

    @property
    def n_terms(self) -> int:
        return self.offsets.shape[0]


class ShardedIndex(NamedTuple):
    """``ns`` per-slave indexes stacked on a leading dimension, padded to
    common shapes (stacking only widens the spare padding)."""

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

    ``arrays`` maps each :class:`InvertedIndex` field name to a numpy array
    (``np.asarray`` of the JAX index's leaf of that name); extra keys such
    as the reference's ``packed`` twin are ignored.  This is how a test
    runs the reference and the port over the very same index bytes.
    """
    dev = torch.device(device)
    return InvertedIndex(*(
        torch.from_numpy(np.require(arrays[f], np.int32, ["C", "W"])).to(dev)
        for f in InvertedIndex._fields
    ))


def sharded_index_from_numpy(
    arrays: Mapping[str, np.ndarray], *, device
) -> ShardedIndex:
    """The sharded twin of :func:`index_from_numpy` (each array ``[ns, ...]``)."""
    dev = torch.device(device)
    return ShardedIndex(*(
        torch.from_numpy(np.require(arrays[f], np.int32, ["C", "W"])).to(dev)
        for f in ShardedIndex._fields
    ))


def build_index(
    corpus: Corpus, *, include_site_terms: bool = True, device=None
) -> tuple[InvertedIndex, IndexMeta]:
    arrays, meta = _build_numpy(corpus, include_site_terms)
    return index_from_numpy(arrays, device=resolve_device(device)), meta


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
