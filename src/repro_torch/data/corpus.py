"""Synthetic web corpus generator (PyTorch port, host-side numpy).

The same generator as the JAX package's ``repro.data.corpus``: Zipf term
frequencies, docIDs in rank order (docID 0 = best), Zipf-sized sites.  For
the same :class:`CorpusConfig` it draws the same numbers from the same
numpy ``Generator`` in the same order, so the arrays are bit-identical.

One step differs in method, not in result: the per-doc dedup sorts one
int64 key ``doc * vocab + term`` instead of ``lexsort``-ing two keys.  The
sorted keys decode to the same ``(doc, term)`` pairs, and at millions of
documents the single-key sort is several times faster.

Mutation streams (online updates) come with the merge-on-read slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CorpusConfig:
    n_docs: int = 10_000
    vocab_size: int = 2_000
    mean_doc_len: int = 64
    zipf_s: float = 1.1           # term-frequency skew
    n_sites: int = 100
    site_zipf_s: float = 1.2      # site-size skew
    seed: int = 0


@dataclasses.dataclass
class Corpus:
    """Flat CSR of documents -> unique term ids, plus per-doc metadata.

    ``doc_terms[doc_offsets[d]:doc_offsets[d+1]]`` are the unique terms of
    doc ``d``, ascending.
    """

    doc_offsets: np.ndarray      # int64[n_docs+1]
    doc_terms: np.ndarray        # int32[nnz]
    doc_site: np.ndarray         # int32[n_docs], site id per doc
    n_docs: int
    vocab_size: int
    n_sites: int

    def terms_of(self, d: int) -> np.ndarray:
        return self.doc_terms[self.doc_offsets[d]:self.doc_offsets[d + 1]]


def _zipf_probs(n: int, s: float) -> np.ndarray:
    ranks = np.arange(1, n + 1, dtype=np.float64)
    p = ranks ** (-s)
    return p / p.sum()


def corpus_from_docs(
    docs: list[np.ndarray],
    sites,
    *,
    vocab_size: int,
    n_sites: int,
) -> Corpus:
    """Assemble a Corpus from per-doc term arrays + sites (docID = index)."""
    lens = np.array([d.shape[0] for d in docs], dtype=np.int64)
    offsets = np.zeros(len(docs) + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    terms = (
        np.concatenate(docs) if docs else np.zeros(0, dtype=np.int32)
    ).astype(np.int32)
    return Corpus(
        doc_offsets=offsets,
        doc_terms=terms,
        doc_site=np.asarray(sites, dtype=np.int32),
        n_docs=len(docs),
        vocab_size=vocab_size,
        n_sites=n_sites,
    )


def generate_corpus(cfg: CorpusConfig) -> Corpus:
    """Generate a synthetic corpus. docIDs come out already rank-ordered."""
    rng = np.random.default_rng(cfg.seed)

    lens = np.maximum(
        1, rng.poisson(lam=cfg.mean_doc_len, size=cfg.n_docs)
    ).astype(np.int64)
    probs = _zipf_probs(cfg.vocab_size, cfg.zipf_s)
    draws = rng.choice(cfg.vocab_size, size=int(lens.sum()), p=probs)

    # Dedup within each doc: sort the (doc, term) keys, drop repeats.
    key = np.repeat(
        np.arange(cfg.n_docs, dtype=np.int64) * cfg.vocab_size, lens
    )
    key += draws
    del draws
    key.sort()
    keep = np.ones(key.shape[0], dtype=bool)
    keep[1:] = key[1:] != key[:-1]
    key = key[keep]
    sd = key // cfg.vocab_size
    st = (key - sd * cfg.vocab_size).astype(np.int32)
    new_lens = np.bincount(sd, minlength=cfg.n_docs).astype(np.int64)
    new_offsets = np.zeros(cfg.n_docs + 1, dtype=np.int64)
    np.cumsum(new_lens, out=new_offsets[1:])

    site_probs = _zipf_probs(cfg.n_sites, cfg.site_zipf_s)
    doc_site = rng.choice(cfg.n_sites, size=cfg.n_docs, p=site_probs).astype(
        np.int32
    )

    return Corpus(
        doc_offsets=new_offsets,
        doc_terms=st,
        doc_site=doc_site,
        n_docs=cfg.n_docs,
        vocab_size=cfg.vocab_size,
        n_sites=cfg.n_sites,
    )
