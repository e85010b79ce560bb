"""Synthetic web corpus generator (PyTorch port, host-side numpy).

The same generator as the JAX package's ``repro.data.corpus``: Zipf term
frequencies, docIDs in rank order (docID 0 = best), Zipf-sized sites.  For
the same :class:`CorpusConfig` it draws the same numbers from the same
numpy ``Generator`` in the same order, so the arrays are bit-identical.

One step differs in method, not in result: the per-doc dedup sorts one
int64 key ``doc * vocab + term`` instead of ``lexsort``-ing two keys.  The
sorted keys decode to the same ``(doc, term)`` pairs, and at millions of
documents the single-key sort is several times faster.

Mutation streams for online updates (:class:`Mutation`,
:func:`generate_mutations`, :func:`apply_mutations`) draw the same numbers
in the same order as the reference's, so one seed gives one stream, op for
op.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

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


# ---------------------------------------------------------------------------
# Mutation streams (the online-update workload, repro_torch.indexing)
# ---------------------------------------------------------------------------

class Mutation(NamedTuple):
    """One ingest operation.

    ``op`` is ``"insert"`` (terms+site, docid assigned by the writer),
    ``"delete"`` (docid only) or ``"update"`` (docid + new terms; ``site``
    is the new site, or None to keep the old one).
    """

    op: str
    docid: int | None
    terms: np.ndarray | None
    site: int | None


@dataclasses.dataclass(frozen=True)
class MutationConfig:
    n_ops: int = 100
    p_insert: float = 0.5
    p_delete: float = 0.2
    p_update: float = 0.3
    mean_doc_len: int = 32
    zipf_s: float = 1.1
    site_zipf_s: float = 1.2
    p_site_change: float = 0.25   # fraction of updates that move sites
    seed: int = 0


def _draw_terms(rng, cfg: MutationConfig, probs: np.ndarray) -> np.ndarray:
    n = max(1, int(rng.poisson(lam=cfg.mean_doc_len)))
    return np.unique(
        rng.choice(probs.shape[0], size=n, p=probs)
    ).astype(np.int32)


def generate_mutations(corpus: Corpus, cfg: MutationConfig) -> list[Mutation]:
    """An interleaved insert/delete/update stream over ``corpus``.

    Deletes and updates target uniformly-random *live* docs (tracking the
    stream's own inserts and deletes); inserts draw term sets and sites
    from the same Zipf laws as the base corpus.  Empty docs are deletion
    tombstones and never targets.
    """
    rng = np.random.default_rng(cfg.seed)
    probs = np.array([cfg.p_insert, cfg.p_delete, cfg.p_update], np.float64)
    probs = probs / probs.sum()
    site_probs = _zipf_probs(corpus.n_sites, cfg.site_zipf_s)
    term_probs = _zipf_probs(corpus.vocab_size, cfg.zipf_s)

    live = np.flatnonzero(np.diff(corpus.doc_offsets) > 0).tolist()
    n_docs = corpus.n_docs
    out: list[Mutation] = []
    for _ in range(cfg.n_ops):
        kind = ["insert", "delete", "update"][rng.choice(3, p=probs)]
        if kind != "insert" and not live:
            kind = "insert"
        if kind == "insert":
            terms = _draw_terms(rng, cfg, term_probs)
            site = int(rng.choice(corpus.n_sites, p=site_probs))
            out.append(Mutation("insert", None, terms, site))
            live.append(n_docs)
            n_docs += 1
        elif kind == "delete":
            i = int(rng.integers(len(live)))
            gid = live.pop(i)
            out.append(Mutation("delete", gid, None, None))
        else:
            gid = live[int(rng.integers(len(live)))]
            terms = _draw_terms(rng, cfg, term_probs)
            site = (
                int(rng.choice(corpus.n_sites, p=site_probs))
                if rng.random() < cfg.p_site_change
                else None
            )
            out.append(Mutation("update", gid, terms, site))
    return out


def apply_mutations(corpus: Corpus, mutations: list[Mutation]) -> Corpus:
    """The post-stream corpus, the ground truth a from-scratch rebuild
    sees.  Deleted docs become *empty* docs (zero terms, site kept), so
    docIDs, and therefore ranks, never shift."""
    docs = [np.asarray(corpus.terms_of(d), np.int32) for d in range(corpus.n_docs)]
    sites = [int(x) for x in corpus.doc_site]
    for m in mutations:
        if m.op == "insert":
            docs.append(np.unique(np.asarray(m.terms, np.int32)))
            sites.append(int(m.site))
        elif m.op == "delete":
            docs[m.docid] = np.zeros(0, dtype=np.int32)
        elif m.op == "update":
            docs[m.docid] = np.unique(np.asarray(m.terms, np.int32))
            if m.site is not None:
                sites[m.docid] = int(m.site)
        else:
            raise ValueError(m.op)
    return corpus_from_docs(
        docs, sites, vocab_size=corpus.vocab_size, n_sites=corpus.n_sites
    )
