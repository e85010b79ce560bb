"""The benchmark's own inputs, drawn from ``--seed``: corpus, queries, mutations.

Frozen copies of the generators the ODYS port carries
(``repro_torch.data.corpus`` and ``repro_torch.core.queries``), rewritten so
that a run draws its data fast and the yardstick never moves with the
program:

- :func:`make_corpus` draws the web corpus on the device with a
  ``torch.Generator`` in a few large calls (Poisson document lengths, Zipf
  terms deduplicated per document, Zipf-sized sites; docIDs in rank order)
  and returns host arrays;
- :func:`make_queries` draws the paper's §5.1 query stream (Fig 7(c)'s mix
  of single, multiple and site-limited queries at k 10 / 50 / 1000) with
  numpy, vectorised;
- :func:`make_mutations` draws the "mixed" insert / delete / update stream
  that feeds merge-on-read.

Every function takes the seed and returns the same arrays for the same
seed.  Nothing here imports the program.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

SEED_MASK = 2**64 - 1

#: Postings per generation chunk: bounds the device memory the corpus
#: generator takes (a few hundred MB), so that it never sets the peak.
CHUNK_DRAWS = 1 << 24


def seed_words(seed: int, stream: int) -> list[int]:
    """A numpy ``SeedSequence`` entropy list for one of the run's streams."""
    return [int(seed) & SEED_MASK, stream]


class CorpusArrays(NamedTuple):
    """Documents as a CSR of unique ascending term ids, plus each site."""

    doc_offsets: np.ndarray  # int64[n_docs + 1]
    doc_terms: np.ndarray    # int32[nnz]
    doc_site: np.ndarray     # int32[n_docs]
    vocab_size: int
    n_sites: int

    @property
    def n_docs(self) -> int:
        return self.doc_site.shape[0]


def zipf_cdf(n: int, s: float) -> np.ndarray:
    """Cumulative Zipf(s) probabilities over ranks 1..n, float64, last 1."""
    p = np.arange(1, n + 1, dtype=np.float64) ** (-s)
    cdf = np.cumsum(p / p.sum())
    cdf[-1] = 1.0
    return cdf


def make_corpus(cfg: dict, seed: int, device) -> CorpusArrays:
    """The configuration's corpus, drawn on ``device`` from ``seed``."""
    dev = torch.device(device)
    n, vocab = int(cfg["n_docs"]), int(cfg["vocab_size"])
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed) & SEED_MASK)
    f64 = torch.float64
    lens = torch.poisson(torch.full((n,), float(cfg["mean_doc_len"]), dtype=f64,
                                    device=dev), generator=g)
    lens = lens.clamp_(min=1).to(torch.int64)
    site_cdf = torch.from_numpy(zipf_cdf(int(cfg["n_sites"]),
                                         float(cfg["site_zipf_s"]))).to(dev)
    sites = torch.searchsorted(site_cdf, torch.rand(n, dtype=f64, generator=g,
                                                    device=dev))
    sites = sites.clamp_(max=int(cfg["n_sites"]) - 1).to(torch.int32)
    term_cdf = torch.from_numpy(zipf_cdf(vocab, float(cfg["term_zipf_s"]))).to(dev)

    ends = np.cumsum(lens.cpu().numpy())
    terms_out, counts_out = [], []
    lo = 0
    while lo < n:
        base = int(ends[lo - 1]) if lo else 0
        hi = max(lo + 1, int(np.searchsorted(ends, base + CHUNK_DRAWS, "right")))
        hi = min(hi, n)
        m = int(ends[hi - 1]) - base
        u = torch.rand(m, dtype=f64, generator=g, device=dev)
        t = torch.searchsorted(term_cdf, u).clamp_(max=vocab - 1)
        del u
        doc = torch.repeat_interleave(
            torch.arange(hi - lo, dtype=torch.int64, device=dev), lens[lo:hi])
        key = torch.unique_consecutive((doc * vocab + t).sort().values)
        del doc, t
        d = key // vocab
        terms_out.append((key - d * vocab).to(torch.int32).cpu().numpy())
        counts_out.append(torch.bincount(d, minlength=hi - lo).cpu().numpy())
        lo = hi
    counts = np.concatenate(counts_out)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    return CorpusArrays(offsets, np.concatenate(terms_out), sites.cpu().numpy(),
                        vocab, int(cfg["n_sites"]))


class QueryStream(NamedTuple):
    """A stream of queries: ``terms[i, :n_terms[i]]`` restricted to
    ``site[i]`` (-1: none), answered top-``k[i]``."""

    terms: np.ndarray    # int32[n, max_terms], -1 padded
    n_terms: np.ndarray  # int32[n]
    site: np.ndarray     # int32[n]
    k: np.ndarray        # int32[n]

    def query(self, i: int) -> tuple[list[int], int | None, int]:
        nt = int(self.n_terms[i])
        site = int(self.site[i])
        return (self.terms[i, :nt].tolist(), None if site < 0 else site,
                int(self.k[i]))

    def __len__(self) -> int:
        return self.k.shape[0]


def _distinct_draws(rng, cdf: np.ndarray, want: np.ndarray, width: int) -> np.ndarray:
    """Per row ``i``, ``want[i]`` distinct draws from ``cdf`` in draw order
    (rejecting repeats, which is sampling without replacement), -1 padded
    to ``width``."""
    n = want.shape[0]
    out = np.full((n, width), -1, dtype=np.int32)
    have = np.zeros(n, dtype=np.int64)
    rows = np.arange(n)
    while True:
        todo = rows[have < want]
        if todo.size == 0:
            return out
        cand = np.searchsorted(cdf, rng.random((todo.size, 4 * width)))
        cand = np.minimum(cand, cdf.shape[0] - 1).astype(np.int32)
        for j in range(cand.shape[1]):
            c = cand[:, j]
            dup = (out[todo] == c[:, None]).any(axis=1)
            take = ~dup & (have[todo] < want[todo])
            r = todo[take]
            out[r, have[r]] = c[take]
            have[r] += 1


def make_queries(traffic: dict, cfg: dict, seed: int, n: int,
                 stream: int = 1) -> QueryStream:
    """``n`` queries of the traffic's mix over the configuration's corpus."""
    rng = np.random.default_rng(seed_words(seed, stream))
    mix = traffic["mix"]
    probs = np.array([p for _, _, p in mix], dtype=np.float64)
    kind = rng.choice(len(mix), size=n, p=probs / probs.sum())
    sct = np.array([c for c, _, _ in mix])[kind]
    k = np.array([kk for _, kk, _ in mix], dtype=np.int32)[kind]
    max_terms = int(traffic["max_terms"])
    nt = np.where(sct == "single", 1,
                  rng.integers(2, max_terms + 1, size=n)).astype(np.int32)
    terms = _distinct_draws(
        rng, zipf_cdf(int(cfg["vocab_size"]), float(traffic["term_zipf_s"])),
        nt, max_terms)
    sites = rng.integers(0, int(cfg["n_sites"]), size=n, dtype=np.int64)
    site = np.where(sct == "limited", sites, -1).astype(np.int32)
    return QueryStream(terms, nt, site, k)


INSERT, DELETE, UPDATE = 0, 1, 2


class Mutation(NamedTuple):
    """One ingest operation: ``gid`` is the inserted document's expected
    docID (the next one) or the target of a delete or update; ``terms``
    (unique, ascending) and ``site`` are the new version's (``site`` -1 on
    an update: keep the old site; unused on a delete)."""

    op: int
    gid: int
    terms: np.ndarray
    site: int


def make_mutations(mix: dict, corpus: CorpusArrays, seed: int, n: int,
                   stream: int = 2) -> list[Mutation]:
    """``n`` mutations of the configuration's update mix.  Deletes and
    updates target uniformly random live documents, the stream's own
    inserts and deletes included; new versions draw their terms and sites
    from the corpus's Zipf laws."""
    rng = np.random.default_rng(seed_words(seed, stream))
    p = np.array([mix["p_insert"], mix["p_delete"], mix["p_update"]], np.float64)
    ops = rng.choice(3, size=n, p=p / p.sum())
    lens = np.maximum(1, rng.poisson(float(mix["mean_doc_len"]), size=n))
    draws = np.searchsorted(zipf_cdf(corpus.vocab_size, float(mix["term_zipf_s"])),
                            rng.random(int(lens.sum())))
    draws = np.minimum(draws, corpus.vocab_size - 1).astype(np.int32)
    cuts = np.cumsum(lens)[:-1]
    sites = np.minimum(np.searchsorted(zipf_cdf(corpus.n_sites,
                                                float(mix["site_zipf_s"])),
                                       rng.random(n)), corpus.n_sites - 1)
    move = rng.random(n) < float(mix["p_site_change"])
    pick = rng.random(n)
    live = np.arange(corpus.n_docs, dtype=np.int64)
    n_live = corpus.n_docs
    next_gid = corpus.n_docs
    out = []
    for i, terms in enumerate(np.split(draws, cuts)):
        op = int(ops[i])
        if op == INSERT:
            if n_live == live.shape[0]:
                live = np.concatenate([live, np.empty_like(live[:1024])])
            live[n_live] = next_gid
            n_live += 1
            out.append(Mutation(INSERT, next_gid, np.unique(terms), int(sites[i])))
            next_gid += 1
            continue
        j = int(pick[i] * n_live)
        gid = int(live[j])
        if op == DELETE:
            n_live -= 1
            live[j] = live[n_live]
            out.append(Mutation(DELETE, gid, np.zeros(0, np.int32), -1))
        else:
            out.append(Mutation(UPDATE, gid, np.unique(terms),
                                int(sites[i]) if move[i] else -1))
    return out
