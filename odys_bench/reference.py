"""Plain NumPy reference of served ODYS search, for deciding ``correct``.

It works out, from the benchmark's own corpus and mutation stream alone,
what every served query must answer:

- the document-partitioned shards: global docID ``d`` lives on slave
  ``d % ns`` as local docID ``d // ns``;
- per slave, each query's driver, the first of its terms with the fewest
  postings on that slave (main postings plus delta postings under
  merge-on-read), and the driver's first ``window`` postings;
- the join: a driver posting matches when it is live, carries the query's
  site (site-limited queries), and is in every other term's list, where a
  term's list is its first ``window`` main postings (a main posting counts
  only while its document is neither deleted nor superseded) together with
  its delta postings;
- per slave, the matches counted (``n_hits``) and the first ``k`` in rank
  order; the master's answer is the first ``k`` of all slaves' and the sum
  of their counts.

Under merge-on-read the driver's window is its main window and its delta
list merged in docID order (main first on a tie) and cut to ``window``
slots; a tombstoned main posting keeps its slot and does not match.  That
is the windowed answer the configuration guarantees ("the exact windowed
top-k of the index it read"); it equals a rebuild's answer wherever the
window covers the lists.

The mutation model follows the stated semantics: an insert takes the next
docID and puts its postings in the delta; a delete marks the document dead
and drops its delta postings; an update marks a main document superseded
(or drops an older delta version) and puts the new version in the delta.

This module imports numpy alone.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

DEAD, SUPERSEDED = 1, 2
INSERT, DELETE, UPDATE = 0, 1, 2

#: Documents per pass over the corpus (bounds host memory).
DOC_CHUNK = 1 << 19
_EMPTY = np.zeros(0, dtype=np.int64)


class MainLists:
    """The base corpus's posting lists, per slave: every term's length and,
    for the terms asked for, the first ``window`` postings (local docIDs,
    ascending) and their sites."""

    def __init__(self, corpus, ns: int, window: int, terms):
        self.ns, self.window = ns, window
        self.doc_site = corpus.doc_site
        vocab = corpus.vocab_size
        want = np.zeros(vocab, dtype=bool)
        want[np.asarray(sorted(set(int(t) for t in terms)), dtype=np.int64)] = True
        lengths = np.zeros(vocab * ns, dtype=np.int64)
        got_t, got_d = [], []
        n_docs = corpus.n_docs
        offs = corpus.doc_offsets
        for lo in range(0, n_docs, DOC_CHUNK):
            hi = min(lo + DOC_CHUNK, n_docs)
            terms_c = corpus.doc_terms[offs[lo]:offs[hi]]
            docs_c = np.repeat(np.arange(lo, hi, dtype=np.int64), np.diff(offs[lo:hi + 1]))
            lengths += np.bincount(terms_c.astype(np.int64) * ns + docs_c % ns,
                                   minlength=vocab * ns)
            sel = want[terms_c]
            got_t.append(terms_c[sel])
            got_d.append(docs_c[sel])
            # a term is complete once every slave holds a whole window of it
            full = lengths.reshape(vocab, ns).min(axis=1) >= window
            want &= ~full
        self.lengths = lengths.reshape(vocab, ns).T.copy()   # [ns, vocab]
        t_all = np.concatenate(got_t)
        d_all = np.concatenate(got_d)
        order = np.argsort(t_all, kind="stable")
        t_all, d_all = t_all[order], d_all[order]
        bounds = np.searchsorted(t_all, np.arange(vocab + 1))
        self._windows: dict[tuple[int, int], np.ndarray] = {}
        for t in np.unique(t_all):
            docs = d_all[bounds[t]:bounds[t + 1]]
            for s in range(ns):
                self._windows[(s, int(t))] = docs[docs % ns == s][:window] // ns

    def window_docs(self, s: int, t: int) -> np.ndarray:
        """Slave ``s``'s first ``window`` local docIDs of term ``t``."""
        return self._windows.get((s, t), _EMPTY)

    def window_sites(self, s: int, t: int) -> np.ndarray:
        return self.doc_site[self.window_docs(s, t) * self.ns + s]


class DeltaState:
    """The merge-on-read state after a prefix of the mutation stream."""

    def __init__(self, corpus, ns: int):
        self.ns = ns
        self.base_site = corpus.doc_site
        self.next_gid = corpus.n_docs
        self.flags: dict[int, int] = {}
        self.delta: dict[int, tuple[np.ndarray, int]] = {}
        self.applied = 0
        self._lists = None
        self._flag_arrays = None

    def site_of(self, gid: int) -> int:
        held = self.delta.get(gid)
        return int(self.base_site[gid]) if held is None else held[1]

    def apply(self, m) -> None:
        self._lists = self._flag_arrays = None
        self.applied += 1
        if m.op == INSERT:
            if m.gid != self.next_gid:
                raise ValueError(f"insert expects docID {self.next_gid}, got {m.gid}")
            self.delta[m.gid] = (m.terms, int(m.site))
            self.next_gid += 1
        elif m.op == DELETE:
            self.delta.pop(m.gid, None)
            self.flags[m.gid] = self.flags.get(m.gid, 0) | DEAD
        elif m.op == UPDATE:
            site = self.site_of(m.gid) if m.site < 0 else int(m.site)
            if m.gid not in self.delta:
                self.flags[m.gid] = self.flags.get(m.gid, 0) | SUPERSEDED
            self.delta[m.gid] = (m.terms, site)
        else:
            raise ValueError(m.op)

    def flags_of(self, s: int, local: np.ndarray) -> np.ndarray:
        """The tombstone bits of slave ``s``'s local docIDs."""
        if self._flag_arrays is None:
            keys = np.array(sorted(self.flags), dtype=np.int64)
            self._flag_arrays = (keys, np.array([self.flags[int(g)] for g in keys],
                                                dtype=np.int64))
        keys, bits = self._flag_arrays
        gids = local.astype(np.int64) * self.ns + s
        if keys.size == 0:
            return np.zeros(gids.shape[0], dtype=np.int64)
        at = np.minimum(np.searchsorted(keys, gids), keys.size - 1)
        return np.where(keys[at] == gids, bits[at], 0)

    def _build(self):
        gids = np.fromiter(self.delta.keys(), dtype=np.int64, count=len(self.delta))
        if gids.size:
            lens = np.array([self.delta[int(g)][0].shape[0] for g in gids])
            terms = np.concatenate([self.delta[int(g)][0] for g in gids]).astype(np.int64)
            sites = np.array([self.delta[int(g)][1] for g in gids], dtype=np.int64)
            g_rep = np.repeat(gids, lens)
            s_rep = np.repeat(sites, lens)
        else:
            terms = g_rep = s_rep = np.zeros(0, dtype=np.int64)
        order = np.lexsort((g_rep, terms))
        self._lists = (terms[order], g_rep[order], s_rep[order])

    def delta_list(self, s: int, t: int) -> tuple[np.ndarray, np.ndarray]:
        """Slave ``s``'s delta postings of term ``t``: local docIDs
        ascending, and their sites."""
        if self._lists is None:
            self._build()
        terms, gids, sites = self._lists
        lo, hi = np.searchsorted(terms, [t, t + 1])
        g, st = gids[lo:hi], sites[lo:hi]
        mine = g % self.ns == s
        return g[mine] // self.ns, st[mine]


class SlaveJoin(NamedTuple):
    """One slave's join of one query (what the answer and the work count
    read)."""

    driver: int               # the driver term
    n_main: int               # main postings in the driver's window
    n_delta: int              # delta postings in the driver's window
    docs: np.ndarray          # the window's local docIDs
    match: np.ndarray         # bool: the posting matches the query
    live: np.ndarray          # bool: the posting is live
    probes: list              # per other term: (term, main window, delta list)


def slave_join(main: MainLists, state: DeltaState | None, s: int,
               terms: list[int], site: int | None) -> SlaveJoin:
    window = main.window

    def length(t):
        n = int(main.lengths[s, t])
        return n + (0 if state is None else state.delta_list(s, t)[0].shape[0])

    lens = [length(t) for t in terms]
    slot = int(np.argmin(lens))
    drv = terms[slot]
    m_docs = main.window_docs(s, drv)
    m_sites = main.window_sites(s, drv)
    if state is None:
        docs, sites, live = m_docs, m_sites, np.ones(m_docs.shape[0], dtype=bool)
        n_main, n_delta = m_docs.shape[0], 0
    else:
        d_docs, d_sites = state.delta_list(s, drv)
        docs = np.concatenate([m_docs, d_docs])
        sites = np.concatenate([m_sites, d_sites])
        from_delta = np.arange(docs.shape[0]) >= m_docs.shape[0]
        order = np.argsort(docs, kind="stable")[:window]
        docs, sites, from_delta = docs[order], sites[order], from_delta[order]
        n_delta = int(from_delta.sum())
        n_main = docs.shape[0] - n_delta
        fl = state.flags_of(s, docs)
        ok_main = (fl & (DEAD | SUPERSEDED)) == 0
        ok_delta = (fl & DEAD) == 0
        live = np.where(from_delta, ok_delta, ok_main)
    match = live.copy()
    if site is not None:
        match &= sites == site
    probes = []
    for j, t in enumerate(terms):
        if j == slot:
            continue
        pm = main.window_docs(s, t)
        inside = np.isin(docs, pm)
        if state is None:
            pd = docs[:0]
        else:
            pd = state.delta_list(s, t)[0]
            inside = (inside & ok_main) | (np.isin(docs, pd) & ok_delta)
        match &= inside
        probes.append((t, pm, pd))
    return SlaveJoin(drv, int(n_main), int(n_delta), docs, match, live, probes)


def answer(main: MainLists, state: DeltaState | None, terms: list[int],
           site: int | None, k: int) -> tuple[list[int], int]:
    """The master's answer: global docIDs in rank order, and ``n_hits``."""
    ns = main.ns
    hits = 0
    cands = []
    for s in range(ns):
        j = slave_join(main, state, s, terms, site)
        local = j.docs[j.match]
        hits += int(local.shape[0])
        cands.append(local[:k].astype(np.int64) * ns + s)
    merged = np.sort(np.concatenate(cands))[:k]
    return merged.tolist(), hits


def snapshots(corpus, ns: int, mutations, ms):
    """Yield ``(m, state)`` for each of the ascending prefixes ``ms`` of
    ``mutations`` (``state`` None without mutations); one state is advanced
    in place, so use it before taking the next."""
    state = None if mutations is None else DeltaState(corpus, ns)
    for m in ms:
        if state is not None:
            if m < state.applied:
                raise ValueError("snapshots must ascend")
            while state.applied < m:
                state.apply(mutations[state.applied])
        yield m, state


def answers(main: MainLists, corpus, queries, mutations=None):
    """Answer ``queries``, each ``(terms, site, k, m)``: ``m`` is how many
    of ``mutations`` its batch had seen (ignored without mutations).
    Returns ``[(docids, n_hits)]`` in the order given."""
    out = [None] * len(queries)
    order = sorted(range(len(queries)), key=lambda i: queries[i][3])
    ms = sorted({queries[i][3] for i in order})
    states = snapshots(corpus, main.ns, mutations, ms)
    m, state = next(states, (None, None))
    for i in order:
        terms, site, k, qm = queries[i]
        while m != qm:
            m, state = next(states)
        out[i] = answer(main, state, list(terms), site, k)
    return out
