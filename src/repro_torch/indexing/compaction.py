"""Compaction: fold the delta back into a fresh main index (port of
``repro.indexing.compaction``).

The fold consumes only what the index structures record (the base corpus
the main index was built from, the tombstone bitmap and the delta slabs,
inverted back to per-doc term sets), never the writer's mutated-corpus
record.  That is what makes ``verify=True`` meaningful: it checks the
folded build, array for array, against a from-scratch build over that
independent record.

The fold is vectorised: the slabs are inverted with one ``nonzero`` per
shard and the corpus is assembled from whole runs of unchanged base
documents, so it costs in proportion to the changed documents, not the
corpus (the reference loops over every document in Python).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.core.index import (
    DOC_DEAD,
    IndexMeta,
    ShardedIndex,
    build_sharded_index,
)
from repro_torch.data.corpus import Corpus
from repro_torch.indexing.delta import DeltaWriter, overlay_corpus


class CompactionMismatch(AssertionError):
    """Folded index differs from the from-scratch rebuild (corruption)."""


def fold_corpus(writer: DeltaWriter) -> Corpus:
    """Fold base + delta + tombstones into the compacted corpus.

    Per global docID ``g``, in precedence order:

    - ``DOC_DEAD`` set           -> empty document (rank slot preserved);
    - live postings in the delta -> the term set recovered by inverting the
      delta slabs (vocabulary terms only; site lists are re-derived from
      ``doc_site`` at build time), ascending;
    - otherwise                  -> the base corpus's term set, unchanged.

    Sites come from the delta's authoritative ``doc_site`` table.
    """
    ns, vocab = writer.ns, writer.vocab_size
    base = writer.base_corpus
    n_total = writer.n_docs
    gids = np.arange(n_total, dtype=np.int64)
    shard, local = gids % ns, gids // ns
    flags = np.stack([st.doc_flags for st in writer._shards])
    site_tab = np.stack([st.doc_site for st in writer._shards])
    sites = site_tab[shard, local]
    fallback = (sites < 0) & (gids < base.n_docs)
    sites[fallback] = base.doc_site[gids[fallback]]
    dead = np.flatnonzero(flags[shard, local] & DOC_DEAD)

    # Invert the delta slabs: (gid, term) pairs sorted by gid, then term.
    pair_g, pair_t = [], []
    for s, st in enumerate(writer._shards):
        lens = st.lengths[:vocab]
        t_idx, pos = np.nonzero(
            np.arange(writer.term_capacity)[None, :] < lens[:, None])
        pair_g.append(st.postings[t_idx, pos].astype(np.int64) * ns + s)
        pair_t.append(t_idx.astype(np.int32))
    pair_g = np.concatenate(pair_g)
    pair_t = np.concatenate(pair_t)
    order = np.lexsort((pair_t, pair_g))
    pair_g, pair_t = pair_g[order], pair_t[order]
    in_delta = np.fromiter(writer.delta_doc_ids, np.int64)
    starts = np.searchsorted(pair_g, in_delta, side="left")
    ends = np.searchsorted(pair_g, in_delta, side="right")

    terms: dict[int, np.ndarray] = {
        int(g): pair_t[a:b] for g, a, b in zip(in_delta, starts, ends)
    }
    empty = np.zeros(0, dtype=np.int32)
    terms.update((int(g), empty) for g in dead)
    return overlay_corpus(base, terms, sites, n_docs=n_total)


def compact(
    writer: DeltaWriter,
    *,
    verify: bool = False,
    term_capacity: int | None = None,
    doc_headroom: int | None = None,
) -> tuple[ShardedIndex, IndexMeta]:
    """Fold the delta into a fresh main :class:`ShardedIndex` on the
    writer's device and rebase the writer.

    With ``verify=True`` the folded build is checked, array for array,
    against a from-scratch build over the writer's mutated-corpus record;
    a mismatch raises :class:`CompactionMismatch` and leaves the writer
    untouched.  ``term_capacity``/``doc_headroom`` re-size the delta
    generation at the boundary (:meth:`DeltaWriter.rebase`).

    A :class:`~repro_torch.indexing.delta.ShardedDeltaWriter` is frozen
    (every shard quiesced) for the whole fold -> verify -> rebase, so
    compaction can race active ingest: the applied state folds
    consistently, and ops still queued (or blocked on the freeze) apply
    afterwards onto the new generation."""
    freeze = getattr(writer, "frozen", None)
    with freeze() if callable(freeze) else contextlib.nullcontext():
        folded = fold_corpus(writer)
        new_index, new_meta = build_sharded_index(
            folded, writer.ns, include_site_terms=writer.include_site_terms,
            device=writer.device,
        )
        if verify:
            ref_index, ref_meta = build_sharded_index(
                writer.mutated_corpus(), writer.ns,
                include_site_terms=writer.include_site_terms,
                device=writer.device,
            )
            if new_meta != ref_meta:
                raise CompactionMismatch(f"meta: {new_meta} != {ref_meta}")
            for name, got, want in zip(ShardedIndex._fields, new_index,
                                       ref_index):
                if not torch.equal(got, want):
                    raise CompactionMismatch(f"field {name!r} diverged")
        writer.rebase(folded, term_capacity=term_capacity,
                      doc_headroom=doc_headroom)
    return new_index, new_meta


def maybe_compact(
    writer: DeltaWriter,
    index: ShardedIndex,
    meta: IndexMeta,
    *,
    threshold: float = 0.5,
    verify: bool = False,
) -> tuple[ShardedIndex, IndexMeta, bool]:
    """Compact iff the delta crossed ``threshold``; returns the (possibly
    unchanged) index and meta and whether compaction ran."""
    if not writer.needs_compaction(threshold):
        return index, meta, False
    new_index, new_meta = compact(writer, verify=verify)
    return new_index, new_meta, True
