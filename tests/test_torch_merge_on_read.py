"""Merge-on-read in the port against the JAX package's jnp path.

The reference's delta snapshot is carried over with ``delta_from_numpy``
(and its index with ``index_from_numpy``), so both sides read the very
same bytes.  Held exactly:

- K3's plain version against ``merged_term_window(drop_dead=False)``:
  docs, the live stream derived from ``src``, and attrs where a slot holds
  a posting;
- K4's plain version against the jnp join mask (``MergedPostingSource.
  member`` per active term, the live stream and the attribute predicate);
- ``query_topk(delta=...)`` on both port backends and all three strategies
  against ``query_topk(delta=..., backend="jnp")`` and against a rebuild
  over the mutated corpus;
- ns = 2 ``distributed_query_topk`` and ``sequential_reference``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import engine as ref_engine
from repro.core import index as ref_index
from repro.core import parallel as ref_parallel
from repro.data import corpus as ref_corpus
from repro.indexing import delta as ref_delta
from repro_torch.core import engine as pt_engine
from repro_torch.core import index as pt_index
from repro_torch.core import parallel as pt_parallel
from repro_torch.indexing import delta as pt_delta
from repro_torch.kernels import delta_merge as dm
from repro_torch.kernels import ops
from repro_torch.kernels import posting_intersect as pi

INV = int(pt_index.INVALID_DOC)
WINDOW = 1024
CFG = dict(n_docs=400, vocab_size=150, mean_doc_len=25, n_sites=10, seed=13)
QUERIES = [
    ([3], None), ([3, 9], None), ([1, 4, 12], None), ([2], 3), ([5, 8], 1),
    ([140], None), ([0, 7], 5), ([3, 9, 23], None), ([0, 1, 2], 2),
    ([0, 1, 2, 3], None),
]
DRIVERS = [3, 9, 1, 17, 140, 23, -1, 0]   # hot, rare, and an inert slot


@pytest.fixture(scope="module")
def setup():
    corpus = ref_corpus.generate_corpus(ref_corpus.CorpusConfig(**CFG))
    ridx, meta = ref_index.build_index(corpus)
    return corpus, ridx, _carry_index(ridx), meta


def _carry_index(ridx):
    return pt_index.index_from_numpy(
        {f: np.asarray(v) for f, v in ridx._asdict().items() if v is not None},
        device="cpu")


def _carry_delta(rdelta):
    return pt_delta.delta_from_numpy(
        {f: np.asarray(v) for f, v in rdelta._asdict().items() if v is not None},
        device="cpu")


def _writer_at_fill(corpus, meta, target, *, ns=1, cap=256, seed=5):
    """A reference writer whose hottest delta list sits at ``target``
    posting fill, with delete and update tombstones (the shapes of the
    reference's own merge-on-read tests)."""
    rng = np.random.default_rng(seed)
    w = ref_delta.DeltaWriter(corpus, meta, ns, term_capacity=cap,
                              doc_headroom=1024)
    w.delete_docs([int(d) for d in rng.choice(corpus.n_docs, 6, replace=False)])
    w.update_docs([
        (int(d), np.unique(rng.integers(0, 40, size=10)), int(rng.integers(10)))
        for d in rng.choice(np.arange(200, 260), 6, replace=False)
    ])
    while w.posting_fill() < target:
        terms = np.unique(rng.integers(0, 24, size=20))
        w.insert_docs([(terms, int(rng.integers(10)))])
    return w


def _batches(queries, meta, strategy="embed"):
    return (ref_engine.make_query_batch(queries, t_max=4, meta=meta,
                                        strategy=strategy),
            pt_engine.make_query_batch(queries, t_max=4, meta=meta,
                                       strategy=strategy, device="cpu"))


def _assert_result(got, want, ctx=""):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]),
                                  err_msg=f"docids {ctx}")
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]),
                                  err_msg=f"n_hits {ctx}")


# ---------------------------------------------------------------- K3


@pytest.mark.parametrize("fill,cap", [(0.0, 256), (0.5, 256), (1.0, 256),
                                      (1.0, 384)])
@pytest.mark.parametrize("window", [WINDOW, 256, 1000])
def test_k3_plain_matches_merged_term_window(setup, fill, cap, window):
    corpus, ridx, pidx, meta = setup
    w = _writer_at_fill(corpus, meta, fill, cap=cap)
    rdelta = ref_delta.local_delta(w.device_delta())
    pdelta = _carry_delta(rdelta)
    assert pdelta.term_capacity == w.term_capacity
    terms = torch.tensor(DRIVERS, dtype=torch.int32)
    source = pt_engine.MergedPostingSource(pidx, pdelta)
    span = source.driver_span(terms, window)
    docs, attrs, src = ops.merge_windows(
        pidx.postings, pidx.attrs, span.off, span.n_eff,
        pdelta.postings, pdelta.attrs, pdelta.offsets, pdelta.lengths,
        pdelta.block_max, terms, window=window)
    assert docs.dtype == attrs.dtype == src.dtype == torch.int32
    live = source.driver_live(docs, src)
    want = jax.vmap(lambda t: ref_engine.merged_term_window(
        ridx, rdelta, t, window, drop_dead=False))(jnp.asarray(terms.numpy()))
    np.testing.assert_array_equal(docs.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(live.numpy(), np.asarray(want[2]))
    real = docs.numpy() != INV
    np.testing.assert_array_equal(attrs.numpy()[real], np.asarray(want[1])[real])
    # INVALID slots: src 0 and INVALID_ATTR, as the kernel writes them
    assert (src.numpy()[~real] == 0).all()
    assert (attrs.numpy()[~real] == int(pt_index.INVALID_ATTR)).all()
    if fill > 0:
        assert src.numpy().any()
    # the port's own torch-backend merge agrees on docs and live too, and
    # equals the reference's in both tombstone modes
    pdocs, _, plive = pt_engine.merged_term_window(pidx, pdelta, terms, window,
                                                   drop_dead=False)
    assert torch.equal(pdocs, docs) and torch.equal(plive, live)
    for drop_dead in (False, True):
        got = pt_engine.merged_term_window(pidx, pdelta, terms, window,
                                           drop_dead=drop_dead)
        ref = jax.vmap(lambda t: ref_engine.merged_term_window(
            ridx, rdelta, t, window, drop_dead=drop_dead))(
                jnp.asarray(terms.numpy()))
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


# ---------------------------------------------------------------- K4


def _ref_join_mask(ridx, rdelta, rqb, window, kernel_filter):
    """The jnp join: merged driver window, then per active term the
    merged-list membership, the live stream and the attribute predicate."""
    source = ref_engine.MergedPostingSource(ridx, rdelta)

    def one(terms, n_terms, filt):
        slot = source.driver_slot(terms, n_terms)
        docs, attrs, mask = source.driver_window(terms[slot], window)
        flags = source.driver_flags(docs)
        for s in range(terms.shape[0]):
            active = (s < n_terms) & (s != slot)
            m = source.member(docs, terms[s], window, flags)
            mask = mask & jnp.where(active, m, True)
        ok = jnp.where(filt < 0, True, attrs == filt)
        return docs, mask & ok

    return jax.vmap(one)(rqb.terms, rqb.n_terms, kernel_filter)


@pytest.mark.parametrize("fill", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("filt", [True, False])
def test_k4_plain_matches_jnp_join(setup, fill, filt):
    corpus, ridx, pidx, meta = setup
    w = _writer_at_fill(corpus, meta, fill)
    rdelta = ref_delta.local_delta(w.device_delta())
    pdelta = _carry_delta(rdelta)
    rqb, pqb = _batches(QUERIES, meta)
    kf = pqb.attr_filter if filt else torch.full_like(pqb.attr_filter, -1)
    for window in (WINDOW, 1000):
        source = pt_engine.MergedPostingSource(pidx, pdelta)
        _, d_terms, active = pt_engine._pick_drivers(source, pqb)
        span = source.driver_span(d_terms, window)
        docs, attrs, src = ops.merge_windows(
            pidx.postings, pidx.attrs, span.off, span.n_eff, pdelta.postings,
            pdelta.attrs, pdelta.offsets, pdelta.lengths, pdelta.block_max,
            d_terms, window=window)
        flags = source.driver_flags(docs)
        live = source.driver_live(docs, src, flags)
        mask = ops.intersect_streamed(
            docs, attrs, live, pqb.terms, active.to(torch.int32), kf,
            pidx.postings, pidx.offsets, pidx.lengths, pidx.block_max,
            pdelta.postings, pdelta.offsets, pdelta.lengths, pdelta.block_max,
            flags)
        want_docs, want_mask = _ref_join_mask(
            ridx, rdelta, rqb, window, jnp.asarray(kf.numpy()))
        np.testing.assert_array_equal(docs.numpy(), np.asarray(want_docs))
        np.testing.assert_array_equal(mask.numpy(),
                                      np.asarray(want_mask).astype(np.int32))
        assert mask.numpy().sum() > 0


def test_k4_plan_and_static_variant(setup):
    """The delta plan reads the delta's valid-max skip table at ``cap``;
    with an empty delta K4 is the static join over a materialized driver
    (its mask equals K1's on the same driver window), and so is its static
    mode, a call without the delta arrays; a call with only some of them
    is refused."""
    corpus, ridx, pidx, meta = setup
    _, pqb = _batches(QUERIES, meta)
    source = pt_engine.StaticPostingSource(pidx)
    _, d_terms, active = pt_engine._pick_drivers(source, pqb)
    active = active.to(torch.int32)
    span = source.driver_span(d_terms, WINDOW)
    docs, mask1 = ops.intersect_fullstream(
        span.off, span.n_eff, pqb.terms, active, pqb.attr_filter,
        pidx.postings, pidx.attrs, pidx.offsets, pidx.lengths,
        pidx.block_max, window=WINDOW)
    attrs = pt_engine.term_window(pidx, d_terms, WINDOW)[1]
    live = (docs != INV).to(torch.int32)
    empty = _carry_delta(ref_delta.local_delta(ref_delta.DeltaWriter(
        corpus, meta, 1, term_capacity=256, doc_headroom=1024).device_delta()))
    assert int(empty.lengths.sum()) == 0
    flags = pt_engine.MergedPostingSource(pidx, empty).driver_flags(docs)
    mask4 = ops.intersect_streamed(docs, attrs, live, pqb.terms, active,
                                   pqb.attr_filter, pidx.postings,
                                   pidx.offsets, pidx.lengths, pidx.block_max,
                                   empty.postings, empty.offsets,
                                   empty.lengths, empty.block_max, flags)
    assert torch.equal(mask4, mask1) and int(mask1.sum()) > 0
    # the static mode (no delta arrays): the main probe alone
    static = ops.intersect_streamed(docs, attrs, live, pqb.terms, active,
                                    pqb.attr_filter, pidx.postings,
                                    pidx.offsets, pidx.lengths, pidx.block_max)
    assert torch.equal(static, mask1)
    with pytest.raises(ValueError, match="all of d_postings"):
        ops.intersect_streamed(docs, attrs, live, pqb.terms, active,
                               pqb.attr_filter, pidx.postings, pidx.offsets,
                               pidx.lengths, pidx.block_max, empty.postings)
    w = _writer_at_fill(corpus, meta, 1.0, cap=384)
    pdelta = _carry_delta(ref_delta.local_delta(w.device_delta()))
    main, delta, cap = pi.plan_streamed(
        docs, pqb.terms, active, pidx.offsets, pidx.lengths, pidx.block_max,
        pdelta.offsets, pdelta.lengths, pdelta.block_max)
    assert cap == 384 and delta[0].shape == main[0].shape
    lo, hi = delta[2][..., 0], delta[2][..., 1]
    assert bool(((hi - lo) <= cap).all() and (lo % cap == 0).all())


# ---------------------------------------------------------------- engine


@pytest.mark.parametrize("strategy", ["embed", "gather", "site_term"])
@pytest.mark.parametrize("fill", [0.0, 0.5, 1.0])
def test_query_topk_matches_reference(setup, strategy, fill):
    corpus, ridx, pidx, meta = setup
    w = _writer_at_fill(corpus, meta, fill)
    rdelta = ref_delta.local_delta(w.device_delta())
    pdelta = _carry_delta(rdelta)
    rqb, pqb = _batches(QUERIES, meta, strategy)
    rebuilt, _ = ref_index.build_index(w.mutated_corpus())
    for window in (WINDOW, 256, 1000):
        want = ref_engine.query_topk(ridx, rqb, delta=rdelta, k=10,
                                     window=window, attr_strategy=strategy,
                                     backend="jnp")
        # The staged comparator joins against the first `window` postings of
        # each merged list, the jnp path against the main window and the
        # whole delta slab: they agree while the window covers the merged
        # lists (not at 256 here), so it is held against the reference's
        # staged path.
        staged = ref_engine.query_topk(ridx, rqb, delta=rdelta, k=10,
                                       window=window, attr_strategy=strategy,
                                       backend="pallas_staged", interpret=True)
        for backend in pt_engine.BACKENDS:
            got = pt_engine.query_topk(pidx, pqb, delta=pdelta, k=10,
                                       window=window, attr_strategy=strategy,
                                       backend=backend)
            _assert_result(got, staged if backend == "kernel_staged" else want,
                           (backend, window))
        assert int(np.asarray(want[1]).sum()) > 0
    # the window covers every merged list here: equal to a rebuild
    got = pt_engine.query_topk(pidx, pqb, delta=pdelta, k=10, window=WINDOW,
                               attr_strategy=strategy)
    want = ref_engine.query_topk(rebuilt, rqb, k=10, window=WINDOW,
                                 attr_strategy=strategy, backend="jnp")
    _assert_result(got, want, "rebuild")


def test_mutation_stream_equals_rebuild(setup):
    """A mixed insert/delete/update stream: merge-on-read equals the
    reference at every checkpoint and a rebuild over the mutated corpus."""
    corpus, ridx, pidx, meta = setup
    muts = ref_corpus.generate_mutations(corpus, ref_corpus.MutationConfig(
        n_ops=80, p_insert=0.45, p_delete=0.25, p_update=0.3,
        mean_doc_len=25, seed=21))
    w = ref_delta.DeltaWriter(corpus, meta, 1, term_capacity=384,
                              doc_headroom=128)
    rqb, pqb = _batches(QUERIES, meta)
    done = 0
    for stop in (20, 50, 80):
        w.apply(muts[done:stop])
        done = stop
        rdelta = ref_delta.local_delta(w.device_delta())
        rebuilt, _ = ref_index.build_index(
            ref_corpus.apply_mutations(corpus, muts[:stop]))
        want = ref_engine.query_topk(rebuilt, rqb, k=10, window=WINDOW,
                                     backend="jnp")
        for backend in pt_engine.BACKENDS:
            got = pt_engine.query_topk(pidx, pqb, delta=_carry_delta(rdelta),
                                       k=10, window=WINDOW, backend=backend)
            _assert_result(got, want, (backend, stop))


@pytest.mark.parametrize("backend", ["kernel", "torch"])
@pytest.mark.parametrize("merge", ["tournament", "allgather"])
def test_distributed_with_deltas_matches_reference(setup, backend, merge):
    corpus, _, _, meta = setup
    ns = 2
    w = _writer_at_fill(corpus, meta, 1.0, ns=ns)
    rsh, _ = ref_index.build_sharded_index(corpus, ns)
    shards = [ref_index.InvertedIndex(*(x[s] for x in rsh)) for s in range(ns)]
    rqb, pqb = _batches(QUERIES, meta)
    want = ref_parallel.sequential_reference(
        shards, rqb, ns=ns, k=10, window=WINDOW, deltas=w.shard_deltas(),
        backend="jnp")
    psh = pt_index.sharded_index_from_numpy(
        {f: np.asarray(v) for f, v in rsh._asdict().items() if v is not None},
        device="cpu")
    pdelta = pt_delta.sharded_delta_from_numpy(
        {f: np.asarray(v) for f, v in w.device_delta()._asdict().items()},
        device="cpu")
    got = pt_parallel.distributed_query_topk(
        psh, pqb, pdelta, ns=ns, k=10, window=WINDOW, merge=merge,
        backend=backend)
    _assert_result(got, want, (backend, merge))
    seq = pt_parallel.sequential_reference(
        [psh.shard(s) for s in range(ns)], pqb, ns=ns, k=10, window=WINDOW,
        deltas=[pdelta.shard(s) for s in range(ns)], backend=backend)
    _assert_result(seq, want, "sequential")
    unmerged = pt_parallel.slave_topk_unmerged(
        psh, pqb, pdelta, ns=ns, k=10, window=WINDOW, backend=backend)
    assert unmerged.docids.shape == (ns, len(QUERIES), 10)
    rebuilt = [ref_index.build_index(p)[0] for p in
               ref_index.partition_corpus(w.mutated_corpus(), ns)]
    _assert_result(got, ref_parallel.sequential_reference(
        rebuilt, rqb, ns=ns, k=10, window=WINDOW), "rebuild")
    with pytest.raises(ValueError, match="delta holds"):
        pt_parallel.distributed_query_topk(
            psh, pqb, pt_delta.ShardedDelta(*(x[:1] for x in pdelta)), ns=ns)


@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_all_tombstoned_driver_window(setup, backend):
    """Every document of the driver term deleted: the driver window is
    tombstones wall to wall and reads as zero hits, also where another
    term's probes would match."""
    corpus, ridx, pidx, meta = setup
    term = 140
    holders = [d for d in range(corpus.n_docs)
               if term in set(corpus.terms_of(d))]
    assert holders
    w = ref_delta.DeltaWriter(corpus, meta, 1, term_capacity=256,
                              doc_headroom=128)
    w.delete_docs(holders)
    rdelta = ref_delta.local_delta(w.device_delta())
    queries = [([term], None), ([term, 3], None), ([term], 3)]
    rqb, pqb = _batches(queries, meta)
    got = pt_engine.query_topk(pidx, pqb, delta=_carry_delta(rdelta), k=10,
                               window=WINDOW, backend=backend)
    assert got[1].tolist() == [0, 0, 0] and bool((got[0] == INV).all())
    _assert_result(got, ref_engine.query_topk(ridx, rqb, delta=rdelta, k=10,
                                              window=WINDOW, backend="jnp"))


@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_empty_main_driver_list_with_delta_postings(backend):
    """A driver term with an empty main list and delta postings is served
    from the delta alone (main n_eff = 0), and drains back to zero hits
    when those documents are deleted again."""
    docs = [np.array(d, np.int32) for d in ([0, 1], [0, 2], [1, 2])]
    corpus = ref_corpus.corpus_from_docs(docs, [0, 1, 0], vocab_size=8,
                                         n_sites=4)
    ridx, meta = ref_index.build_index(corpus)
    pidx = _carry_index(ridx)
    empty_t = 5
    w = ref_delta.DeltaWriter(corpus, meta, 1, term_capacity=256,
                              doc_headroom=128)
    gids = w.insert_docs([([empty_t, 0], 2), ([empty_t], 1)])
    queries = [([empty_t], None), ([empty_t, 0], None), ([0, empty_t], 2)]
    rqb, pqb = _batches(queries, meta)
    for expect in ([2, 1, 1], [0, 0, 0]):
        rdelta = ref_delta.local_delta(w.device_delta())
        got = pt_engine.query_topk(pidx, pqb, delta=_carry_delta(rdelta),
                                   k=10, window=WINDOW, backend=backend)
        _assert_result(got, ref_engine.query_topk(
            ridx, rqb, delta=rdelta, k=10, window=WINDOW, backend="jnp"))
        assert got[1].tolist() == expect
        w.delete_docs(gids)


def test_delta_on_another_device_is_refused(setup):
    corpus, _, pidx, meta = setup
    w = _writer_at_fill(corpus, meta, 0.0)
    pdelta = _carry_delta(ref_delta.local_delta(w.device_delta()))
    _, pqb = _batches(QUERIES, meta)
    moved = pdelta._replace(**{f: getattr(pdelta, f).to("meta")
                               for f in pt_delta.ShardedDelta._fields})
    with pytest.raises(ValueError, match="delta on"):
        pt_engine.query_topk(pidx, pqb, delta=moved)
    # the plain K3 on an empty slab is the main window copied through
    span = pt_engine.StaticPostingSource(pidx).driver_span(
        torch.tensor(DRIVERS, dtype=torch.int32), 300)
    d, a, s = dm.merge_delta_windows(
        pidx.postings, pidx.attrs, span.off, span.n_eff, pdelta.postings,
        pdelta.attrs, pdelta.offsets, torch.zeros_like(pdelta.lengths),
        pdelta.block_max, torch.tensor(DRIVERS, dtype=torch.int32), window=300)
    main = pt_engine.term_window(pidx, torch.tensor(DRIVERS, dtype=torch.int32), 300)
    assert torch.equal(d, main[0]) and not s.any()


def test_k3_k4_cuda_wrappers_refuse_cpu_tensors(setup):
    """A CPU tensor never reaches a kernel: the wrappers check every
    argument before anything is built or launched."""
    corpus, _, pidx, meta = setup
    w = _writer_at_fill(corpus, meta, 0.5)
    pdelta = _carry_delta(ref_delta.local_delta(w.device_delta()))
    terms = torch.tensor(DRIVERS, dtype=torch.int32)
    source = pt_engine.MergedPostingSource(pidx, pdelta)
    span = source.driver_span(terms, WINDOW)
    k3 = (pidx.postings, pidx.attrs, span.off, span.n_eff, pdelta.postings,
          pdelta.attrs, pdelta.offsets, pdelta.lengths, terms)
    with pytest.raises(ValueError, match="CUDA tensor"):
        dm.merge_delta_windows_cuda(*k3, window=WINDOW, cap=256)
    docs, attrs, src = dm.merge_delta_windows_torch(*k3, window=WINDOW, cap=256)
    _, pqb = _batches(QUERIES[:len(DRIVERS)], meta)
    active = torch.ones_like(pqb.terms)
    main, delta, cap = pi.plan_streamed(
        docs, pqb.terms, active, pidx.offsets, pidx.lengths, pidx.block_max,
        pdelta.offsets, pdelta.lengths, pdelta.block_max)
    flags = source.driver_flags(docs)
    k4 = (docs, attrs, source.driver_live(docs, src, flags), flags, active,
          pqb.attr_filter, pidx.postings, *main, pdelta.postings, *delta)
    with pytest.raises(ValueError, match="CUDA tensor"):
        pi.streamed_join_cuda(*k4, cap=cap)
    assert dm.merge_delta_windows_cuda.launches == 0
    assert pi.streamed_join_cuda.launches == 0
