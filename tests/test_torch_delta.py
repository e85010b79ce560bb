"""The port's write path against the JAX package's: mutation streams, the
``DeltaWriter`` snapshots and counters, capacity errors, compaction.

The same seeds and the same op stream go to both writers; every snapshot
array, ``version``, fill and ``mutated_corpus()`` must be equal, and the
compacted ``ShardedIndex`` must equal the reference's array for array."""
import numpy as np
import pytest
import torch

from repro.core import index as ref_index
from repro.data import corpus as ref_corpus
from repro.indexing import compaction as ref_compaction
from repro.indexing import delta as ref_delta
from repro_torch.core import index as pt_index
from repro_torch.data import corpus as pt_corpus
from repro_torch.indexing import compaction as pt_compaction
from repro_torch.indexing import delta as pt_delta

BLOCK = pt_index.BLOCK
CFG = dict(n_docs=240, vocab_size=90, mean_doc_len=15, n_sites=6, seed=9)


@pytest.fixture(scope="module")
def corpora():
    rc = ref_corpus.generate_corpus(ref_corpus.CorpusConfig(**CFG))
    pc = pt_corpus.generate_corpus(pt_corpus.CorpusConfig(**CFG))
    _, meta = ref_index.build_index(rc)
    return rc, pc, meta, pt_index.IndexMeta(**vars(meta))


def _writers(corpora, ns, **kw):
    rc, pc, meta, pmeta = corpora
    return (ref_delta.DeltaWriter(rc, meta, ns, **kw),
            pt_delta.DeltaWriter(pc, pmeta, ns, device="cpu", **kw))


def _streams(corpora, **kw):
    rc, pc, _, _ = corpora
    cfg = dict(n_ops=60, mean_doc_len=15, seed=4)
    cfg.update(kw)
    return (ref_corpus.generate_mutations(rc, ref_corpus.MutationConfig(**cfg)),
            pt_corpus.generate_mutations(pc, pt_corpus.MutationConfig(**cfg)))


def _assert_same_corpus(got, want):
    assert got.n_docs == want.n_docs
    assert (got.vocab_size, got.n_sites) == (want.vocab_size, want.n_sites)
    for f in ("doc_offsets", "doc_terms", "doc_site"):
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


def _assert_same_writer(pw, rw):
    rd, pd = rw.device_delta(), pw.device_delta()
    for f in pt_delta.ShardedDelta._fields:
        np.testing.assert_array_equal(getattr(pd, f).numpy(),
                                      np.asarray(getattr(rd, f)), err_msg=f)
    for rs, ps in zip(rw.shard_deltas(), pw.shard_deltas(), strict=True):
        assert ps.term_capacity == rs.term_capacity
        for f in pt_delta.ShardedDelta._fields:
            np.testing.assert_array_equal(getattr(ps, f).numpy(),
                                          np.asarray(getattr(rs, f)), err_msg=f)
    for attr in ("version", "n_docs", "doc_headroom", "term_capacity",
                 "nd_cap", "generation", "delta_doc_ids"):
        assert getattr(pw, attr) == getattr(rw, attr), attr
    for fn in ("posting_fill", "doc_fill", "fill"):
        assert getattr(pw, fn)() == getattr(rw, fn)(), fn
    for thr in (0.01, 0.5, 1.0):
        assert pw.needs_compaction(thr) == rw.needs_compaction(thr)
    _assert_same_corpus(pw.mutated_corpus(), rw.mutated_corpus())


def _apply_both(rw, pw, rmuts, pmuts):
    """Apply op by op; any error must be the same, at the same op."""
    for rm, pm in zip(rmuts, pmuts, strict=True):
        errs = []
        for w, m in ((rw, rm), (pw, pm)):
            try:
                w.apply([m])
                errs.append(None)
            except (KeyError, ValueError, ref_delta.DeltaFullError,
                    pt_delta.DeltaFullError) as e:
                errs.append((type(e).__name__, str(e),
                             getattr(e, "applied", None)))
        assert errs[0] == errs[1], (rm.op, errs)


@pytest.mark.parametrize("seed", [0, 4, 21])
def test_mutation_stream_matches_reference(corpora, seed):
    rc, pc, _, _ = corpora
    rmuts, pmuts = _streams(corpora, n_ops=120, seed=seed,
                            p_insert=0.4, p_delete=0.3, p_update=0.3)
    for r, p in zip(rmuts, pmuts, strict=True):
        assert (p.op, p.docid, p.site) == (r.op, r.docid, r.site)
        if r.terms is None:
            assert p.terms is None
        else:
            assert p.terms.dtype == r.terms.dtype
            np.testing.assert_array_equal(p.terms, r.terms)
    r_after = ref_corpus.apply_mutations(rc, rmuts)
    p_after = pt_corpus.apply_mutations(pc, pmuts)
    _assert_same_corpus(p_after, r_after)
    # a second stream over a corpus with deletion tombstones (empty docs)
    cfg = ref_corpus.MutationConfig(n_ops=50, seed=seed + 1)
    r2 = ref_corpus.generate_mutations(r_after, cfg)
    p2 = pt_corpus.generate_mutations(
        p_after, pt_corpus.MutationConfig(n_ops=50, seed=seed + 1))
    assert [(m.op, m.docid, m.site) for m in p2] == [
        (m.op, m.docid, m.site) for m in r2]
    _assert_same_corpus(pt_corpus.apply_mutations(p_after, p2),
                        ref_corpus.apply_mutations(r_after, r2))


@pytest.mark.parametrize("cap", [BLOCK, 256, 384])
@pytest.mark.parametrize("ns", [1, 2, 3])
def test_writer_snapshots_match_reference(corpora, ns, cap):
    rw, pw = _writers(corpora, ns, term_capacity=cap, doc_headroom=128)
    rmuts, pmuts = _streams(corpora, n_ops=90, p_insert=0.45, p_delete=0.25,
                            p_update=0.3)
    _assert_same_writer(pw, rw)
    done = 0
    for stop in (15, 50, 90):
        _apply_both(rw, pw, rmuts[done:stop], pmuts[done:stop])
        done = stop
        _assert_same_writer(pw, rw)
    snap = pw.device_delta()
    assert pw.device_delta() is snap       # cached per version
    pw.insert_docs([([1], 0)])
    assert pw.device_delta() is not snap


def test_delta_full_error_at_the_same_op(corpora):
    # term capacity: the BLOCK+1-th posting of term 0 does not fit
    rw, pw = _writers(corpora, 1, term_capacity=2, doc_headroom=512)
    docs = [([0], 0)] * (BLOCK + 5)
    got = []
    for w in (rw, pw):
        with pytest.raises(RuntimeError) as ei:
            w.insert_docs(docs)
        got.append((type(ei.value).__name__, str(ei.value), ei.value.applied))
    assert got[0] == got[1] and got[1][2] == BLOCK
    _assert_same_writer(pw, rw)
    # an update batch that overflows after one update landed
    ups = [(6, [2], 1), (5, [0, 1], None), (7, [3], None)]
    got = []
    for w in (rw, pw):
        with pytest.raises(RuntimeError) as ei:
            w.update_docs(ups)
        got.append((str(ei.value), ei.value.applied))
    assert got[0] == got[1] and got[1][1] == 1
    _assert_same_writer(pw, rw)
    # document headroom is exact
    rw, pw = _writers(corpora, 2, term_capacity=8 * BLOCK, doc_headroom=3)
    got = []
    for w in (rw, pw):
        with pytest.raises(RuntimeError) as ei:
            w.insert_docs([([1], 0)] * 6)
        got.append((str(ei.value), ei.value.applied))
    assert got[0] == got[1]
    _assert_same_writer(pw, rw)
    # a long mixed stream into small capacity fails at the same op
    rw, pw = _writers(corpora, 2, term_capacity=BLOCK, doc_headroom=64)
    rmuts, pmuts = _streams(corpora, n_ops=200, mean_doc_len=30, seed=7,
                            p_insert=0.7, p_delete=0.1, p_update=0.2)
    _apply_both(rw, pw, rmuts, pmuts)
    _assert_same_writer(pw, rw)


def test_bad_ops_raise_like_the_reference(corpora):
    rw, pw = _writers(corpora, 2, term_capacity=BLOCK, doc_headroom=16)
    for op in (
        lambda w: w.delete_docs([10_000]),
        lambda w: w.update_docs([(10_000, [1], None)]),
        lambda w: w.insert_docs([([1, 95], 0)]),
        lambda w: w.insert_docs([([1], 7)]),
        lambda w: w.update_docs([(3, [-1], None)]),
    ):
        got = []
        for w in (rw, pw):
            with pytest.raises((KeyError, ValueError)) as ei:
                op(w)
            got.append((type(ei.value).__name__, str(ei.value)))
        assert got[0] == got[1]
    for w in (rw, pw):
        w.delete_docs([3, 3])                  # a second delete is a no-op
        with pytest.raises(KeyError, match="deleted"):
            w.update_docs([(3, [1], None)])
    _assert_same_writer(pw, rw)


def test_update_moves_site_and_site_term(corpora):
    rc, _, meta, _ = corpora
    rw, pw = _writers(corpora, 1, term_capacity=BLOCK, doc_headroom=64)
    gid = 17
    new_site = (int(rc.doc_site[gid]) + 1) % meta.n_sites
    for w in (rw, pw):
        w.update_docs([(gid, [3], new_site)])
        w.update_docs([(gid, [3, 4], None)])   # site kept from the update
    _assert_same_writer(pw, rw)
    d = pw.device_delta()
    t = meta.vocab_size + new_site
    o, n = int(d.offsets[0, t]), int(d.lengths[0, t])
    assert gid in d.postings[0, o:o + n].tolist()
    assert int(d.doc_flags[0, gid]) == int(pt_index.DOC_SUPERSEDED)


@pytest.mark.parametrize("ns", [1, 2])
def test_fold_and_compact_verify_match_reference(corpora, ns):
    rc, pc, _, _ = corpora
    rw, pw = _writers(corpora, ns, term_capacity=256, doc_headroom=128)
    rmuts, pmuts = _streams(corpora, n_ops=60)
    _apply_both(rw, pw, rmuts, pmuts)
    _assert_same_corpus(pt_compaction.fold_corpus(pw),
                        ref_compaction.fold_corpus(rw))
    _assert_same_corpus(pt_compaction.fold_corpus(pw),
                        pt_corpus.apply_mutations(pc, pmuts))

    r_idx, r_meta = ref_compaction.compact(rw, verify=True)
    p_idx, p_meta = pt_compaction.compact(pw, verify=True)
    assert p_meta == pt_index.IndexMeta(**vars(r_meta))
    for f in pt_index.ShardedIndex._fields:
        np.testing.assert_array_equal(getattr(p_idx, f).numpy(),
                                      np.asarray(getattr(r_idx, f)), err_msg=f)
    assert pw.fill() == pw.doc_fill()          # the posting delta drained
    _assert_same_writer(pw, rw)
    _assert_same_corpus(pw.base_corpus, rw.base_corpus)

    # the writer keeps accepting mutations; a second compaction re-sizes
    rmuts2, pmuts2 = _streams(corpora, n_ops=40, seed=8)
    rmuts2 = [m for m in rmuts2 if m.op == "insert"]
    pmuts2 = [m for m in pmuts2 if m.op == "insert"]
    _apply_both(rw, pw, rmuts2, pmuts2)
    for w in (rw, pw):
        w.delete_docs([1, 2])
        w.update_docs([(4, [5, 6], 2)])
    _assert_same_writer(pw, rw)
    r_idx, _ = ref_compaction.compact(rw, verify=True, term_capacity=384,
                                      doc_headroom=256)
    p_idx, _ = pt_compaction.compact(pw, verify=True, term_capacity=384,
                                     doc_headroom=256)
    for f in pt_index.ShardedIndex._fields:
        np.testing.assert_array_equal(getattr(p_idx, f).numpy(),
                                      np.asarray(getattr(r_idx, f)), err_msg=f)
    _assert_same_writer(pw, rw)
    assert pw.generation == 1 and pw.term_capacity == 384


def test_rebase_matches_reference(corpora):
    rw, pw = _writers(corpora, 2, term_capacity=BLOCK, doc_headroom=32)
    rmuts, pmuts = _streams(corpora, n_ops=30)
    _apply_both(rw, pw, rmuts, pmuts)
    rw.rebase(ref_compaction.fold_corpus(rw))
    pw.rebase(pt_compaction.fold_corpus(pw))
    _assert_same_writer(pw, rw)
    rw.rebase(rw.mutated_corpus(), doc_headroom=100)
    pw.rebase(pw.mutated_corpus(), doc_headroom=100)
    _assert_same_writer(pw, rw)


def test_compaction_mismatch_is_detected(corpora):
    _, pw = _writers(corpora, 2, term_capacity=BLOCK, doc_headroom=64)
    _, pmuts = _streams(corpora, n_ops=30, seed=5)
    pw.apply(pmuts)
    version = pw.version
    pw._terms_over[0] = np.asarray([0, 1, 2], np.int32)   # corrupt the record
    with pytest.raises(pt_compaction.CompactionMismatch):
        pt_compaction.compact(pw, verify=True)
    assert pw.version == version                          # writer untouched


def test_maybe_compact_and_doc_headroom(corpora):
    rc, pc, _, _ = corpora
    _, pw = _writers(corpora, 1, term_capacity=BLOCK, doc_headroom=400)
    index, meta = pt_index.build_sharded_index(pc, 1, device="cpu")
    i2, _, ran = pt_compaction.maybe_compact(pw, index, meta, threshold=0.5)
    assert not ran and i2 is index
    for _ in range(BLOCK // 2):
        pw.insert_docs([([7], 0)])
    _, m3, ran = pt_compaction.maybe_compact(pw, index, meta, threshold=0.5,
                                             verify=True)
    assert ran and m3.n_docs == pc.n_docs + BLOCK // 2
    # document headroom is lifetime-fixed and never triggers compaction
    _, pw = _writers(corpora, 1, term_capacity=4 * BLOCK, doc_headroom=8)
    for i in range(8):
        pw.insert_docs([([i], 0)])
    assert pw.doc_fill() == 1.0 and not pw.needs_compaction(0.5)
    pt_compaction.compact(pw)
    assert pw.doc_fill() == 1.0 and not pw.needs_compaction(0.5)


def test_delta_carry_over_from_numpy(corpora):
    rw, pw = _writers(corpora, 2, term_capacity=256, doc_headroom=64)
    rmuts, pmuts = _streams(corpora, n_ops=40)
    _apply_both(rw, pw, rmuts, pmuts)
    rd = rw.device_delta()
    carried = pt_delta.sharded_delta_from_numpy(
        {f: np.asarray(v) for f, v in rd._asdict().items()}, device="cpu")
    for got, want in zip(carried, pw.device_delta(), strict=True):
        assert torch.equal(got, want)
    one = pt_delta.delta_from_numpy(
        {f: np.asarray(v) for f, v in rw.shard_deltas()[1]._asdict().items()
         if v is not None}, device="cpu")
    mine = pw.shard_deltas()[1]
    assert one.packed is None and mine.packed is None
    for f in pt_delta.ShardedDelta._fields:
        assert torch.equal(getattr(one, f), getattr(mine, f)), f
    assert pt_delta.local_delta(carried).term_capacity == 256


def test_packed_codec_and_default_device(corpora, monkeypatch):
    _, pc, _, pmeta = corpora
    pw = pt_delta.DeltaWriter(pc, pmeta, 2, codec="packed", device="cpu")
    pw.insert_docs([([1, 4], 0)])
    views = pw.shard_deltas()
    for view, raw in zip(views, pw.device_delta().postings, strict=True):
        assert view.packed is not None
        assert torch.equal(pt_index.unpack_flat_postings_torch(view.packed), raw)
    assert pw.shard_deltas()[0].packed is views[0].packed   # cached per version
    assert pw.device_delta().shard(0).packed is None        # the raw snapshot
    with pytest.raises(ValueError, match="codec"):
        pt_delta.DeltaWriter(pc, pmeta, 1, codec="zip", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt_delta.DeltaWriter(pc, pmeta, 1)
