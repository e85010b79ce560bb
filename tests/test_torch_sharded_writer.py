"""The port's multi-master ``ShardedDeltaWriter`` on the CPU.

First the twins of ``tests/test_sharded_writer.py``: the
:class:`VectorVersion` stamp moves on exactly the shard an op lands on and
any shard's publish (or a rebase) invalidates a cached result; concurrent
insert/delete/update streams converge to the snapshot of a sequential
``DeltaWriter`` applying the same ops; the queues drain and count
conflicts; compaction races active ingest with ``verify=True``.

Then cross-package parity: the reference's and the port's sharded writers
take the same sequential ops (inserts, deletes, updates, a capacity-failed
insert, an unknown-docID conflict) and give equal stamps, snapshots field
by field, conflict counts and packed twins; and an updatable service over
each answers the same queries (the reference on ``backend="jnp"``: its
Pallas streamed path does not run on the installed jax)."""
import os
import sys
import threading

import numpy as np
import pytest
import torch

import jax

from repro.core import index as ref_index
from repro.data import corpus as ref_corpus
from repro.indexing import delta as ref_delta
from repro.obs.registry import MetricsRegistry as RefRegistry
from repro.serving.search import SearchService as RefService
from repro_torch.core import index as pt_index
from repro_torch.data import corpus as pt_corpus
from repro_torch.indexing import (
    DeltaFullError,
    DeltaWriter,
    ShardedDeltaWriter,
    VectorVersion,
    compact,
)
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.serving.scheduler import ResultCache
from repro_torch.serving.search import SearchService

NS = 4
CFG = dict(n_docs=60, vocab_size=50, mean_doc_len=8, n_sites=4, seed=5)


@pytest.fixture()
def setup():
    corpus = pt_corpus.generate_corpus(pt_corpus.CorpusConfig(**CFG))
    _, meta = pt_index.build_sharded_index(corpus, NS, device="cpu")
    return corpus, meta


def make_writer(corpus, meta, **kw):
    kw.setdefault("term_capacity", 256)
    kw.setdefault("doc_headroom", 512)
    return ShardedDeltaWriter(corpus, meta, NS, device="cpu", **kw)


def _assert_same_snapshot(got, want):
    for name, g, r in zip(got._fields, got, want):
        assert torch.equal(g, r), name


# ------------------------------------------------------------ vector version


def test_vector_version_bumps_only_the_touched_shard(setup):
    corpus, meta = setup
    w = make_writer(corpus, meta)
    v0 = w.version
    assert v0 == VectorVersion(0, (0,) * NS)
    (gid,) = w.insert_docs([([1, 2], 0)])
    v1 = w.version
    assert v1.epoch == 0
    assert v1.seqs[gid % NS] == 1
    assert sum(v1.seqs) == 1          # exactly one shard moved
    w.delete_docs([gid])
    v2 = w.version
    assert v2.seqs[gid % NS] == 2
    assert v2 != v1 and v1 != v0      # every publish is a distinct stamp
    assert hash(v2) != hash(v1)       # usable as a cache stamp


def test_rebase_bumps_epoch(setup):
    corpus, meta = setup
    w = make_writer(corpus, meta)
    w.insert_docs([([3, 4], 1)])
    v_before = w.version
    assert v_before.epoch == 0
    compact(w, verify=True)
    v = w.version
    assert v.epoch == 1               # structural change: new generation
    assert v.seqs == v_before.seqs    # seqs carry over; epoch alone moves
    assert v != v_before


def test_vector_version_invalidates_cache_across_any_shard(setup):
    corpus, meta = setup
    w = make_writer(corpus, meta)
    cache = ResultCache(capacity=8)
    key = ((7,), None, 10)
    cache.put(key, w.version, "result-A")
    assert cache.get(key, w.version) == "result-A"
    w.insert_docs([([7], 0)])
    assert cache.get(key, w.version) is None
    assert cache.stats.stale == 1
    # re-cache at the new version, then mutate a *different* shard
    cache.put(key, w.version, "result-B")
    gids = w.insert_docs([([9], 1), ([9], 2), ([9], 3)])
    assert any(g % NS != gids[0] % NS for g in gids)
    assert cache.get(key, w.version) is None
    assert cache.stats.stale == 2


# ------------------------------------------- multi-writer vs sequential oracle


def _oracle_from(w: ShardedDeltaWriter, corpus, meta, ops_by_gid,
                 doc_headroom=512):
    """Sequential single writer applying the concurrent run's final ops in
    gid order; its publish must equal the concurrent writer's snapshot."""
    ref = DeltaWriter(corpus, meta, NS, term_capacity=256,
                      doc_headroom=doc_headroom, device="cpu")
    for gid in range(corpus.n_docs, w.n_docs):
        terms = [int(t) for t in w._terms_of(gid)]
        ref.insert_docs([(terms or [0], w._site_of(gid))])
        if not terms:
            # a capacity-failure placeholder or a doc deleted after insert
            ref.delete_docs([gid])
    for gid, op in ops_by_gid:
        if op == "delete":
            ref.delete_docs([gid])
        else:
            ref.update_docs([op])
    return ref


def test_interleaved_inserts_match_sequential_oracle(setup):
    corpus, meta = setup
    w = make_writer(corpus, meta)
    n_threads, per_thread = 4, 30
    errs = []

    def worker(tid):
        try:
            for j in range(per_thread):
                w.insert_docs([([(tid * per_thread + j) % 50,
                                 (tid + j) % 50], tid % 4)])
        except Exception as e:  # surface in the main thread
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errs
    assert w.n_docs == corpus.n_docs + n_threads * per_thread
    assert sum(w.version.seqs) == n_threads * per_thread

    ref = _oracle_from(w, corpus, meta, [])
    _assert_same_snapshot(w.device_delta(), ref.device_delta())
    compact(w, verify=True)


def test_interleaved_mixed_streams_match_oracle(setup):
    """Insert/delete/update streams on disjoint doc subsets interleave
    freely; the published snapshot equals the sequential oracle's."""
    corpus, meta = setup
    w = make_writer(corpus, meta)
    base_gids = w.insert_docs([([i % 50], i % 4) for i in range(24)])
    ops_by_gid = []
    lock = threading.Lock()
    errs = []

    def worker(tid):
        try:
            for i, gid in enumerate(base_gids[tid::3]):
                if i % 2 == 0:
                    upd = (gid, [(gid + i) % 50, (gid + i + 1) % 50], 1)
                    w.update_docs([upd])
                    with lock:
                        ops_by_gid.append((gid, upd))
                else:
                    w.delete_docs([gid])
                    with lock:
                        ops_by_gid.append((gid, "delete"))
        except Exception as e:
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errs

    ref = DeltaWriter(corpus, meta, NS, term_capacity=256, doc_headroom=512,
                      device="cpu")
    ref.insert_docs([([i % 50], i % 4) for i in range(24)])
    final = dict(ops_by_gid)
    for gid in sorted(final):
        if final[gid] == "delete":
            ref.delete_docs([gid])
        else:
            ref.update_docs([final[gid]])
    _assert_same_snapshot(w.device_delta(), ref.device_delta())
    compact(w, verify=True)


# -------------------------------------------------------- queue + conflicts


def test_striped_queues_drain_and_count_conflicts(setup):
    corpus, meta = setup
    reg = MetricsRegistry()
    w = make_writer(corpus, meta, registry=reg)
    w.submit_insert([5, 6], 2)
    w.submit_insert([7], 1)
    w.submit_delete(0)
    w.submit_update(1, [8], None)
    w.submit_delete(10 ** 6)          # unknown gid -> conflict, not a crash
    assert w.queue_depth() == 5
    assert [reg.gauge("odys_ingest_queue_depth", shard=str(s)).value
            for s in range(NS)] == [3.0, 2.0, 0.0, 0.0]
    applied = w.drain()
    assert applied == 4
    assert w.queue_depth() == 0
    assert w.n_docs == corpus.n_docs + 2
    assert reg.counter("odys_ingest_conflicts_total").value == 1
    assert [reg.counter("odys_ingest_ops_total", op=op).value
            for op in ("insert", "delete", "update")] == [2, 1, 1]
    w.device_delta()
    assert [reg.gauge("odys_ingest_publish_seq", shard=str(s)).value
            for s in range(NS)] == list(map(float, w.version.seqs))


def test_snapshot_cache_keyed_on_vector_version(setup):
    corpus, meta = setup
    w = make_writer(corpus, meta)
    w.insert_docs([([1], 0)])
    s1 = w.device_delta()
    assert w.device_delta() is s1     # same stamp -> cached snapshot
    before = [x.clone() for x in s1]
    (gid,) = w.insert_docs([([2], 1)])
    s2 = w.device_delta()
    assert s2 is not s1               # any shard's publish drops the cache
    # the older snapshot is a value: the later mutation did not reach it
    assert all(torch.equal(a, b) for a, b in zip(s1, before))
    assert not torch.equal(s1.lengths, s2.lengths)
    # shards that did not move reuse their cached rows; the one that moved
    # has new rows
    moved = gid % NS
    assert [torch.equal(s1.postings[s], s2.postings[s]) for s in range(NS)] == [
        s != moved for s in range(NS)]


def test_stress_queues_lose_no_update(setup):
    """More threads than cores submit and drain at once, with the
    interpreter switching threads as often as it can: every op is applied
    or counted as a conflict exactly once, and the counters and stamps
    agree with what was submitted."""
    corpus, meta = setup
    reg = MetricsRegistry()
    w = make_writer(corpus, meta, doc_headroom=4096, registry=reg)
    n_threads, per_thread = (os.cpu_count() or 4) + 4, 8
    applied, errs = [], []
    lock = threading.Lock()

    def worker(tid):
        try:
            for i in range(per_thread):
                w.submit_insert([tid % 50, (tid + i) % 50], tid % 4)
                w.submit_delete(10 ** 6 + tid)       # always a conflict
                n = w.drain(tid % NS)
                with lock:
                    applied.append(n)
        except Exception as e:
            errs.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert not errs
    n_ops = n_threads * per_thread
    total = sum(applied) + w.drain()
    assert w.queue_depth() == 0
    assert total == n_ops == sum(w.version.seqs)
    assert w.n_docs == corpus.n_docs + n_ops
    assert reg.counter("odys_ingest_conflicts_total").value == n_ops
    assert reg.counter("odys_ingest_ops_total", op="insert").value == n_ops
    ref = _oracle_from(w, corpus, meta, [], doc_headroom=4096)
    _assert_same_snapshot(w.device_delta(), ref.device_delta())


# -------------------------------------------- compaction racing active ingest


def test_compaction_races_active_writer_queue(setup):
    """Writers keep inserting while the main thread compacts (verify=True):
    every fold cross-checks against a from-scratch rebuild, and no insert
    is lost or applied twice across the generation change."""
    corpus, meta = setup
    w = make_writer(corpus, meta, term_capacity=512, doc_headroom=2048)
    stop = threading.Event()
    inserted = [0, 0]
    errs = []

    def ingest(tid):
        try:
            while not stop.is_set():
                w.insert_docs([([(inserted[tid] + tid) % 50], tid % 4)])
                inserted[tid] += 1
        except DeltaFullError:
            pass
        except Exception as e:
            errs.append(e)

    threads = [threading.Thread(target=ingest, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    try:
        for _ in range(3):
            compact(w, verify=True)   # freeze -> fold -> verify -> rebase
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errs
    assert w.version.epoch == 3
    assert w.n_docs == corpus.n_docs + sum(inserted)
    compact(w, verify=True)


# -------------------------------------------------- parity with the reference


@pytest.fixture(scope="module")
def pair():
    rc = ref_corpus.generate_corpus(ref_corpus.CorpusConfig(**CFG))
    pc = pt_corpus.generate_corpus(pt_corpus.CorpusConfig(**CFG))
    return rc, pc


def _pair_writers(pair, ns, **kw):
    rc, pc = pair
    _, rmeta = ref_index.build_sharded_index(rc, ns)
    pmeta = pt_index.IndexMeta(**vars(rmeta))
    rreg, preg = RefRegistry(), MetricsRegistry()
    rw = ref_delta.ShardedDeltaWriter(rc, rmeta, ns, registry=rreg, **kw)
    pw = ShardedDeltaWriter(pc, pmeta, ns, device="cpu", registry=preg, **kw)
    return rw, pw, rreg, preg


def _ops(rw, pw):
    """The same sequential ops on both writers: inserts, a capacity-failed
    insert, deletes, updates (incl. a site change), and queued conflicts."""
    for w in (rw, pw):
        w.insert_docs([([1, 2, 3], 0), ([2, 5], 1), ([7], 2), ([2], 3)])
        w.delete_docs([0, 61])
        w.update_docs([(5, [9, 10], None), (62, [4], 2), (63, [2, 8], None)])
        # term 2 holds postings up to capacity on every shard, then one more
        # insert with it fails and leaves a dead placeholder
        for _ in range(1000):
            try:
                w.insert_docs([([2, 11], 1)])
            except (DeltaFullError, ref_delta.DeltaFullError):
                break
        else:
            raise AssertionError("no capacity failure")
        w.submit_delete(10 ** 6)           # unknown docID
        w.submit_update(0, [3], None)      # a deleted doc
        w.submit_insert([12, 13], 2)
        w.submit_update(7, [14], 3)
        assert w.drain() == 2


@pytest.mark.parametrize("codec", ["raw", "packed"])
@pytest.mark.parametrize("ns", [1, 4])
def test_matches_reference_sharded_writer(pair, ns, codec):
    rw, pw, rreg, preg = _pair_writers(pair, ns, term_capacity=128,
                                       doc_headroom=1024, codec=codec)
    _ops(rw, pw)
    assert isinstance(pw.version, VectorVersion)
    assert tuple(pw.version) == tuple(rw.version)
    assert pw.n_docs == rw.n_docs
    rd, pd = rw.device_delta(), pw.device_delta()
    for f in pd._fields:
        np.testing.assert_array_equal(getattr(pd, f).numpy(),
                                      np.asarray(getattr(rd, f)), err_msg=f)
    conflicts = [reg.counter("odys_ingest_conflicts_total").value
                 for reg in (rreg, preg)]
    assert conflicts[0] == conflicts[1] == 2   # the unknown and the deleted doc
    for op in ("insert", "delete", "update"):
        assert (preg.counter("odys_ingest_ops_total", op=op).value
                == rreg.counter("odys_ingest_ops_total", op=op).value), op
    if codec == "packed":
        for rs, ps in zip(rw.shard_deltas(), pw.shard_deltas(), strict=True):
            for f in ("words", "blk_base", "blk_meta", "blk_woff"):
                np.testing.assert_array_equal(
                    getattr(ps.packed, f).numpy(),
                    np.asarray(getattr(rs.packed, f)), err_msg=f)
            assert ps.packed.chunk_rows == rs.packed.chunk_rows
    # the mutated-corpus records agree too
    rm, pm = rw.mutated_corpus(), pw.mutated_corpus()
    for f in ("doc_offsets", "doc_terms", "doc_site"):
        np.testing.assert_array_equal(getattr(pm, f), getattr(rm, f), err_msg=f)


def test_updatable_service_matches_reference_service(pair):
    """An updatable service over each sharded writer (ns = 1: the
    reference service needs one jax device a shard) answers the same
    queries equally, before and after compaction; the cache stamp is the
    VectorVersion."""
    rc, pc = pair
    rsh, rmeta = ref_index.build_sharded_index(rc, 1)
    psh, pmeta = pt_index.build_sharded_index(pc, 1, device="cpu")
    rw, pw, _, _ = _pair_writers(pair, 1, term_capacity=256, doc_headroom=256)
    kw = dict(ns=1, k=10, window=1024, t_max=4, batch_size=4, cache_size=64)
    ref = RefService(rsh, rmeta, jax.make_mesh((1,), ("data",)), backend="jnp",
                     writer=rw, **kw)
    port = SearchService(psh, pmeta, device="cpu", writer=pw, **kw)
    queries = [([1], None), ([2], None), ([2, 5], None), ([3], 0), ([7], None),
               ([9, 10], None), ([4], 2), ([11], None), ([12], None)]

    def same():
        want = [(h.docids, h.n_hits) for h in ref.search(queries)]
        assert [(h.docids, h.n_hits) for h in port.search(queries)] == want
        return want

    first = same()
    assert port._snapshot_version() == pw.version
    for svc in (ref, port):
        svc.insert([([2, 12], 0), ([1, 9, 10], 1)])
        svc.delete([3])
        svc.update([(4, [2, 7], None)])
    assert tuple(pw.version) == tuple(rw.version)
    assert same() != first
    assert port.stats()["cache"]["stale"] == ref.stats()["cache"]["stale"] > 0
    ref.compact(verify=True)
    port.compact(verify=True)
    assert pw.version.epoch == 1
    same()
