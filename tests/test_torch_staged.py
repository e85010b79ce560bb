"""The staged comparator path (``backend="kernel_staged"``: windows staged
into ``[Q, T_MAX, window]``, then K9) against the JAX package's own staged
path, ``query_topk(backend="pallas_staged", interpret=True)``, whose
Pallas K9 runs in interpret mode here, and against its jnp path.

Held exactly, on a corpus whose lists exceed one TILE (6000 pages, vocab
500, mean page length 30: lists reach 5,981 postings):

- ``query_topk`` for the three strategies, on the static index and under
  merge-on-read (a packed writer with deletes, updates and inserts), raw
  and packed, at windows 1024 and 3000;
- ``sequential_reference(backend="kernel_staged")`` at ns = 2, static and
  with deltas, against the reference's staged ``sequential_reference``;
- the updatable ``SearchService(backend="kernel_staged")`` against the
  reference's staged service and the port's ``backend="torch"`` service,
  before and after a mutation stream and compaction.

The staged path joins against the first ``window`` postings of each
merged list, the jnp path against the main window and the whole delta
slab; where the window does not cover the merged lists the two can differ
in the reference itself, and the port follows the reference's staged
path (checked below case by case).
"""
import numpy as np
import pytest

import jax

from repro.core import engine as ref_engine
from repro.core import index as ref_index
from repro.core import parallel as ref_parallel
from repro.data import corpus as ref_corpus
from repro.indexing import delta as ref_delta
from repro.serving.search import SearchService as RefService
from repro_torch.core import engine as pt_engine
from repro_torch.core import index as pt_index
from repro_torch.core import parallel as pt_parallel
from repro_torch.data import corpus as pt_corpus
from repro_torch.indexing import delta as pt_delta
from repro_torch.kernels import posting_intersect as pi
from repro_torch.serving.search import SearchService

CFG = dict(n_docs=6000, vocab_size=500, mean_doc_len=30, n_sites=20, seed=3)
QUERIES = [
    ([0], None), ([0, 1], None), ([1, 2, 3], 2), ([4], 1), ([0, 5, 6], None),
    ([7, 8], None), ([0, 1, 2, 3], None), ([450], None), ([2, 499], 3),
    ([30, 0], 5), ([11, 12, 13, 14], None),
]
K = 50


def _carry_index(ridx):
    arrays = {f: np.asarray(getattr(ridx, f)) for f in pt_index.ShardedIndex._fields}
    return pt_index.index_from_numpy({**arrays, "packed": ridx.packed}, device="cpu")


def _carry_delta(rdelta):
    arrays = {f: np.asarray(getattr(rdelta, f)) for f in pt_delta.ShardedDelta._fields}
    return pt_delta.delta_from_numpy({**arrays, "packed": rdelta.packed},
                                     device="cpu")


def _writer(corpus, meta, ns=1, seed=7):
    """A packed reference writer with deletes, updates and inserts, some of
    them into the hottest lists."""
    rng = np.random.default_rng(seed)
    w = ref_delta.DeltaWriter(corpus, meta, ns, term_capacity=256,
                              doc_headroom=1024, codec="packed")
    w.delete_docs([int(d) for d in rng.choice(corpus.n_docs, 40, replace=False)])
    w.update_docs([(int(d), np.unique(rng.integers(0, 40, size=12)),
                    int(rng.integers(20)))
                   for d in rng.choice(np.arange(100, 3000), 30, replace=False)])
    w.insert_docs([(np.unique(rng.integers(0, 40, size=15)), int(rng.integers(20)))
                   for _ in range(60)])
    return w


@pytest.fixture(scope="module")
def setup():
    corpus = ref_corpus.generate_corpus(ref_corpus.CorpusConfig(**CFG))
    ridx, meta = ref_index.build_index(corpus, codec="packed")
    pidx = _carry_index(ridx)
    assert int(pidx.lengths.max()) > 3000
    w = _writer(corpus, meta)
    (rdelta,) = w.shard_deltas()
    return dict(corpus=corpus, ridx=ridx, pidx=pidx, meta=meta, writer=w,
                rdelta=rdelta, pdelta=_carry_delta(rdelta))


def _assert_result(got, want, ctx=""):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]),
                                  err_msg=f"docids {ctx}")
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]),
                                  err_msg=f"n_hits {ctx}")


def _same(a, b) -> bool:
    return all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(a, b))


@pytest.mark.parametrize("window", [1024, 3000])
@pytest.mark.parametrize("codec", ["raw", "packed"])
@pytest.mark.parametrize("mor", [False, True], ids=["static", "mor"])
@pytest.mark.parametrize("strategy", ["embed", "gather", "site_term"])
def test_staged_matches_reference(setup, strategy, mor, codec, window):
    rqb = ref_engine.make_query_batch(QUERIES, t_max=4, meta=setup["meta"],
                                      strategy=strategy)
    pqb = pt_engine.make_query_batch(QUERIES, t_max=4, meta=setup["meta"],
                                     strategy=strategy, device="cpu")
    kw = dict(k=K, window=window, attr_strategy=strategy, codec=codec)
    rdelta = setup["rdelta"] if mor else None
    staged = ref_engine.query_topk(setup["ridx"], rqb, delta=rdelta,
                                   backend="pallas_staged", interpret=True, **kw)
    jnp_path = ref_engine.query_topk(setup["ridx"], rqb, delta=rdelta,
                                     backend="jnp", **kw)
    launches = pi.batched_block_skip_join_cuda.launches
    got = pt_engine.query_topk(setup["pidx"], pqb,
                               delta=setup["pdelta"] if mor else None,
                               backend="kernel_staged", **kw)
    assert pi.batched_block_skip_join_cuda.launches == launches  # CPU: plain
    _assert_result(got, staged, "vs the reference's staged path")
    # the two reference paths agree on the static index
    if not mor:
        _assert_result(got, jnp_path, "vs the reference's jnp path")
    assert int(np.asarray(staged[1]).sum()) > 0


def test_staged_differs_from_jnp_only_past_the_window(setup):
    """Under merge-on-read the reference's staged path and its jnp path
    agree while the window covers every merged list, and the port's staged
    path follows the staged one where they do not: a new page holding a
    rare term and the hottest one is in the hottest term's delta slab (jnp)
    but past its first 256 merged postings (staged)."""
    meta = setup["meta"]
    w = _writer(setup["corpus"], meta)
    w.insert_docs([(np.array([0, 450]), 1)])
    (rdelta,) = w.shard_deltas()
    pdelta = _carry_delta(rdelta)
    queries = QUERIES + [([450, 0], None)]
    rqb = ref_engine.make_query_batch(queries, t_max=4, meta=meta)
    pqb = pt_engine.make_query_batch(queries, t_max=4, meta=meta, device="cpu")
    longest = int(np.max(np.asarray(setup["ridx"].lengths)
                         + np.asarray(rdelta.lengths)))
    outcomes = {}
    for window in (256, longest + 1):
        staged = ref_engine.query_topk(setup["ridx"], rqb, delta=rdelta, k=K,
                                       window=window, backend="pallas_staged",
                                       interpret=True)
        jnp_path = ref_engine.query_topk(setup["ridx"], rqb, delta=rdelta, k=K,
                                         window=window, backend="jnp")
        got = pt_engine.query_topk(setup["pidx"], pqb, delta=pdelta, k=K,
                                   window=window, backend="kernel_staged")
        _assert_result(got, staged, window)
        outcomes[window] = _same(staged, jnp_path)
    assert outcomes == {256: False, longest + 1: True}


@pytest.mark.parametrize("mor", [False, True], ids=["static", "mor"])
def test_sequential_reference_ns2(setup, mor):
    ns, window = 2, 1024
    corpus, meta = setup["corpus"], setup["meta"]
    rsh, _ = ref_index.build_sharded_index(corpus, ns)
    shards = [ref_index.InvertedIndex(*(x[s] for x in rsh)) for s in range(ns)]
    w = _writer(corpus, meta, ns=ns) if mor else None
    rqb = ref_engine.make_query_batch(QUERIES, t_max=4, meta=meta)
    pqb = pt_engine.make_query_batch(QUERIES, t_max=4, meta=meta, device="cpu")
    want = ref_parallel.sequential_reference(
        shards, rqb, ns=ns, k=K, window=window,
        deltas=None if w is None else w.shard_deltas(),
        backend="pallas_staged", interpret=True)
    psh = [_carry_index(s) for s in shards]
    pdeltas = None if w is None else [_carry_delta(d) for d in w.shard_deltas()]
    got = pt_parallel.sequential_reference(psh, pqb, ns=ns, k=K, window=window,
                                           deltas=pdeltas, backend="kernel_staged")
    _assert_result(got, want, "sequential")
    sharded = pt_index.sharded_index_from_numpy(
        {f: np.asarray(getattr(rsh, f)) for f in pt_index.ShardedIndex._fields},
        device="cpu")
    pdelta = None if w is None else pt_delta.sharded_delta_from_numpy(
        {f: np.asarray(v) for f, v in w.device_delta()._asdict().items()},
        device="cpu")
    for merge in ("tournament", "allgather"):
        dist = pt_parallel.distributed_query_topk(
            sharded, pqb, pdelta, ns=ns, k=K, window=window, merge=merge,
            backend="kernel_staged")
        _assert_result(dist, want, merge)


def test_updatable_service_staged(setup):
    """The same mutations through the port's staged service, the reference's
    staged service and the port's torch service (a corpus whose lists fit
    the window, so the three agree): equal hits before and after each half
    of the stream and after ``compact(verify=True)``."""
    cfg = dict(n_docs=400, vocab_size=150, mean_doc_len=25, n_sites=10, seed=13)
    rcorpus = ref_corpus.generate_corpus(ref_corpus.CorpusConfig(**cfg))
    pcorpus = pt_corpus.generate_corpus(pt_corpus.CorpusConfig(**cfg))
    rsh, meta = ref_index.build_sharded_index(rcorpus, 1)
    psh, pmeta = pt_index.build_sharded_index(pcorpus, 1, device="cpu")
    mcfg = dict(n_ops=60, p_insert=0.45, p_delete=0.25, p_update=0.3,
                mean_doc_len=25, seed=21)
    rmuts = ref_corpus.generate_mutations(rcorpus, ref_corpus.MutationConfig(**mcfg))
    pmuts = pt_corpus.generate_mutations(pcorpus, pt_corpus.MutationConfig(**mcfg))
    kw = dict(ns=1, k=10, window=1024, t_max=4, batch_size=4, strategy="gather",
              term_capacity=256, doc_headroom=128, updatable=True)
    ref = RefService(rsh, meta, jax.make_mesh((1,), ("data",)),
                     backend="pallas_staged", interpret=True, corpus=rcorpus, **kw)
    port = SearchService(psh, pmeta, device="cpu", backend="kernel_staged",
                         corpus=pcorpus, **kw)
    plain = SearchService(psh, pmeta, device="cpu", backend="torch",
                          corpus=pcorpus, **kw)
    stream = [([3], None), ([3, 9], None), ([1, 4, 12], None), ([2], 3),
              ([5, 8], 1), ([140], None), ([0, 7], 5), ([3, 9, 23], 2)]
    for half in (slice(0, 30), slice(30, 60)):
        for svc, muts in ((ref, rmuts), (port, pmuts), (plain, pmuts)):
            for m in muts[half]:
                if m.op == "insert":
                    svc.insert([(m.terms, m.site)])
                elif m.op == "delete":
                    svc.delete([m.docid])
                else:
                    svc.update([(m.docid, m.terms, m.site)])
        want = [(h.docids, h.n_hits) for h in ref.search(stream)]
        assert [(h.docids, h.n_hits) for h in port.search(stream)] == want
        assert [(h.docids, h.n_hits) for h in plain.search(stream)] == want
    assert sum(n for _, n in want) > 0
    ref.compact(verify=True)
    port.compact(verify=True)
    assert [(h.docids, h.n_hits) for h in port.search(stream)] == want
    assert port.backend == "kernel_staged" and port.stats()["n_batches"] > 0


def test_live_q_refused_on_the_staged_backend(setup):
    pqb = pt_engine.make_query_batch(QUERIES, t_max=4, meta=setup["meta"],
                                     device="cpu")
    with pytest.raises(ValueError, match="live_q"):
        pt_engine.query_topk(setup["pidx"], pqb, backend="kernel_staged",
                             live_q=np.ones(len(QUERIES), bool))
    assert "kernel_staged" in pt_engine.BACKENDS
