"""The port's serving layer: ``SearchService(device="cpu")`` against the JAX
package's ``SearchService`` (ns=1 on a one-device mesh, ``backend="jnp"``)
on the same query stream — hits, batch counts, cache hits and
``pad_fraction`` identical — plus the ``form_batch``, LRU, router and
failure cases of the scheduler copy."""
import types

import numpy as np
import pytest
import torch

import jax

from repro.core import index as ref_index
from repro.data import corpus as ref_corpus
from repro.serving.search import SearchService as RefService
from repro_torch.core import index as pt_index
from repro_torch.core.engine import make_query_batch
from repro_torch.core.faults import SetHealth
from repro_torch.core.parallel import SearchResult, distributed_query_topk
from repro_torch.core.perfmodel import QUERY_MIX_DEFAULT
from repro_torch.core.perfmodel import sojourn as pt_sojourn
from repro_torch.core.queries import WorkloadConfig, generate_workload
from repro_torch.data import corpus as pt_corpus
from repro_torch.serving.router import HealthAwareRouter
from repro_torch.serving.scheduler import MasterScheduler, MultiSetRouter, form_batch
from repro_torch.serving.search import SearchService

CFG = dict(n_docs=400, vocab_size=150, mean_doc_len=25, n_sites=10, seed=13)
QUERIES = [
    ([3], None), ([3, 9], None), ([1, 4, 12], None), ([2], 3),
    ([5, 8], 1), ([140], None), ([0, 7], 5),
]


@pytest.fixture(scope="module")
def setup():
    rsh, meta = ref_index.build_sharded_index(
        ref_corpus.generate_corpus(ref_corpus.CorpusConfig(**CFG)), 1)
    psh, pmeta = pt_index.build_sharded_index(
        pt_corpus.generate_corpus(pt_corpus.CorpusConfig(**CFG)), 1, device="cpu")
    assert pmeta == pt_index.IndexMeta(**vars(meta))
    return rsh, meta, psh, pmeta


def _stream():
    """QUERIES, then a workload from the port's generator, with repeats."""
    meta = pt_index.IndexMeta(n_docs=400, vocab_size=150, n_sites=10,
                              n_terms=160, include_site_terms=True)
    specs = generate_workload(meta, QUERY_MIX_DEFAULT,
                              WorkloadConfig(n_queries=24, seed=3))
    work = [(list(s.terms), s.site) for s in specs]
    return QUERIES + work + QUERIES[:4] + work[:6]


@pytest.mark.parametrize("strategy", ["embed", "gather", "site_term"])
@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_service_matches_reference_service(setup, strategy, backend):
    rsh, meta, psh, pmeta = setup
    kw = dict(ns=1, k=10, window=1024, t_max=4, strategy=strategy,
              batch_size=5, t_max_buckets=(2, 4), cache_size=64)
    ref = RefService(rsh, meta, jax.make_mesh((1,), ("data",)),
                     backend="jnp", **kw)
    port = SearchService(psh, pmeta, device="cpu", backend=backend, **kw)
    stream = _stream()
    # two passes: the second is all cache hits
    for _ in range(2):
        want = ref.search(stream)
        got = port.search(stream)
        assert [(h.docids, h.n_hits) for h in got] == [
            (h.docids, h.n_hits) for h in want]
    rs, ps = ref.stats(), port.stats()
    for key in ("n_batches", "n_padded", "n_short_circuited", "pad_fraction",
                "pending", "cache", "cache_entries"):
        assert ps[key] == rs[key], key
    counts = ("sid", "in_flight", "n_batches", "n_queries")  # not clock stamps
    assert [{c: st[c] for c in counts} for st in ps["sets"]] == [
        {c: st[c] for c in counts} for st in rs["sets"]]
    assert ps["cache"]["hits"] > 0 and ps["pad_fraction"] > 0


def test_submit_drain_and_search_batch(setup):
    _, _, psh, pmeta = setup
    svc = SearchService(psh, pmeta, ns=1, device="cpu", window=1024,
                        batch_size=4)
    tickets = [svc.submit(t, s) for t, s in QUERIES]
    assert svc.scheduler.pending() == len(QUERIES)
    svc.drain()
    assert all(t.done for t in tickets) and svc.scheduler.pending() == 0
    res = SearchService(psh, pmeta, ns=1, device="cpu", window=1024,
                        batch_size=len(QUERIES)).search_batch(QUERIES)
    inv = int(pt_index.INVALID_DOC)
    for t, row, h in zip(tickets, res.docids.numpy(), res.n_hits.numpy()):
        assert t.result.docids == [int(d) for d in row if d != inv]
        assert t.result.n_hits == int(h)


def _result_block(k: int, contiguous: bool):
    """A synthetic ``SearchResult`` of rows full, partly filled and empty:
    ascending docIDs up to ``INVALID_DOC - 1``, ``INVALID_DOC`` after
    them, ``n_hits`` at or above each row's fill."""
    rng = np.random.default_rng(k)
    inv = int(pt_index.INVALID_DOC)
    fills = [k, k // 2, 0, 1, k - 1, k, 0]
    docs = np.full((len(fills), k + 3), inv, dtype=np.int32)
    hits = np.zeros(len(fills), dtype=np.int32)
    for i, c in enumerate(fills):
        docs[i, :c] = np.sort(rng.choice(inv, c, replace=False))
        hits[i] = c + (rng.integers(0, 5 * k) if c == k else 0)
    docs[0, k - 1] = inv - 1  # the largest docID still counts
    wide = torch.from_numpy(docs)
    # the plain merge returns a slice of its sorted rows, a view
    block = wide[:, :k].contiguous() if contiguous else wide[:, :k]
    return SearchResult(block, torch.from_numpy(hits))


@pytest.mark.parametrize("contiguous", [True, False])
@pytest.mark.parametrize("k", [1, 10, 50, 1000])
def test_execute_extracts_the_per_element_hits(setup, monkeypatch, k, contiguous):
    """``_execute``'s hits against the per-element formula, inline here as
    the oracle: the same docIDs in the same order, as Python ints."""
    _, _, psh, pmeta = setup
    svc = SearchService(psh, pmeta, ns=1, device="cpu", window=1024, k=k)
    res = _result_block(k, contiguous)
    monkeypatch.setattr(svc, "_run_engine", lambda *a, **kw: res)
    got = svc._execute([([3], None)] * len(res.n_hits), 4, k, 0)
    inv = pt_index.INVALID_DOC
    want = [([int(d) for d in row if d != inv], int(h))
            for row, h in zip(res.docids.numpy(), res.n_hits.numpy())]
    assert [(h.docids, h.n_hits) for h in got] == want
    assert {len(h.docids) for h in got} == {0, 1, k // 2, k - 1, k}
    for h in got:
        assert type(h.docids) is list and type(h.n_hits) is int
        assert all(type(d) is int for d in h.docids)


@pytest.mark.parametrize("merge", ["tournament", "allgather"])
@pytest.mark.parametrize("backend", ["torch", "kernel", "kernel_staged"])
def test_result_rows_ascend_with_invalid_suffix(merge, backend):
    """The invariant the service's extraction counts on: every row of
    ``distributed_query_topk``'s docIDs is non-decreasing (rank order), so
    ``INVALID_DOC`` (the largest int32) appears only as a suffix, and the
    valid prefix holds ``min(n_hits, k)`` docIDs."""
    corpus = pt_corpus.generate_corpus(pt_corpus.CorpusConfig(**CFG))
    index, meta = pt_index.build_sharded_index(corpus, 2, device="cpu")
    queries = QUERIES + [([0], None), ([0, 1], None), ([100, 110], 3)]
    batch = make_query_batch(queries, t_max=4, meta=meta, device="cpu")
    inv = int(pt_index.INVALID_DOC)
    fills = set()
    for k in (1, 16, 64):
        res = distributed_query_topk(index, batch, ns=2, k=k, window=1024,
                                     merge=merge, backend=backend)
        docs, hits = res.docids.numpy(), res.n_hits.numpy()
        assert docs.shape == (len(queries), k)
        assert (np.diff(docs.astype(np.int64), axis=1) >= 0).all()
        valid = docs != inv
        assert (valid[:, 1:] <= valid[:, :-1]).all()
        assert valid.sum(1).tolist() == np.minimum(hits, k).tolist()
        fills |= {"empty" if c == 0 else "full" if c == k else "partial"
                  for c in valid.sum(1).tolist()}
    assert fills == {"empty", "partial", "full"}


def test_default_device_service_raises_without_card(setup, monkeypatch):
    _, _, psh, pmeta = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SearchService(psh, pmeta, ns=1)


def test_service_refuses_later_slices(setup):
    _, _, psh, pmeta = setup
    with pytest.raises(ValueError, match="needs the base corpus"):
        SearchService(psh, pmeta, ns=1, device="cpu", updatable=True)
    # health-aware routing has come (tests/test_torch_faults_router.py),
    # and per-set ranks (tests/test_torch_search_sets.py): a slice of
    # another shape than (pod=1, data=ns) raises the reference's ValueError
    svc = SearchService(psh, pmeta, ns=1, device="cpu",
                        set_health=SetHealth.all_alive(1))
    assert isinstance(svc.scheduler.router, HealthAwareRouter)
    wide = types.SimpleNamespace(mesh_dim_names=("pod", "data"),
                                 mesh=torch.zeros((1, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match=r"set mesh must be \(pod=1, data=1\)"):
        SearchService(psh, pmeta, ns=1, device="cpu", set_meshes=[wide])
    with pytest.raises(RuntimeError, match="read-only"):
        SearchService(psh, pmeta, ns=1, device="cpu").delete([0])


def _mutate(svc, muts):
    for m in muts:
        if m.op == "insert":
            svc.insert([(m.terms, m.site)])
        elif m.op == "delete":
            svc.delete([m.docid])
        else:
            svc.update([(m.docid, m.terms, m.site)])


@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_updatable_service_matches_reference_service(setup, backend):
    """The same mutations through both services' write paths: hits equal
    the reference service's before and after ``compact(verify=True)``, and
    equal a service over the rebuilt mutated corpus."""
    rsh, meta, psh, pmeta = setup
    rcorpus = ref_corpus.generate_corpus(ref_corpus.CorpusConfig(**CFG))
    pcorpus = pt_corpus.generate_corpus(pt_corpus.CorpusConfig(**CFG))
    mcfg = dict(n_ops=80, p_insert=0.45, p_delete=0.25, p_update=0.3,
                mean_doc_len=25, seed=21)
    rmuts = ref_corpus.generate_mutations(rcorpus, ref_corpus.MutationConfig(**mcfg))
    pmuts = pt_corpus.generate_mutations(pcorpus, pt_corpus.MutationConfig(**mcfg))
    kw = dict(ns=1, k=10, window=1024, t_max=4, batch_size=4,
              term_capacity=256, doc_headroom=128, updatable=True)
    mesh = jax.make_mesh((1,), ("data",))
    ref = RefService(rsh, meta, mesh, backend="jnp", corpus=rcorpus, **kw)
    port = SearchService(psh, pmeta, device="cpu", backend=backend,
                         corpus=pcorpus, **kw)
    stream = _stream()
    for half in (slice(0, 40), slice(40, 80)):
        _mutate(ref, rmuts[half])
        _mutate(port, pmuts[half])
        assert port.writer.version == ref.writer.version
        want = [(h.docids, h.n_hits) for h in ref.search(stream)]
        assert [(h.docids, h.n_hits) for h in port.search(stream)] == want
    rebuilt, rb_meta = pt_index.build_sharded_index(
        port.writer.mutated_corpus(), 1, device="cpu")
    fresh = SearchService(rebuilt, rb_meta, ns=1, window=1024, device="cpu")
    assert [(h.docids, h.n_hits) for h in fresh.search(stream)] == want
    ref.compact(verify=True)
    port.compact(verify=True)
    for f in pt_index.ShardedIndex._fields:
        assert getattr(port.index, f).numpy().tolist() == \
            jax.device_get(getattr(ref.index, f)).tolist(), f
    assert port.meta == pt_index.IndexMeta(**vars(ref.meta))
    assert [(h.docids, h.n_hits) for h in port.search(stream)] == want
    assert [(h.docids, h.n_hits) for h in ref.search(stream)] == want
    rs, ps = ref.stats(), port.stats()
    for key in ("n_batches", "n_padded", "n_short_circuited", "cache"):
        assert ps[key] == rs[key], key


def test_cached_result_goes_stale_after_a_mutation(setup):
    _, _, psh, pmeta = setup
    pcorpus = pt_corpus.generate_corpus(pt_corpus.CorpusConfig(**CFG))
    svc = SearchService(psh, pmeta, ns=1, window=1024, device="cpu",
                        updatable=True, corpus=pcorpus, cache_size=16)
    q = [([3, 9], None)]
    before = svc.search(q)[0]
    assert svc.search(q)[0] == before
    assert svc.stats()["cache"]["hits"] == 1
    (gid,) = svc.insert([([3, 9], 0)])
    after = svc.search(q)[0]
    cache = svc.stats()["cache"]
    assert cache["stale"] == 1 and cache["hits"] == 1
    assert after.n_hits == before.n_hits + 1   # the new doc is visible
    svc.delete([gid])
    assert svc.search(q)[0] == before and svc.stats()["cache"]["stale"] == 2
    # auto_compact folds a full delta without changing results
    auto = SearchService(psh, pmeta, ns=1, window=1024, device="cpu",
                         updatable=True, corpus=pcorpus, term_capacity=128,
                         auto_compact=0.5)
    for _ in range(70):
        auto.insert([([3], 1)])
    assert auto.writer.generation == 0 and auto.writer.posting_fill() < 0.5
    assert auto.meta.n_docs > pmeta.n_docs
    with pytest.raises(ValueError, match="writer.ns"):
        SearchService(psh, pmeta, ns=1, device="cpu", writer=type(
            "W", (), {"ns": 2, "n_terms": pmeta.n_terms})())


# ---------------------------------------------------------------- scheduler


def test_form_batch_empty_queue_is_noop():
    assert form_batch([], 4, pad=lambda x: x) == []


def test_form_batch_pads_partial_and_pops():
    queue = [1, 2, 3]
    batch = form_batch(queue, 4, pad=lambda first: -first)
    assert batch == [1, 2, 3, -1]
    assert queue == []


def test_form_batch_leaves_excess():
    queue = list(range(10))
    assert form_batch(queue, 4) == [0, 1, 2, 3]
    assert queue == list(range(4, 10))


def test_lru_eviction_and_stats():
    calls = []

    def executor(queries, t_max, k, sid):
        calls.append(len(queries))
        return [sum(t[0]) for t in queries]

    s = MasterScheduler(executor, batch_size=1, t_max_buckets=(4,),
                        cache_size=2)
    for terms in ([1], [2], [3]):   # fills then overflows capacity 2
        s.submit(terms)
        s.drain()
    assert s.cache.stats.evicted == 1
    s.submit([1])                    # evicted -> recomputed
    s.drain()
    assert s.cache.stats.hits == 0
    s.submit([3])                    # still resident -> hit
    assert s.cache.stats.hits == 1
    assert len(calls) == 4


def test_router_prefers_earliest_available():
    r = MultiSetRouter(2)
    a = r.route(4)
    a.busy_until = 10.0
    b = r.route(4)
    assert b.sid != a.sid
    r.complete(a, 4)
    r.complete(b, 4)
    assert [s.in_flight for s in r.sets] == [0, 0]


def test_multi_set_router_spreads_and_accounts(setup):
    _, _, psh, pmeta = setup
    svc = SearchService(psh, pmeta, ns=1, device="cpu", window=1024,
                        batch_size=2, n_sets=2, cache_size=0)
    hits = svc.search([([int(t)], None) for t in range(8)])
    assert all(h is not None for h in hits)
    sets = svc.stats()["sets"]
    assert [s["in_flight"] for s in sets] == [0, 0]
    assert all(s["n_batches"] >= 1 for s in sets)
    assert sum(s["n_queries"] for s in sets) == 8


def test_executor_failure_restores_queue_and_accounting():
    boom = {"armed": True}

    def executor(queries, t_max, k, sid):
        if boom["armed"]:
            raise RuntimeError("slave died")
        return [sum(t[0]) for t in queries]

    s = MasterScheduler(executor, batch_size=2, t_max_buckets=(4,),
                        cache_size=0)
    t1, t2 = s.submit([1]), s.submit([2])
    with pytest.raises(RuntimeError, match="slave died"):
        s.step()
    assert s.pending() == 2
    assert [st.in_flight for st in s.router.sets] == [0]
    boom["armed"] = False
    s.drain()
    assert t1.result == 1 and t2.result == 2


def test_width_too_large_and_termless_rejected(setup):
    _, _, psh, pmeta = setup
    svc = SearchService(psh, pmeta, ns=1, device="cpu", t_max=2,
                        t_max_buckets=(2,))
    with pytest.raises(ValueError, match="exceeds the largest"):
        svc.submit([1, 2, 3])
    with pytest.raises(ValueError, match="at least one term"):
        svc.submit([])


def test_workload_matches_reference():
    from repro.core.perfmodel import QUERY_MIX_DEFAULT as REF_MIX
    from repro.core.perfmodel import sojourn as ref_sojourn
    from repro.core.queries import WorkloadConfig as RefCfg
    from repro.core.queries import generate_workload as ref_generate

    meta = pt_index.IndexMeta(n_docs=400, vocab_size=150, n_sites=10,
                              n_terms=160, include_site_terms=True)
    want = ref_generate(meta, REF_MIX, RefCfg(n_queries=200, seed=5))
    got = generate_workload(meta, QUERY_MIX_DEFAULT, WorkloadConfig(n_queries=200, seed=5))
    assert [vars(s) for s in got] == [vars(s) for s in want]
    assert dict(QUERY_MIX_DEFAULT.qmr) == dict(REF_MIX.qmr)
    # the scheduler's M/D/1 sojourn copy
    for lam in (0.0, 10.0, 50.0, 99.0, 200.0):
        assert pt_sojourn(lam, 0.01) == ref_sojourn(lam, 0.01)
