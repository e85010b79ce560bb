"""The reference against brute force where the window covers the lists,
and against the port's served hits through the whole harness (CPU, small
cells)."""
import pytest
from conftest import CELLS, run_small

from odys_bench import data, reference


def _brute(docs, sites, terms, site, k):
    hit = [d for d, ts in enumerate(docs)
           if set(terms) <= set(ts) and (site is None or sites[d] == site)]
    return hit[:k], len(hit)


@pytest.fixture(scope="module")
def small():
    cfg = dict(n_docs=3000, vocab_size=300, mean_doc_len=20, term_zipf_s=1.1,
               n_sites=20, site_zipf_s=1.2)
    c = data.make_corpus(cfg, 21, "cpu")
    mix = {"mix": [["single", 10, 0.3], ["multiple", 50, 0.4], ["limited", 5, 0.3]],
           "max_terms": 3, "term_zipf_s": 1.1}
    q = data.make_queries(mix, cfg, 21, 300)
    return cfg, c, q


def test_reference_equals_brute_force_when_the_window_covers(small):
    cfg, c, q = small
    docs = [c.doc_terms[c.doc_offsets[d]:c.doc_offsets[d + 1]].tolist()
            for d in range(c.n_docs)]
    queries = [(*q.query(i), 0) for i in range(len(q))]
    main = reference.MainLists(c, 4, c.n_docs, [t for x in queries for t in x[0]])
    got = reference.answers(main, c, queries)
    for (terms, site, k, _), (ids, n) in zip(queries, got):
        assert (ids, n) == _brute(docs, c.doc_site, terms, site, k)


def test_reference_under_mutations_equals_a_rebuild(small):
    cfg, c, q = small
    upd = {"p_insert": 0.4, "p_delete": 0.3, "p_update": 0.3, "mean_doc_len": 20,
           "term_zipf_s": 1.1, "site_zipf_s": 1.2, "p_site_change": 0.5}
    muts = data.make_mutations(upd, c, 4, 400)
    docs = [c.doc_terms[c.doc_offsets[d]:c.doc_offsets[d + 1]].tolist()
            for d in range(c.n_docs)]
    sites = c.doc_site.tolist()
    at = [0, 150, 400]
    queries = [(*q.query(i), at[i % 3]) for i in range(len(q))]
    main = reference.MainLists(c, 4, c.n_docs, [t for x in queries for t in x[0]])
    got = reference.answers(main, c, queries, muts)
    applied = 0
    for m_at in at:
        while applied < m_at:
            m = muts[applied]
            if m.op == data.INSERT:
                docs.append(m.terms.tolist())
                sites.append(m.site)
            elif m.op == data.DELETE:
                docs[m.gid] = []
            else:
                docs[m.gid] = m.terms.tolist()
                sites[m.gid] = sites[m.gid] if m.site < 0 else m.site
            applied += 1
        for (terms, site, k, qm), ans in zip(queries, got):
            if qm == m_at:
                assert ans == _brute(docs, sites, terms, site, k)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_served_hits_equal_the_reference(cell):
    res = run_small(cell, 2**31 + 11)
    assert res["correct"], res["compared"]
    n_win, n_rb = res["checked"]
    assert n_win == min(res["answered"], 256) and n_win >= 64 and res["failed"] == 0
    if "mor" in cell:
        assert n_rb >= 100 and res["fill"][1] > res["fill"][0]


def test_a_traced_run_reads_the_host_layers():
    res = run_small("mor-4x1M.paper-mix-ingest", 2**31 + 12, seconds=2.5, trace=True)
    assert res["correct"]
    got = {k: v for k, (v, _) in res["metrics"].items()}
    for name in ("pad_share", "finalize_ms", "dispatch_ms", "publish_ms",
                 "response_ms_p95"):
        assert got[name] is not None and got[name] >= 0, name
    # no card: the device's readings are left out, never 0
    for name in ("device_ops_per_batch", "join_roofline_pct", "device_idle_pct"):
        assert got[name] is None
