"""The port's host spans (``repro_torch.obs.trace.host_span``) on the CPU:
the phases a timed batch carries, the ``record_function`` events a
profiled batch leaves in the trace, and the untraced path, which never
builds a span."""
import json

import pytest
import torch

from repro_torch.core.index import build_sharded_index
from repro_torch.data.corpus import CorpusConfig, generate_corpus
from repro_torch.obs import trace
from repro_torch.obs.registry import MetricsRegistry, NullRegistry
from repro_torch.serving.search import SearchService

BATCH = 6
#: The host phases the spans add to each batch's spans.
SPAN_PHASES = ("form", "batch_build", "slave_launch", "merge_launch", "complete", "admit")


@pytest.fixture(scope="module")
def shards():
    corpus = generate_corpus(CorpusConfig(n_docs=1200, vocab_size=120, mean_doc_len=25,
                                          n_sites=8, seed=21))
    return {ns: build_sharded_index(corpus, ns, device="cpu") for ns in (1, 4)}


def _queries(n: int, shift: int = 0) -> list:
    return [([(3 * i + shift) % 60, (7 * i + shift) % 90 + 1], None if i % 3 else i % 8)
            for i in range(n)]


def _service(shards, ns, registry, merge="tournament", span_sink=None):
    index, meta = shards[ns]
    return SearchService(index, meta, ns=ns, k=10, window=256, t_max=4,
                         batch_size=BATCH, cache_size=0, merge=merge, device="cpu",
                         registry=registry, span_sink=span_sink)


def _hits(hits) -> list:
    return [(h.docids, h.n_hits) for h in hits]


@pytest.mark.parametrize("merge", ["tournament", "allgather"])
@pytest.mark.parametrize("ns", [1, 4])
def test_a_timed_batch_carries_the_span_phases(shards, ns, merge):
    spans = []
    svc = _service(shards, ns, MetricsRegistry(), merge, spans.append)
    assert svc.scheduler.trace
    svc.search(_queries(3 * BATCH))
    first = {}
    for s in spans:
        first.setdefault(s.batch_id, s)
    assert sorted(first) == [0, 1, 2]
    for s in first.values():
        p = s.phases
        for phase in SPAN_PHASES + ("slave_dispatch", "master_merge", "finalize"):
            assert p[phase] >= 0, phase
        assert p["batch_build"] + p["slave_launch"] + p["merge_launch"] <= p["slave_dispatch"]
    # batch-level phases reach every query of the batch; ``admit`` is each query's own
    by_batch = [[s for s in spans if s.batch_id == b] for b in range(3)]
    for members in by_batch:
        assert len(members) == BATCH
        assert len({(m.phases["form"], m.phases["complete"]) for m in members}) == 1
    # the new phases stay out of the exposition's phase series
    assert not set(SPAN_PHASES) & set(trace.PHASES)


@pytest.mark.parametrize("timed", [False, True])
@pytest.mark.parametrize("ns", [1, 4])
def test_a_profiled_batch_leaves_its_spans_in_order(shards, tmp_path, ns, timed):
    svc = _service(shards, ns, MetricsRegistry() if timed else NullRegistry())
    svc.search(_queries(BATCH))        # the shapes once, outside the profile
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        svc.search(_queries(2 * BATCH, shift=5))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    odys = sorted((e for e in events if e.get("ph") == "X" and e["name"].startswith("odys.")),
                  key=lambda e: float(e["ts"]))
    one = (["odys.form", "odys.batch_build"] + ["odys.slave"] * ns
           + ["odys.merge", "odys.device_wait", "odys.finalize", "odys.complete"]
           + ["odys.spans"] * timed)   # a timed batch closes its spans last
    assert [e["name"] for e in odys] == 2 * one
    assert {e["cat"] for e in odys} == {"user_annotation"}
    for a, b in zip(odys, odys[1:]):
        assert float(a["ts"]) + float(a["dur"]) <= float(b["ts"]), (a["name"], b["name"])


def test_the_untraced_path_never_builds_a_span(shards, monkeypatch):
    queries = _queries(2 * BATCH)
    traced = _service(shards, 4, MetricsRegistry())
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        want = _hits(traced.search(queries))

    def refuse(*a, **kw):
        raise AssertionError("record_function built on the untraced path")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    svc = _service(shards, 4, NullRegistry())
    assert not svc.scheduler.trace
    tickets = [svc.submit(t, s) for t, s in queries]
    svc.drain()
    assert _hits(t.result for t in tickets) == want
    assert all(t.span is None for t in tickets)
    assert trace.host_span("odys.x", "x", None) is trace.batch_span("odys.y", "y")


def test_a_span_admitted_traced_finishes_in_an_untraced_batch(shards):
    spans = []
    svc = _service(shards, 1, MetricsRegistry(), span_sink=spans.append)
    tickets = [svc.submit(t, s) for t, s in _queries(BATCH)]
    svc.scheduler.trace = False
    svc.drain()
    assert all(t.done for t in tickets) and len(spans) == BATCH
    for s in spans:
        assert "admit" in s.phases and "form" not in s.phases and "complete" not in s.phases


def test_the_batch_collector_closes_when_the_batch_fails(shards, monkeypatch):
    import repro_torch.serving.search as search_mod

    svc = _service(shards, 1, MetricsRegistry())

    def broken(*a, **kw):
        raise RuntimeError("no batch")

    monkeypatch.setattr(search_mod, "distributed_query_topk", broken)
    with pytest.raises(RuntimeError, match="no batch"):
        svc.search(_queries(BATCH))
    assert trace._open.phases is None
