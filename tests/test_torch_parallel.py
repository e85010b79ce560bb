"""The port's distributed query path (ns slaves stacked on one device)
against the JAX package's ``sequential_reference(backend="jnp")``, which
needs no mesh.  Both merges, both port backends.  Exact equality."""
import numpy as np
import pytest
import torch

from repro.core import engine as ref_engine
from repro.core import index as ref_index
from repro.core import parallel as ref_parallel
from repro.data import corpus as ref_corpus
from repro_torch.core import engine as pt_engine
from repro_torch.core import index as pt_index
from repro_torch.core import parallel as pt_parallel

CFG = dict(n_docs=1200, vocab_size=250, mean_doc_len=30, n_sites=12, seed=11)
QUERIES = [
    ([7], None), ([3, 9], None), ([1, 4, 12], None), ([2], 3),
    ([5, 8], 1), ([240], None), ([0, 1], None), ([0], 0),
]


@pytest.fixture(scope="module", params=[2, 4])
def setup(request):
    ns = request.param
    corpus = ref_corpus.generate_corpus(ref_corpus.CorpusConfig(**CFG))
    rsh, meta = ref_index.build_sharded_index(corpus, ns)
    shards = [ref_index.InvertedIndex(*(x[s] for x in rsh)) for s in range(ns)]
    psh = pt_index.sharded_index_from_numpy(
        {f: np.asarray(v) for f, v in rsh._asdict().items()}, device="cpu")
    return ns, shards, psh, meta


def _batches(meta, strategy):
    return (ref_engine.make_query_batch(QUERIES, t_max=4, meta=meta,
                                        strategy=strategy),
            pt_engine.make_query_batch(QUERIES, t_max=4, meta=meta,
                                       strategy=strategy, device="cpu"))


@pytest.mark.parametrize("backend", ["torch", "kernel"])
@pytest.mark.parametrize("merge", ["tournament", "allgather"])
@pytest.mark.parametrize("strategy", ["embed", "gather", "site_term"])
def test_distributed_matches_sequential_reference(setup, strategy, merge, backend):
    ns, shards, psh, meta = setup
    rqb, pqb = _batches(meta, strategy)
    for k, window in ((5, 1024), (10, 1000), (50, 2048)):
        want = ref_parallel.sequential_reference(
            shards, rqb, ns=ns, k=k, window=window, attr_strategy=strategy,
            backend="jnp")
        got = pt_parallel.distributed_query_topk(
            psh, pqb, ns=ns, k=k, window=window, attr_strategy=strategy,
            merge=merge, backend=backend)
        np.testing.assert_array_equal(got.docids.numpy(), np.asarray(want.docids))
        np.testing.assert_array_equal(got.n_hits.numpy(), np.asarray(want.n_hits))
        assert got.docids.dtype == got.n_hits.dtype == torch.int32
        port_ref = pt_parallel.sequential_reference(
            [psh.shard(s) for s in range(ns)], pqb, ns=ns, k=k, window=window,
            attr_strategy=strategy)
        assert torch.equal(port_ref.docids, got.docids)
        assert torch.equal(port_ref.n_hits, got.n_hits)


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_slave_topk_unmerged(setup, backend):
    ns, shards, psh, meta = setup
    rqb, pqb = _batches(meta, "embed")
    got = pt_parallel.slave_topk_unmerged(psh, pqb, ns=ns, k=10, window=1024,
                                          backend=backend)
    assert got.docids.shape == (ns, len(QUERIES), 10)
    for s, idx in enumerate(shards):
        docs, hits = ref_engine.query_topk(idx, rqb, k=10, window=1024,
                                           backend="jnp")
        want = ref_index.local_to_global_docids(docs, np.int32(s), ns)
        np.testing.assert_array_equal(got.docids[s].numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.n_hits[s].numpy(), np.asarray(hits))


def test_tournament_needs_power_of_two_and_allgather_takes_three():
    corpus = ref_corpus.generate_corpus(ref_corpus.CorpusConfig(**CFG))
    rsh, meta = ref_index.build_sharded_index(corpus, 3)
    shards = [ref_index.InvertedIndex(*(x[s] for x in rsh)) for s in range(3)]
    psh = pt_index.sharded_index_from_numpy(
        {f: np.asarray(v) for f, v in rsh._asdict().items()}, device="cpu")
    rqb, pqb = _batches(meta, "embed")
    with pytest.raises(ValueError, match="power-of-two"):
        pt_parallel.distributed_query_topk(psh, pqb, ns=3, merge="tournament")
    want = ref_parallel.sequential_reference(shards, rqb, ns=3, k=10, window=1024)
    got = pt_parallel.distributed_query_topk(psh, pqb, ns=3, k=10, window=1024,
                                             merge="allgather")
    np.testing.assert_array_equal(got.docids.numpy(), np.asarray(want.docids))
    np.testing.assert_array_equal(got.n_hits.numpy(), np.asarray(want.n_hits))
