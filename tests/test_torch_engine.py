"""The port's slave engine against the JAX package's ``query_topk(backend=
"jnp")``, on an index carried over with ``index_from_numpy``.

Both port backends run: ``"torch"`` (plain ops) and ``"kernel"`` (the K1
path, which on CPU tensors runs K1's plain version).  Integer outputs:
exact equality."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import engine as ref_engine
from repro.core import index as ref_index
from repro.data import corpus as ref_corpus
from repro_torch.core import engine as pt_engine
from repro_torch.core import index as pt_index
from repro_torch.data import corpus as pt_corpus

INV = int(pt_index.INVALID_DOC)
WINDOWS = [128, 1000, 1024, 1536, 2048]
KS = [1, 5, 10]
QUERIES = [
    ([7], None),            # single keyword
    ([3, 9], None),         # two-keyword join
    ([1, 4, 12], None),     # three-keyword join
    ([2], 3),               # limited search, single keyword
    ([5, 8], 1),            # limited search, join
    ([240], None),          # rare keyword (short posting list)
    ([0, 1, 2, 3], None),   # four long lists
    ([0, 6], 0),            # limited join on the largest site
]
CFG = dict(n_docs=2500, vocab_size=250, mean_doc_len=30, n_sites=12, seed=11)


def _carry(ridx):
    return pt_index.index_from_numpy(
        {f: np.asarray(v) for f, v in ridx._asdict().items() if v is not None},
        device="cpu")


@pytest.fixture(scope="module")
def setup():
    corpus = ref_corpus.generate_corpus(ref_corpus.CorpusConfig(**CFG))
    ridx, meta = ref_index.build_index(corpus)
    return corpus, ridx, _carry(ridx), meta


def _both(ridx, pidx, meta, queries, *, strategy, k, window):
    rqb = ref_engine.make_query_batch(queries, t_max=4, meta=meta, strategy=strategy)
    pqb = pt_engine.make_query_batch(queries, t_max=4, meta=meta,
                                     strategy=strategy, device="cpu")
    for f in pt_engine.QueryBatch._fields:
        np.testing.assert_array_equal(np.asarray(getattr(rqb, f)),
                                      getattr(pqb, f).numpy())
    want = ref_engine.query_topk(ridx, rqb, k=k, window=window,
                                 attr_strategy=strategy, backend="jnp")
    want = tuple(np.asarray(x) for x in want)
    for backend in pt_engine.BACKENDS:
        got = pt_engine.query_topk(pidx, pqb, k=k, window=window,
                                   attr_strategy=strategy, backend=backend)
        assert got[0].dtype == got[1].dtype == torch.int32
        np.testing.assert_array_equal(got[0].numpy(), want[0], err_msg=backend)
        np.testing.assert_array_equal(got[1].numpy(), want[1], err_msg=backend)
    return want


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("strategy", ["embed", "gather", "site_term"])
def test_query_topk_matches_reference(setup, strategy, window):
    _, ridx, pidx, meta = setup
    for k in KS:
        docs, hits = _both(ridx, pidx, meta, QUERIES, strategy=strategy,
                           k=k, window=window)
        assert hits.sum() > 0


def test_driver_is_first_shortest_slot():
    """Equal-length lists: the driver is the FIRST shortest active slot, as
    with jnp.argmin; the joined result must not depend on which of the two
    tied lists drives, but the slot choice is checked directly too."""
    assert int(torch.argmin(torch.tensor([3, 1, 1, 2], dtype=torch.int32))) == 1
    docs = [np.array(d, np.int32) for d in
            ([0, 1, 3], [0, 3], [1, 3], [0, 1, 3], [2, 3], [2, 3])]
    corpus = ref_corpus.corpus_from_docs(docs, [0, 1, 0, 1, 0, 1],
                                         vocab_size=4, n_sites=2)
    ridx, meta = ref_index.build_index(corpus, include_site_terms=False)
    pidx = _carry(ridx)
    # term 0 -> docs {0, 1, 3}, term 1 -> {0, 2, 3}: lists 0 and 1 tie at
    # length 3; term 2 -> {4, 5}; term 3 -> every doc
    queries = [([0, 1], None), ([1, 0], None), ([3, 0, 1], None),
               ([3, 1, 0], 1), ([0, 2], None)]
    for strategy in ("embed", "gather"):
        _both(ridx, pidx, meta, queries, strategy=strategy, k=3, window=128)
    terms = torch.tensor([[0, 1, -1, -1], [1, 0, -1, -1], [3, 0, 1, -1]],
                         dtype=torch.int32)
    n_terms = torch.tensor([2, 2, 3], dtype=torch.int32)
    slot = pt_engine.StaticPostingSource(pidx).driver_slot(terms, n_terms)
    ref_src = ref_engine.StaticPostingSource(ridx)
    want = [int(ref_src.driver_slot(jnp.asarray(t.numpy()), int(n)))
            for t, n in zip(terms, n_terms)]
    assert slot.tolist() == want == [0, 0, 1]


@pytest.mark.parametrize("window", [1024, 256])
def test_empty_lists_and_all_pad_tiles(window):
    corpus = ref_corpus.Corpus(
        doc_offsets=np.array([0, 2, 4], np.int64),
        doc_terms=np.array([0, 1, 0, 2], np.int32),
        doc_site=np.array([0, 1], np.int32),
        n_docs=2, vocab_size=8, n_sites=2)
    ridx, meta = ref_index.build_index(corpus, include_site_terms=False)
    queries = [([5], None), ([0, 5], None), ([0], None), ([0, 2], None)]
    _, hits = _both(ridx, _carry(ridx), meta, queries, strategy="embed", k=5,
                    window=window)
    assert list(hits) == [0, 0, 2, 1]


def test_driver_stream_at_array_edge():
    """A driver list starting inside the flat array's final partial tile
    returns its own documents, not a neighbour's."""
    docs = [np.array([i // 3], np.int32) for i in range(36)]
    corpus = ref_corpus.corpus_from_docs(docs, [i % 4 for i in range(36)],
                                         vocab_size=12, n_sites=4)
    ridx, meta = ref_index.build_index(corpus, include_site_terms=False)
    queries = [([t], None) for t in range(12)]
    want_docs, _ = _both(ridx, _carry(ridx), meta, queries, strategy="embed",
                         k=10, window=1024)
    for t in range(12):
        got = [int(d) for d in want_docs[t] if d != INV]
        assert got == [d for d in range(36) if d // 3 == t]


def test_single_keyword_topk(setup):
    _, ridx, pidx, _ = setup
    terms = np.array([7, 3, 240, 0, 249], dtype=np.int32)
    for k in (1, 10, 300):
        want = ref_engine.single_keyword_topk(ridx, jnp.asarray(terms), k=k)
        got = pt_engine.single_keyword_topk(pidx, torch.from_numpy(terms), k=k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_brute_force_where_window_covers_lists(setup):
    """With a window longer than every list the engine is exact, so both
    port backends equal the port's (and the reference's) brute force."""
    corpus, ridx, pidx, meta = setup
    window = 4096
    assert int(np.asarray(ridx.lengths).max()) <= window
    port_corpus = pt_corpus.Corpus(
        corpus.doc_offsets, corpus.doc_terms, corpus.doc_site,
        corpus.n_docs, corpus.vocab_size, corpus.n_sites)
    truth = pt_engine.brute_force_topk(port_corpus, QUERIES, 10)
    assert truth == ref_engine.brute_force_topk(corpus, QUERIES, 10)
    qb = pt_engine.make_query_batch(QUERIES, t_max=4, meta=meta, device="cpu")
    for backend in pt_engine.BACKENDS:
        docs, _ = pt_engine.query_topk(pidx, qb, k=10, window=window,
                                       backend=backend)
        got = [[int(d) for d in row if d != INV] for row in docs.numpy()]
        assert got == truth, backend


def test_unknown_backend_and_strategy_rejected(setup):
    _, _, pidx, meta = setup
    qb = pt_engine.make_query_batch(QUERIES, t_max=4, meta=meta, device="cpu")
    with pytest.raises(ValueError, match="backend"):
        pt_engine.query_topk(pidx, qb, backend="jnp")
    with pytest.raises(ValueError, match="attr_strategy"):
        pt_engine.query_topk(pidx, qb, attr_strategy="nope")


def test_make_query_batch_default_device_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt_engine.make_query_batch(QUERIES, t_max=4)
