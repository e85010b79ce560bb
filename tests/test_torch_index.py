"""The port's corpus and index equal the JAX package's, array for array.

Tolerance: exact equality (all integer arrays)."""
import numpy as np
import pytest
import torch

from repro.core import index as ref_index
from repro.data import corpus as ref_corpus
from repro_torch.core import index as pt_index
from repro_torch.data import corpus as pt_corpus

CONFIGS = [
    dict(n_docs=600, vocab_size=250, mean_doc_len=30, n_sites=12, seed=11),
    dict(n_docs=400, vocab_size=150, mean_doc_len=25, n_sites=10, seed=13),
    dict(n_docs=257, vocab_size=40, mean_doc_len=9, n_sites=3, seed=5),
]


def _corpora(cfg):
    return (ref_corpus.generate_corpus(ref_corpus.CorpusConfig(**cfg)),
            pt_corpus.generate_corpus(pt_corpus.CorpusConfig(**cfg)))


def _edge_corpora():
    """12 BLOCK-padded single-term lists: the flat length is not a TILE
    multiple and the last lists start inside the final partial tile."""
    docs = [np.array([i // 3], np.int32) for i in range(36)]
    sites = [i % 4 for i in range(36)]
    return (ref_corpus.corpus_from_docs(docs, sites, vocab_size=12, n_sites=4),
            pt_corpus.corpus_from_docs(docs, sites, vocab_size=12, n_sites=4))


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("cfg", CONFIGS)
def test_corpus_bit_identical(cfg):
    ref, port = _corpora(cfg)
    for f in ("doc_offsets", "doc_terms", "doc_site"):
        a, b = getattr(ref, f), getattr(port, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (ref.n_docs, ref.vocab_size, ref.n_sites) == (
        port.n_docs, port.vocab_size, port.n_sites)


@pytest.mark.parametrize("site_terms", [True, False])
@pytest.mark.parametrize("cfg", CONFIGS)
def test_index_arrays_equal(cfg, site_terms):
    ref_c, port_c = _corpora(cfg)
    ridx, rmeta = ref_index.build_index(ref_c, include_site_terms=site_terms)
    pidx, pmeta = pt_index.build_index(
        port_c, include_site_terms=site_terms, device="cpu")
    assert dataclass_fields(rmeta) == dataclass_fields(pmeta)
    for f in pt_index.ShardedIndex._fields:
        a, b = _np(getattr(ridx, f)), _np(getattr(pidx, f))
        assert b.dtype == np.int32 and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def dataclass_fields(meta):
    return (meta.n_docs, meta.vocab_size, meta.n_sites, meta.n_terms,
            meta.include_site_terms)


@pytest.mark.parametrize("site_terms", [True, False])
@pytest.mark.parametrize("ns", [2, 3])
def test_sharded_index_equal(ns, site_terms):
    ref_c, port_c = _corpora(CONFIGS[0])
    rsh, rmeta = ref_index.build_sharded_index(
        ref_c, ns, include_site_terms=site_terms)
    psh, pmeta = pt_index.build_sharded_index(
        port_c, ns, include_site_terms=site_terms, device="cpu")
    assert dataclass_fields(rmeta) == dataclass_fields(pmeta)
    for f in pt_index.ShardedIndex._fields:
        a, b = _np(getattr(rsh, f)), _np(getattr(psh, f))
        assert a.shape == b.shape and a.shape[0] == ns, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for s in range(ns):
        shard = psh.shard(s)
        np.testing.assert_array_equal(_np(shard.postings), _np(rsh.postings[s]))


@pytest.mark.parametrize("ns", [1, 2, 3, 4])
def test_partition_corpus_equal(ns):
    ref_c, port_c = _corpora(CONFIGS[2])
    for r, p in zip(ref_index.partition_corpus(ref_c, ns),
                    pt_index.partition_corpus(port_c, ns)):
        for f in ("doc_offsets", "doc_terms", "doc_site"):
            np.testing.assert_array_equal(getattr(r, f), getattr(p, f))
            assert getattr(r, f).dtype == getattr(p, f).dtype
        assert r.n_docs == p.n_docs


def test_array_edge_index_equal():
    ref_c, port_c = _edge_corpora()
    ridx, _ = ref_index.build_index(ref_c, include_site_terms=False)
    pidx, _ = pt_index.build_index(port_c, include_site_terms=False, device="cpu")
    for f in pt_index.ShardedIndex._fields:
        np.testing.assert_array_equal(_np(getattr(ridx, f)), _np(getattr(pidx, f)))
    # the last list sits inside the final partial tile, with a spare tile after
    assert pidx.postings.shape[0] == pt_index.flat_tile_pad(12 * pt_index.BLOCK)


@pytest.mark.parametrize("n", [0, 1, 127, 1023, 1024, 1025, 4096, 10_000])
def test_flat_tile_pad_equal(n):
    assert pt_index.flat_tile_pad(n) == ref_index.flat_tile_pad(n)


def test_local_to_global_keeps_invalid():
    inv = int(pt_index.INVALID_DOC)
    local = np.array([[0, 5, inv], [inv, 1, 2]], np.int32)
    for ns, shard in ((2, 1), (4, 3), (3, 0)):
        got = pt_index.local_to_global_docids(torch.from_numpy(local), shard, ns)
        want = ref_index.local_to_global_docids(local, np.int32(shard), ns)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.dtype == torch.int32
        assert (got.numpy()[local == inv] == inv).all()


def test_index_from_numpy_round_trip():
    ref_c, port_c = _corpora(CONFIGS[1])
    ridx, _ = ref_index.build_index(ref_c)
    carried = pt_index.index_from_numpy(
        {f: np.asarray(v) for f, v in ridx._asdict().items() if v is not None},
        device="cpu")
    own, _ = pt_index.build_index(port_c, device="cpu")
    for f in pt_index.ShardedIndex._fields:
        assert torch.equal(getattr(carried, f), getattr(own, f)), f
    rsh, _ = ref_index.build_sharded_index(ref_c, 2)
    psh = pt_index.sharded_index_from_numpy(
        {f: np.asarray(v) for f, v in rsh._asdict().items()}, device="cpu")
    back = {f: getattr(psh, f).numpy() for f in pt_index.ShardedIndex._fields}
    for f, v in back.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(rsh, f)))


def test_default_device_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, port_c = _corpora(CONFIGS[2])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt_index.build_sharded_index(port_c, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt_index.resolve_device()
    assert pt_index.resolve_device("cpu") == torch.device("cpu")
