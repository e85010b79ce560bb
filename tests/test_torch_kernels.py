"""The port's kernel modules against the JAX package, on the CPU.

- the probe-plan helpers against ``repro.kernels.posting_intersect``'s
  ``window_tile_spans``, ``driver_tile_spans`` and ``_probe_plan``;
- K1's plain version ``(docs, mask)`` against an oracle built from the
  reference's ``term_window`` / ``member_sorted`` plus the attribute
  predicate (the Pallas K1 itself cannot run on the installed jax);
- K2's plain version against the interpret-mode Pallas ``merge_topk_rows``
  and against ``np.sort``.

All integer outputs: the tolerance is exact equality.  The CUDA kernels
themselves are held against these plain versions on the card by
``chip_smoke.py``."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import engine as ref_engine
from repro.core import index as ref_index
from repro.data import corpus as ref_corpus
from repro.kernels import posting_intersect as ref_pi
from repro.kernels import topk_merge as ref_tm
from repro_torch.core import index as pt_index
from repro_torch.kernels import posting_intersect as pt_pi
from repro_torch.kernels import topk_merge as pt_tm

INV = int(pt_index.INVALID_DOC)
WINDOWS = [128, 1000, 1024, 1536, 2048]


def _carry(ridx):
    return pt_index.index_from_numpy(
        {f: np.asarray(v) for f, v in ridx._asdict().items() if v is not None},
        device="cpu")


@functools.lru_cache(maxsize=None)
def _setup(kind):
    if kind == "zipf":
        corpus = ref_corpus.generate_corpus(ref_corpus.CorpusConfig(
            n_docs=3000, vocab_size=300, mean_doc_len=30, n_sites=12, seed=11))
        ridx, meta = ref_index.build_index(corpus)
    elif kind == "empty":
        corpus = ref_corpus.Corpus(
            doc_offsets=np.array([0, 2, 4], np.int64),
            doc_terms=np.array([0, 1, 0, 2], np.int32),
            doc_site=np.array([0, 1], np.int32),
            n_docs=2, vocab_size=8, n_sites=2)
        ridx, meta = ref_index.build_index(corpus, include_site_terms=False)
    else:  # "edge": the last lists start inside the final partial tile
        docs = [np.array([i // 3], np.int32) for i in range(36)]
        corpus = ref_corpus.corpus_from_docs(
            docs, [i % 4 for i in range(36)], vocab_size=12, n_sites=4)
        ridx, meta = ref_index.build_index(corpus, include_site_terms=False)
    return ridx, _carry(ridx), meta


def _queries(kind, meta):
    """(terms[Q, T], n_terms[Q], attr_filter[Q]) with a seed, numpy."""
    rng = np.random.default_rng(7)
    if kind == "zipf":
        q_n, t_n = 24, 4
        n_terms = rng.integers(1, t_n + 1, size=q_n)
        terms = np.full((q_n, t_n), -1, np.int32)
        for q in range(q_n):
            # Zipf-ish: small ids have long lists
            terms[q, :n_terms[q]] = rng.choice(
                np.r_[np.arange(12), rng.integers(0, meta.n_terms, 8)],
                size=n_terms[q], replace=False)
        attr = np.where(rng.random(q_n) < 0.4, rng.integers(0, 12, q_n), -1)
        return terms, n_terms.astype(np.int32), attr.astype(np.int32)
    if kind == "empty":
        terms = np.array([[5, -1], [0, 5], [0, -1], [0, 2], [3, 4]], np.int32)
        n_terms = np.array([1, 2, 1, 2, 2], np.int32)
        return terms, n_terms, np.array([-1, -1, 1, -1, -1], np.int32)
    terms = np.array([[t, (t + 11) % 12] if t % 2 else [t, -1]
                      for t in range(12)], np.int32)
    n_terms = np.array([2 if t % 2 else 1 for t in range(12)], np.int32)
    return terms, n_terms, np.where(np.arange(12) % 3 == 0, 1, -1).astype(np.int32)


def _drivers(ridx, terms, n_terms, window):
    """Driver term, active slots and span, from the reference's source."""
    src = ref_engine.StaticPostingSource(ridx)
    slots = np.arange(terms.shape[1])
    d_slot = np.array([int(src.driver_slot(jnp.asarray(t), int(n)))
                       for t, n in zip(terms, n_terms)])
    d_terms = terms[np.arange(len(terms)), d_slot]
    active = ((slots[None] < n_terms[:, None])
              & (slots[None] != d_slot[:, None])).astype(np.int32)
    span = src.driver_span(jnp.asarray(d_terms), window)
    return d_terms, active, np.asarray(span.off), np.asarray(span.n_eff)


def _oracle(ridx, terms, active, d_terms, attr_filter, window):
    """K1's (docs, mask) from the reference's jnp helpers."""
    docs_all, masks = [], []
    for q in range(terms.shape[0]):
        docs, attrs, valid = ref_engine.term_window(
            ridx, jnp.int32(d_terms[q]), window)
        mask = np.asarray(valid)
        for t in range(terms.shape[1]):
            if active[q, t]:
                b, _, _ = ref_engine.term_window(ridx, jnp.int32(terms[q, t]), window)
                mask = mask & np.asarray(ref_engine.member_sorted(docs, b))
        if attr_filter[q] >= 0:
            mask = mask & (np.asarray(attrs) == attr_filter[q])
        docs_all.append(np.asarray(docs))
        masks.append(mask.astype(np.int32))
    return np.stack(docs_all), np.stack(masks)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.int32))


# ------------------------------------------------------------ probe plan


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("kind", ["zipf", "empty", "edge"])
def test_plan_helpers_bit_identical(kind, window):
    ridx, pidx, meta = _setup(kind)
    terms, n_terms, _ = _queries(kind, meta)
    _, _, off, n_eff = _drivers(ridx, terms, n_terms, window)
    num_a = -(-window // pt_index.TILE)
    bm = np.asarray(ridx.block_max)

    ref_a = jax.vmap(functools.partial(
        ref_pi.driver_tile_spans, jnp.asarray(bm), s_tiles=num_a))(
            jnp.asarray(off), jnp.asarray(n_eff))
    got_a = pt_pi.driver_tile_spans(_t(bm), _t(off), _t(n_eff), s_tiles=num_a)
    for r, g in zip(ref_a, got_a):
        np.testing.assert_array_equal(np.asarray(r), g.numpy())

    ref_w = jax.vmap(functools.partial(
        ref_pi.window_tile_spans, jnp.asarray(bm), s_tiles=num_a + 1))(
            jnp.asarray(off), jnp.asarray(n_eff))
    got_w = pt_pi.window_tile_spans(_t(bm), _t(off), _t(n_eff), s_tiles=num_a + 1)
    for r, g in zip(ref_w, got_w):
        np.testing.assert_array_equal(np.asarray(r), g.numpy())
        assert g.dtype == torch.int32

    ref_plan = ref_pi._probe_plan(
        ref_a, jnp.asarray(terms), ridx.offsets, ridx.lengths, ridx.block_max,
        window=window, s_tiles=num_a + 1)
    got_plan = pt_pi._probe_plan(
        got_a, _t(terms), pidx.offsets, pidx.lengths, pidx.block_max,
        window=window, s_tiles=num_a + 1)
    for r, g in zip(ref_plan, got_plan):
        np.testing.assert_array_equal(np.asarray(r), g.numpy())
        assert g.dtype == torch.int32


def test_take_fill_reads_fill_out_of_range():
    flat = torch.arange(5, dtype=torch.int32)
    idx = torch.tensor([[0, 4, 5, 9]], dtype=torch.int32)
    got = pt_pi._take_fill(flat, idx, INV)
    want = jnp.take(jnp.arange(5, dtype=jnp.int32), jnp.asarray(idx.numpy()),
                    mode="fill", fill_value=INV)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------ K1


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("kind", ["zipf", "empty", "edge"])
def test_k1_plain_matches_oracle(kind, window):
    ridx, pidx, meta = _setup(kind)
    terms, n_terms, attr = _queries(kind, meta)
    d_terms, active, off, n_eff = _drivers(ridx, terms, n_terms, window)
    want_docs, want_mask = _oracle(ridx, terms, active, d_terms, attr, window)
    docs, mask = pt_pi.intersect_batched_driver_streamed(
        _t(off), _t(n_eff), _t(terms), _t(active), _t(attr),
        pidx.postings, pidx.attrs, pidx.offsets, pidx.lengths, pidx.block_max,
        window=window)
    assert docs.shape == mask.shape == (terms.shape[0], window)
    assert docs.dtype == mask.dtype == torch.int32
    np.testing.assert_array_equal(docs.numpy(), want_docs)
    np.testing.assert_array_equal(mask.numpy(), want_mask)
    if kind == "zipf":
        assert want_mask.sum() > 0


@pytest.mark.parametrize("attr_on", [False, True])
def test_k1_dispatch_on_cpu_runs_plain_version(attr_on):
    """On a CPU tensor the wrapper runs the plain version and launches
    nothing."""
    ridx, pidx, meta = _setup("zipf")
    terms, n_terms, attr = _queries("zipf", meta)
    if not attr_on:
        attr = np.full_like(attr, -1)
    d_terms, active, off, n_eff = _drivers(ridx, terms, n_terms, 1024)
    plan = pt_pi.plan_driver_streamed(
        _t(off), _t(n_eff), _t(terms), _t(active), pidx.offsets, pidx.lengths,
        pidx.block_max, window=1024)
    args = (_t(off), _t(n_eff), _t(active), _t(attr), pidx.postings,
            pidx.attrs, *plan)
    before = pt_pi.driver_streamed_join_cuda.launches
    got = pt_pi.driver_streamed_join(*args, window=1024)
    want = pt_pi.driver_streamed_join_torch(*args, window=1024)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert pt_pi.driver_streamed_join_cuda.launches == before
    # inactive slots have no planned tiles
    assert (plan[1].numpy()[active == 0] == 0).all()


def test_k1_cuda_wrapper_refuses_cpu_tensors():
    ridx, pidx, meta = _setup("empty")
    terms, n_terms, attr = _queries("empty", meta)
    d_terms, active, off, n_eff = _drivers(ridx, terms, n_terms, 128)
    plan = pt_pi.plan_driver_streamed(
        _t(off), _t(n_eff), _t(terms), _t(active), pidx.offsets, pidx.lengths,
        pidx.block_max, window=128)
    with pytest.raises(ValueError, match="CUDA tensor"):
        pt_pi.driver_streamed_join_cuda(
            _t(off), _t(n_eff), _t(active), _t(attr), pidx.postings,
            pidx.attrs, *plan, window=128)


# ------------------------------------------------------------ K2


@pytest.mark.parametrize("m,k", [(20, 10), (100, 50), (256, 1), (500, 10),
                                 (1000, 1000), (2000, 1000)])
def test_k2_plain_matches_pallas_interpret_and_np_sort(m, k):
    rng = np.random.default_rng(m + k)
    cands = rng.integers(0, 10**6, size=(3, m)).astype(np.int32)
    cands[0, : m // 3] = INV                      # a row padded with INVALID
    got = pt_tm.merge_topk_rows(torch.from_numpy(cands), k)
    want = ref_tm.merge_topk_rows(jnp.asarray(cands), k, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.sort(cands, axis=1)[:, :k])
    assert got.dtype == torch.int32


def test_k2_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensor"):
        pt_tm.merge_topk_rows_cuda(torch.zeros((2, 8), dtype=torch.int32), 4)
