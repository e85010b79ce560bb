"""The port's kernel-level ops against the JAX package's Pallas kernels, run
in interpret mode: K9 (``ops.intersect_batched``), K10 (``ops.intersect``),
K11 (``ops.sort``, ``ops.topk_merge``), the skip map and ``skip_fraction``,
and the static modes of K4, K4p, K7 and K7p.

Held exactly, on the same numpy inputs:

- K9's plain version against ``repro.kernels.ops.intersect_batched``: with
  and without ``a_live``, inactive slots, empty drivers and windows, and
  other-term windows wider or narrower than the driver's;
- K10's plain version against ``repro.kernels.ops.intersect`` on the sweep
  of the reference's kernel tests, plus a hypothesis case; and the port's
  ``ref.intersect_mask_ref`` against the reference's;
- ``compute_skip_map`` (flat and batched over a driver and its term slots)
  and ``skip_fraction`` against the reference's;
- K11's plain version against the reference's bitonic network, int32 and
  float32, at the CUDA sort's tile edges and past 2**18, on sorted,
  reversed, one-value and all-pad vectors, and on a float vector holding
  ``inf`` and 3e9, which both return as the pad value 2147483648.0
  (ROADMAP R4);
- the static modes of K4 and K7 (raw and packed; no delta arrays) against
  the reference's K9 on the windows ``repro.core.engine._query_windows``
  stages, on a corpus whose lists exceed one TILE;
- every new CUDA wrapper refuses a CPU tensor;
- on the host alone, the kernel sources: every ``_build.KERNELS`` source
  exists, every ``#include "..."`` under ``csrc/`` names a file there, and
  no source includes the synchronous probe ``probe.cuh`` (K10 runs K9's
  body on the asynchronous one).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

from repro.core import engine as ref_engine
from repro.core import index as ref_index
from repro.data import corpus as ref_corpus
from repro.kernels import ops as ref_ops
from repro.kernels import posting_intersect as ref_pi
from repro.kernels import ref as ref_ref
from repro_torch.core import engine as pt_engine
from repro_torch.core import index as pt_index
from repro_torch.kernels import ops
from repro_torch.kernels import posting_intersect as pi
from repro_torch.kernels import ref as pt_ref
from repro_torch.kernels import topk_merge as tm

INV = int(pt_index.INVALID_DOC)
TILE = pt_index.TILE
# lists up to ~6000 postings: several TILEs per window
CFG = dict(n_docs=6000, vocab_size=500, mean_doc_len=30, n_sites=20, seed=3)
QUERIES = [
    ([0], None), ([0, 1], None), ([1, 2, 3], 2), ([4], 1), ([0, 5, 6], None),
    ([7, 8], None), ([0, 1, 2, 3], None), ([450], None), ([2, 499], 3),
]


def _sorted_list(rng, n, valid, hi):
    v = np.sort(rng.choice(hi, size=valid, replace=False)).astype(np.int32)
    return np.concatenate([v, np.full(n - valid, INV, np.int32)])


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------------ K9 --
@pytest.mark.parametrize("w_a,w_b", [(1024, 1024), (1000, 3000), (2048, 1536),
                                     (3000, 700)])
@pytest.mark.parametrize("with_live", [False, True])
def test_k9_plain_matches_reference(w_a, w_b, with_live):
    rng = np.random.default_rng(w_a * 7 + w_b)
    q_n, t_n, hi = 5, 3, 6000
    a = np.stack([_sorted_list(rng, w_a, v, hi)
                  for v in (w_a, w_a // 2, 0, min(w_a, 300), w_a // 3)])
    b = np.full((q_n, t_n, w_b), INV, np.int32)
    for q in range(q_n):
        for t in range(t_n):
            # mostly the driver's own docs, so that joins hit
            own = a[q][a[q] != INV]
            keep = own[rng.random(own.size) < 0.7]
            extra = rng.choice(hi, size=min(w_b // 3, 500), replace=False)
            docs = np.unique(np.concatenate([keep, extra]))[:w_b]
            b[q, t, :docs.size] = docs
    b[3, 1] = INV                                 # an active empty window
    active = np.array([[1, 1, 0], [1, 0, 1], [1, 1, 1], [1, 1, 1], [0, 0, 0]],
                      np.int32)
    attrs = rng.integers(0, 4, size=(q_n, w_a)).astype(np.int32)
    filt = np.array([-1, 2, -1, 1, 3], np.int32)
    live = (rng.random((q_n, w_a)) < 0.8).astype(np.int32) if with_live else None
    want = ref_ops.intersect_batched(
        jnp.asarray(a), jnp.asarray(attrs), jnp.asarray(b), jnp.asarray(active),
        jnp.asarray(filt), a_live=None if live is None else jnp.asarray(live))
    got = ops.intersect_batched(_t(a), _t(attrs), _t(b), _t(active), _t(filt),
                                a_live=None if live is None else _t(live))
    assert got.dtype == torch.int32 and got.shape == (q_n, w_a)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.sum()) > 0


# ----------------------------------------------------------------- K10 --
@pytest.mark.parametrize("na,va,nb,vb", [
    (1024, 1024, 1024, 1024), (1024, 500, 2048, 1700), (2048, 2048, 1024, 64),
    (1024, 0, 1024, 512), (4096, 3000, 4096, 4000), (512, 300, 768, 400),
])
@pytest.mark.parametrize("attr_filter", [-1, 2])
def test_k10_plain_matches_reference(na, va, nb, vb, attr_filter):
    rng = np.random.default_rng(na + va + nb + vb)
    a = _sorted_list(rng, na, va, 50_000)
    b = _sorted_list(rng, nb, vb, 50_000)
    attrs = rng.integers(0, 5, size=na).astype(np.int32)
    want = np.asarray(ref_ops.intersect(jnp.asarray(a), jnp.asarray(attrs),
                                        jnp.asarray(b), attr_filter))
    np.testing.assert_array_equal(
        ops.intersect(_t(a), _t(attrs), _t(b), attr_filter).numpy(), want)
    # a 0-d tensor filter, and the oracles
    np.testing.assert_array_equal(
        ops.intersect(_t(a), _t(attrs), _t(b),
                      torch.tensor(attr_filter, dtype=torch.int32)).numpy(), want)
    np.testing.assert_array_equal(
        pt_ref.intersect_mask_ref(_t(a), _t(attrs), _t(b), attr_filter).numpy(),
        np.asarray(ref_ref.intersect_mask_ref(jnp.asarray(a), jnp.asarray(attrs),
                                              jnp.asarray(b), attr_filter)))


if HAVE_HYPOTHESIS:
    @settings(max_examples=20, deadline=None)
    @given(va=st.integers(0, 1500), vb=st.integers(0, 1500),
           overlap=st.integers(0, 300), attr=st.integers(-1, 3),
           seed=st.integers(0, 2**16))
    def test_k10_property_matches_reference(va, vb, overlap, attr, seed):
        rng = np.random.default_rng(seed)
        shared = rng.choice(10_000, size=overlap, replace=False)
        a_v = np.sort(np.concatenate([shared, rng.choice(
            np.arange(10_000, 20_000), size=va, replace=False)])).astype(np.int32)
        b_v = np.sort(np.concatenate([shared, rng.choice(
            np.arange(20_000, 30_000), size=vb, replace=False)])).astype(np.int32)
        a = np.concatenate([a_v, np.full(1000 - a_v.size % 1000, INV, np.int32)])
        b = np.concatenate([b_v, np.full(700 - b_v.size % 700, INV, np.int32)])
        attrs = rng.integers(0, 4, size=a.size).astype(np.int32)
        got = ops.intersect(_t(a), _t(attrs), _t(b), attr).numpy()
        want = np.asarray(ref_ops.intersect(jnp.asarray(a), jnp.asarray(attrs),
                                            jnp.asarray(b), attr))
        np.testing.assert_array_equal(got, want)
        if attr < 0:
            assert got.sum() == overlap
else:
    @pytest.mark.skip(reason="hypothesis not installed")
    def test_k10_property_matches_reference():
        pass


# ------------------------------------------------ skip map, skip_fraction --
@pytest.mark.parametrize("na,va,nb,vb", [(2048, 1500, 4096, 3000),
                                         (1024, 0, 2048, 100),
                                         (3072, 3072, 1024, 1024)])
def test_compute_skip_map_matches_reference(na, va, nb, vb):
    rng = np.random.default_rng(na + vb)
    a = _sorted_list(rng, na, va, 40_000)
    b = _sorted_list(rng, nb, vb, 40_000)
    start, n_b = ops.compute_skip_map(_t(a), _t(b))
    r_start, r_n = ref_pi.compute_skip_map(jnp.asarray(a), jnp.asarray(b))
    assert start.dtype == n_b.dtype == torch.int32
    np.testing.assert_array_equal(start.numpy(), np.asarray(r_start))
    np.testing.assert_array_equal(n_b.numpy(), np.asarray(r_n))
    assert ops.skip_fraction(_t(a), _t(b)).item() == float(
        ref_ops.skip_fraction(jnp.asarray(a), jnp.asarray(b)))


def test_batched_skip_map_and_skip_fraction_match_reference():
    rng = np.random.default_rng(11)
    a = np.stack([_sorted_list(rng, 2048, v, 30_000) for v in (2048, 900, 0)])
    b = np.stack([np.stack([_sorted_list(rng, 3072, v, 30_000)
                            for v in (3072, 1000, 0, 10)]) for _ in range(3)])
    start, n_b = ops.compute_skip_map(_t(a)[:, None], _t(b))
    r_start, r_n = jax.vmap(jax.vmap(ref_pi.compute_skip_map, in_axes=(None, 0)))(
        jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(start.numpy(), np.asarray(r_start))
    np.testing.assert_array_equal(n_b.numpy(), np.asarray(r_n))
    with pytest.raises(ValueError, match="TILE-padded"):
        ops.compute_skip_map(_t(a[:, :1000]), _t(b))
    # disjoint ranges skip everything, like ranges skip little; unpadded
    near = _sorted_list(rng, 4000, 4000, 50_000)
    far = np.sort(rng.choice(np.arange(10**6, 2 * 10**6), 3000)).astype(np.int32)
    like = _sorted_list(rng, 4000, 3500, 50_000)
    for x, y in ((near, like), (near, far), (far[:1500], near)):
        assert ops.skip_fraction(_t(x), _t(y)).item() == float(
            ref_ops.skip_fraction(jnp.asarray(x), jnp.asarray(y)))
    assert ops.skip_fraction(_t(near), _t(far)).item() > 0.9


# ----------------------------------------------------------------- K11 --
SORT_TILE = tm.SORT_TILE
# (order, n): the CUDA sort's tile edges ride on the random sizes; these are
# the orders a merge sort can get wrong, at one size past three tiles
K11_ORDERS = [pytest.param((order, 3 * SORT_TILE + 5), id=f"{order}-{3 * SORT_TILE + 5}")
              for order in ("sorted", "reversed", "one-value", "all-pad")]


@pytest.mark.parametrize("n", [2, 7, 100, 256, 777, 2048, SORT_TILE - 1, SORT_TILE,
                               SORT_TILE + 1, 2 * SORT_TILE, (1 << 18) + 1, *K11_ORDERS])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_k11_plain_matches_reference(n, dtype):
    if isinstance(n, tuple):
        order, n = n
        x = {"sorted": np.arange(n), "reversed": np.arange(n, 0, -1),
             "one-value": np.full(n, -7), "all-pad": np.full(n, INV)}[order].astype(dtype)
    else:
        rng = np.random.default_rng(n)
        if dtype == np.int32:
            x = rng.integers(-(1 << 30), 1 << 30, size=n).astype(dtype)
            x[: n // 3] = x[n // 2]                     # ties
        else:
            x = rng.normal(size=n).astype(dtype) * 1e4
    got = ops.sort(_t(x))
    assert got.dtype == torch.from_numpy(x).dtype and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_ops.sort(jnp.asarray(x))))
    np.testing.assert_array_equal(got.numpy(), pt_ref.sort_ref(_t(x)).numpy())


def test_k11_float_pad_quirk_matches_reference():
    """R4: the reference pads with INVALID_DOC cast to float32
    (2147483648.0) and keeps the first n, so inf and 3e9 come back as the
    pad; the port does the same."""
    x = np.array([3, np.inf, -1, 3e9, 5], np.float32)
    want = np.asarray(ref_ops.sort(jnp.asarray(x)))
    got = ops.sort(_t(x)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.array([-1, 3, 5, 2**31, 2**31], np.float32))
    # below the pad, plain order holds
    y = np.array([2.0e9, -np.inf, 7, 2147483520.0], np.float32)
    np.testing.assert_array_equal(ops.sort(_t(y)).numpy(), np.sort(y))


@pytest.mark.parametrize("ns,k", [(16, 128), (4, 1000), (3, 7), (1, 40)])
def test_k11_merge_topk_matches_reference(ns, k):
    rng = np.random.default_rng(ns * k)
    c = np.sort(rng.integers(0, 1 << 28, size=(ns, k)).astype(np.int32), axis=1)
    c[0, k // 2:] = INV                               # a slave short of k
    want = np.asarray(ref_ops.topk_merge(jnp.asarray(c), k))
    np.testing.assert_array_equal(ops.topk_merge(_t(c), k).numpy(), want)
    np.testing.assert_array_equal(pt_ref.merge_topk_ref(_t(c), k).numpy(),
                                  np.asarray(ref_ref.merge_topk_ref(jnp.asarray(c), k)))


# ---------------------------------------- static K4 / K7 against K9 -----
@pytest.fixture(scope="module")
def corpus_setup():
    corpus = ref_corpus.generate_corpus(ref_corpus.CorpusConfig(**CFG))
    ridx, meta = ref_index.build_index(corpus, codec="packed")
    arrays = {f: np.asarray(getattr(ridx, f)) for f in pt_index.ShardedIndex._fields}
    pidx = pt_index.index_from_numpy({**arrays, "packed": ridx.packed}, device="cpu")
    assert int(pidx.lengths.max()) > 3 * TILE
    return ridx, pidx, meta


@pytest.mark.parametrize("window", [1024, 3000])
@pytest.mark.parametrize("filt", [True, False])
@pytest.mark.parametrize("kernel", ["K4", "K4p", "K7", "K7p"])
def test_static_k4_k7_match_reference_k9(corpus_setup, window, filt, kernel):
    ridx, pidx, meta = corpus_setup
    rqb = ref_engine.make_query_batch(QUERIES, t_max=4, meta=meta)
    pqb = pt_engine.make_query_batch(QUERIES, t_max=4, meta=meta, device="cpu")
    r_docs, r_attrs, _, r_others, r_active = ref_engine._query_windows(
        ridx, rqb, window=window, attr_strategy="embed")
    filt_q = rqb.attr_filter if filt else jnp.full_like(rqb.attr_filter, -1)
    want = np.asarray(ref_ops.intersect_batched(r_docs, r_attrs, r_others,
                                                r_active, filt_q))
    docs, attrs, active = (_t(np.asarray(x)) for x in (r_docs, r_attrs, r_active))
    # the port stages the same windows
    p_docs, p_attrs, p_live, p_others, p_active = pt_engine._query_windows(
        pt_engine.StaticPostingSource(pidx), pqb, window=window,
        attr_strategy="embed")
    assert p_live is None and torch.equal(p_others, _t(np.asarray(r_others)))
    assert torch.equal(p_docs, docs) and torch.equal(p_active, active)
    valid = (docs != INV).to(torch.int32)
    join = ops.intersect_streamed_compact if kernel[:2] == "K7" else ops.intersect_streamed
    packed = pidx.packed if kernel.endswith("p") else None
    got = join(docs, attrs, valid, pqb.terms, active, _t(np.asarray(filt_q)),
               pidx.postings, pidx.offsets, pidx.lengths, pidx.block_max,
               packed=packed)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ops.intersect_batched(docs, attrs, p_others, active,
                              _t(np.asarray(filt_q))).numpy(), want)
    assert want.sum() > 0


def test_new_cuda_wrappers_refuse_cpu_tensors():
    one = torch.zeros(TILE, dtype=torch.int32)
    row, plan = one[None], torch.zeros((1, 1, 1), dtype=torch.int32)
    act, filt = torch.ones((1, 1), dtype=torch.int32), torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        pi.batched_block_skip_join_cuda(row, row, None, row[None], act, filt,
                                        plan, plan)
    with pytest.raises(ValueError, match="CUDA"):
        pi.block_skip_join_cuda(one, one, one, filt, plan[0, 0], plan[0, 0])
    with pytest.raises(ValueError, match="TILE-padded"):
        pi.block_skip_join_cuda(one[:5], one[:5], one, filt, plan[0, 0], plan[0, 0])
    with pytest.raises(ValueError, match="CUDA"):
        tm.bitonic_sort_cuda(one)
    with pytest.raises(ValueError, match="float32"):
        tm.bitonic_sort_cuda(one.to(torch.int64))
    assert pi.batched_block_skip_join_cuda.launches == 0
    assert pi.block_skip_join_cuda.launches == 0
    assert tm.bitonic_sort_cuda.launches == 0
    assert ops.ref is pt_ref


# ------------------------------------------------------ kernel sources --
def _csrc_files():
    from repro_torch.kernels import _build

    return _build, sorted(_build.CSRC.glob("*.cu")) + sorted(_build.CSRC.glob("*.cuh"))


def test_every_kernel_source_exists():
    _build, _ = _csrc_files()
    for name, k in _build.KERNELS.items():
        assert (_build.CSRC / f"{k.source}.cu").is_file(), name
    assert _build.KERNELS["block_skip"].source == "staged_join"
    assert _build.KERNELS["batched_block_skip"].source == "staged_join"
    # every source is a kernel's: no orphan .cu
    assert {p.stem for p in _build.CSRC.glob("*.cu")} == set(_build.SOURCES)


@pytest.mark.parametrize("kind", ["include", "probe"])
def test_csrc_includes_resolve_and_skip_the_synchronous_probe(kind):
    import re

    _build, files = _csrc_files()
    assert files
    local = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)
    for path in files:
        names = local.findall(path.read_text())
        if kind == "include":
            for inc in names:
                assert (_build.CSRC / inc).is_file(), f"{path.name} includes {inc}"
        else:
            assert "probe.cuh" not in names, path.name
    if kind == "probe":
        assert not (_build.CSRC / "probe.cuh").exists()
        assert not (_build.CSRC / "block_skip.cu").exists()
