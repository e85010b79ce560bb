"""The staging precondition of the CUDA slave joins K1 and K4 on the CPU.

Their kernels (``csrc/probe_async.cuh``) stage each planned probe range
into shared memory with bulk copies of whole 16-byte chunks, the range's
ends rounded out to them.  So a copy stays inside its array when the array
starts on 16 bytes and holds whole chunks, which the CUDA wrappers check
before a launch (``_build.check_aligned``; here with the launch replaced,
since the CPU has no card), and it reads nothing before its range when the
range starts on 16 bytes.  ``probe_staging_check`` states the plan's side:
every range that the plans of ``plan_driver_streamed`` (K1, K1p) and
``plan_streamed`` (K4, K4p: main and delta) name starts on 16 bytes and,
rounded up, ends inside its array; for a packed twin, the words of the
range's blocks (from ``blk_woff``) do the same.  Here it holds on the plans
of a small index, of the array-edge index (lists in the flat array's last
partial tile) and of ``DeltaWriter`` snapshots, raw and packed, at term
capacities 256 and 384, and it fails on a plan shifted by one posting and
on an array cut short.  The plans themselves equal the reference's
(``tests/test_torch_kernels.py``)."""
import numpy as np
import pytest
import torch

from repro_torch.core import engine as pt_engine
from repro_torch.core.index import BLOCK, build_index, pack_index
from repro_torch.data.corpus import (CorpusConfig, corpus_from_docs,
                                     generate_corpus)
from repro_torch.indexing.delta import DeltaWriter
from repro_torch.kernels import _build
from repro_torch.kernels import delta_merge as dm
from repro_torch.kernels import posting_intersect as pi

WINDOWS = [128, 1000, 1536, 4096]
CFG = dict(n_docs=3000, vocab_size=300, mean_doc_len=30, n_sites=12, seed=11)


@pytest.fixture(scope="module")
def small():
    corpus = generate_corpus(CorpusConfig(**CFG))
    idx, meta = build_index(corpus, device="cpu")
    return corpus, idx, pack_index(idx), meta


@pytest.fixture(scope="module")
def edge():
    """14 lists of one block each: the last two start in the flat array's
    last partial tile and overlap every other list."""
    docs = [np.unique(np.array([i % 4, 4 + i % 5, 13] + [12] * (i % 2 == 0),
                               np.int32)) for i in range(60)]
    corpus = corpus_from_docs(docs, [i % 4 for i in range(60)], vocab_size=14,
                              n_sites=4)
    idx, meta = build_index(corpus, include_site_terms=False, device="cpu")
    return corpus, idx, pack_index(idx), meta


EDGE_QUERIES = [([12, 13], None), ([0, 13], None), ([13, 12, 3], None),
                ([5, 12], None), ([1, 6, 13], None), ([8, 12], 2), ([11], None)]


def _batch(meta, n_q=24, seed=7):
    rng = np.random.default_rng(seed)
    hot = min(12, meta.n_terms)
    queries = [([int(t) for t in rng.choice(
        np.r_[np.arange(hot), rng.integers(0, meta.n_terms, 8)],
        size=int(rng.integers(1, 5)), replace=False)], None) for _ in range(n_q)]
    return pt_engine.make_query_batch(queries, t_max=4, meta=meta, device="cpu")


def _driver_plan(idx, batch, window):
    source = pt_engine.StaticPostingSource(idx)
    _, d_terms, active = pt_engine._pick_drivers(source, batch)
    span = source.driver_span(d_terms, window)
    return pi.plan_driver_streamed(span.off, span.n_eff, batch.terms,
                                   active.to(torch.int32), idx.offsets,
                                   idx.lengths, idx.block_max, window=window)


def _streamed_plans(idx, delta, batch, window):
    """K4's main and delta plans as the kernel backend builds them: the
    driver is K3's merged window (its plain version)."""
    source = pt_engine.MergedPostingSource(idx, delta)
    _, d_terms, active = pt_engine._pick_drivers(source, batch)
    span = source.driver_span(d_terms, window)
    docs, _, _ = dm.merge_delta_windows(
        idx.postings, idx.attrs, span.off, span.n_eff, delta.postings,
        delta.attrs, delta.offsets, delta.lengths, delta.block_max, d_terms,
        window=window)
    main, dplan, cap = pi.plan_streamed(
        docs, batch.terms, active.to(torch.int32), idx.offsets, idx.lengths,
        idx.block_max, delta.offsets, delta.lengths, delta.block_max)
    assert cap == delta.term_capacity
    return main, dplan


def _writer(corpus, meta, fill, cap, codec, seed=5):
    """A writer whose hottest delta list sits at ``fill``, with delete and
    update tombstones."""
    rng = np.random.default_rng(seed)
    w = DeltaWriter(corpus, meta, 1, term_capacity=cap, doc_headroom=1024,
                    codec=codec, device="cpu")
    w.delete_docs([int(d) for d in rng.choice(corpus.n_docs, 6, replace=False)])
    w.update_docs([(int(d), np.unique(rng.integers(0, 40, size=10)),
                    int(rng.integers(10)))
                   for d in rng.choice(np.arange(200, 260), 6, replace=False)])
    while w.posting_fill() < fill:
        w.insert_docs([(np.unique(rng.integers(0, 24, size=20)),
                        int(rng.integers(10)))])
    return w


def _check(plan, flat, packed=None):
    n = pi.probe_staging_check(*plan, n_postings=flat.numel(), packed=packed)
    assert n > 0
    return n


@pytest.mark.parametrize("codec", ["raw", "packed"])
@pytest.mark.parametrize("window", WINDOWS)
def test_driver_plan_stages(small, codec, window):
    _, idx, twin, meta = small
    plan = _driver_plan(idx, _batch(meta), window)
    _check(plan, idx.postings, twin.packed if codec == "packed" else None)


@pytest.mark.parametrize("codec", ["raw", "packed"])
@pytest.mark.parametrize("window", [128, 1000, 1024, 1536])
def test_edge_index_plan_stages(edge, codec, window):
    """Lists that start in the flat array's last partial tile: rounded up
    to 16 bytes, their ranges still end inside the array."""
    _, idx, twin, meta = edge
    batch = pt_engine.make_query_batch(EDGE_QUERIES, t_max=4, meta=meta,
                                       device="cpu")
    plan = _driver_plan(idx, batch, window)
    _check(plan, idx.postings, twin.packed if codec == "packed" else None)
    # the last list's range starts in the last tile before the spare one
    last = int(idx.offsets[-1])
    assert last // 1024 == idx.postings.numel() // 1024 - 2
    assert bool((plan[2][..., 0] == last).any())


@pytest.mark.parametrize("codec", ["raw", "packed"])
@pytest.mark.parametrize("cap", [256, 384])
@pytest.mark.parametrize("fill", [0.0, 0.5, 1.0])
def test_streamed_plans_stage(small, codec, cap, fill):
    corpus, idx, twin, meta = small
    w = _writer(corpus, meta, fill, cap, codec)
    delta = w.shard_deltas()[0]
    assert delta.term_capacity == cap
    batch = _batch(meta)
    for window in (4096, 1000):
        main, dplan = _streamed_plans(idx, delta, batch, window)
        _check(main, idx.postings, twin.packed if codec == "packed" else None)
        if fill > 0:
            _check(dplan, delta.postings, delta.packed)
        else:
            pi.probe_staging_check(*dplan, n_postings=delta.postings.numel(),
                                   packed=delta.packed)
        assert bool((dplan[2][..., 0] % cap == 0).all())


def test_static_streamed_plan_stages(small):
    """K4's static mode (no delta arrays): the main plan alone."""
    _, idx, twin, meta = small
    batch = _batch(meta)
    source = pt_engine.StaticPostingSource(idx)
    _, d_terms, active = pt_engine._pick_drivers(source, batch)
    docs = pt_engine.term_window(idx, d_terms, 1536)[0]
    main, dplan, cap = pi.plan_streamed(docs, batch.terms, active.to(torch.int32),
                                        idx.offsets, idx.lengths, idx.block_max)
    assert dplan is None and cap == 0
    _check(main, idx.postings, twin.packed)


@pytest.mark.parametrize("which", ["driver", "main", "delta"])
@pytest.mark.parametrize("codec", ["raw", "packed"])
def test_shifted_plan_fails(small, which, codec):
    """A plan whose window bounds move by one posting names ranges that
    start off a 16-byte boundary: the check refuses it."""
    corpus, idx, twin, meta = small
    batch = _batch(meta)
    packed = codec == "packed"
    if which == "driver":
        plan, flat, tw = _driver_plan(idx, batch, 1000), idx.postings, twin.packed
    else:
        delta = _writer(corpus, meta, 1.0, 256, codec).shard_deltas()[0]
        main, dplan = _streamed_plans(idx, delta, batch, 1000)
        plan, flat, tw = ((main, idx.postings, twin.packed) if which == "main"
                          else (dplan, delta.postings, delta.packed))
    tw = tw if packed else None
    _check(plan, flat, tw)
    b_tile, n_b, bounds = plan
    with pytest.raises(ValueError, match="16-byte"):
        pi.probe_staging_check(b_tile, n_b, bounds + 1, n_postings=flat.numel(),
                               packed=tw)


def test_range_past_the_array_fails(edge):
    """A range whose rounded end, or whose blocks' words, pass the end of
    the array is refused: an array cut to the live extent of the last list
    and a twin whose words are cut short."""
    _, idx, twin, meta = edge
    batch = pt_engine.make_query_batch(EDGE_QUERIES, t_max=4, meta=meta,
                                       device="cpu")
    plan = _driver_plan(idx, batch, 1024)
    _check(plan, idx.postings, twin.packed)
    lo, hi = plan[2][..., 0].long(), plan[2][..., 1].long()
    live = plan[1] > 0
    ends = torch.where(live, hi[..., None].expand_as(plan[1]), torch.zeros_like(plan[1]))
    last = int(ends.max())
    short = last - last % 4 if last % 4 else last - 1
    with pytest.raises(ValueError, match="16-byte"):
        pi.probe_staging_check(*plan, n_postings=short)
    pk = twin.packed
    cut = type(pk)(pk.words[:int(pk.blk_woff[-1]) - 4], pk.blk_base, pk.blk_meta,
                   pk.blk_woff, chunk_rows=pk.chunk_rows)
    assert int(pk.blk_woff[-1]) % 4 == 0 and int(pk.blk_woff[-1]) > 0
    with pytest.raises(ValueError, match="16-byte"):
        pi.probe_staging_check(*plan, packed=cut)
    assert int(lo.min()) % BLOCK == 0


class _Launched(Exception):
    """Raised in place of a launch: the wrapper's checks all passed."""


def _flawed(x, flaw):
    """``x`` (16-byte aligned, whole chunks) as given, starting one element
    in, or one element short."""
    return {None: x, "start": x[1:], "length": x[:-1]}[flaw]


def _flawed_twin(pk, flaw):
    return type(pk)(_flawed(pk.words, flaw), pk.blk_base, pk.blk_meta,
                    pk.blk_woff, chunk_rows=pk.chunk_rows)


@pytest.mark.parametrize("flaw", [None, "start", "length"])
@pytest.mark.parametrize("kernel", ["K1", "K1p", "K4", "K4s", "K4p", "K4ps"])
def test_wrappers_refuse_arrays_the_copies_cannot_stage(small, monkeypatch,
                                                        kernel, flaw):
    """Each CUDA wrapper of K1 and K4 refuses, before its launch, a flat
    array (K4 and K4p: the delta's) that does not start on 16 bytes or does
    not hold whole 16-byte chunks, and launches with a sound one."""
    corpus, idx, twin, meta = small
    delta = _writer(corpus, meta, 0.5, 256, "packed").shard_deltas()[0]
    monkeypatch.setattr(_build, "check_args", lambda *a, **k: None)

    def launch(name):
        raise _Launched(name)

    monkeypatch.setattr(_build, "kernel", launch)
    z = torch.zeros(1, dtype=torch.int32)
    act = torch.ones((1, 2), dtype=torch.int32)
    drv = torch.zeros((1, 8), dtype=torch.int32)
    main_flaw = flaw if kernel in ("K1", "K1p", "K4s", "K4ps") else None
    delta_flaw = flaw if kernel in ("K4", "K4p") else None
    if kernel == "K1":
        run = lambda: pi.driver_streamed_join_cuda(
            z, z, act, z, _flawed(idx.postings, main_flaw), idx.attrs, z, z, z,
            window=8)
    elif kernel == "K1p":
        run = lambda: pi.driver_streamed_join_packed_cuda(
            z, z, act, z, _flawed_twin(twin.packed, main_flaw), idx.attrs, z, z,
            z, window=8)
    elif kernel in ("K4", "K4s"):
        d = (_flawed(delta.postings, delta_flaw), z, z, z) if kernel == "K4" \
            else (None, None, None, None)
        run = lambda: pi.streamed_join_cuda(
            drv, drv, drv, drv, act, z, _flawed(idx.postings, main_flaw), z, z,
            z, *d, cap=256)
    else:
        d = (_flawed_twin(delta.packed, delta_flaw), z, z, z) if kernel == "K4p" \
            else (None, None, None, None)
        run = lambda: pi.streamed_join_packed_cuda(
            drv, drv, drv, drv, act, z, _flawed_twin(twin.packed, main_flaw), z,
            z, z, *d, cap=256)
    if flaw is None:
        with pytest.raises(_Launched):
            run()
    else:
        match = "16-byte alignment" if flaw == "start" else "multiple of 16 bytes"
        with pytest.raises(ValueError, match=match):
            run()
