"""The port's block codec and packed read path against the JAX package's.

Held exactly (integer arrays and docIDs throughout):

- the codec: the port's ``pack_flat_postings`` returns the reference's
  words, descriptors and ``chunk_rows`` (every width, TILE-edge sizes,
  multi-list arrays with ``span_blocks``, seeded random arrays), rejects
  the same layouts, and both of its decodes give back the raw array;
- carry-over: a reference twin carried over equals the port's own pack;
- the packed path: ``query_topk(codec="packed")`` on both port backends
  (the kernel backend runs K1p, K3p and K4p's plain versions here) equals
  the reference's ``codec="packed", backend="jnp"`` and the raw path, at
  windows 128, 1000, 2048, 4096 and delta fills 0, 0.5, 1.0, on the corpus
  and mutation writer of the reference's own codec tests; K1p, K3p and
  K4p's plain versions equal the raw plain versions; the packed writer's
  twins equal the reference writer's; ``sequential_reference`` at ns = 2;
  compaction re-packed through ``pack_index``; the codec's errors and the
  ``odys_index_bytes`` gauges.

The reference's Pallas packed modes do not run on the installed jax, so
its packed path is held through its jnp backend (the full-array decode).
"""
import numpy as np
import pytest
import torch

from repro.core import engine as ref_engine
from repro.core import index as ref_index
from repro.core import parallel as ref_parallel
from repro.data import corpus as ref_corpus
from repro.indexing import compaction as ref_compaction
from repro.indexing import delta as ref_delta
from repro.kernels.registry import synthetic_flat_index
from repro.obs import registry as ref_registry
from repro_torch.core import engine as pt_engine
from repro_torch.core import index as pt_index
from repro_torch.core import parallel as pt_parallel
from repro_torch.data import corpus as pt_corpus
from repro_torch.indexing import compaction as pt_compaction
from repro_torch.indexing import delta as pt_delta
from repro_torch.kernels import delta_merge as dm
from repro_torch.kernels import ops
from repro_torch.kernels import posting_intersect as pi
from repro_torch.obs import registry as pt_registry

BLOCK = pt_index.BLOCK
INV = int(pt_index.INVALID_DOC)
CFG = dict(n_docs=400, vocab_size=150, mean_doc_len=25, n_sites=10, seed=13)
QUERIES = [
    ([3], None), ([3, 9], None), ([1, 4, 12], None), ([2], 3), ([5, 8], 1),
    ([140], None), ([0, 7], 5),
]
WINDOWS = (128, 1000, 2048, 4096)
FILLS = (0.0, 0.5, 1.0)
ARRAYS = ("words", "blk_base", "blk_meta", "blk_woff")


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _flat_from_docs(docs) -> np.ndarray:
    """One list of ``docs`` from offset 0, INVALID fill to flat_tile_pad."""
    docs = np.asarray(docs, np.int32)
    flat = np.full(pt_index.flat_tile_pad(docs.size), INV, np.int32)
    flat[: docs.size] = docs
    return flat


def _assert_same_twin(got, want, ctx=""):
    for f in ARRAYS:
        g, w = _np(getattr(got, f)), _np(getattr(want, f))
        assert g.dtype == np.int32, (f, ctx)
        np.testing.assert_array_equal(g, w, err_msg=f"{f} {ctx}")
    assert got.chunk_rows == want.chunk_rows, ctx
    assert got.n_blocks == want.n_blocks, ctx


def _roundtrip(flat, **kw):
    """The port's pack equals the reference's; both port decodes give the
    array back."""
    pk = pt_index.pack_flat_postings(flat, device="cpu", **kw)
    _assert_same_twin(pk, ref_index.pack_flat_postings(flat, **kw))
    np.testing.assert_array_equal(pt_index.unpack_flat_postings(pk), flat)
    np.testing.assert_array_equal(
        pt_index.unpack_flat_postings_torch(pk).numpy(), flat)
    assert pk.padding().spare_tile_ok(pk.chunk_rows * BLOCK)
    assert pk.padding() == tuple(ref_index.pack_flat_postings(flat, **kw).padding())
    assert pk.words.shape[0] == pt_index.packed_word_pad(
        int(pk.blk_woff[-1]), pk.chunk_rows)
    assert pk.blk_woff[pk.n_blocks] == pk.blk_woff[-1]
    return pk


# ------------------------------------------------------------ the codec --
@pytest.mark.parametrize("width", pt_index.PACK_WIDTHS)
def test_width_selection_and_roundtrip(width):
    gap = 0 if width == 0 else min((1 << width) - 1, 70_000)
    docs = 7 + gap * np.arange(130, dtype=np.int64)      # two blocks
    pk = _roundtrip(_flat_from_docs(docs.astype(np.int32)))
    assert int(pk.blk_meta[0]) & 63 == width
    assert pt_index.PACK_WIDTHS == ref_index.PACK_WIDTHS
    assert pt_index.DESC_PAD == ref_index.DESC_PAD


@pytest.mark.parametrize("n", [0, 1, 127, 128, 129, 1023, 1024, 1025, 2047, 2048])
def test_tile_edge_sizes_roundtrip(n):
    rng = np.random.default_rng(n)
    docs = np.cumsum(rng.integers(1, 9, size=n)).astype(np.int32)
    pk = _roundtrip(_flat_from_docs(docs))
    assert pk.n_blocks == pt_index.flat_tile_pad(n) // BLOCK


def test_sign_bit_words_and_width32_roundtrip():
    """A field that sets its word's sign bit (width 16, lane 1's gap
    >= 2**15 at shift 16) and a width-32 block (a gap near 2**31) decode
    exactly."""
    gaps = np.ones(256, np.int64)
    gaps[1] = 40_000                    # block 0: width 16
    gaps[130] = 2**31 - 50_000          # block 1: width 32
    docs = np.cumsum(gaps)
    assert docs[-1] < 2**31 - 1
    pk = _roundtrip(_flat_from_docs(docs.astype(np.int32)))
    assert [int(m) & 63 for m in pk.blk_meta[:2]] == [16, 32]
    assert int(pk.words[0]) < 0         # the word's top bit is set


def test_multi_list_roundtrip_and_span_blocks():
    arrays, live = synthetic_flat_index((150, 100, 90, 0, 5))
    flat = arrays["postings"]
    pk8 = _roundtrip(flat)
    pk32 = _roundtrip(flat, span_blocks=32)
    assert pk32.chunk_rows >= pk8.chunk_rows
    offsets, lengths = arrays["offsets"], arrays["lengths"]
    assert pt_index.flat_live_extent(offsets, lengths) == live
    assert pt_index.padding_contract(offsets, lengths, flat.shape[0]) == tuple(
        ref_index.padding_contract(offsets, lengths, flat.shape[0]))


def test_pack_rejects_invalid_layouts():
    hole = _flat_from_docs(np.arange(10, dtype=np.int32))
    hole[4] = INV                      # a valid posting after an INVALID
    cases = (np.zeros(100, np.int32), hole,
             _flat_from_docs(np.array([9, 5, 1], np.int32)))
    for flat in cases:
        with pytest.raises(ValueError) as want:
            ref_index.pack_flat_postings(flat)
        with pytest.raises(ValueError) as got:
            pt_index.pack_flat_postings(flat, device="cpu")
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seed", range(12))
def test_roundtrip_property(seed):
    """Seeded random arrays: multi-list CSR layouts from the reference
    index build, or one list with gaps spanning every width."""
    rng = np.random.default_rng(seed)
    if seed % 2:
        lens = rng.integers(0, 260, size=rng.integers(1, 6))
        flat = synthetic_flat_index(tuple(int(x) for x in lens))[0]["postings"]
    else:
        n = int(rng.integers(0, 700))
        mags = rng.choice([1, 3, 15, 255, 65_535, 1 << 20], size=n)
        flat = _flat_from_docs(np.cumsum(rng.integers(0, mags + 1)).astype(np.int32))
    _roundtrip(flat, span_blocks=int(rng.choice([8, 16, 40])))


def test_pack_follows_the_tensor_device(monkeypatch):
    flat = _flat_from_docs(np.arange(0, 600, 3, dtype=np.int32))
    pk = pt_index.pack_flat_postings(torch.from_numpy(flat))
    assert pk.device == torch.device("cpu")
    moved = pk.to("meta")
    assert all(x.device.type == "meta" for x in moved.arrays())
    assert moved.chunk_rows == pk.chunk_rows
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt_index.pack_flat_postings(flat)


# ------------------------------------------------------------ carry-over --
def _carry_index(ridx):
    arrays = {f: np.asarray(getattr(ridx, f)) for f in pt_index.ShardedIndex._fields}
    return pt_index.index_from_numpy({**arrays, "packed": ridx.packed},
                                     device="cpu")


def _carry_delta(rdelta):
    arrays = {f: np.asarray(getattr(rdelta, f)) for f in pt_delta.ShardedDelta._fields}
    return pt_delta.delta_from_numpy({**arrays, "packed": rdelta.packed},
                                     device="cpu")


@pytest.fixture(scope="module")
def setup():
    rc = ref_corpus.generate_corpus(ref_corpus.CorpusConfig(**CFG))
    pc = pt_corpus.generate_corpus(pt_corpus.CorpusConfig(**CFG))
    ridx, meta = ref_index.build_index(rc, codec="packed")
    pidx, pmeta = pt_index.build_index(pc, codec="packed", device="cpu")
    rqb = ref_engine.make_query_batch(QUERIES, t_max=4, meta=meta)
    pqb = pt_engine.make_query_batch(QUERIES, t_max=4, meta=pmeta, device="cpu")
    writers = {fill: _writers_at_fill(rc, pc, meta, pmeta, fill) for fill in FILLS}
    return dict(rc=rc, pc=pc, ridx=ridx, pidx=pidx, meta=meta, pmeta=pmeta,
                rqb=rqb, pqb=pqb, writers=writers)


def _writers_at_fill(rc, pc, meta, pmeta, target, *, ns=1, cap=256, seed=5):
    """Packed reference and port writers taken through the same op stream
    (the reference codec tests' stream) until the hottest list sits at
    ``target`` fill: deletes and updates, then inserts."""
    rng = np.random.default_rng(seed)
    rw = ref_delta.DeltaWriter(rc, meta, ns, term_capacity=cap,
                               doc_headroom=1024, codec="packed")
    pw = pt_delta.DeltaWriter(pc, pmeta, ns, term_capacity=cap,
                              doc_headroom=1024, codec="packed", device="cpu")
    dead = [int(d) for d in rng.choice(rc.n_docs, 6, replace=False)]
    upd = [(int(d), np.unique(rng.integers(0, 40, size=10)), int(rng.integers(10)))
           for d in rng.choice(np.arange(200, 260), 6, replace=False)]
    for w in (rw, pw):
        w.delete_docs(dead)
        w.update_docs(upd)
    while rw.posting_fill() < target:
        doc = (np.unique(rng.integers(0, 24, size=20)), int(rng.integers(10)))
        rw.insert_docs([doc])
        pw.insert_docs([doc])
    assert pw.posting_fill() == rw.posting_fill()
    return rw, pw


def test_index_twin_equal_and_carried_over(setup):
    ridx, pidx = setup["ridx"], setup["pidx"]
    _assert_same_twin(pidx.packed, ridx.packed)
    carried = _carry_index(ridx)
    _assert_same_twin(carried.packed, pidx.packed)
    for f in pt_index.ShardedIndex._fields:
        assert torch.equal(getattr(carried, f), getattr(pidx, f)), f
    _assert_same_twin(pt_index.packed_from_numpy(
        {f: np.asarray(getattr(ridx.packed, f)) for f in ARRAYS}
        | {"chunk_rows": ridx.packed.chunk_rows}, device="cpu"), pidx.packed)
    raw, _ = pt_index.build_index(setup["pc"], device="cpu")
    assert raw.packed is None
    _assert_same_twin(pt_index.pack_index(raw).packed, pidx.packed)


@pytest.mark.parametrize("cap", [256, 384])
@pytest.mark.parametrize("ns", [1, 2])
def test_packed_writer_twins_match_reference(setup, ns, cap):
    rw, pw = _writers_at_fill(setup["rc"], setup["pc"], setup["meta"],
                              setup["pmeta"], 0.5, ns=ns, cap=cap)
    for rd, pd in zip(rw.shard_deltas(), pw.shard_deltas(), strict=True):
        _assert_same_twin(pd.packed, rd.packed, (ns, cap))
        np.testing.assert_array_equal(pd.postings.numpy(), np.asarray(rd.postings))
        _assert_same_twin(_carry_delta(rd).packed, pd.packed)
        assert pd.packed.chunk_rows == rd.packed.chunk_rows
    pw.delete_docs([3])
    rw.delete_docs([3])
    for rd, pd in zip(rw.shard_deltas(), pw.shard_deltas(), strict=True):
        _assert_same_twin(pd.packed, rd.packed, "after a delete")


# ------------------------------------------------------- packed read path --
def _assert_result(got, want, ctx=""):
    np.testing.assert_array_equal(_np(got[0]), _np(want[0]), err_msg=f"docids {ctx}")
    np.testing.assert_array_equal(_np(got[1]), _np(want[1]), err_msg=f"n_hits {ctx}")


@pytest.mark.parametrize("window", WINDOWS)
def test_packed_path_matches_reference(setup, window):
    """Static and at fills 0, 0.5, 1.0: the port's packed path on both
    backends equals the reference's packed jnp path and the raw path."""
    ridx, pidx, rqb, pqb = setup["ridx"], setup["pidx"], setup["rqb"], setup["pqb"]
    cases = [(None, None)] + [
        (rw.shard_deltas()[0], pw.shard_deltas()[0])
        for rw, pw in (setup["writers"][f] for f in FILLS)]
    for rdelta, pdelta in cases:
        ctx = (window, None if pdelta is None else int(pdelta.lengths.max()))
        want = ref_engine.query_topk(ridx, rqb, delta=rdelta, k=10, window=window,
                                     backend="jnp", codec="packed")
        for backend in ("torch", "kernel"):
            got = pt_engine.query_topk(pidx, pqb, delta=pdelta, k=10,
                                       window=window, backend=backend,
                                       codec="packed")
            _assert_result(got, want, (backend,) + ctx)
            raw = pt_engine.query_topk(pidx, pqb, delta=pdelta, k=10,
                                       window=window, backend=backend)
            _assert_result(raw, got, ("raw", backend) + ctx)


def test_kernel_backend_reads_no_raw_posting(setup):
    """With the raw postings zeroed, the packed kernel backend still
    answers as before (it reads only the twins)."""
    pidx, pqb = setup["pidx"], setup["pqb"]
    _, pw = setup["writers"][1.0]
    pdelta = pw.shard_deltas()[0]
    want = pt_engine.query_topk(pidx, pqb, delta=pdelta, k=10, window=1000,
                                backend="kernel", codec="packed")
    blind = pt_engine.query_topk(
        pidx._replace(postings=torch.zeros_like(pidx.postings)), pqb,
        delta=pdelta._replace(postings=torch.zeros_like(pdelta.postings)),
        k=10, window=1000, backend="kernel", codec="packed")
    _assert_result(blind, want)
    static = pt_engine.query_topk(
        pidx._replace(postings=torch.zeros_like(pidx.postings)), pqb, k=10,
        window=1000, backend="kernel", codec="packed")
    _assert_result(static, pt_engine.query_topk(pidx, pqb, k=10, window=1000,
                                                backend="kernel"))


# ---------------------------------------- plain versions: packed vs raw --
def _k1_inputs(idx, batch, window):
    src = pt_engine.StaticPostingSource(idx)
    _, d_terms, active = pt_engine._pick_drivers(src, batch)
    active = active.to(torch.int32)
    span = src.driver_span(d_terms, window)
    plan = pi.plan_driver_streamed(span.off, span.n_eff, batch.terms, active,
                                   idx.offsets, idx.lengths, idx.block_max,
                                   window=window)
    return span.off, span.n_eff, active, batch.attr_filter, plan


@pytest.mark.parametrize("window", [256, 1000, 1536])
def test_k1p_plain_matches_raw_plain(setup, window):
    pidx, pqb = setup["pidx"], setup["pqb"]
    off, neff, active, filt, plan = _k1_inputs(pidx, pqb, window)
    want = pi.driver_streamed_join_torch(off, neff, active, filt, pidx.postings,
                                         pidx.attrs, *plan, window=window)
    got = pi.driver_streamed_join_packed_torch(off, neff, active, filt,
                                               pidx.packed, pidx.attrs, *plan,
                                               window=window)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)
    via_ops = ops.intersect_fullstream(
        off, neff, pqb.terms, active, filt, torch.zeros_like(pidx.postings),
        pidx.attrs, pidx.offsets, pidx.lengths, pidx.block_max, window=window,
        packed=pidx.packed)
    for g, w in zip(via_ops, want, strict=True):
        assert torch.equal(g, w)


@pytest.mark.parametrize("fill", FILLS)
def test_k3p_k4p_plain_match_raw_plain(setup, fill):
    pidx, pqb = setup["pidx"], setup["pqb"]
    _, pw = setup["writers"][fill]
    delta = pw.shard_deltas()[0]
    cap = delta.term_capacity
    for window in (256, 1000):
        src = pt_engine.MergedPostingSource(pidx, delta)
        _, d_terms, active = pt_engine._pick_drivers(src, pqb)
        active = active.to(torch.int32)
        span = src.driver_span(d_terms, window)
        common = (pidx.attrs, span.off, span.n_eff)
        d_common = (delta.attrs, delta.offsets, delta.lengths, d_terms)
        want = dm.merge_delta_windows_torch(pidx.postings, *common,
                                            delta.postings, *d_common,
                                            window=window, cap=cap)
        got = dm.merge_delta_windows_packed_torch(pidx.packed, *common,
                                                  delta.packed, *d_common,
                                                  window=window, cap=cap)
        for g, w in zip(got, want, strict=True):
            assert torch.equal(g, w)
        docs, attrs, srcs = want
        flags = src.driver_flags(docs)
        live = src.driver_live(docs, srcs, flags)
        main, dplan, cap = pi.plan_streamed(
            docs, pqb.terms, active, pidx.offsets, pidx.lengths, pidx.block_max,
            delta.offsets, delta.lengths, delta.block_max)
        head = (docs, attrs, live, flags, active, pqb.attr_filter)
        want4 = pi.streamed_join_torch(*head, pidx.postings, *main,
                                       delta.postings, *dplan, cap=cap)
        got4 = pi.streamed_join_packed_torch(*head, pidx.packed, *main,
                                             delta.packed, *dplan, cap=cap)
        assert torch.equal(got4, want4)


def test_packed_modes_go_together(setup):
    pidx, pqb = setup["pidx"], setup["pqb"]
    delta = setup["writers"][0.5][1].shard_deltas()[0]
    args = (pidx.postings, pidx.attrs, pidx.offsets[:2], pidx.lengths[:2],
            delta.postings, delta.attrs, delta.offsets, delta.lengths,
            delta.block_max, torch.tensor([3, 9], dtype=torch.int32))
    with pytest.raises(ValueError, match="go together"):
        ops.merge_windows(*args, window=256, packed=pidx.packed)
    with pytest.raises(ValueError, match="go together"):
        ops.merge_windows(*args, window=256, d_packed=delta.packed)
    docs = torch.full((2, 256), INV, dtype=torch.int32)
    with pytest.raises(ValueError, match="d_packed"):
        ops.intersect_streamed(
            docs, docs, docs, pqb.terms[:2], pqb.terms[:2] * 0, pqb.attr_filter[:2],
            pidx.postings, pidx.offsets, pidx.lengths, pidx.block_max,
            delta.postings, delta.offsets, delta.lengths, delta.block_max,
            docs * 0, packed=pidx.packed)


def test_k3p_row_and_cuda_wrappers_refuse_cpu(setup):
    """K3p's decode row covers a window and a slab that start inside a
    block; the CUDA wrappers take only CUDA tensors."""
    for window, cap in ((4096, 256), (1000, 384), (1, 128)):
        m_room, row = dm.k3p_row(window, cap)
        assert m_room >= -(-(BLOCK - 1 + window) // BLOCK) * BLOCK
        assert row - m_room >= -(-(BLOCK - 1 + cap) // BLOCK) * BLOCK
    pidx, pqb = setup["pidx"], setup["pqb"]
    off, neff, active, filt, plan = _k1_inputs(pidx, pqb, 256)
    with pytest.raises(ValueError, match="CUDA"):
        pi.driver_streamed_join_packed_cuda(off, neff, active, filt, pidx.packed,
                                            pidx.attrs, *plan, window=256)


# -------------------------------------------- distributed and compaction --
@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_sequential_reference_packed_ns2(setup, backend):
    rc, pc, meta, pmeta = setup["rc"], setup["pc"], setup["meta"], setup["pmeta"]
    ns = 2
    rw, pw = _writers_at_fill(rc, pc, meta, pmeta, 0.5, ns=ns)
    rshards = [ref_index.pack_index(ref_index.build_index(p)[0])
               for p in ref_index.partition_corpus(rc, ns)]
    pshards = [pt_index.pack_index(pt_index.build_index(p, device="cpu")[0])
               for p in pt_index.partition_corpus(pc, ns)]
    for r, p in zip(rshards, pshards, strict=True):
        _assert_same_twin(p.packed, r.packed)
    kw = dict(ns=ns, k=10, window=1024)
    want = ref_parallel.sequential_reference(
        rshards, setup["rqb"], deltas=rw.shard_deltas(), backend="jnp",
        codec="packed", **kw)
    got = pt_parallel.sequential_reference(
        pshards, setup["pqb"], deltas=pw.shard_deltas(), backend=backend,
        codec="packed", **kw)
    _assert_result(got, want)
    raw = pt_parallel.sequential_reference(
        pshards, setup["pqb"], deltas=pw.shard_deltas(), backend=backend, **kw)
    _assert_result(raw, got)


def test_compaction_repack_equals_raw_rebuild(setup):
    rc, pc, meta, pmeta = setup["rc"], setup["pc"], setup["meta"], setup["pmeta"]
    rw, pw = _writers_at_fill(rc, pc, meta, pmeta, 1.0)
    mutated = pw.mutated_corpus()
    new_sharded, _ = pt_compaction.compact(pw, verify=True)
    compacted = pt_index.pack_index(new_sharded.shard(0))
    ref_sharded, _ = ref_compaction.compact(rw, verify=False)
    _assert_same_twin(compacted.packed, ref_index.pack_index(
        ref_index.InvertedIndex(*(x[0] for x in ref_sharded))).packed)
    rebuilt, _ = pt_index.build_index(mutated, device="cpu")
    want = pt_engine.query_topk(rebuilt, setup["pqb"], k=10, window=1024,
                                backend="torch")
    for backend in ("torch", "kernel"):
        got = pt_engine.query_topk(compacted, setup["pqb"], k=10, window=1024,
                                   backend=backend, codec="packed")
        _assert_result(got, want, backend)
    # the rebased packed writer packs its next version again
    pw.insert_docs([([1, 2], 0)])
    view = pw.shard_deltas()[0]
    assert torch.equal(pt_index.unpack_flat_postings_torch(view.packed),
                       view.postings)


# ----------------------------------------------------- errors and gauges --
def test_codec_validation_matches_reference(setup):
    rc, pc, meta, pmeta = setup["rc"], setup["pc"], setup["meta"], setup["pmeta"]
    ridx_raw, _ = ref_index.build_index(rc)
    pidx_raw, _ = pt_index.build_index(pc, device="cpu")
    rw, pw = _writers_at_fill(rc, pc, meta, pmeta, 0.0)
    rd_raw = rw.shard_deltas()[0]._replace(packed=None)
    pd_raw = pw.shard_deltas()[0]._replace(packed=None)
    cases = [
        (dict(codec="zstd"), setup["ridx"], setup["pidx"], None, None),
        (dict(codec="packed"), ridx_raw, pidx_raw, None, None),
        (dict(codec="packed"), setup["ridx"], setup["pidx"], rd_raw, pd_raw),
    ]
    for kw, ridx, pidx, rd, pd in cases:
        with pytest.raises(ValueError) as want:
            ref_engine.query_topk(ridx, setup["rqb"], delta=rd, k=10,
                                  window=1024, **kw)
        for backend in ("torch", "kernel"):
            with pytest.raises(ValueError) as got:
                pt_engine.query_topk(pidx, setup["pqb"], delta=pd, k=10,
                                     window=1024, backend=backend, **kw)
            assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="codec"):
        pt_index.build_index(pc, codec="zip", device="cpu")
    with pytest.raises(ValueError, match="codec"):
        pt_parallel.sequential_reference([pidx_raw], setup["pqb"], ns=1, k=10,
                                         window=1024, codec="packed")


def _gauges(collected):
    return {(labels["layout"], labels["kind"]): inst.value
            for name, _k, _h, series in collected if name == "odys_index_bytes"
            for labels, inst in series}


def test_index_bytes_gauges_match_reference(setup):
    rc, pc, meta, pmeta = setup["rc"], setup["pc"], setup["meta"], setup["pmeta"]
    r_prev = ref_registry.set_registry(ref_registry.MetricsRegistry())
    p_prev = pt_registry.set_registry(pt_registry.MetricsRegistry())
    try:
        ref_index.build_index(rc, codec="packed")
        pt_index.build_index(pc, codec="packed", device="cpu")
        rw, pw = _writers_at_fill(rc, pc, meta, pmeta, 0.5, ns=2)
        rw.shard_deltas()
        pw.shard_deltas()
        want = _gauges(ref_registry.get_registry().collect())
        got = _gauges(pt_registry.get_registry().collect())
    finally:
        ref_registry.set_registry(r_prev)
        pt_registry.set_registry(p_prev)
    assert set(want) == {("raw", "main"), ("packed", "main"),
                         ("raw", "delta"), ("packed", "delta")}
    assert got == want
    assert got[("raw", "main")] > got[("packed", "main")] > 0
