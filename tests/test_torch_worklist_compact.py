"""Work-list compaction in the port (``backend="kernel_compact"``) against
the JAX package, on the shapes of the reference's own compaction tests.

Held exactly:

- the builders: the port's tables equal ``repro.kernels.worklist``'s row
  for row, padding included, on random plans and on the plans of the
  reference's own orchestrators (whose Pallas launches are replaced by a
  capture here, since they do not run on the installed jax); the port's
  plans equal the reference's ``_driver_plan`` and ``_streamed_plan``;
  the builder invariants of the reference's tests; the occupancy gauge
  and steps-saved counter equal the reference's;
- the plain versions of K6, K7 and K8 (raw and packed), which execute the
  table, against the dense plain K1, K4 and K3 on live rows, with inert
  rows as the reference gives them;
- ``query_topk(backend="kernel_compact")`` against the reference's
  ``backend="jnp"`` at delta fills 0, 0.5 and 1.0 and without a delta, on
  both codecs and the three strategies; the ns = 2 striped
  ``sequential_reference`` against a rebuild; a partial batch with
  ``live_q``; an all-inert batch calls no kernel and no plain version;
  ``live_q`` on another backend raises.

The reference's Pallas compact path cannot be the oracle here (it needs
``pl.unblocked``, which the installed jax lacks), so the end-to-end oracle
is its jnp path.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import engine as ref_engine
from repro.core import index as ref_index
from repro.core import parallel as ref_parallel
from repro.data import corpus as ref_corpus
from repro.indexing import delta as ref_delta
from repro.kernels import delta_merge as ref_dm
from repro.kernels import posting_intersect as ref_pi
from repro.kernels import worklist as ref_wl
from repro.obs import registry as ref_registry
from repro_torch.core import engine as pt_engine
from repro_torch.core import index as pt_index
from repro_torch.core import parallel as pt_parallel
from repro_torch.indexing import delta as pt_delta
from repro_torch.kernels import delta_merge as dm
from repro_torch.kernels import ops
from repro_torch.kernels import posting_intersect as pi
from repro_torch.kernels import worklist as wl
from repro_torch.obs import registry as pt_registry

INV = int(pt_index.INVALID_DOC)
INV_ATTR = int(pt_index.INVALID_ATTR)
WINDOW = 1024
CFG = dict(n_docs=400, vocab_size=150, mean_doc_len=25, n_sites=10, seed=13)
# the reference compaction tests' queries: 1..4 terms, limited searches and
# a rare term
QUERIES = [
    ([3], None),
    ([3, 9], None),
    ([1, 4, 12], None),
    ([1, 4, 12, 23], None),
    ([2], 3),
    ([5, 8], 1),
    ([140], None),
    ([0, 7], 5),
]
FILLS = (0.0, 0.5, 1.0)
LIVE = {
    "all": None,
    "tail": np.array([True] * 5 + [False] * 3),
    "one": np.eye(len(QUERIES), dtype=bool)[2],
    "alternate": np.arange(len(QUERIES)) % 2 == 0,
}
KERNEL_NAMES = ("intersect_batched_driver_streamed_compact",
                "intersect_batched_streamed_compact",
                "merge_delta_windows_compact")


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _carry_index(ridx):
    arrays = {f: np.asarray(getattr(ridx, f)) for f in pt_index.ShardedIndex._fields}
    return pt_index.index_from_numpy({**arrays, "packed": ridx.packed},
                                     device="cpu")


def _carry_delta(rdelta):
    arrays = {f: np.asarray(getattr(rdelta, f)) for f in pt_delta.ShardedDelta._fields}
    return pt_delta.delta_from_numpy({**arrays, "packed": rdelta.packed},
                                     device="cpu")


def _writer_at_fill(corpus, meta, target, *, ns=1, seed=5, codec="packed"):
    """The reference tests' delta stream: deletes and updates (tombstones of
    both kinds), then inserts until the hottest list is at ``target``."""
    rng = np.random.default_rng(seed)
    w = ref_delta.DeltaWriter(corpus, meta, ns, term_capacity=256,
                              doc_headroom=1024, codec=codec)
    w.delete_docs([int(d) for d in rng.choice(corpus.n_docs, 6, replace=False)])
    w.update_docs([
        (int(d), np.unique(rng.integers(0, 40, size=10)), int(rng.integers(10)))
        for d in rng.choice(np.arange(200, 260), 6, replace=False)
    ])
    while w.posting_fill() < target:
        terms = np.unique(rng.integers(0, 24, size=20))
        w.insert_docs([(terms, int(rng.integers(10)))])
    return w


@pytest.fixture(scope="module")
def setup():
    corpus = ref_corpus.generate_corpus(ref_corpus.CorpusConfig(**CFG))
    ridx, meta = ref_index.build_index(corpus, codec="packed")
    deltas = {}
    for fill in FILLS:
        rdelta = _writer_at_fill(corpus, meta, fill).shard_deltas()[0]
        deltas[fill] = (rdelta, _carry_delta(rdelta))
    deltas[None] = (None, None)
    return dict(corpus=corpus, ridx=ridx, pidx=_carry_index(ridx), meta=meta,
                deltas=deltas)


def _batches(queries, meta, strategy="embed"):
    return (ref_engine.make_query_batch(queries, t_max=4, meta=meta,
                                        strategy=strategy),
            pt_engine.make_query_batch(queries, t_max=4, meta=meta,
                                       strategy=strategy, device="cpu"))


def _assert_rows(got, want, rows, ctx=""):
    """docids and n_hits equal on ``rows``; elsewhere INVALID_DOC and 0."""
    rows = np.ones(len(_np(got[1])), bool) if rows is None else rows
    for g, w, what in zip(got, want, ("docids", "n_hits")):
        np.testing.assert_array_equal(_np(g)[rows], _np(w)[rows],
                                      err_msg=f"{what} {ctx}")
    assert (_np(got[0])[~rows] == INV).all(), ctx
    assert (_np(got[1])[~rows] == 0).all(), ctx


# ----------------------------------------------------------- the builders --
def test_worklist_pad_and_layout_match_reference():
    assert [wl.worklist_pad(n) for n in range(300)] == [
        ref_wl.worklist_pad(n) for n in range(300)]
    for name in ("DESC_COLS", "FLAG_FIRST", "FLAG_TERM_START", "FLAG_TERM_END",
                 "FLAG_LAST"):
        assert getattr(wl, name) == getattr(ref_wl, name), name


def _random_plan(rng):
    q_n, t_n, num_a = (int(x) for x in rng.integers(1, 7, size=3))
    shape = (q_n, t_n, num_a)
    n_b = rng.integers(0, 4, shape) * (rng.random(shape) < 0.7)
    plan = dict(n_b=n_b.astype(np.int32),
                b_tile=rng.integers(0, 60, shape).astype(np.int32),
                active=(rng.random((q_n, t_n)) < 0.6).astype(np.int32),
                a_any=rng.random((q_n, num_a)) < 0.8)
    return plan, q_n


@pytest.mark.parametrize("seed", range(12))
def test_builders_equal_reference_on_random_plans(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        plan, q_n = _random_plan(rng)
        kw = dict(live_q=None if rng.random() < 0.3 else rng.random(q_n) < 0.6,
                  kernel="t", dense_steps=int(rng.integers(1, 500)))
        if rng.random() < 0.5:
            shape = plan["n_b"].shape
            kw["n_d"] = (rng.integers(0, 3, shape)
                         * (rng.random(shape) < 0.5)).astype(np.int32)
            kw["d_tile"] = rng.integers(0, 9, shape).astype(np.int32)
        got = wl.build_intersect_worklist(**plan, **kw)
        want = ref_wl.build_intersect_worklist(**plan, **kw)
        assert got.n_items == want.n_items and got.dense_steps == want.dense_steps
        assert got.desc.dtype == np.int32
        np.testing.assert_array_equal(got.desc, want.desc)
        m_neff = rng.integers(0, 5000, q_n)
        s_w = int(rng.integers(1, 6))
        mkw = dict(tile=pt_index.TILE, s_w=s_w, live_q=kw["live_q"], kernel="m",
                   dense_steps=q_n * s_w)
        got = wl.build_merge_worklist(m_neff, **mkw)
        want = ref_wl.build_merge_worklist(m_neff, **mkw)
        assert got.n_items == want.n_items
        np.testing.assert_array_equal(got.desc, want.desc)


def test_intersect_builder_grouping_flags_and_padding():
    # 2 queries x 2 driver tiles x 2 term slots; query 1 has one term.
    n_b = np.array([[[2, 1], [1, 0]],
                    [[3, 0], [0, 0]]], np.int32)
    active = np.array([[1, 1], [1, 0]], np.int32)
    a_any = np.array([[True, True], [True, False]])
    w = wl.build_intersect_worklist(n_b, np.zeros_like(n_b), active, a_any,
                                    kernel="t", dense_steps=24)
    desc = w.desc
    assert desc.shape == (wl.worklist_pad(w.n_items), wl.DESC_COLS)
    live = desc[: w.n_items]
    keys = [tuple(r[:2]) for r in live]
    assert keys == sorted(keys)
    for q, i in sorted(set(keys)):
        grp = [r for r in live if (r[0], r[1]) == (q, i)]
        assert grp[0][4] & wl.FLAG_FIRST and grp[-1][4] & wl.FLAG_LAST
        starts = [r[2] for r in grp if r[4] & wl.FLAG_TERM_START]
        assert starts == [r[2] for r in grp if r[4] & wl.FLAG_TERM_END]
    # q0/i0: term 0 probes tiles 0, 1, then term 1 tile 0
    g = [r for r in live if (r[0], r[1]) == (0, 0)]
    assert [(r[2], r[3]) for r in g] == [(0, 0), (0, 1), (1, 0)]
    # q0/i1: term 1's span is empty -> one dead-term item
    g = [r for r in live if (r[0], r[1]) == (0, 1)]
    assert len(g) == 1 and g[0][3] == -1 and g[0][4] == (
        wl.FLAG_FIRST | wl.FLAG_TERM_START | wl.FLAG_TERM_END | wl.FLAG_LAST)
    # q1/i1: dead driver tile -> one init+finalize item
    g = [r for r in live if (r[0], r[1]) == (1, 1)]
    assert len(g) == 1 and g[0][4] == wl.FLAG_FIRST | wl.FLAG_LAST
    # padding clones the last item with probes -1 and flags 0
    for r in desc[w.n_items:]:
        assert (r[0], r[1]) == tuple(desc[w.n_items - 1][:2])
        assert r[3] == -1 and r[5] == -1 and r[4] == 0
    # the group heads the kernels take: one per (q, i), then n_items
    heads = w.group_heads()
    assert heads.dtype == np.int32
    assert heads.tolist() == [k for k, r in enumerate(live)
                              if r[4] & wl.FLAG_FIRST] + [w.n_items]
    assert len(heads) - 1 == len(set(keys))


def test_intersect_builder_live_q_and_occupancy_metrics():
    reg = pt_registry.MetricsRegistry()
    prev = pt_registry.set_registry(reg)
    try:
        n_b = np.ones((3, 2, 1), np.int32)
        w = wl.build_intersect_worklist(
            n_b, np.zeros_like(n_b), np.ones((3, 2), np.int32),
            np.ones((3, 1), bool), live_q=np.array([True, False, True]),
            kernel="t", dense_steps=12)
        assert {int(q) for q in w.desc[: w.n_items, 0]} == {0, 2}
        assert w.n_items == 4 and w.dense_steps == 12
        assert w.occupancy == pytest.approx(4 / 12)
        assert reg.gauge("odys_kernel_grid_occupancy", kernel="t").value == \
            pytest.approx(4 / 12)
        assert reg.counter("odys_kernel_steps_saved_total", kernel="t").value == 8
    finally:
        pt_registry.set_registry(prev)


def test_merge_builder_tiles_and_empty():
    m_neff = np.array([2500, 0, 900], np.int32)
    w = wl.build_merge_worklist(m_neff, tile=1024, s_w=2, kernel="t",
                                dense_steps=6)
    live = w.desc[: w.n_items]
    assert [(r[0], r[1]) for r in live] == [(0, 0), (0, 1), (1, 0), (2, 0)]
    assert live[0][4] == wl.FLAG_FIRST and live[1][4] == wl.FLAG_LAST
    assert live[2][4] == wl.FLAG_FIRST | wl.FLAG_LAST
    assert w.group_heads().tolist() == [0, 2, 3, 4]
    w0 = wl.build_merge_worklist(m_neff, tile=1024, s_w=2,
                                 live_q=np.zeros(3, bool), kernel="t",
                                 dense_steps=6)
    assert w0.n_items == 0 and w0.occupancy == 0.0
    assert (w0.desc[:, 3] == -1).all() and (w0.desc[:, 5] == -1).all()


def test_host_pull_and_upload():
    x = torch.arange(12, dtype=torch.int32).view(3, 4)
    y = torch.tensor([[True, False]])
    hx, hy = wl.plan_to_host(x, y)
    np.testing.assert_array_equal(hx, x.numpy())
    np.testing.assert_array_equal(hy, y.numpy().astype(np.int32))
    w = wl.build_merge_worklist(np.array([3000, 10]), tile=1024, s_w=4,
                                kernel="t", dense_steps=8)
    desc, heads = wl.table_to_device(w, "cpu")
    np.testing.assert_array_equal(desc.numpy(), w.desc)
    np.testing.assert_array_equal(heads.numpy(), w.group_heads())
    assert desc.is_contiguous() and heads.is_contiguous()
    assert wl.live_rows(None, 3) is None
    np.testing.assert_array_equal(wl.live_rows(torch.tensor([1, 0, 1]), 3),
                                  [True, False, True])
    with pytest.raises(ValueError, match="live_q"):
        wl.live_rows([True, False], 3)


# -------------------------------------------------- plans and tables ------
def _prelude(pidx, pdelta, pqb, window):
    """What the kernel path hands the kernels: driver terms, active slots,
    the main driver span and the (``embed``) attribute filter."""
    source = pt_engine.make_posting_source(pidx, pdelta)
    _, d_terms, active = pt_engine._pick_drivers(source, pqb)
    span = source.driver_span(d_terms, window)
    return source, d_terms, active.to(torch.int32), span, pqb.attr_filter


def _j(x):
    return jnp.asarray(_np(x))


@pytest.mark.parametrize("window", [WINDOW, 256, 1000])
def test_plans_equal_reference(setup, window):
    """K6's and K7's plans, ``a_any`` included, equal the reference's
    ``_driver_plan`` and ``_streamed_plan`` (jnp) on the same inputs."""
    ridx, pidx = setup["ridx"], setup["pidx"]
    _, pqb = _batches(QUERIES, setup["meta"])
    rdelta, pdelta = setup["deltas"][0.5]
    _, d_terms, active, span, _ = _prelude(pidx, None, pqb, window)
    got = pi._driver_plan(span.off, span.n_eff, pqb.terms, active, pidx.offsets,
                          pidx.lengths, pidx.block_max, window=window)
    num_a = -(-window // pt_index.TILE)
    want = ref_pi._driver_plan(
        _j(span.off), _j(span.n_eff), _j(pqb.terms), ridx.offsets, ridx.lengths,
        ridx.block_max, window=window, num_a=num_a, s_tiles=num_a + 1)
    act = active.numpy()[:, :, None]
    for g, w, name in zip(got, want, ("a_any", "b_tile", "n_b", "bounds")):
        w = np.asarray(w) * act if name == "n_b" else np.asarray(w)
        np.testing.assert_array_equal(_np(g), w, err_msg=name)
    # K7's plans over a materialized (merged) driver window
    docs = torch.from_numpy(np.sort(np.random.default_rng(window).choice(
        400, (len(QUERIES), window))).astype(np.int32))
    docs[:, window // 2:] = INV
    a_any, main, delta, cap = pi._streamed_plans(
        docs, pqb.terms, active, pidx.offsets, pidx.lengths, pidx.block_max,
        pdelta.offsets, pdelta.lengths, pdelta.block_max)
    for width, offs, plan, src in ((window, "", main, ridx),
                                   (cap, "d_", delta, rdelta)):
        want = ref_pi._streamed_plan(
            _j(docs), _j(pqb.terms), src.offsets, src.lengths, src.block_max,
            window=width, s_tiles=-(-width // pt_index.TILE) + 1)
        np.testing.assert_array_equal(a_any.numpy(), np.asarray(want[0]))
        for g, w, name in zip(plan, want[1:], ("b_tile", "n_b", "bounds")):
            w = np.asarray(w) * act if name == "n_b" else np.asarray(w)
            np.testing.assert_array_equal(_np(g), w, err_msg=offs + name)


class _Capture:
    """Stands in for a launch: records the descriptor table it was given
    and returns ``result``."""

    def __init__(self, result=None, call=None):
        self.tables, self.result, self.call = [], result, call

    def __call__(self, desc, *args, **kw):
        self.tables.append(_np(desc).copy())
        return self.call(desc, *args, **kw) if self.call else self.result


def _gauges(reg, name):
    return {labels["kernel"]: m.value for n, _, _, series in reg.collect()
            if n == name for labels, m in series}


@pytest.mark.parametrize("fill", [0.5, 1.0])
@pytest.mark.parametrize("live", list(LIVE))
def test_tables_and_metrics_equal_reference(setup, monkeypatch, fill, live):
    """The reference's own compact orchestrators, run up to their Pallas
    launch on the same inputs, build the same descriptor tables as the
    port's, and emit the same occupancy gauge and steps-saved counter."""
    ridx, pidx = setup["ridx"], setup["pidx"]
    rdelta, pdelta = setup["deltas"][fill]
    _, pqb = _batches(QUERIES, setup["meta"])
    live_q = LIVE[live]
    q_n = len(QUERIES)
    ref_cap = {n: _Capture() for n in ("drv", "str", "mrg")}
    monkeypatch.setattr(ref_pi, "_driver_compact_call", ref_cap["drv"])
    monkeypatch.setattr(ref_pi, "_streamed_compact_call", ref_cap["str"])
    monkeypatch.setattr(ref_dm, "_merge_compact_call", ref_cap["mrg"])
    pt_cap = {"drv": _Capture(call=pi.driver_compact_join),
              "str": _Capture(call=pi.streamed_compact_join),
              "mrg": _Capture(call=dm.merge_compact_torch)}
    monkeypatch.setattr(pi, "driver_compact_join", pt_cap["drv"])
    monkeypatch.setattr(pi, "streamed_compact_join", pt_cap["str"])
    monkeypatch.setattr(dm, "merge_compact_torch", pt_cap["mrg"])
    regs = ref_registry.MetricsRegistry(), pt_registry.MetricsRegistry()
    prev = ref_registry.set_registry(regs[0]), pt_registry.set_registry(regs[1])
    try:
        # static: K6
        _, d_terms, active, span, kf = _prelude(pidx, None, pqb, WINDOW)
        base = (pqb.terms, active, kf)
        ref_pi.intersect_batched_driver_streamed_compact(
            *(_j(x) for x in (span.off, span.n_eff) + base), ridx.postings,
            ridx.attrs, ridx.offsets, ridx.lengths, ridx.block_max,
            window=WINDOW, live_q=live_q)
        ops.intersect_fullstream_compact(
            span.off, span.n_eff, *base, pidx.postings, pidx.attrs,
            pidx.offsets, pidx.lengths, pidx.block_max, window=WINDOW,
            live_q=live_q)
        # merge-on-read: K8, then K7 over the port's merged window
        source, d_terms, active, span, kf = _prelude(pidx, pdelta, pqb, WINDOW)
        d_args = (rdelta.postings, rdelta.attrs, rdelta.offsets, rdelta.lengths,
                  rdelta.block_max)
        ref_dm.merge_delta_windows_compact(
            ridx.postings, ridx.attrs, _j(span.off), _j(span.n_eff), *d_args,
            _j(d_terms), window=WINDOW, live_q=live_q)
        docs, attrs, src = ops.merge_windows_compact(
            pidx.postings, pidx.attrs, span.off, span.n_eff, pdelta.postings,
            pdelta.attrs, pdelta.offsets, pdelta.lengths, pdelta.block_max,
            d_terms, window=WINDOW, live_q=live_q)
        flags = source.driver_flags(docs)
        alive = source.driver_live(docs, src, flags)
        ref_pi.intersect_batched_streamed_compact(
            _j(docs), _j(attrs), _j(alive), _j(pqb.terms), _j(active), _j(kf),
            ridx.postings, ridx.offsets, ridx.lengths, ridx.block_max,
            rdelta.postings, rdelta.offsets, rdelta.lengths, rdelta.block_max,
            _j(flags), live_q=live_q)
        ops.intersect_streamed_compact(
            docs, attrs, alive, pqb.terms, active, kf, pidx.postings,
            pidx.offsets, pidx.lengths, pidx.block_max, pdelta.postings,
            pdelta.offsets, pdelta.lengths, pdelta.block_max, flags,
            live_q=live_q)
    finally:
        ref_registry.set_registry(prev[0])
        pt_registry.set_registry(prev[1])
    for name in ref_cap:
        assert len(ref_cap[name].tables) == len(pt_cap[name].tables) == 1, name
        np.testing.assert_array_equal(pt_cap[name].tables[0],
                                      ref_cap[name].tables[0], err_msg=name)
    for metric in ("odys_kernel_grid_occupancy", "odys_kernel_steps_saved_total"):
        want, got = _gauges(regs[0], metric), _gauges(regs[1], metric)
        assert set(got) == set(KERNEL_NAMES) and got == want, metric
    n_live = q_n if live_q is None else int(live_q.sum())
    assert _gauges(regs[1], "odys_kernel_grid_occupancy")[
        "merge_delta_windows_compact"] > 0 or n_live == 0


# -------------------------------------------- plain versions vs dense ------
def _k1_dense(pidx, pqb, window, packed):
    _, _, active, span, kf = _prelude(pidx, None, pqb, window)
    plan = pi.plan_driver_streamed(span.off, span.n_eff, pqb.terms, active,
                                   pidx.offsets, pidx.lengths, pidx.block_max,
                                   window=window)
    want = pi.driver_streamed_join_torch(span.off, span.n_eff, active, kf,
                                         pidx.postings, pidx.attrs, *plan,
                                         window=window)
    return span, active, kf, want


@pytest.mark.parametrize("codec", ["raw", "packed"])
@pytest.mark.parametrize("window", [WINDOW, 256, 2500])
def test_k6_plain_matches_dense_k1(setup, monkeypatch, codec, window):
    pidx = setup["pidx"]
    _, pqb = _batches(QUERIES, setup["meta"])
    span, active, kf, (docs, mask) = _k1_dense(pidx, pqb, window, codec)
    packed = pidx.packed if codec == "packed" else None
    postings = pidx.postings if packed is None else torch.zeros_like(pidx.postings)
    seen = []
    name = "driver_compact_join" + ("" if packed is None else "_packed")
    real = getattr(pi, name)
    monkeypatch.setattr(pi, name, lambda *a, **k: seen.append(1) or real(*a, **k))
    for live, live_q in LIVE.items():
        got_d, got_m = ops.intersect_fullstream_compact(
            span.off, span.n_eff, pqb.terms, active, kf, postings, pidx.attrs,
            pidx.offsets, pidx.lengths, pidx.block_max, window=window,
            packed=packed, live_q=live_q)
        rows = np.ones(len(QUERIES), bool) if live_q is None else live_q
        assert torch.equal(got_d[rows], docs[rows]), live
        assert torch.equal(got_m[rows], mask[rows]), live
        assert (got_d[~rows] == INV).all() and (got_m[~rows] == 0).all(), live
    assert len(seen) == len(LIVE)
    assert int(mask.sum()) > 0


def _k3_k4_dense(pidx, pdelta, pqb, window):
    source, d_terms, active, span, kf = _prelude(pidx, pdelta, pqb, window)
    cap = pdelta.term_capacity
    k3 = (pidx.postings, pidx.attrs, span.off, span.n_eff, pdelta.postings,
          pdelta.attrs, pdelta.offsets, pdelta.lengths, d_terms)
    merged = dm.merge_delta_windows_torch(*k3, window=window, cap=cap)
    docs, attrs, src = merged
    flags = source.driver_flags(docs)
    alive = source.driver_live(docs, src, flags)
    main, dplan, cap = pi.plan_streamed(
        docs, pqb.terms, active, pidx.offsets, pidx.lengths, pidx.block_max,
        pdelta.offsets, pdelta.lengths, pdelta.block_max)
    mask = pi.streamed_join_torch(docs, attrs, alive, flags, active, kf,
                                  pidx.postings, *main, pdelta.postings, *dplan,
                                  cap=cap)
    return span, d_terms, active, kf, merged, (docs, attrs, alive, flags), mask


@pytest.mark.parametrize("codec", ["raw", "packed"])
@pytest.mark.parametrize("fill", FILLS)
def test_k8_k7_plain_match_dense_k3_k4(setup, codec, fill):
    pidx = setup["pidx"]
    _, pdelta = setup["deltas"][fill]
    _, pqb = _batches(QUERIES, setup["meta"])
    packed = pidx.packed if codec == "packed" else None
    d_packed = pdelta.packed if codec == "packed" else None
    # the packed modes read no raw posting
    m_post, d_post = ((pidx.postings, pdelta.postings) if packed is None else
                      (torch.zeros_like(pidx.postings),
                       torch.zeros_like(pdelta.postings)))
    for window in (WINDOW, 256, 1000):
        span, d_terms, active, kf, merged, drv, mask = _k3_k4_dense(
            pidx, pdelta, pqb, window)
        for live, live_q in LIVE.items():
            rows = np.ones(len(QUERIES), bool) if live_q is None else live_q
            got = ops.merge_windows_compact(
                m_post, pidx.attrs, span.off, span.n_eff, d_post, pdelta.attrs,
                pdelta.offsets, pdelta.lengths, pdelta.block_max, d_terms,
                window=window, packed=packed, d_packed=d_packed, live_q=live_q)
            for g, w, inert in zip(got, merged, (INV, INV_ATTR, 1)):
                assert torch.equal(g[rows], w[rows]), (window, live)
                assert (g[~rows] == inert).all(), (window, live)
            got_m = ops.intersect_streamed_compact(
                *drv[:3], pqb.terms, active, kf, m_post, pidx.offsets,
                pidx.lengths, pidx.block_max, d_post, pdelta.offsets,
                pdelta.lengths, pdelta.block_max, drv[3], packed=packed,
                d_packed=d_packed, live_q=live_q)
            assert torch.equal(got_m[rows], mask[rows]), (window, live)
            assert (got_m[~rows] == 0).all(), (window, live)
        assert int(mask.sum()) > 0


def test_plain_versions_execute_the_table(setup):
    """The plain versions follow the table, not the dense plan: a table
    whose only live group is one (query, tile) writes that row alone, and
    a group whose term run names no tile masks everything."""
    pidx = setup["pidx"]
    _, pqb = _batches(QUERIES, setup["meta"])
    span, active, kf, (docs, mask) = _k1_dense(pidx, pqb, WINDOW, "raw")
    q = int(np.flatnonzero(mask.sum(1).numpy() > 0)[0])
    # FIRST|LAST only: validity and the filter, no join
    desc = torch.tensor([[q, 0, 0, -1, wl.FLAG_FIRST | wl.FLAG_LAST, -1, 0, 0],
                         [q, 0, 0, -1, 0, -1, 0, 0]], dtype=torch.int32)
    heads = torch.tensor([0, 1], dtype=torch.int32)
    bounds = pi.plan_driver_streamed(
        span.off, span.n_eff, pqb.terms, active, pidx.offsets, pidx.lengths,
        pidx.block_max, window=WINDOW)[2]
    args = (span.off, span.n_eff, kf, pidx.postings, pidx.attrs, bounds)
    d, m = pi.driver_compact_join_torch(desc, heads, *args, window=WINDOW)
    assert torch.equal(d[q], docs[q])
    pos = (int(span.off[q]) + torch.arange(WINDOW)).clamp(
        max=pidx.attrs.shape[0] - 1)
    valid = (docs[q] != INV) & ((kf[q] < 0) | (pidx.attrs[pos] == kf[q]))
    assert torch.equal(m[q], valid.to(torch.int32))
    others = torch.arange(len(QUERIES)) != q
    assert (d[others] == INV).all() and (m[others] == 0).all()
    # a dead-term group: all zero
    desc[0, 4] = (wl.FLAG_FIRST | wl.FLAG_TERM_START | wl.FLAG_TERM_END
                  | wl.FLAG_LAST)
    _, m = pi.driver_compact_join_torch(desc, heads, *args, window=WINDOW)
    assert (m == 0).all()


def test_compact_cuda_wrappers_refuse_cpu_tensors(setup):
    pidx = setup["pidx"]
    desc = torch.zeros((2, 8), dtype=torch.int32)
    heads = torch.tensor([0, 1], dtype=torch.int32)
    one = torch.zeros(1, dtype=torch.int32)
    bounds = torch.zeros((1, 1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        pi.driver_compact_join_cuda(desc, heads, one, one, one, pidx.postings,
                                    pidx.attrs, bounds, window=WINDOW)
    with pytest.raises(ValueError, match="CUDA"):
        pi.driver_compact_join_packed_cuda(desc, heads, one, one, one,
                                           pidx.packed, pidx.attrs, bounds,
                                           window=WINDOW)
    row = torch.zeros((1, WINDOW), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        pi.streamed_compact_join_cuda(desc, heads, row, row, row, row, one,
                                      pidx.postings, bounds, pidx.postings,
                                      bounds)
    _, pdelta = setup["deltas"][0.5]
    k8 = (pidx.attrs, one, one)
    d8 = (pdelta.attrs, pdelta.offsets, pdelta.lengths, one)
    with pytest.raises(ValueError, match="CUDA"):
        dm.merge_compact_cuda(desc, heads, pidx.postings, *k8, pdelta.postings,
                              *d8, window=WINDOW, cap=256)
    with pytest.raises(ValueError, match="CUDA"):
        dm.merge_compact_packed_cuda(desc, heads, pidx.packed, *k8,
                                     pdelta.packed, *d8, window=WINDOW, cap=256)
    with pytest.raises(ValueError, match="go together"):
        ops.merge_windows_compact(pidx.postings, *k8, pdelta.postings, *d8[:3],
                                  pdelta.block_max, one, window=WINDOW,
                                  packed=pidx.packed)
    with pytest.raises(ValueError, match="all of d_postings"):
        ops.intersect_streamed_compact(row, row, row, bounds[..., 0], one[None],
                                       one, pidx.postings, pidx.offsets,
                                       pidx.lengths, pidx.block_max,
                                       pidx.postings)


# ------------------------------------------------------- the engine -------
@pytest.mark.parametrize("codec", ["raw", "packed"])
@pytest.mark.parametrize("fill", [None, *FILLS])
def test_compact_matches_reference(setup, codec, fill):
    """kernel_compact equals the reference's jnp path bit for bit, with and
    without a delta, on both codecs (and the port's dense kernel path)."""
    ridx, pidx = setup["ridx"], setup["pidx"]
    rdelta, pdelta = setup["deltas"][fill]
    rqb, pqb = _batches(QUERIES, setup["meta"])
    want = ref_engine.query_topk(ridx, rqb, delta=rdelta, k=10, window=WINDOW,
                                 backend="jnp", codec=codec)
    got = pt_engine.query_topk(pidx, pqb, delta=pdelta, k=10, window=WINDOW,
                               backend="kernel_compact", codec=codec)
    _assert_rows(got, want, None, (codec, fill))
    dense = pt_engine.query_topk(pidx, pqb, delta=pdelta, k=10, window=WINDOW,
                                 backend="kernel", codec=codec)
    _assert_rows(got, dense, None, ("dense", codec, fill))
    assert int(_np(got[1]).sum()) > 0


@pytest.mark.parametrize("strategy", ["embed", "gather", "site_term"])
@pytest.mark.parametrize("fill", [None, 0.5])
def test_compact_strategies_match_reference(setup, strategy, fill):
    ridx, pidx = setup["ridx"], setup["pidx"]
    rdelta, pdelta = setup["deltas"][fill]
    rqb, pqb = _batches(QUERIES, setup["meta"], strategy)
    for window in (WINDOW, 256):
        want = ref_engine.query_topk(ridx, rqb, delta=rdelta, k=50,
                                     window=window, attr_strategy=strategy,
                                     backend="jnp")
        got = pt_engine.query_topk(pidx, pqb, delta=pdelta, k=50, window=window,
                                   attr_strategy=strategy,
                                   backend="kernel_compact",
                                   live_q=LIVE["alternate"])
        _assert_rows(got, want, LIVE["alternate"], (strategy, fill, window))


@pytest.mark.parametrize("codec", ["raw", "packed"])
def test_striped_parity_ns2(setup, codec):
    """ns = 2 striping: per-shard compacted merge-on-read and the global
    merge equal a from-scratch rebuild (and the reference's jnp path)."""
    corpus, meta = setup["corpus"], setup["meta"]
    w = _writer_at_fill(corpus, meta, 0.5, ns=2)
    parts = ref_index.partition_corpus(corpus, 2)
    rshards = [ref_index.build_index(p, codec="packed")[0] for p in parts]
    rqb, pqb = _batches(QUERIES, meta)
    got = pt_parallel.sequential_reference(
        [_carry_index(r) for r in rshards], pqb, ns=2, k=10, window=WINDOW,
        deltas=[_carry_delta(d) for d in w.shard_deltas()],
        backend="kernel_compact", codec=codec)
    rebuilt = [ref_index.build_index(p)[0]
               for p in ref_index.partition_corpus(w.mutated_corpus(), 2)]
    want = ref_parallel.sequential_reference(rebuilt, rqb, ns=2, k=10,
                                             window=WINDOW)
    _assert_rows(got, want, None, ("rebuild", codec))
    jnp_want = ref_parallel.sequential_reference(
        rshards, rqb, ns=2, k=10, window=WINDOW, deltas=w.shard_deltas(),
        backend="jnp")
    _assert_rows(got, jnp_want, None, ("jnp", codec))


@pytest.mark.parametrize("codec", ["raw", "packed"])
def test_inert_padded_partial_batch(setup, codec):
    """A partial bucket padded with clones of its last live query, as the
    scheduler pads: live rows equal the reference's, inert rows are empty."""
    ridx, pidx = setup["ridx"], setup["pidx"]
    rdelta, pdelta = setup["deltas"][0.5]
    real = QUERIES[:3]
    padded = real + [real[-1]] * 5
    live_q = np.array([True] * 3 + [False] * 5)
    rqb, pqb = _batches(padded, setup["meta"])
    for rd, pd in ((None, None), (rdelta, pdelta)):
        want = ref_engine.query_topk(ridx, rqb, delta=rd, k=10, window=WINDOW,
                                     backend="jnp", codec=codec)
        got = pt_engine.query_topk(pidx, pqb, delta=pd, k=10, window=WINDOW,
                                   backend="kernel_compact", codec=codec,
                                   live_q=live_q)
        _assert_rows(got, want, live_q, (codec, pd is None))
        as_tensor = pt_engine.query_topk(pidx, pqb, delta=pd, k=10,
                                         window=WINDOW, backend="kernel_compact",
                                         codec=codec,
                                         live_q=torch.from_numpy(live_q))
        _assert_rows(as_tensor, got, None, "tensor live_q")


_DISPATCHERS = (
    (pi, ("driver_compact_join", "driver_compact_join_torch",
          "driver_compact_join_cuda", "driver_compact_join_packed",
          "driver_compact_join_packed_torch", "driver_compact_join_packed_cuda",
          "streamed_compact_join", "streamed_compact_join_torch",
          "streamed_compact_join_cuda", "streamed_compact_join_packed",
          "streamed_compact_join_packed_torch",
          "streamed_compact_join_packed_cuda")),
    (dm, ("merge_compact_torch", "merge_compact_cuda",
          "merge_compact_packed_torch", "merge_compact_packed_cuda")),
)


@pytest.mark.parametrize("codec", ["raw", "packed"])
def test_all_inert_batch_launches_nothing(setup, monkeypatch, codec):
    """An all-inert batch returns (INVALID_DOC, 0) rows without calling a
    kernel or a plain version, and uploads no table."""
    pidx = setup["pidx"]
    _, pdelta = setup["deltas"][0.5]
    _, pqb = _batches(QUERIES, setup["meta"])

    def boom(*a, **kw):
        raise AssertionError("a compact kernel ran for an all-inert batch")

    for mod, names in _DISPATCHERS:
        for name in names:
            monkeypatch.setattr(mod, name, boom)
    monkeypatch.setattr(pi, "table_to_device", boom)
    monkeypatch.setattr(dm, "table_to_device", boom)
    for pd in (None, pdelta):
        docs, hits = pt_engine.query_topk(
            pidx, pqb, delta=pd, k=10, window=WINDOW, backend="kernel_compact",
            codec=codec, live_q=np.zeros(len(QUERIES), bool))
        assert docs.shape == (len(QUERIES), 10) and hits.shape == (len(QUERIES),)
        assert (docs == INV).all() and (hits == 0).all()


@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_live_q_rejected_on_dense_backends(setup, backend):
    _, pqb = _batches(QUERIES[:2], setup["meta"])
    with pytest.raises(ValueError, match="kernel_compact"):
        pt_engine.query_topk(setup["pidx"], pqb, k=10, window=WINDOW,
                             backend=backend, live_q=np.array([True, False]))
    with pytest.raises(ValueError, match="live_q has shape"):
        pt_engine.query_topk(setup["pidx"], pqb, k=10, window=WINDOW,
                             backend="kernel_compact", live_q=[True])
    assert "kernel_compact" in pt_engine.BACKENDS
