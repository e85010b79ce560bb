"""The streams of the CUDA work-list joins K6 and K7 on the CPU.

Their kernels (``csrc/slave_join.cuh``) run the block bodies of K1 and K4
over a work list: a block's producer warp reads its group's rows and sets
each term slot's streams (``TablePlan``), the main range and, under
merge-on-read, the delta range, each the planned range of the kind's least
tile and its number of tiles.  ``table_streams`` states that derivation on
the host.  Here, on the tables of a small index and of the array-edge index
(lists in the flat array's last partial tile), raw and packed, at windows
128, 1000, 1536 and 4096, under ``live_q`` all live, the last rows inert
and every other query live, and on ``DeltaWriter`` snapshots at term
capacities 256 and 384 and fills 0, 0.5 and 1.0, with the static mode too,
the stream table:

- equals K1's (K4's) planned range, from ``plan_driver_streamed``
  (``plan_streamed``), for every live (query, term, driver tile), and
  names no stream in a no-op group and one active empty stream in a
  dead-term group;
- holds as a set exactly the positions of its run's rows' tiles, clipped;
- meets the bulk copies' staging precondition on the raw arrays and on the
  twins (``ranges_staging_check``);
- searched as the kernels search it, gives the plain versions' masks.

It raises on a run whose tiles are not consecutive, and the staging check
refuses a table whose bounds moved by one posting and an array cut short.
The CUDA wrappers of K6, K6p, K7 and K7p (and the static modes) refuse
arrays that the bulk copies cannot stage, with the launch replaced."""
import numpy as np
import pytest
import torch

from repro_torch.core import engine as pt_engine
from repro_torch.core.index import (DOC_DEAD, DOC_SUPERSEDED, INVALID_DOC, TILE,
                                    build_index, pack_index)
from repro_torch.data.corpus import (CorpusConfig, corpus_from_docs,
                                     generate_corpus)
from repro_torch.indexing.delta import DeltaWriter
from repro_torch.kernels import _build
from repro_torch.kernels import delta_merge as dm
from repro_torch.kernels import posting_intersect as pi
from repro_torch.kernels import worklist as wlm

WINDOWS = [128, 1000, 1536, 4096]
LIVE = ["all", "tail", "alternate"]
CFG = dict(n_docs=3000, vocab_size=300, mean_doc_len=30, n_sites=12, seed=11)
INV = int(INVALID_DOC)
EDGE_QUERIES = [([12, 13], None), ([0, 13], None), ([13, 12, 3], None),
                ([5, 12], None), ([1, 6, 13], None), ([8, 12], 2), ([11], None)]
FIRST, START, END, LAST = (wlm.FLAG_FIRST, wlm.FLAG_TERM_START,
                           wlm.FLAG_TERM_END, wlm.FLAG_LAST)


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


def _batch(meta, n_q=24, seed=7):
    rng = np.random.default_rng(seed)
    hot = min(12, meta.n_terms)
    queries = [([int(t) for t in rng.choice(
        np.r_[np.arange(hot), rng.integers(0, meta.n_terms, 8)],
        size=int(rng.integers(1, 5)), replace=False)], None) for _ in range(n_q)]
    return pt_engine.make_query_batch(queries, t_max=4, meta=meta, device="cpu")


def _live(name, q_n):
    return {"all": None,
            "tail": np.arange(q_n) < q_n - max(1, q_n // 3),
            "alternate": np.arange(q_n) % 2 == 0}[name]


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


def _driver_case(idx, batch, window, live):
    """K1's plan and K6's table (with its bounds) of one batch."""
    source = pt_engine.StaticPostingSource(idx)
    _, d_terms, active = pt_engine._pick_drivers(source, batch)
    active = active.to(torch.int32)
    span = source.driver_span(d_terms, window)
    args = (span.off, span.n_eff, batch.terms, active, idx.offsets, idx.lengths,
            idx.block_max)
    plan = pi.plan_driver_streamed(*args, window=window)
    wl, bounds = pi.plan_driver_compact(*args, window=window, live_q=live)
    desc, heads = wlm.table_to_device(wl, "cpu")
    return span, active, plan, desc, heads, bounds


def _streamed_case(idx, delta, batch, window, live):
    """K4's driver and plans and K7's table: under merge-on-read (``delta``)
    the driver is K3's merged window (its plain version), with its live
    stream and flags; in the static mode the term's main window."""
    if delta is None:
        source = pt_engine.StaticPostingSource(idx)
        _, d_terms, active = pt_engine._pick_drivers(source, batch)
        docs = pt_engine.term_window(idx, d_terms, window)[0]
        attrs = torch.zeros_like(docs)
        alive, flags, d_arrays = (docs != INV).to(torch.int32), None, ()
    else:
        source = pt_engine.MergedPostingSource(idx, delta)
        _, d_terms, active = pt_engine._pick_drivers(source, batch)
        span = source.driver_span(d_terms, window)
        docs, attrs, src = dm.merge_delta_windows_torch(
            idx.postings, idx.attrs, span.off, span.n_eff, delta.postings,
            delta.attrs, delta.offsets, delta.lengths, d_terms, window=window,
            cap=delta.term_capacity)
        flags = source.driver_flags(docs)
        alive = source.driver_live(docs, src, flags)
        d_arrays = (delta.offsets, delta.lengths, delta.block_max)
    active = active.to(torch.int32)
    args = (docs, batch.terms, active, idx.offsets, idx.lengths, idx.block_max,
            *d_arrays)
    main, dplan, _ = pi.plan_streamed(*args)
    wl, bounds, d_bounds = pi.plan_streamed_compact(*args, live_q=live)
    desc, heads = wlm.table_to_device(wl, "cpu")
    drv = (docs, attrs, alive, flags)
    return drv, active, [main] + ([] if dplan is None else [dplan]), desc, heads, \
        bounds, d_bounds


def _dense_range(plan, q, t, i):
    """K1's / K4's planned range of (q, t, i), (0, 0) when empty."""
    b_tile, n_b, bounds = (x.long() for x in plan)
    tile0, nb = int(b_tile[q, t, i]) * TILE, int(n_b[q, t, i])
    lo, hi = int(bounds[q, t, 0]), int(bounds[q, t, 1])
    rlo, rhi = max(tile0, lo), min(tile0 + nb * TILE, hi)
    return (0, 0) if nb <= 0 or rhi <= rlo else (rlo, rhi)


def _merged(pieces):
    """The union of the intervals ``pieces`` as disjoint sorted intervals."""
    out = []
    for a, b in sorted(p for p in pieces if p[1] > p[0]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def _check_streams(desc, heads, plans, active, tbounds):
    """table_streams against the dense plans, the rows' tiles and the
    special groups; returns the stream table."""
    lo, hi, act = pi.table_streams(desc, heads, *tbounds)
    spt = len(plans)
    items, group, gq, gi = (x.numpy() for x in wlm.table_items(desc, heads))
    t_n = active.shape[1]
    assert lo.shape == hi.shape == act.shape == (gq.shape[0], t_n * spt)
    bnd = [b.long().numpy() for b in tbounds]
    kinds = {"normal": 0, "noop": 0, "dead": 0}
    for g in range(gq.shape[0]):
        q, i = int(gq[g]), int(gi[g])
        rows = items[group == g]
        starts = rows[rows[:, 4] & START != 0]
        if starts.size == 0:
            kinds["noop"] += 1
            assert not act[g].any() and not lo[g].any() and not hi[g].any()
            continue
        if rows.shape[0] == 1 and rows[0, 3] < 0 and rows[0, 5] < 0:
            kinds["dead"] += 1
            assert rows[0, 4] & END
            assert int(act[g].sum()) == spt and int(act[g, rows[0, 2] * spt]) == 1
            assert bool((hi[g] == lo[g]).all())
            continue
        kinds["normal"] += 1
        for t in range(t_n):
            for kind in range(spt):
                j = t * spt + kind
                assert int(act[g, j]) == int(active[q, t]), (g, t)
                got = (int(lo[g, j]), int(hi[g, j]))
                got = (0, 0) if got[1] <= got[0] else got
                want = _dense_range(plans[kind], q, t, i) if active[q, t] else (0, 0)
                assert got == want, (g, q, t, i, kind)
                # as a set: the run's rows' tiles, clipped to the term's bounds
                tiles = rows[(rows[:, 2] == t) & (rows[:, 3 + 2 * kind] >= 0),
                             3 + 2 * kind]
                b_lo, b_hi = bnd[kind][q, t]
                pieces = [(max(x * TILE, b_lo), min((x + 1) * TILE, b_hi))
                          for x in tiles.tolist()]
                assert _merged(pieces) == ([] if got == (0, 0) else [got]), (g, t)
    assert kinds["normal"] > 0
    return lo, hi, act, kinds


def _emulate(rows_of, streams, flats, ok_of, keep0):
    """The kernels' probe of one group's slots: per active term, found in
    any of its streams whose kind the slot's flags allow (``ok_of[kind]``),
    ANDed into ``keep0``."""
    lo, hi, act = streams
    spt = len(flats)
    keep = keep0.copy()
    for j in range(0, lo.shape[0], spt):
        if not act[j]:
            continue
        found = np.zeros_like(keep)
        for kind in range(spt):
            vals = flats[kind][int(lo[j + kind]):int(hi[j + kind])]
            found |= ok_of[kind] & np.isin(rows_of, vals)
        keep &= found
    return keep


def _k6_emulated(desc, heads, streams, span, attr_filter, idx, window):
    """K6's mask, group by group, from the stream table; rows of no group
    are 0."""
    _, _, gq, gi = (x.numpy() for x in wlm.table_items(desc, heads))
    post, attrs = idx.postings.numpy(), idx.attrs.numpy()
    off, neff = span.off.long().numpy(), span.n_eff.long().numpy()
    filt = attr_filter.numpy()
    mask = np.zeros((off.shape[0], window), np.int32)
    for g, (q, i) in enumerate(zip(gq.tolist(), gi.tolist())):
        w = np.arange(i * TILE, min((i + 1) * TILE, window))
        live = w < neff[q]
        pos = np.minimum(off[q] + w, post.shape[0] - 1)
        x = np.where(live, post[pos], INV)
        keep = (x != INV) & ((filt[q] < 0) | (attrs[pos] == filt[q]))
        mask[q, w] = _emulate(x, [s[g].numpy() for s in streams], [post],
                              [np.ones_like(keep)], keep)
    return mask


def _k7_emulated(desc, heads, streams, drv, attr_filter, flats):
    _, _, gq, gi = (x.numpy() for x in wlm.table_items(desc, heads))
    docs, attrs, alive = (x.numpy() for x in drv[:3])
    flags = None if drv[3] is None else drv[3].numpy()
    filt = attr_filter.numpy()
    mask = np.zeros(docs.shape, np.int32)
    for g, (q, i) in enumerate(zip(gq.tolist(), gi.tolist())):
        w = np.arange(i * TILE, min((i + 1) * TILE, docs.shape[1]))
        x = docs[q, w]
        keep = (x != INV) & (alive[q, w] != 0) & ((filt[q] < 0) | (attrs[q, w] == filt[q]))
        fl = np.zeros_like(x) if flags is None else flags[q, w]
        ok = [(fl & (int(DOC_DEAD) | int(DOC_SUPERSEDED))) == 0, (fl & int(DOC_DEAD)) == 0]
        mask[q, w] = _emulate(x, [s[g].numpy() for s in streams], flats, ok, keep)
    return mask


def _driver_streams(idx, twin, batch, window, live, codec):
    span, active, plan, desc, heads, bounds = _driver_case(idx, batch, window, live)
    lo, hi, act, kinds = _check_streams(desc, heads, [plan], active, (bounds,))
    n = pi.ranges_staging_check(lo, hi, n_postings=idx.postings.numel(),
                                packed=twin.packed if codec == "packed" else None)
    assert n > 0
    filt = batch.attr_filter.to(torch.int32)
    _, want = pi.driver_compact_join_torch(desc, heads, span.off, span.n_eff, filt,
                                           idx.postings, idx.attrs, bounds,
                                           window=window)
    got = _k6_emulated(desc, heads, (lo, hi, act), span, filt, idx, window)
    np.testing.assert_array_equal(got, want.numpy())
    return kinds


@pytest.mark.parametrize("live", LIVE)
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("codec", ["raw", "packed"])
def test_driver_table_streams(small, codec, window, live):
    _, idx, twin, meta = small
    batch = _batch(meta)
    _driver_streams(idx, twin, batch, window, _live(live, 24), codec)


@pytest.mark.parametrize("live", LIVE)
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("codec", ["raw", "packed"])
def test_edge_index_table_streams(edge, codec, window, live):
    """Lists that start in the flat array's last partial tile; the queries
    hold empty and dead-term groups."""
    _, idx, twin, meta = edge
    batch = pt_engine.make_query_batch(EDGE_QUERIES, t_max=4, meta=meta,
                                       device="cpu")
    _driver_streams(idx, twin, batch, window, _live(live, len(EDGE_QUERIES)), codec)


def _streamed_streams(idx, twin, delta, batch, window, live, codec):
    drv, active, plans, desc, heads, bounds, d_bounds = _streamed_case(
        idx, delta, batch, window, live)
    tb = (bounds,) if d_bounds is None else (bounds, d_bounds)
    lo, hi, act, kinds = _check_streams(desc, heads, plans, active, tb)
    spt = len(plans)
    packed = codec == "packed"
    for kind, (flat, tw) in enumerate(
            [(idx.postings, twin.packed)]
            + ([] if delta is None else [(delta.postings, delta.packed)])):
        pi.ranges_staging_check(lo[:, kind::spt], hi[:, kind::spt],
                                n_postings=flat.numel(), packed=tw if packed else None)
    filt = batch.attr_filter.to(torch.int32)
    d_post = None if delta is None else delta.postings
    want = pi.streamed_compact_join_torch(desc, heads, *drv, filt, idx.postings,
                                          bounds, d_post, d_bounds)
    flats = [idx.postings.numpy()] + ([] if delta is None else [d_post.numpy()])
    got = _k7_emulated(desc, heads, (lo, hi, act), drv, filt, flats)
    np.testing.assert_array_equal(got, want.numpy())
    return kinds


@pytest.mark.parametrize("fill", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("cap", [256, 384])
@pytest.mark.parametrize("codec", ["raw", "packed"])
def test_streamed_table_streams(small, codec, cap, fill):
    corpus, idx, twin, meta = small
    delta = _writer(corpus, meta, fill, cap, codec).shard_deltas()[0]
    assert delta.term_capacity == cap
    batch = _batch(meta)
    for window in (4096, 1000):
        for live in LIVE:
            _streamed_streams(idx, twin, delta, batch, window, _live(live, 24), codec)


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("codec", ["raw", "packed"])
def test_static_streamed_table_streams(small, codec, window):
    """K7's static mode (no delta arrays): one stream a term."""
    _, idx, twin, meta = small
    batch = _batch(meta)
    for live in LIVE:
        _streamed_streams(idx, twin, None, batch, window, _live(live, 24), codec)


def _table(rows):
    """A one-group table of the rows [t, main_tile, flags, delta_tile] of
    query 0, tile 0, padded as the builder pads."""
    desc = np.array([[0, 0, t, m, f, d, 0, 0] for t, m, f, d in rows], np.int32)
    pad = desc[-1].copy()
    pad[3], pad[4], pad[5] = -1, 0, -1
    desc = np.vstack([desc, pad[None]])
    return (torch.from_numpy(desc),
            torch.tensor([0, len(rows)], dtype=torch.int32))


BOUNDS = torch.tensor([[[5000, 9000], [100, 4200]]], dtype=torch.int32)
D_BOUNDS = torch.tensor([[[2048, 2300], [0, 256]]], dtype=torch.int32)


@pytest.mark.parametrize("case", ["lockstep", "delta outlasts main", "gap",
                                  "repeat", "delta gap"])
def test_table_runs(case):
    """Each kind's tiles counted apart: main tiles that stop while the delta
    tiles go on (and the other way round) give each kind its own range; a
    run whose tiles of one kind leave a gap, or repeat one, raises."""
    rows = {
        # term 0: main 4, 5, 6 with delta 2; term 1: main 0 alone
        "lockstep": [(0, 4, FIRST | START, 2), (0, 5, 0, -1), (0, 6, END, -1),
                     (1, 0, START | END | LAST, -1)],
        # term 1: main 0, delta 0 .. 2 (rows whose main tile is -1)
        "delta outlasts main": [(0, 5, FIRST | START | END, -1),
                                (1, 0, START, 0), (1, -1, 0, 1),
                                (1, -1, END | LAST, 2)],
        "gap": [(0, 4, FIRST | START, -1), (0, 6, END | LAST, -1)],
        "repeat": [(0, 4, FIRST | START, -1), (0, 4, 0, -1), (0, 5, END | LAST, -1)],
        "delta gap": [(0, 5, FIRST | START, 2), (0, 6, 0, 4), (0, -1, END | LAST, 5)],
    }[case]
    desc, heads = _table(rows)
    if case in ("gap", "repeat", "delta gap"):
        with pytest.raises(ValueError, match="not consecutive"):
            pi.table_streams(desc, heads, BOUNDS, D_BOUNDS)
        return
    lo, hi, act = (x[0].tolist() for x in pi.table_streams(desc, heads, BOUNDS,
                                                           D_BOUNDS))
    assert act == [1, 1, 1, 1]
    if case == "lockstep":
        # main [max(4096, 5000), min(7 * 1024, 9000)); delta tile 2 clipped
        assert (lo, hi) == ([5000, 2048, 100, 0], [7168, 2300, 1024, 0])
    else:
        assert (lo, hi) == ([5120, 0, 100, 0], [6144, 0, 1024, 256])
    # the static mode reads no delta column
    lo, hi, act = pi.table_streams(desc, heads, BOUNDS)
    assert lo.shape == (1, 2) and act.tolist() == [[1, 1]]


@pytest.mark.parametrize("which", ["driver", "main", "delta"])
@pytest.mark.parametrize("codec", ["raw", "packed"])
def test_shifted_table_fails(small, which, codec):
    """A table read with bounds moved by one posting names streams that
    start off a 16-byte boundary: the staging check refuses them."""
    corpus, idx, twin, meta = small
    batch = _batch(meta)
    packed = codec == "packed"
    if which == "driver":
        _, _, _, desc, heads, bounds = _driver_case(idx, batch, 1000, None)
        tb, kind, flat, tw = (bounds,), 0, idx.postings, twin.packed
    else:
        delta = _writer(corpus, meta, 1.0, 256, codec).shard_deltas()[0]
        _, _, _, desc, heads, bounds, d_bounds = _streamed_case(
            idx, delta, batch, 1000, None)
        tb = (bounds, d_bounds)
        kind, flat, tw = ((0, idx.postings, twin.packed) if which == "main"
                          else (1, delta.postings, delta.packed))
    tw = tw if packed else None
    spt = len(tb)
    lo, hi, _ = pi.table_streams(desc, heads, *tb)
    assert pi.ranges_staging_check(lo[:, kind::spt], hi[:, kind::spt],
                                   n_postings=flat.numel(), packed=tw) > 0
    moved = tuple(b + 1 if k == kind else b for k, b in enumerate(tb))
    lo, hi, _ = pi.table_streams(desc, heads, *moved)
    with pytest.raises(ValueError, match="16-byte"):
        pi.ranges_staging_check(lo[:, kind::spt], hi[:, kind::spt],
                                n_postings=flat.numel(), packed=tw)


def test_table_range_past_the_array_fails(edge):
    """A stream whose rounded end, or whose blocks' words, pass the end of
    the array is refused: the flat array cut to the live extent of the last
    list, and a twin whose words are cut short."""
    _, idx, twin, meta = edge
    batch = pt_engine.make_query_batch(EDGE_QUERIES, t_max=4, meta=meta,
                                       device="cpu")
    _, _, _, desc, heads, bounds = _driver_case(idx, batch, 1024, None)
    lo, hi, _ = pi.table_streams(desc, heads, bounds)
    pi.ranges_staging_check(lo, hi, n_postings=idx.postings.numel(),
                            packed=twin.packed)
    last = int(hi.max())
    short = last - last % 4 if last % 4 else last - 1
    with pytest.raises(ValueError, match="16-byte"):
        pi.ranges_staging_check(lo, hi, n_postings=short)
    pk = twin.packed
    cut = type(pk)(pk.words[:int(pk.blk_woff[-1]) - 4], pk.blk_base, pk.blk_meta,
                   pk.blk_woff, chunk_rows=pk.chunk_rows)
    with pytest.raises(ValueError, match="16-byte"):
        pi.ranges_staging_check(lo, hi, packed=cut)


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
@pytest.mark.parametrize("kernel", ["K6", "K6p", "K7", "K7s", "K7p", "K7ps"])
def test_compact_wrappers_refuse_arrays_the_copies_cannot_stage(
        small, monkeypatch, kernel, flaw):
    """Each CUDA wrapper of K6 and K7 refuses, before its launch, a flat
    array (K7 and K7p: the delta's) that does not start on 16 bytes or does
    not hold whole 16-byte chunks, and launches with a sound one."""
    corpus, idx, twin, meta = small
    delta = _writer(corpus, meta, 0.5, 256, "packed").shard_deltas()[0]
    monkeypatch.setattr(_build, "check_args", lambda *a, **k: None)

    def launch(name):
        raise _Launched(name)

    monkeypatch.setattr(_build, "kernel", launch)
    z = torch.zeros(1, dtype=torch.int32)
    desc = torch.zeros((2, 8), dtype=torch.int32)
    heads = torch.tensor([0, 1], dtype=torch.int32)
    bnd = torch.zeros((1, 2, 2), dtype=torch.int32)
    drv = torch.zeros((1, 8), dtype=torch.int32)
    main_flaw = flaw if kernel in ("K6", "K6p", "K7s", "K7ps") else None
    delta_flaw = flaw if kernel in ("K7", "K7p") else None
    if kernel == "K6":
        run = lambda: pi.driver_compact_join_cuda(
            desc, heads, z, z, z, _flawed(idx.postings, main_flaw), idx.attrs, bnd,
            window=8)
    elif kernel == "K6p":
        run = lambda: pi.driver_compact_join_packed_cuda(
            desc, heads, z, z, z, _flawed_twin(twin.packed, main_flaw), idx.attrs,
            bnd, window=8)
    elif kernel in ("K7", "K7s"):
        d = ((drv, _flawed(delta.postings, delta_flaw), bnd) if kernel == "K7"
             else (None, None, None))
        run = lambda: pi.streamed_compact_join_cuda(
            desc, heads, drv, drv, drv, d[0], z, _flawed(idx.postings, main_flaw),
            bnd, d[1], d[2])
    else:
        d = ((drv, _flawed_twin(delta.packed, delta_flaw), bnd) if kernel == "K7p"
             else (None, None, None))
        run = lambda: pi.streamed_compact_join_packed_cuda(
            desc, heads, drv, drv, drv, d[0], z, _flawed_twin(twin.packed, main_flaw),
            bnd, d[1], d[2])
    if flaw is None:
        with pytest.raises(_Launched):
            run()
    else:
        match = "16-byte alignment" if flaw == "start" else "multiple of 16 bytes"
        with pytest.raises(ValueError, match=match):
            run()
