"""The partition arithmetic of the CUDA merges K2, K3 and K3p on the CPU.

The kernels cannot run here, so the port replays their index arithmetic
on the host and these tests hold the replays against the plain versions
(themselves held against the reference in ``test_torch_kernels.py``,
``test_torch_merge_on_read.py`` and ``test_torch_packed.py``) and against
numpy:

- K3 and K3p (``csrc/delta_merge.cu`` + ``merge_path.cuh``): a block owns
  a chunk of output slots and stages every main and delta position one of
  them can read (``chunk_ranges``; the main range as ``staged_main``,
  before the slab's length is known; K3p decodes the codec blocks that
  hold them, ``range_blocks``), within the shared memory of
  ``chunk_rooms``.
  ``merge_chunks_replay`` merges every slot reading only the staged
  ranges, which must stay inside the live ranges (``staging_check``), and
  must equal ``merge_delta_windows_torch`` slot for slot: at chunk-edge
  inputs (equal docIDs at a chunk start, merged lengths ending inside and
  at a chunk, empty and full streams, an inert driver) and seeded random
  ones, windows 256, 1000, 4096 and 65536, caps 256 and 384.  Ranges that
  are too wide or too narrow are caught.
- K8 and K8p (``csrc/merge_compact.cu`` + ``merge_path.cuh``): the same
  chunk bodies over a work list, block row ``g`` the query of group
  ``g``'s head row, its main stream clipped to the group's tiles.
  ``merge_chunks_replay`` with ``desc`` and ``heads`` replays that grid
  and must equal ``merge_compact_torch`` / ``merge_compact_packed_torch``
  slot for slot, inert rows included: windows 256, 1000, 4096, caps 256
  and 384, edge and random inputs, live patterns all, 20 of 32 and one;
  a group whose last tile row is dropped merges only its tiles.
- K2 (``csrc/topk_merge_rows.cu``): ``warp_sort_run`` replays the
  in-register network, ``merge_rounds`` and ``merge_topk_rows_replay`` the
  truncated merge-path rounds; the replay equals ``merge_topk_rows_torch``
  and ``np.sort`` on random, duplicate-heavy, all-``INVALID_DOC`` and
  ``INT_MIN`` rows, with ``k`` past ``m``, and a wrong truncation is
  caught.  Every padded width up to 32768 fits the kernel's chunks a
  thread and its shared memory.
- The replays' constants are the sources' ``#define``s.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.core.index import (BLOCK, DESC_PAD, INVALID_DOC, TILE, flat_tile_pad,
                                    pack_flat_postings)
from repro_torch.kernels import _build
from repro_torch.kernels import delta_merge as dm
from repro_torch.kernels import topk_merge as tm
from repro_torch.kernels import worklist as wlm

INV = int(INVALID_DOC)
INT_MIN = -(2**31)
OPTIN = 232_448          # H100 shared memory a block (opt-in)
WINDOWS = [256, 1000, 4096, 65536]
CAPS = [256, 384]


def _define(source: str, name: str) -> int:
    text = (_build.CSRC / source).read_text()
    return int(re.search(rf"^#define {name} (\d+)", text, re.MULTILINE).group(1))


@pytest.mark.parametrize("source,name,value", [
    ("delta_merge.cu", "K3_CHUNK", dm.K3_CHUNK),
    ("delta_merge.cu", "K3P_CHUNK", dm.K3P_CHUNK),
    ("topk_merge_rows.cu", "RUN", tm.RUN),
    ("topk_merge_rows.cu", "ITEMS", tm.ITEMS),
    ("topk_merge_rows.cu", "MAX_CHUNKS", tm.MAX_CHUNKS),
    ("topk_merge_rows.cu", "MAX_THREADS", tm.MAX_THREADS),
    ("decode.cuh", "PBLOCK", BLOCK),
    ("merge_compact.cu", "K8_CHUNK", dm.K8_CHUNK),
    ("merge_compact.cu", "K8P_CHUNK", dm.K8P_CHUNK),
    ("merge_path.cuh", "WL_TILE", TILE),
])
def test_replay_constants_are_the_sources(source, name, value):
    assert _define(source, name) == value


# ------------------------------------------------------------ K3 / K3p


def _random_inputs(window, cap, seed, q_n=6, stride=None):
    """Seeded streams of every fill: main lists of 0, 5, a random number
    and window postings (m_neff up to 2 past them), delta slabs empty,
    partial and full, drivers including -1; docIDs drawn so that the two
    streams share some.  Each query's list at ``stride`` (default ``window
    + 2 * BLOCK``) postings from the last, plus 0 or BLOCK."""
    rng = np.random.default_rng(seed)
    n_terms = 5
    stride = window + 2 * BLOCK if stride is None else stride
    post = np.full(q_n * stride, INV, np.int32)
    att = np.full(q_n * stride, -1, np.int32)
    m_off = (np.arange(q_n) * stride + rng.integers(0, 2, q_n) * BLOCK).astype(np.int32)
    m_neff = np.zeros(q_n, np.int32)
    for q in range(q_n):
        n = int(rng.choice([0, 5, int(rng.integers(0, window)), window]))
        post[m_off[q]:m_off[q] + n] = np.sort(rng.choice(3 * window, n, replace=False))
        att[m_off[q]:m_off[q] + n] = rng.integers(0, 4, n)
        m_neff[q] = n + rng.integers(0, 3)
    d_post = np.full(n_terms * cap, INV, np.int32)
    d_att = np.full(n_terms * cap, -1, np.int32)
    d_len = np.zeros(n_terms, np.int32)
    for t in range(n_terms):
        n = [0, cap, int(rng.integers(1, cap)), cap // 2, 1][t]
        d_post[t * cap:t * cap + n] = np.sort(rng.choice(3 * window, n, replace=False))
        d_att[t * cap:t * cap + n] = rng.integers(0, 4, n)
        d_len[t] = n
    terms = rng.integers(-1, n_terms, q_n).astype(np.int32)
    d_off = np.arange(n_terms, dtype=np.int32) * cap
    return tuple(torch.from_numpy(x) for x in (post, att, m_off, m_neff, d_post,
                                               d_att, d_off, d_len, terms))


def _numpy_merge(args, window, cap):
    """An independent merge: per query a stable argsort of main then delta."""
    post, att, m_off, m_neff, d_post, d_att, d_off, d_len, terms = (
        x.numpy().astype(np.int64) for x in args)
    q_n = terms.shape[0]
    out = [np.full((q_n, window), v, np.int64) for v in (INV, -1, 0)]
    for q in range(q_n):
        t = terms[q]
        tt = min(max(t, 0), d_off.shape[0] - 1)
        na = min(max(m_neff[q], 0), window)
        nb = 0 if t < 0 else min(d_len[tt], cap)
        keys = np.r_[post[m_off[q]:m_off[q] + na], d_post[d_off[tt]:d_off[tt] + nb]]
        vals = np.r_[att[m_off[q]:m_off[q] + na], d_att[d_off[tt]:d_off[tt] + nb]]
        order = np.argsort(keys, kind="stable")[:window]
        n = order.size
        out[0][q, :n], out[1][q, :n] = keys[order], vals[order]
        out[2][q, :n] = order >= na
    return out


def _inputs(kind, window, cap):
    if kind == "edges":
        return dm.merge_edge_inputs(window, cap, seed=3)
    raw = _random_inputs(window, cap, seed=window + cap)
    return raw, None


@pytest.mark.parametrize("packed", [False, True], ids=["K3", "K3p"])
@pytest.mark.parametrize("kind", ["edges", "random"])
@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("window", WINDOWS)
def test_chunk_replay_equals_plain(window, cap, kind, packed):
    raw, twins = _inputs(kind, window, cap)
    want = dm.merge_delta_windows_torch(*raw, window=window, cap=cap)
    if packed and twins is not None:
        # K3p stages the twins' decoded blocks
        raw = ((dm.unpack_flat_postings_torch(twins[0]),) + raw[1:4]
               + (dm.unpack_flat_postings_torch(twins[1]),) + raw[5:])
    got, stats = dm.merge_chunks_replay(*raw, window=window, cap=cap, packed=packed)
    for g, w, n in zip(got, want, _numpy_merge(raw, window, cap)):
        assert torch.equal(g, w)
        np.testing.assert_array_equal(g.numpy(), n)
    chunk = dm.K3P_CHUNK if packed else dm.K3_CHUNK
    assert stats["main"] <= min(window, cap + chunk)
    assert stats["delta"] <= min(cap, window + chunk)
    if packed:
        # at most 5 main and 3 delta blocks a chunk at cap 256 (chunk 256)
        assert stats["main_blocks"] <= -(-(cap + chunk) // BLOCK) + 1
        assert stats["delta_blocks"] <= cap // BLOCK + 1


@pytest.mark.parametrize("window", WINDOWS)
def test_edge_inputs_hold_their_edges(window):
    """The edge inputs do what they say: equal docIDs at output slots k0 -
    1 (main) and k0 (delta) for chunk starts below the window, merged
    lengths one before, at and inside a chunk."""
    raw, _ = dm.merge_edge_inputs(window, 256, seed=3)
    docs, _, src = dm.merge_delta_windows_torch(*raw, window=window, cap=256)
    s = dm.K3_CHUNK
    ties = {k0 for q in range(docs.shape[0]) for k0 in range(s, window, s)
            if docs[q, k0 - 1] == docs[q, k0] != INV and src[q, k0 - 1] == 0
            and src[q, k0] == 1}
    assert set(range(s, min(window - 1, 4 * s) + 1, s)) <= ties
    n = (raw[3].clamp(max=window) + torch.where(raw[8] >= 0, raw[7], 0)).tolist()
    assert {s - 1, s, s + 81} <= set(n)
    assert 0 in raw[3].tolist() and -1 in raw[8].tolist()


def test_k3p_twins_decode_to_the_raw_edge_inputs():
    raw, twins = dm.merge_edge_inputs(1000, 384, seed=3)
    assert torch.equal(dm.unpack_flat_postings_torch(twins[0]), raw[0])
    assert torch.equal(dm.unpack_flat_postings_torch(twins[1]), raw[4])
    pk = (twins[0],) + raw[1:4] + (twins[1],) + raw[5:]
    for g, w in zip(dm.merge_delta_windows_packed_torch(*pk, window=1000, cap=384),
                    dm.merge_delta_windows_torch(*raw, window=1000, cap=384)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("na,nb", [(0, 0), (0, 256), (4096, 0), (4096, 256),
                                   (300, 384), (1000, 1), (65536, 256)])
def test_chunk_ranges_hold_every_co_rank(na, nb):
    """Every slot of a chunk has its co-rank (a binary search over the
    whole streams) inside the chunk's ranges, and the positions it reads
    there: main below co-rank + 1, delta below slot - co-rank + 1; the
    main range staged before nb is known (cap 384 here) holds them."""
    rng = np.random.default_rng(na + nb)
    a = np.sort(rng.choice(4 * (na + nb) + 8, na, replace=False))
    b = np.sort(rng.choice(4 * (na + nb) + 8, nb, replace=False))
    for k0 in range(0, na + nb, dm.K3_CHUNK):
        ilo, ihi, jlo, jhi = dm.chunk_ranges(na, nb, k0)
        mlo, mhi = dm.staged_main(na, k0, max(nb, 384))
        assert mlo <= ilo and ihi <= mhi
        for k in range(k0, min(k0 + dm.K3_CHUNK, na + nb)):
            lo, hi = max(0, k - nb), min(k, na)
            while lo < hi:
                mid = (lo + hi) // 2
                lo, hi = (mid + 1, hi) if a[mid] <= b[k - mid - 1] else (lo, mid)
            assert ilo <= lo <= ihi and jlo <= k - lo <= jhi


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("cap", CAPS)
def test_k3p_blocks_cover_their_ranges(window, cap):
    """The blocks K3p decodes hold its staged ranges and fit their rooms,
    for every chunk start and stream offset; 5 main and 3 delta blocks at
    most at cap 256."""
    m_room, d_room = dm.chunk_rooms(window, cap, packed=True)
    rng = np.random.default_rng(window + cap)
    for _ in range(200):
        na, nb = int(rng.integers(0, window + 1)), int(rng.integers(0, cap + 1))
        p0, d0 = int(rng.integers(0, 10**6)) * BLOCK, int(rng.integers(0, 100)) * cap
        p0 += int(rng.integers(0, BLOCK)) * (rng.random() < 0.3)
        for k0 in range(0, max(1, min(window, na + nb)), dm.K3P_CHUNK):
            ilo, ihi, jlo, jhi = dm.chunk_ranges(na, nb, k0, dm.K3P_CHUNK)
            mlo, mhi = dm.staged_main(na, k0, cap, dm.K3P_CHUNK)
            mhi = max(mlo, mhi)
            dm.staging_check((mlo, mhi, jlo, jhi), na, nb)
            assert mlo <= ilo <= ihi <= mhi
            for (lo, hi), base, room in (((mlo, mhi), p0, m_room),
                                         ((jlo, jhi), d0, d_room)):
                first, n = dm.range_blocks(base, lo, hi)
                if hi > lo:
                    assert first * BLOCK <= base + lo and base + hi <= (first + n) * BLOCK
                assert n * BLOCK <= room
            if cap == 256 and p0 % BLOCK == 0:
                assert dm.range_blocks(p0, mlo, mhi)[1] <= 5
                assert dm.range_blocks(d0, jlo, jhi)[1] <= 3


@pytest.mark.parametrize("packed", [False, True], ids=["K3", "K3p"])
def test_chunk_form_fits_where_the_first_design_needed_scratch(packed):
    """Window 65536 at cap 256 stages its chunks, where K3p's whole row
    would pass the opt-in shared memory; caps past about 14,000 at that
    window do not (K3 then merges out of global memory, K3p takes its
    large-cap form); 8 KB a block at the main shape."""
    assert dm.k3p_row(65536, 256)[1] * 4 > OPTIN
    for window, cap in ((65536, 256), (65536, 384), (4096, 65536), (256, 256)):
        assert dm.chunk_fits(window, cap, OPTIN, packed=packed)
    assert not dm.chunk_fits(65536, 16384, OPTIN, packed=packed)
    assert 8 * sum(dm.chunk_rooms(4096, 256, packed=packed)) <= 8 * 1024


def _flawed(good, flaw):
    def ranges(na, nb, k0, chunk=dm.K3_CHUNK):
        ilo, ihi, jlo, jhi = good(na, nb, k0, chunk)
        if flaw == "wide":
            return ilo, min(na + 1, k0 + chunk), jlo, jhi
        if flaw == "narrow":
            return ilo, ihi, jlo, max(jlo, jhi - 1)
        return ilo + 1, ihi + 1, jlo, jhi
    return ranges


@pytest.mark.parametrize("flaw", ["wide", "narrow", "shifted"])
@pytest.mark.parametrize("packed", [False, True], ids=["K3", "K3p"])
def test_flawed_ranges_are_caught(monkeypatch, flaw, packed):
    """Ranges one posting too wide leave the live range (refused), too
    narrow or shifted by one miss a posting a slot needs (refused, or a
    result that differs from the plain version)."""
    raw, _ = dm.merge_edge_inputs(1000, 256, seed=3)
    monkeypatch.setattr(dm, "chunk_ranges", _flawed(dm.chunk_ranges, flaw))
    try:
        got, _ = dm.merge_chunks_replay(*raw, window=1000, cap=256, packed=packed)
    except (ValueError, IndexError):
        return
    assert flaw != "wide", "a range past the live one was not refused"
    want = dm.merge_delta_windows_torch(*raw, window=1000, cap=256)
    assert not all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("bad", [(-1, 10, 0, 5), (0, 11, 0, 5), (0, 10, 0, 6),
                                 (3, 2, 0, 5), (0, 10, -1, 5)])
def test_staging_check_refuses_ranges_past_the_live_ones(bad):
    with pytest.raises(ValueError, match="leave the live ranges"):
        dm.staging_check(bad, 10, 5)
    dm.staging_check((0, 10, 0, 5), 10, 5)


# ------------------------------------------------------------ K8 / K8p

LIVE = ["all", "20 of 32", "one"]


def _padded(x, fill):
    """``x`` padded with ``fill`` to a TILE-padded length (the codec's)."""
    out = torch.full((flat_tile_pad(x.shape[0]),), fill, dtype=x.dtype)
    out[:x.shape[0]] = x
    return out


def _table_inputs(kind, window, cap):
    """Raw merge inputs and their block-codec twins: the chunk-edge cases,
    or 32 seeded random queries (their flat arrays padded to TILE)."""
    if kind == "edges":
        return dm.merge_edge_inputs(window, cap, seed=3)
    stride = (-(-window // BLOCK) + 2) * BLOCK          # lists start on a block
    raw = list(_random_inputs(window, cap, seed=window + cap + 1, q_n=32, stride=stride))
    for i, fill in ((0, INV), (1, -1), (4, INV), (5, -1)):
        raw[i] = _padded(raw[i], fill)
    raw = tuple(raw)
    return raw, (pack_flat_postings(raw[0]),
                 pack_flat_postings(raw[4], span_blocks=max(DESC_PAD, cap // BLOCK)))


def _live(pattern, q_n):
    if pattern == "all":
        return None
    if pattern == "one":
        return np.eye(q_n, dtype=bool)[q_n // 2]
    live = np.zeros(q_n, bool)
    live[np.random.default_rng(q_n).permutation(q_n)[:max(1, q_n * 20 // 32)]] = True
    return live


@pytest.mark.parametrize("packed", [False, True], ids=["K8", "K8p"])
@pytest.mark.parametrize("live", LIVE)
@pytest.mark.parametrize("kind", ["edges", "random"])
@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("window", [4096, 1000, 256])
def test_table_replay_equals_plain(window, cap, kind, live, packed):
    raw, twins = _table_inputs(kind, window, cap)
    q_n = raw[8].shape[0]
    wl = dm.plan_merge_compact(raw[3], window=window, live_q=_live(live, q_n))
    desc, heads = wlm.table_to_device(wl, "cpu")
    if packed:
        pk = (twins[0],) + raw[1:4] + (twins[1],) + raw[5:]
        want = dm.merge_compact_packed_torch(desc, heads, *pk, window=window, cap=cap)
        # K8p stages the twins' decoded blocks
        raw = ((dm.unpack_flat_postings_torch(twins[0]),) + raw[1:4]
               + (dm.unpack_flat_postings_torch(twins[1]),) + raw[5:])
    else:
        want = dm.merge_compact_torch(desc, heads, *raw, window=window, cap=cap)
    got, stats = dm.merge_chunks_replay(*raw, window=window, cap=cap, packed=packed,
                                        desc=desc, heads=heads)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    rows = torch.ones(q_n, dtype=torch.bool) if live == "all" else torch.from_numpy(
        _live(live, q_n))
    dense = dm.merge_delta_windows_torch(*raw, window=window, cap=cap)
    for g, d, inert in zip(got, dense, (INV, -1, 1)):
        assert torch.equal(g[rows], d[rows])
        assert bool((g[~rows] == inert).all())
    chunk = dm.K8P_CHUNK if packed else dm.K8_CHUNK
    assert stats["chunks"] > 0
    assert stats["main"] <= min(window, cap + chunk)
    assert stats["delta"] <= min(cap, window + chunk)


@pytest.mark.parametrize("packed", [False, True], ids=["K8", "K8p"])
def test_table_replay_clips_to_the_group_tiles(packed):
    """A group whose last tile row is dropped from the table merges only
    the main postings of its remaining tiles, as the plain version (which
    assembles the window from the rows' tiles) does."""
    window, cap = 4096, 256
    raw, twins = _table_inputs("random", window, cap)
    wl = dm.plan_merge_compact(raw[3], window=window)
    heads = wl.group_heads().astype(np.int64)
    sizes = np.diff(heads)
    g = int(np.nonzero(sizes >= 2)[0][0])
    drop = heads[g + 1] - 1
    desc_h = np.delete(wl.desc, drop, axis=0)
    desc_h = np.concatenate([desc_h, desc_h[-1:]])     # keep the padded size
    heads_h = heads.copy()
    heads_h[g + 1:] -= 1
    desc = torch.from_numpy(desc_h.astype(np.int32))
    heads = torch.from_numpy(heads_h.astype(np.int32))
    if packed:
        pk = (twins[0],) + raw[1:4] + (twins[1],) + raw[5:]
        want = dm.merge_compact_packed_torch(desc, heads, *pk, window=window, cap=cap)
    else:
        want = dm.merge_compact_torch(desc, heads, *raw, window=window, cap=cap)
    got, _ = dm.merge_chunks_replay(*raw, window=window, cap=cap, packed=packed,
                                    desc=desc, heads=heads)
    for gt, w in zip(got, want):
        assert torch.equal(gt, w)
    q = int(desc_h[heads_h[g], 0])
    full = dm.merge_delta_windows_torch(*raw, window=window, cap=cap)
    assert not torch.equal(got[0][q], full[0][q])


def test_table_replay_needs_both_table_arrays():
    raw, _ = dm.merge_edge_inputs(256, 256, seed=3)
    with pytest.raises(ValueError, match="go together"):
        dm.merge_chunks_replay(*raw, window=256, cap=256,
                               desc=torch.zeros((1, 8), dtype=torch.int32))


# ------------------------------------------------------------ K2


def _rows(kind, q_n, m, rng):
    if kind == "random":
        return rng.integers(INT_MIN, INV, (q_n, m), dtype=np.int64)
    if kind == "duplicates":
        return rng.integers(0, 7, (q_n, m))
    if kind == "invalid":
        return np.full((q_n, m), INV)
    if kind == "int_min":
        x = rng.integers(-5, 5, (q_n, m))
        x[:, ::3] = INT_MIN
        return x
    # sorted runs of k, as the master merge passes them
    x = np.sort(rng.integers(0, 10**6, (q_n, m)), axis=1)
    return np.concatenate([np.sort(x[:, :m // 2], 1), np.sort(x[:, m // 2:], 1)], 1)


K2_SHAPES = [(1, 10), (20, 10), (100, 50), (256, 256), (257, 10), (257, 300),
             (513, 1), (2000, 1000), (4000, 1000), (4000, 5000), (1000, 1024)]


@pytest.mark.parametrize("kind", ["random", "duplicates", "invalid", "int_min", "runs"])
@pytest.mark.parametrize("m,k", K2_SHAPES)
def test_k2_replay_equals_plain(m, k, kind):
    rng = np.random.default_rng(m * 7 + k)
    q_n = 1 if m >= 2000 else 3
    cands = torch.from_numpy(_rows(kind, q_n, m, rng).astype(np.int32))
    got = tm.merge_topk_rows_replay(cands, k)
    want = tm.merge_topk_rows_torch(cands, k)
    assert torch.equal(got, want)
    mpad = max(256, 1 << (m - 1).bit_length())
    padded = np.full((q_n, mpad), INV, np.int64)
    padded[:, :m] = cands.numpy()
    np.testing.assert_array_equal(got.numpy(), np.sort(padded, axis=1)[:, :min(k, mpad)])


@pytest.mark.parametrize("seed", range(4))
def test_warp_sort_run_sorts(seed):
    rng = np.random.default_rng(seed)
    keys = [rng.permutation(256), rng.integers(INT_MIN, INV, 256), np.zeros(256),
            np.arange(256)[::-1], rng.integers(0, 3, 256)][seed % 5]
    np.testing.assert_array_equal(tm.warp_sort_run(keys), np.sort(keys))


@pytest.mark.parametrize("k", [1, 10, 50, 1000, 4096, 32768])
def test_k2_rounds_fit_the_kernel(k):
    """Every row of up to 32768 keys: each round's chunks fit MAX_CHUNKS a
    thread, its runs fit shared memory, the merged lengths shrink to k and
    the last one covers min(k, the padded runs)."""
    for m in [257, 300, 511, 512, 513, 1000, 2000, 4000, 4097, 8192, 9000,
              16385, 30000, 32768]:
        kk = min(k, tm._padded_width(m))
        threads, rounds = tm.merge_rounds(m, kk)
        n_runs = -(-m // tm.RUN)
        assert threads == min(tm.MAX_THREADS, 32 * n_runs)
        keys = n_runs * tm.RUN
        assert (keys + keys // 32) * 4 <= tm.MAX_SMEM_BYTES   # one pad int in 32
        assert len(rounds) == (n_runs - 1).bit_length()
        for rd in rounds:
            assert rd.chunks <= tm.MAX_CHUNKS * threads
            assert rd.glen <= kk and rd.last_len <= rd.glen
        assert rounds[-1].groups == 1
        assert rounds[-1].last_len == min(kk, n_runs * tm.RUN)


def test_wrong_truncation_is_caught(monkeypatch):
    """A round that keeps only min(k, length) of a merged pair (not min(k,
    2 * length)) loses keys; the replay shows it."""
    good = tm.merge_rounds

    def flawed(m, k):
        threads, rounds = good(m, k)
        return threads, [rd._replace(glen=min(k, rd.length),
                                     last_len=min(k, rd.length)) for rd in rounds]
    monkeypatch.setattr(tm, "merge_rounds", flawed)
    cands = torch.from_numpy(np.random.default_rng(0).integers(
        0, 10**6, (2, 2000)).astype(np.int32))
    assert not torch.equal(tm.merge_topk_rows_replay(cands, 1000),
                           tm.merge_topk_rows_torch(cands, 1000))
