"""K9's and K10's streams on the CPU: the skip ranges that the producer warp
of ``csrc/staged_join.cu`` derives (``SkipPlan`` in
``csrc/slave_join.cuh``), stated on the host by
``posting_intersect.skip_streams``.

The kernel cannot run here, so these tests hold its arithmetic:

- ``skip_streams`` against the skip map read directly (each active slot's
  positions ``[b_start * TILE, min((b_start + n_b) * TILE, W_b))`` of its
  own window row, empty where ``n_b`` is 0; inactive slots ``(0, 0)``), on
  the shapes of ``test_torch_block_skip.test_k9_plain_matches_reference``
  (inactive slots, an active empty window, an empty driver) and at an
  other-term window of 65536 whose skip ranges pass one round of the
  probe's buffer (``RAW_CAP``, 4096 postings);
- a host replay of K9's membership over those streams (a driver slot kept
  while valid, live, passing the filter and found in every active slot's
  stream) against ``batched_block_skip_join_torch`` and the reference's
  Pallas K9 in interpret mode (ROADMAP R2), with and without ``a_live``;
- the streams' staging precondition (``ranges_staging_check``: each
  starts on 16 bytes and ends, rounded up, inside ``b_docs``), and the
  wrapper's refusal of a ``b_docs`` that does not start on 16 bytes, before
  any launch (the launch replaced, as ``test_torch_probe_staging.py`` does
  for K1 and K4);
- K10, the same kernel body at Q = T = 1: ``skip_streams`` of its skip map
  equal to the ranges of ``compute_skip_map(a, b)`` on 1-D lists (a skip
  range past one round of 4096 postings, an empty ``b``), its membership
  replayed over them against ``block_skip_join_torch`` and the reference's
  Pallas K10, the ranges' staging precondition, and its wrapper's refusal
  of a misaligned ``b_docs`` view (launch replaced).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as ref_ops
from repro_torch.core import index as pt_index
from repro_torch.kernels import _build
from repro_torch.kernels import posting_intersect as pi

INV = int(pt_index.INVALID_DOC)
TILE = pt_index.TILE
RAW_CAP = 4096           # postings a raw round buffer of probe_async.cuh holds
SHAPES = [(1024, 1024), (1000, 3000), (2048, 1536), (3000, 700)]


def _sorted_list(rng, n, valid, hi):
    v = np.sort(rng.choice(hi, size=valid, replace=False)).astype(np.int32)
    return np.concatenate([v, np.full(n - valid, INV, np.int32)])


def _inputs(w_a, w_b, with_live):
    """``test_k9_plain_matches_reference``'s inputs: 5 queries, 3 slots,
    the driver's own docs mostly in each window, slot (3, 1) an active
    empty window, query 4 with no active slot, query 2 an empty driver."""
    rng = np.random.default_rng(w_a * 7 + w_b)
    q_n, t_n, hi = 5, 3, 6000
    a = np.stack([_sorted_list(rng, w_a, v, hi)
                  for v in (w_a, w_a // 2, 0, min(w_a, 300), w_a // 3)])
    b = np.full((q_n, t_n, w_b), INV, np.int32)
    for q in range(q_n):
        for t in range(t_n):
            own = a[q][a[q] != INV]
            keep = own[rng.random(own.size) < 0.7]
            extra = rng.choice(hi, size=min(w_b // 3, 500), replace=False)
            docs = np.unique(np.concatenate([keep, extra]))[:w_b]
            b[q, t, :docs.size] = docs
    b[3, 1] = INV
    active = np.array([[1, 1, 0], [1, 0, 1], [1, 1, 1], [1, 1, 1], [0, 0, 0]],
                      np.int32)
    attrs = rng.integers(0, 4, size=(q_n, w_a)).astype(np.int32)
    filt = np.array([-1, 2, -1, 1, 3], np.int32)
    live = (rng.random((q_n, w_a)) < 0.8).astype(np.int32) if with_live else None
    return a, attrs, b, active, filt, live


def _wide_inputs(with_live):
    """One other-term window of 65536 postings per slot, dense against the
    driver's docIDs, so that a driver tile's skip range spans more than
    four B tiles (more than one RAW_CAP round)."""
    rng = np.random.default_rng(65536)
    q_n, t_n, w_a, w_b = 2, 2, 2048, 65536
    a = np.stack([_sorted_list(rng, w_a, w_a, 10**6), _sorted_list(rng, w_a, 1500, 10**6)])
    b = np.full((q_n, t_n, w_b), INV, np.int32)
    for q in range(q_n):
        for t in range(t_n):
            own = a[q][a[q] != INV]
            docs = np.unique(np.concatenate([own[rng.random(own.size) < 0.8],
                                             rng.choice(10**6, 60000, replace=False)]))
            b[q, t, :min(docs.size, w_b)] = docs[:w_b]
    active = np.ones((q_n, t_n), np.int32)
    attrs = rng.integers(0, 4, size=(q_n, w_a)).astype(np.int32)
    filt = np.array([-1, 1], np.int32)
    live = (rng.random((q_n, w_a)) < 0.9).astype(np.int32) if with_live else None
    return a, attrs, b, active, filt, live


CASES = [(w_a, w_b) for w_a, w_b in SHAPES] + ["wide"]


def _case(case, with_live):
    return _wide_inputs(with_live) if case == "wide" else _inputs(*case, with_live)


def _args(a, attrs, b, active, filt, live):
    t = lambda x: None if x is None else torch.from_numpy(np.array(x))
    return pi.batched_block_skip_args(t(a), t(attrs), t(b), t(active), t(filt), t(live))


def _ids(case):
    return "wide" if case == "wide" else f"{case[0]}x{case[1]}"


def _map_ranges(b_start, n_b, active, w_b):
    """Each (q, t, i) range read straight off the skip map, in loops."""
    q_n, t_n, num_a = b_start.shape
    lo = np.zeros(b_start.shape, np.int64)
    hi = np.zeros(b_start.shape, np.int64)
    for q in range(q_n):
        for t in range(t_n):
            if not active[q, t]:
                continue
            row = (q * t_n + t) * w_b
            for i in range(num_a):
                s, n = int(b_start[q, t, i]), int(n_b[q, t, i])
                r0 = s * TILE
                r1 = min((s + n) * TILE, w_b) if n > 0 else r0
                lo[q, t, i], hi[q, t, i] = row + r0, row + max(r1, r0)
    return lo, hi


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_skip_streams_are_the_skip_map(case):
    a9 = _args(*_case(case, False))
    b, active, b_start, n_b = a9[3], a9[4], a9[6], a9[7]
    w_b = b.shape[-1]
    lo, hi, act = pi.skip_streams(b_start, n_b, active, w_b)
    assert lo.shape == hi.shape == act.shape == b_start.shape
    want_lo, want_hi = _map_ranges(b_start.numpy(), n_b.numpy(), active.numpy(), w_b)
    np.testing.assert_array_equal(lo.numpy(), want_lo)
    np.testing.assert_array_equal(hi.numpy(), want_hi)
    np.testing.assert_array_equal(act.numpy(), np.broadcast_to(
        (active.numpy() != 0)[:, :, None], b_start.shape).astype(np.int64))
    # each stream inside its own window row
    row = (torch.arange(b.shape[0] * b.shape[1]).view(b.shape[:2]) * w_b)[:, :, None]
    on = act > 0
    assert bool(((lo >= row) & (hi <= row + w_b) & (lo <= hi))[on].all())
    if case != "wide":
        # the active empty window (3, 1) has empty streams only; query 4 none
        assert bool((hi[3, 1] == lo[3, 1]).all()) and bool((act[3, 1] == 1).all())
        assert bool((act[4] == 0).all()) and bool((hi[4] == 0).all())
    else:
        assert int((hi - lo).max()) > RAW_CAP
    # active None: every slot active
    lo_all, _, act_all = pi.skip_streams(b_start, n_b, None, w_b)
    assert bool((act_all == 1).all())
    assert torch.equal(lo_all[on], lo[on])


def _replay(a9):
    """K9's membership over its streams, slot by slot on the host."""
    a, attrs, live, b, active, filt, b_start, n_b = (
        None if x is None else x.numpy() for x in a9)
    q_n, w_a = a.shape
    t_n, w_b = b.shape[1:]
    lo, hi, act = (x.numpy() for x in pi.skip_streams(*(torch.from_numpy(x) for x in
                                                         (b_start, n_b, active)), w_b))
    flat = b.reshape(-1)
    out = np.zeros((q_n, w_a), np.int32)
    for q in range(q_n):
        for i in range(w_a // TILE):
            x = a[q, i * TILE:(i + 1) * TILE]
            at = attrs[q, i * TILE:(i + 1) * TILE]
            keep = (x != INV) & ((filt[q] < 0) | (at == filt[q]))
            if live is not None:
                keep &= live[q, i * TILE:(i + 1) * TILE] != 0
            for t in range(t_n):
                if act[q, t, i]:
                    keep &= np.isin(x, flat[lo[q, t, i]:hi[q, t, i]])
            out[q, i * TILE:(i + 1) * TILE] = keep
    return out


@pytest.mark.parametrize("with_live", [False, True])
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_stream_replay_is_k9(case, with_live):
    a, attrs, b, active, filt, live = _case(case, with_live)
    a9 = _args(a, attrs, b, active, filt, live)
    got = _replay(a9)
    plain = pi.batched_block_skip_join_torch(*a9).numpy()
    np.testing.assert_array_equal(got, plain)
    want = ref_ops.intersect_batched(
        jnp.asarray(a), jnp.asarray(attrs), jnp.asarray(b), jnp.asarray(active),
        jnp.asarray(filt), a_live=None if live is None else jnp.asarray(live))
    np.testing.assert_array_equal(got[:, :a.shape[1]], np.asarray(want))
    assert int(got.sum()) > 0


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_streams_stage(case):
    a9 = _args(*_case(case, True))
    b = a9[3]
    lo, hi, _ = pi.skip_streams(a9[6], a9[7], a9[4], b.shape[-1])
    assert pi.ranges_staging_check(lo, hi, n_postings=b.numel()) > 0
    assert bool((lo % 4 == 0).all())
    # a range shifted by one posting is refused
    shifted = lo + (hi > lo).long()
    with pytest.raises(ValueError, match="16-byte"):
        pi.ranges_staging_check(shifted, hi + 1, n_postings=b.numel() + 4)


class _Launched(Exception):
    """Raised in place of a launch: the wrapper's checks all passed."""


@pytest.mark.parametrize("flaw", [None, "start", "aligned offset"])
def test_wrapper_refuses_misaligned_b_docs(monkeypatch, flaw):
    """The K9 wrapper refuses, before its launch, a ``b_docs`` view that
    does not start on 16 bytes, and launches with one that does (also a
    view four elements into its buffer)."""
    a9 = list(_args(*_case((1024, 1024), True)))
    b = a9[3]
    buf = torch.full((b.numel() + 8,), INV, dtype=torch.int32)
    at = {None: 0, "start": 1, "aligned offset": 4}[flaw]
    assert buf.data_ptr() % 16 == 0      # the CPU allocator aligns on 64 bytes
    view = buf[at:at + b.numel()].view(b.shape)
    view.copy_(b)
    a9[3] = view
    monkeypatch.setattr(_build, "check_args", lambda *a, **k: None)

    def launch(name):
        raise _Launched(name)

    monkeypatch.setattr(_build, "kernel", launch)
    if flaw == "start":
        with pytest.raises(ValueError, match="16-byte alignment"):
            pi.batched_block_skip_join_cuda(*a9)
    else:
        with pytest.raises(_Launched, match="batched_block_skip"):
            pi.batched_block_skip_join_cuda(*a9)


# ----------------------------------------------------------------- K10 --
# (n_a, valid_a, n_b, valid_b, docID range): the reference kernel tests'
# sweep, bench_kernels.py's shape, skip ranges past one round (RAW_CAP), an
# empty b
K10_CASES = [(1024, 1024, 1024, 1024, 50_000), (1024, 500, 2048, 1700, 50_000),
             (2048, 2048, 1024, 64, 50_000), (1024, 0, 1024, 512, 50_000),
             (4096, 4000, 8192, 8000, 10**6), (2048, 2000, 65536, 60000, 10**5),
             (2048, 2000, 1024, 0, 10**5)]


def _k10_case(case):
    na, va, nb, vb, hi = case
    rng = np.random.default_rng(na + va + nb + vb)
    a = _sorted_list(rng, na, va, hi)
    b = _sorted_list(rng, nb, vb, hi)
    attrs = rng.integers(0, 5, size=na).astype(np.int32)
    return a, attrs, b


def _k10_ids(case):
    return f"{case[0]}-{case[1]}x{case[2]}-{case[3]}"


@pytest.mark.parametrize("case", K10_CASES, ids=_k10_ids)
def test_k10_streams_are_the_skip_map(case):
    """K10's plan is K9's at Q = T = 1 with every slot active: one stream a
    driver tile, exactly the skip map's range of the 1-D list."""
    a, attrs, b = _k10_case(case)
    a10 = pi.block_skip_args(torch.from_numpy(a), torch.from_numpy(attrs),
                             torch.from_numpy(b), -1)
    a_p, _, b_p, _, b_start, n_b = a10
    w_b = b_p.shape[0]
    bs_map, nb_map = pi.compute_skip_map(a_p, b_p)
    assert torch.equal(bs_map, b_start) and torch.equal(nb_map, n_b)
    lo, hi, act = pi.skip_streams(b_start[None, None], n_b[None, None], None, w_b)
    assert lo.shape == (1, 1, a_p.shape[0] // TILE) and bool((act == 1).all())
    want_lo, want_hi = _map_ranges(bs_map[None, None].numpy(), nb_map[None, None].numpy(),
                                   np.ones((1, 1), np.int32), w_b)
    np.testing.assert_array_equal(lo.numpy(), want_lo)
    np.testing.assert_array_equal(hi.numpy(), want_hi)
    assert bool(((lo >= 0) & (lo <= hi) & (hi <= w_b)).all())
    if case[3] == 0:
        assert bool((hi == lo).all())                 # an empty b: no range
    if case[2] == 65536:
        assert int((hi - lo).max()) > RAW_CAP         # past one round


@pytest.mark.parametrize("attr_filter", [-1, 2])
@pytest.mark.parametrize("case", K10_CASES, ids=_k10_ids)
def test_k10_stream_replay_is_k10(case, attr_filter):
    a, attrs, b = _k10_case(case)
    a10 = pi.block_skip_args(torch.from_numpy(a), torch.from_numpy(attrs),
                             torch.from_numpy(b), attr_filter)
    a_p, at_p, b_p, filt, b_start, n_b = a10
    one = torch.ones((1, 1), dtype=torch.int32)
    got = _replay((a_p[None], at_p[None], None, b_p[None, None], one, filt,
                   b_start[None, None], n_b[None, None]))[0]
    np.testing.assert_array_equal(got, pi.block_skip_join_torch(*a10).numpy())
    want = ref_ops.intersect(jnp.asarray(a), jnp.asarray(attrs), jnp.asarray(b),
                             attr_filter)
    np.testing.assert_array_equal(got[:a.shape[0]], np.asarray(want))
    lo, hi, _ = pi.skip_streams(b_start[None, None], n_b[None, None], None, b_p.shape[0])
    if int((hi > lo).sum()):
        assert pi.ranges_staging_check(lo, hi, n_postings=b_p.numel()) > 0
    if case[3] == 0:
        assert int(got.sum()) == 0                    # every slot dies


@pytest.mark.parametrize("flaw", [None, "start", "aligned offset"])
def test_k10_wrapper_refuses_misaligned_b_docs(monkeypatch, flaw):
    """The K10 wrapper refuses, before its launch, a ``b_docs`` view that
    does not start on 16 bytes, and launches with one that does;
    ``block_skip_args`` copies a misaligned list, so its operands pass."""
    a, attrs, b = _k10_case(K10_CASES[1])
    a10 = list(pi.block_skip_args(torch.from_numpy(a), torch.from_numpy(attrs),
                                  torch.from_numpy(b), -1))
    b_p = a10[2]
    buf = torch.full((b_p.numel() + 8,), INV, dtype=torch.int32)
    at = {None: 0, "start": 1, "aligned offset": 4}[flaw]
    assert buf.data_ptr() % 16 == 0
    view = buf[at:at + b_p.numel()]
    view.copy_(b_p)
    a10[2] = view
    monkeypatch.setattr(_build, "check_args", lambda *a, **k: None)

    def launch(name):
        raise _Launched(name)

    monkeypatch.setattr(_build, "kernel", launch)
    if flaw == "start":
        with pytest.raises(ValueError, match="16-byte alignment"):
            pi.block_skip_join_cuda(*a10)
        fixed = pi.block_skip_args(a10[0], a10[1], view, -1)
        assert fixed[2].data_ptr() % 16 == 0 and torch.equal(fixed[2], view)
    else:
        with pytest.raises(_Launched, match="block_skip"):
            pi.block_skip_join_cuda(*a10)
    assert pi.block_skip_join_cuda.launches == 0
