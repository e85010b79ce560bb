"""The port's closed-loop calibration against the JAX package's.

With ``_timed`` scripted to the same times in both modules, both fit the
same ``MasterParams``, ``st_slave``, ``st_master``, ``slave_max``,
``t_comparison``, ``t_base`` and projections, to the last bit; the timed
functions themselves return the same results in both.  Scripted timings
that put all the time in the slave phase fit ``st_master`` to ``_FLOOR``.
An unscripted CPU run gives positive, finite constants and a finite
Formula (18) error on a virtual-time replay.  ``_timed`` synchronises a
CUDA device after every call."""
import dataclasses
import math

import numpy as np
import pytest
import torch

import jax

from repro.core import calibrate as ref_cal
from repro.core import index as ref_index
from repro.core import perfmodel as ref_pm
from repro.data import corpus as ref_corpus
from repro_torch.core import calibrate as pt_cal
from repro_torch.core import index as pt_index
from repro_torch.core import perfmodel as pt_pm
from repro_torch.core.faults import SetHealth
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.residual import ModelResidualMonitor
from repro_torch.serving.search import SearchService

CFG = dict(n_docs=600, vocab_size=200, mean_doc_len=25, n_sites=8, seed=3)


@pytest.fixture(scope="module", params=[1, 2, 4])
def engines(request):
    ns = request.param
    corpus = ref_corpus.generate_corpus(ref_corpus.CorpusConfig(**CFG))
    rsh, meta = ref_index.build_sharded_index(corpus, ns)
    psh = pt_index.sharded_index_from_numpy(
        {f: np.asarray(v) for f, v in rsh._asdict().items()}, device="cpu")
    return ns, rsh, meta, psh, pt_index.IndexMeta(**vars(meta))


def _numpy(out):
    """A timed function's result as plain Python / numpy, either package."""
    if isinstance(out, list):
        return out
    if hasattr(out, "_asdict"):
        return {f: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
                for f, v in out._asdict().items()}
    return np.asarray(out.cpu() if isinstance(out, torch.Tensor) else out)


class Script:
    """A stand-in for ``_timed``: returns scripted times that depend only on
    the call's kind, top-k, width and order.  With ``run`` it also runs the
    function once and keeps the result, to compare across packages (the
    reference's slave phase on ns > 1 shards needs ns jax devices, so there
    only the arithmetic is compared)."""

    def __init__(self, slave_share=0.6, run=True):
        self.calls, self.results = [], []
        self.slave_share = slave_share
        self.run = run

    def __call__(self, fn, *args, reps=3, device=None, **kw):
        if self.run:
            self.results.append(_numpy(fn(*args, **kw)))
        name = getattr(fn, "__name__", "")
        n = len(self.calls)
        if name == "slave_topk_unmerged":
            kind, size = "slave", kw["k"]
        elif name == "master_path":
            kind, size = "master", len(args[0])
        else:
            kind, size = "merge", int(args[0].shape[1])
        self.calls.append((kind, size, reps))
        if kind == "merge":
            base = 2e-8 * size * (1 + 0.1 * math.log2(size)) + 1e-6
        elif kind == "slave":
            base = 1e-4 * self.slave_share * (1 + size / 500) * (1 + 0.03 * (n % 5))
        elif self.slave_share >= 1:  # all the time in the slave phase
            return list(self.slave_times)
        else:  # the master path: its slave phase's k, one call back
            k = self.calls[-2][1]
            base = 1e-4 * (1 + k / 500) * (1 + 0.03 * ((n - 1) % 5))
        times = [base * (1 + 0.05 * ((i * 7 + n) % 3)) for i in range(reps)]
        if kind == "slave":
            self.slave_times = times
        return times


def _calibrate(engines, monkeypatch, slave_share=0.6, **kw):
    ns, rsh, meta, psh, pmeta = engines
    s_ref, s_port = Script(slave_share, ns == 1), Script(slave_share, ns == 1)
    monkeypatch.setattr(ref_cal, "_timed", s_ref)
    monkeypatch.setattr(pt_cal, "_timed", s_port)
    kw = dict(ns=ns, window=1024, q=4, reps=2, **kw)
    want = ref_cal.calibrate_from_engine(rsh, meta, jax.make_mesh((1,), ("data",)),
                                         backend="jnp", **kw)
    got = pt_cal.calibrate_from_engine(psh, pmeta, **kw)
    return got, want, s_port, s_ref


@pytest.mark.parametrize("k_values", [(10,), (10, 50), (10, 50, 1000)])
@pytest.mark.parametrize("merge", ["tournament", "allgather"])
def test_scripted_calibration_equals_reference(engines, monkeypatch, k_values, merge):
    got, want, s_port, s_ref = _calibrate(engines, monkeypatch, k_values=k_values,
                                          merge=merge)
    assert s_port.calls == s_ref.calls
    assert len(s_port.results) == (len(s_port.calls) if engines[0] == 1 else 0)
    for i, (g, w) in enumerate(zip(s_port.results, s_ref.results)):
        if isinstance(g, dict):
            for f in g:
                np.testing.assert_array_equal(g[f], w[f], err_msg=f"call {i} {f}")
        elif isinstance(g, list):
            assert g == w, f"call {i}"
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"call {i}")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.master.T_parent_proc > 0 and got.t_comparison > 0
    for lam in (1.0, 100.0, 0.5 * got.max_stable_load()):
        for bs, mw in ((1, 0.0), (32, 1e-3)):
            assert got.projected_response(lam, batch_size=bs, max_wait=mw) == (
                want.projected_response(lam, batch_size=bs, max_wait=mw))
    cluster = pt_pm.engine_cluster(got.ns)
    assert pt_pm.OdysPerfModel(master=got.master, network=got.network).max_stable_load(
        cluster, pt_pm.SINGLE_10_ONLY) == ref_pm.OdysPerfModel(
        master=want.master, network=want.network).max_stable_load(
        ref_pm.engine_cluster(want.ns), ref_pm.SINGLE_10_ONLY)


@pytest.mark.parametrize("widths", [(2, 4, 8), (2, 4)])
@pytest.mark.parametrize("k_values", [(10,), (10, 50, 1000)])
def test_scripted_merge_fit_equals_reference(monkeypatch, widths, k_values):
    s_ref, s_port = Script(), Script()
    monkeypatch.setattr(ref_cal, "_timed", s_ref)
    monkeypatch.setattr(pt_cal, "_timed", s_port)
    got = pt_cal.fit_merge_constants(k_values=k_values, widths=widths, q=4, reps=2,
                                     device="cpu", seed=5)
    want = ref_cal.fit_merge_constants(k_values=k_values, widths=widths, q=4, reps=2,
                                       backend="jnp", seed=5)
    assert got == want
    for g, w in zip(s_port.results, s_ref.results):
        np.testing.assert_array_equal(g, w)


def test_scripted_all_time_in_slaves_floors_st_master(engines, monkeypatch):
    got, want, _, _ = _calibrate(engines, monkeypatch, slave_share=1.0,
                                 k_values=(10, 50))
    assert got.st_master == {10: pt_cal._FLOOR, 50: pt_cal._FLOOR}
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.master.T_parent_proc == pt_cal._FLOOR


def test_calibration_from_fields_round_trip():
    cal = pt_cal.Calibration(
        master=pt_pm.PAPER_TABLE3_MASTER, network=pt_pm.PAPER_TABLE3_NETWORK, ns=4,
        st_slave={10: 1e-4}, st_master={10: 5e-5}, slave_max={10: 1.2e-4},
        t_comparison=1e-9, t_base=2e-8, n_sets=2)
    assert pt_cal.calibration_from_fields(**dataclasses.asdict(cal)) == cal


def test_max_stable_load_is_the_tighter_tier():
    cal = pt_cal.Calibration(
        master=pt_pm.PAPER_TABLE3_MASTER, network=pt_pm.PAPER_TABLE3_NETWORK, ns=4,
        st_slave={10: 1e-2, 50: 2e-2}, st_master={10: 5e-5, 50: 6e-5},
        slave_max={10: 1.2e-2, 50: 2.2e-2}, t_comparison=1e-9, t_base=2e-8)
    assert cal.max_stable_load() == 1 / 1e-2
    assert cal.with_sets(2).max_stable_load() == 2 / 1e-2
    assert cal.max_stable_load(pt_pm.QUERY_MIX_DEFAULT) == 1 / 2e-2
    lam = cal.max_stable_load()
    assert math.isfinite(cal.projected_response(0.99 * lam))
    assert math.isinf(cal.projected_response(lam))


def test_timed_synchronises_the_card_after_every_call(monkeypatch):
    events = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: events.append(("sync", d)))
    dev = torch.device("cuda", 0)
    times = pt_cal._timed(lambda x: events.append(("call", x)), 7, reps=3, device=dev)
    assert len(times) == 3 and all(t >= 0 for t in times)
    assert events == [("call", 7), ("sync", dev)] * 4
    events.clear()
    pt_cal._timed(lambda: events.append("call"), reps=2, device=torch.device("cpu"))
    assert events == ["call"] * 3


def test_calibration_needs_the_unit_query(engines):
    ns, _, _, psh, pmeta = engines
    with pytest.raises(ValueError, match="k=10"):
        pt_cal.calibrate_from_engine(psh, pmeta, ns=ns, k_values=(50,))


# --------------------------------------------------------- unscripted CPU run
@pytest.fixture(scope="module")
def cal(engines):
    ns, _, _, psh, pmeta = engines
    return pt_cal.calibrate_from_engine(psh, pmeta, ns=ns, k_values=(10, 50),
                                        window=256, q=4, reps=2)


def test_fit_merge_constants_positive():
    t_cmp, t_base, raw = pt_cal.fit_merge_constants(
        k_values=(10,), widths=(2, 4), q=4, reps=2, device="cpu")
    assert t_cmp > 0 and t_base > 0 and all(v > 0 for v in raw.values())


def test_calibration_is_measured_not_paper(cal):
    m = cal.master
    assert set(m.T_master_rpc) == set(pt_pm.KS)
    assert m.T_parent_proc > 0 and m.T_parent_proc != pt_pm.PAPER_TABLE3_MASTER.T_parent_proc
    assert m.t_per_context_switch == 0.0
    for k in (10, 50):
        assert cal.st_slave[k] > 0 and cal.st_master[k] > 0
        assert cal.slave_max[k] >= cal.st_slave[k] * 0.5
    for v in (cal.t_comparison, cal.t_base, *m.T_master_rpc.values()):
        assert math.isfinite(v) and v > 0


def test_slave_max_time_bends_with_load(cal):
    low = cal.slave_max_time("single", 10, 1.0, cal.ns)
    high = cal.slave_max_time("single", 10, 0.9 / cal.st_slave[10], cal.ns)
    assert high > low
    assert cal.slave_max_time("single", 1000, 1.0, cal.ns) == pytest.approx(
        cal.slave_max_time("single", 50, 1.0, cal.ns))


def test_replay_vs_model_formula18(engines, cal):
    """A health-aware two-set service replays a Poisson trace in virtual
    time with the residual monitor as span sink; the measured mean and the
    projection give a finite Formula (18) error, and the monitor's gauge
    equals the offline number at the same rate."""
    ns, _, _, psh, pmeta = engines
    reg = MetricsRegistry()
    cal2 = cal.with_sets(2)
    lam = 0.25 * cal2.max_stable_load()
    mon = ModelResidualMonitor(cal2, batch_size=4, lam=lam, registry=reg)
    health = SetHealth.all_alive(2)
    svc = SearchService(psh, pmeta, ns=ns, k=10, window=256, t_max=2,
                        t_max_buckets=(2,), batch_size=4, cache_size=0, n_sets=2,
                        set_health=health, registry=reg, device="cpu")
    svc.search([([i], None) for i in range(4)])  # warm
    svc.scheduler.span_sink = mon.sink
    rng = np.random.default_rng(0)
    arrivals = np.cumsum(rng.exponential(1.0 / lam, size=24))
    trace = [(float(t), [int(rng.integers(0, 64))], None) for t in arrivals]
    tickets = svc.scheduler.replay(trace[:12])
    health.fail(1)
    tickets += svc.scheduler.replay(trace[12:])
    assert all(t.done for t in tickets)
    assert {t.set_id for t in tickets[12:]} == {0}
    measured = float(np.mean([t.response_time for t in tickets]))
    projected = cal2.projected_response(lam, batch_size=4)
    err = pt_pm.estimation_error(projected, measured)
    assert measured > 0 and projected > 0 and math.isfinite(err)
    online = mon.update()
    assert online["projected"] == projected
    assert online["measured"] == pytest.approx(measured)
    assert reg.gauge("odys_model_residual").value == online["error"]
