"""The port's metric exposition and model-residual monitor against the JAX
package's: ``to_prometheus`` text and ``to_json`` document identical for
the same instruments and for the registry of the same virtual-time replay
(health-aware router, a set failed and recovered, the residual monitor as
span sink); ``ModelResidualMonitor`` gauges equal given a carried-over
calibration and the same spans; and ``python -m repro_torch.obs``'s
``demo``, ``check`` and ``inert`` on the CPU."""
import dataclasses
import itertools
import json
import math

import numpy as np
import pytest

from repro.core import calibrate as ref_cal
from repro.core import faults as ref_faults
from repro.core import perfmodel as ref_pm
from repro.obs import exposition as ref_expo
from repro.obs import registry as ref_reg
from repro.obs import residual as ref_res
from repro.obs import trace as ref_trace
from repro.serving import router as ref_router
from repro.serving import scheduler as ref_sched
from repro_torch.core import calibrate as pt_cal
from repro_torch.core import faults as pt_faults
from repro_torch.core import perfmodel as pt_pm
from repro_torch.obs import __main__ as obs_cli
from repro_torch.obs import exposition as pt_expo
from repro_torch.obs import registry as pt_reg
from repro_torch.obs import residual as pt_res
from repro_torch.obs import trace as pt_trace
from repro_torch.serving import router as pt_router
from repro_torch.serving import scheduler as pt_sched

REF = dict(expo=ref_expo, reg=ref_reg, res=ref_res, trace=ref_trace,
           router=ref_router, sched=ref_sched, faults=ref_faults)
PORT = dict(expo=pt_expo, reg=pt_reg, res=pt_res, trace=pt_trace,
            router=pt_router, sched=pt_sched, faults=pt_faults)


def _fill(reg_mod, case):
    """The same instruments, in the same order, on a fresh registry."""
    reg = reg_mod.MetricsRegistry()
    if case == "counters":
        reg.counter("odys_c_total", help="a counter").inc(2)
        reg.counter("odys_c_total", help="a counter", set="1").inc(0.5)
        reg.counter("odys_other_total").inc()
    elif case == "gauges":
        reg.gauge("odys_g", help='quote " and \\ and\nnewline', lbl='a"b').set(3.25)
        reg.gauge("odys_g", lbl="x").set(-1e20)
        reg.gauge("odys_big").set(1e16)
        reg.gauge("odys_inf").set(math.inf)
    elif case == "histograms":
        h = reg.histogram("odys_h_seconds", help="phases", phase="route")
        for v in (1.5e-6, 5e-6, 3e-3, 0.2, 7.0, 1e4):
            h.observe(v)
        reg.histogram("odys_h_seconds", phase="finalize").observe(2e-4)
        reg.histogram("odys_empty_seconds")
    else:  # mixed
        reg.counter("odys_b_total").inc(7)
        reg.gauge("odys_a").set(0.1)
        reg.histogram("odys_c_seconds", custom="y").observe(0.004)
    return reg


@pytest.mark.parametrize("case", ["counters", "gauges", "histograms", "mixed"])
def test_exposition_identical(case):
    pt, rf = _fill(pt_reg, case), _fill(ref_reg, case)
    assert pt_expo.to_prometheus(pt) == ref_expo.to_prometheus(rf)
    if case == "gauges":   # an infinite gauge is not JSON: both refuse it
        for expo, reg in ((pt_expo, pt), (ref_expo, rf)):
            with pytest.raises(ValueError):
                expo.dump_json(reg)
        return
    assert pt_expo.to_json(pt) == ref_expo.to_json(rf)
    assert pt_expo.dump_json(pt) == ref_expo.dump_json(rf)
    assert json.loads(pt_expo.dump_json(pt))["format"] == "repro.obs/v1"


def test_exposition_of_null_registry_is_empty():
    assert pt_expo.to_prometheus(pt_reg.NullRegistry()) == "\n"
    assert pt_expo.to_json(pt_reg.NullRegistry()) == {
        "format": "repro.obs/v1", "metrics": {}}


# ------------------------------------------------------------ calibration --
def _ref_calibration(n_sets=1, ns=2):
    master = dataclasses.replace(
        ref_pm.PAPER_TABLE3_MASTER, T_parent_proc=2e-4, T_child_proc=0.0,
        T_master_rpc={10: 1e-5, 50: 2e-5, 1000: 6e-5}, t_comparison=3e-9,
        t_base=4e-8, t_per_context_switch=0.0)
    network = ref_pm.NetworkParams(ST_network={k: 1e-9 for k in ref_pm.KS})
    return ref_cal.Calibration(
        master=master, network=network, ns=ns,
        st_slave={10: 4e-4, 50: 5e-4}, st_master={10: 2.5e-4, 50: 3e-4},
        slave_max={10: 4.4e-4, 50: 5.6e-4}, t_comparison=3e-9, t_base=4e-8,
        n_sets=n_sets)


def _carry(cal):
    return pt_cal.calibration_from_fields(**dataclasses.asdict(cal))


def test_calibration_carries_over_field_by_field():
    rc = _ref_calibration(n_sets=2)
    pc = _carry(rc)
    assert dataclasses.asdict(pc) == dataclasses.asdict(rc)
    for lam in (10.0, 500.0, 2000.0, 4000.0):
        for mix in ("SINGLE_10_ONLY", "QUERY_MIX_DEFAULT"):
            got = pc.projected_response(lam, batch_size=8, max_wait=1e-3,
                                        mix=getattr(pt_pm, mix))
            want = rc.projected_response(lam, batch_size=8, max_wait=1e-3,
                                         mix=getattr(ref_pm, mix))
            assert got == want or (math.isinf(got) and math.isinf(want))
    assert pc.with_sets(3).slave_max_time("single", 1000, 50.0, 2) == (
        rc.with_sets(3).slave_max_time("single", 1000, 50.0, 2))


@pytest.mark.parametrize("lam,batch_size,max_wait",
                         [(50.0, 2, 0.01), (None, 4, 0.0), (800.0, 32, 2e-3)])
def test_residual_monitor_equal_on_same_spans(lam, batch_size, max_wait):
    rc = _ref_calibration()
    outs = []
    for mods, cal in ((PORT, _carry(rc)), (REF, rc)):
        reg = mods["reg"].MetricsRegistry()
        mon = mods["res"].ModelResidualMonitor(
            cal, batch_size=batch_size, max_wait=max_wait, lam=lam, registry=reg)
        for i, r in enumerate([0.002, 0.004, 0.003, 0.005, 0.0025]):
            s = mods["trace"].QuerySpan(qid=i, submit_time=i / 400.0)
            s.finish_time = i / 400.0 + r
            mon.sink(s)
        hit = mods["trace"].QuerySpan(qid=99, submit_time=0.0, from_cache=True)
        hit.finish_time = 0.0
        mon.sink(hit)
        outs.append((mon.update(), mods["expo"].to_prometheus(reg)))
    assert outs[0] == outs[1]
    assert math.isfinite(outs[0][0]["error"])
    assert "odys_model_spans_skipped_total 1" in outs[0][1]


def test_residual_monitor_nan_before_samples():
    out = pt_res.ModelResidualMonitor(None, batch_size=2).update()
    assert math.isnan(out["error"]) and out["n"] == 0


def _replay(mods, cal):
    """The same virtual-time replay in either package: a two-set
    health-aware router (set 1 fails after the 10th finished span and
    recovers after the 20th), a cache, the residual monitor as span sink,
    and deterministic clocks."""
    reg = mods["reg"].MetricsRegistry()
    health = mods["faults"].SetHealth.all_alive(2)
    router = mods["router"].HealthAwareRouter(2, health)
    mon = mods["res"].ModelResidualMonitor(cal, batch_size=4, max_wait=2e-3,
                                           registry=reg)
    seen = []

    def sink(span):
        mon.sink(span)
        seen.append(span.set_id)
        if len(seen) == 10:
            health.fail(1)
        if len(seen) == 20:
            health.recover(1)

    ticks = itertools.count()
    sch = mods["sched"].MasterScheduler(
        lambda qs, t_max, k, sid: [(tuple(q[0]), k, sid) for q in qs],
        batch_size=4, t_max_buckets=(2, 4), cache_size=8, max_wait=2e-3,
        registry=reg, router=router, span_sink=sink,
        wall_clock=lambda: next(ticks) * 1e-4)
    rng = np.random.default_rng(11)
    arrivals = np.cumsum(rng.exponential(1 / 900.0, size=60))
    trace = [(float(t), [int(x) for x in rng.integers(0, 12, 1 + i % 3)], None)
             for i, t in enumerate(arrivals)]
    tickets = sch.replay(trace)
    return ([(t.result, t.set_id, t.from_cache, t.response_time) for t in tickets],
            mon.update(), mods["expo"].to_prometheus(reg),
            mods["expo"].dump_json(reg), seen)


def test_replay_registry_exposition_identical():
    rc = _ref_calibration()
    got, want = _replay(PORT, _carry(rc)), _replay(REF, rc)
    assert got[0] == want[0]          # results, sets, cache hits, responses
    assert got[1] == want[1]          # the monitor's numbers
    assert got[2] == want[2]          # Prometheus text
    assert got[3] == want[3]          # JSON document
    assert got[4] == want[4]
    assert 'odys_set_health_transitions_total{to="dead"} 1' in got[2]
    assert math.isfinite(got[1]["error"])


# -------------------------------------------------------------------- CLI --
@pytest.fixture
def restore_registry():
    prev = pt_reg.get_registry()
    yield
    pt_reg.set_registry(prev)


def test_obs_cli_demo_check_inert_on_cpu(tmp_path, restore_registry, capsys):
    out = str(tmp_path / "obs")
    assert obs_cli.main(["demo", "--out", out, "--device", "cpu", "--queries", "24"]) == 0
    assert obs_cli.main(["check", "--out", out]) == 0
    doc = json.loads((tmp_path / "obs" / "metrics.json").read_text())
    assert set(obs_cli.REQUIRED_FAMILIES) <= set(doc["metrics"])
    res = doc["metrics"]["odys_model_residual"]["series"][0]["value"]
    assert math.isfinite(res)
    assert obs_cli.main(["inert", "--device", "cpu", "--queries", "16"]) == 0
    text = capsys.readouterr().out
    assert "0 problem(s)" in text and "identical with metrics on and off" in text


def test_obs_cli_check_flags_problems(tmp_path, restore_registry):
    bad = tmp_path / "bad"
    bad.mkdir()
    assert obs_cli.main(["check", "--out", str(bad)]) == 1
    (bad / "metrics.json").write_text(json.dumps(
        {"format": "other", "metrics": {"odys_queue_depth": {
            "kind": "counter", "help": "", "series": []}}}))
    assert obs_cli.main(["check", "--out", str(bad)]) == 1


def test_obs_cli_refuses_without_a_card(monkeypatch, restore_registry):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        obs_cli.main(["inert"])
