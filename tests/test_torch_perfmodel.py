"""The port's hybrid performance model against the JAX package's: every
``OdysPerfModel`` formula over a grid of arrival rates, clusters, top-k,
search-condition types and both mixes; the paper's headline arithmetic;
the partitioning method, the slave-max model and its calibration, and the
discrete-event simulator on the same samples and seeds.  Both packages do
the same float64 arithmetic, so every comparison is exact."""
import dataclasses
import math

import numpy as np
import pytest

from repro.core import perfmodel as ref_pm
from repro.core import simulate as ref_sim
from repro.core import slave_max as ref_sm
from repro_torch.core import perfmodel as pt_pm
from repro_torch.core import simulate as pt_sim
from repro_torch.core import slave_max as pt_sm

CLUSTERS = {
    "five-node": dict(nm=1, ncm=4, ns=5, nh=1),
    "paper-set": dict(nm=4, ncm=4, ns=300, nh=11),
    "engine-4": dict(nm=1, ncm=1, ns=4, nh=1, nps=1),
}
MIXES = ("SINGLE_10_ONLY", "QUERY_MIX_DEFAULT")
LAMBDAS = (0.0, 1.0, 40.5, 81.0, 266.0, 5000.0)


def _pair(cluster):
    return (ref_pm.ClusterConfig(**CLUSTERS[cluster]),
            pt_pm.ClusterConfig(**CLUSTERS[cluster]))


def _slave(sct, k, lam, ns):
    """One deterministic slave-max function both models are given."""
    return 1e-3 * (1 + len(sct)) * math.log(k) * (1 + lam / 1e4) * math.log1p(ns)


def test_paper_constants_are_the_references():
    assert dataclasses.asdict(pt_pm.PAPER_TABLE3_MASTER) == dataclasses.asdict(
        ref_pm.PAPER_TABLE3_MASTER)
    assert dataclasses.asdict(pt_pm.PAPER_TABLE3_NETWORK) == dataclasses.asdict(
        ref_pm.PAPER_TABLE3_NETWORK)
    assert (pt_pm.KS, pt_pm.SCTS, pt_pm.MS, pt_pm.US) == (
        ref_pm.KS, ref_pm.SCTS, ref_pm.MS, ref_pm.US)
    for name in MIXES:
        assert dict(getattr(pt_pm, name).qmr) == dict(getattr(ref_pm, name).qmr)


@pytest.mark.parametrize("ns", [1, 2, 5, 64, 300])
@pytest.mark.parametrize("k", [10, 50, 1000])
def test_master_params_formulas_4_to_8(k, ns):
    r, p = ref_pm.PAPER_TABLE3_MASTER, pt_pm.PAPER_TABLE3_MASTER
    for name in ("T_merge", "T_context_switch", "ST_master", "ST_master_cpu",
                 "ST_master_membus", "w_master"):
        assert getattr(p, name)(k, ns) == getattr(r, name)(k, ns), name
    assert pt_pm.PAPER_TABLE3_NETWORK.w_network(k) == (
        ref_pm.PAPER_TABLE3_NETWORK.w_network(k))


@pytest.mark.parametrize("mix", MIXES)
@pytest.mark.parametrize("cluster", sorted(CLUSTERS))
@pytest.mark.parametrize("lam", LAMBDAS)
def test_model_formulas_1_to_17(lam, cluster, mix):
    rc, pc = _pair(cluster)
    rmix, pmix = getattr(ref_pm, mix), getattr(pt_pm, mix)
    rm, pm = ref_pm.OdysPerfModel(), pt_pm.OdysPerfModel()
    assert pm.mix_weight_master(pmix, pc.ns) == rm.mix_weight_master(rmix, rc.ns)
    assert pm.mix_weight_network(pmix) == rm.mix_weight_network(rmix)
    for name in ("lambda_master_cpu", "lambda_master_membus", "lambda_network"):
        assert getattr(pm, name)(lam, pc, pmix) == getattr(rm, name)(lam, rc, rmix)
    for k in pt_pm.KS:
        for name in ("x_master_cpu", "x_master_membus", "x_network",
                     "master_network_time"):
            assert getattr(pm, name)(lam, pc, pmix, k) == getattr(rm, name)(
                lam, rc, rmix, k), (name, k)
    got = pm.total_response_time(lam, pc, pmix, _slave)
    want = rm.total_response_time(lam, rc, rmix, _slave)
    assert got == want or (math.isinf(got) and math.isinf(want))


@pytest.mark.parametrize("mix", MIXES)
@pytest.mark.parametrize("cluster", sorted(CLUSTERS))
def test_max_stable_load(cluster, mix):
    rc, pc = _pair(cluster)
    got = pt_pm.OdysPerfModel().max_stable_load(pc, getattr(pt_pm, mix))
    assert got == ref_pm.OdysPerfModel().max_stable_load(rc, getattr(ref_pm, mix))
    assert got > 0


@pytest.mark.parametrize("lam", [0.0, 10.0, 999.0, 1000.0, 2000.0])
@pytest.mark.parametrize("st", [1e-5, 1e-3])
def test_md1_and_sojourn(lam, st):
    assert pt_pm.md1_queue_length(lam, st) == ref_pm.md1_queue_length(lam, st)
    assert pt_pm.sojourn(lam, st) == ref_pm.sojourn(lam, st)


def test_query_mix_validates():
    with pytest.raises(AssertionError):
        pt_pm.QueryMix({("single", 10): 0.5})


@pytest.mark.parametrize("ns", [1, 4, 300])
@pytest.mark.parametrize("n_sets", [1, 3])
def test_engine_cluster_and_helpers(ns, n_sets):
    assert dataclasses.asdict(pt_pm.engine_cluster(ns, n_sets)) == (
        dataclasses.asdict(ref_pm.engine_cluster(ns, n_sets)))
    assert pt_pm.per_day(ns * 1.5) == ref_pm.per_day(ns * 1.5)
    assert pt_pm.per_sec(ns * 1e6) == ref_pm.per_sec(ns * 1e6)
    assert pt_pm.estimation_error(ns + 0.25, ns) == ref_pm.estimation_error(ns + 0.25, ns)


def test_headline_node_arithmetic():
    """§5.2.4: 143 sets of 304 nodes = 43,472 nodes for 1B queries/day;
    286 sets = 86,944 nodes at half the per-set load."""
    c300 = pt_pm.ClusterConfig(nm=4, ncm=4, ns=300, nh=11)
    assert pt_pm.nodes_for_service(1e9, 7e6, c300) == (143, 43472)
    assert pt_pm.nodes_for_service(1e9, 3.5e6, c300) == (286, 86944)
    assert pt_pm.nodes_for_service(1e9, 7e6, c300) == ref_pm.nodes_for_service(
        1e9, 7e6, ref_pm.ClusterConfig(nm=4, ncm=4, ns=300, nh=11))


def _fig13(pm, sm):
    model = pm.OdysPerfModel()
    c300 = pm.ClusterConfig(nm=4, ncm=4, ns=300, nh=11)
    mix = pm.QUERY_MIX_DEFAULT
    targets = []
    for lam, total in ((81.0, 0.211), (40.5, 0.162)):
        mn = sum(r * model.master_network_time(lam, c300, mix, k)
                 for (_, k), r in mix.qmr.items())
        targets.append((lam, total - mn))
    slave = sm.calibrate(targets, ns=300)
    est = [model.total_response_time(
        lam, c300, mix,
        lambda sct, k, lam_, ns: slave.slave_max_time("single", 10, lam_, ns))
        for lam in (81.0, 40.5)]
    return slave, est


def test_headline_211_and_162_ms():
    """Fig 13: 211 ms at 81 q/s a set and 162 ms at 40.5, the model's own
    output once its slave half is calibrated; equal to the reference's."""
    slave, est = _fig13(pt_pm, pt_sm)
    ref_slave, ref_est = _fig13(ref_pm, ref_sm)
    assert est == ref_est
    assert (slave.s_base, slave.lam_cap) == (ref_slave.s_base, ref_slave.lam_cap)
    assert pt_pm.estimation_error(est[0], 0.211) < 0.02
    assert pt_pm.estimation_error(est[1], 0.162) < 0.02


@pytest.mark.parametrize("ns", [1, 3, 4, 5, 20, 300])
def test_partitioning_method(ns):
    times = np.random.default_rng(ns).lognormal(0, 0.4, size=(5, 600))
    np.testing.assert_array_equal(pt_sm.partitioning_method(times, ns),
                                  ref_sm.partitioning_method(times, ns))


def test_partitioning_method_exact_and_short():
    times = np.arange(1, 13, dtype=np.float64).reshape(1, 12)
    assert pt_sm.partitioning_method(times, 4)[0] == 8.0
    with pytest.raises(ValueError):
        pt_sm.partitioning_method(np.ones((1, 10)), 11)


@pytest.mark.parametrize("sigma,ns,seed", [(0.25, 5, 0), (0.25, 300, 0),
                                           (0.4, 64, 3), (0.1, 1, 9)])
def test_expected_max_factor(sigma, ns, seed):
    assert pt_sm.expected_max_factor(sigma, ns, seed=seed) == (
        ref_sm.expected_max_factor(sigma, ns, seed=seed))


@pytest.mark.parametrize("sct", ["single", "multiple", "limited"])
@pytest.mark.parametrize("k", [10, 50, 1000])
def test_calibrated_slave_model(sct, k):
    kw = dict(s_base=0.05, lam_cap=200.0, sigma=0.25)
    p, r = pt_sm.CalibratedSlaveModel(**kw), ref_sm.CalibratedSlaveModel(**kw)
    for lam in (0.0, 81.0, 199.0, 500.0):
        assert p.mean(sct, k, lam) == r.mean(sct, k, lam)
        assert p.slave_max_time(sct, k, lam, 300) == r.slave_max_time(sct, k, lam, 300)
    np.testing.assert_array_equal(p.sample(sct, k, 81.0, (4, 50), seed=k),
                                  r.sample(sct, k, 81.0, (4, 50), seed=k))


@pytest.mark.parametrize("targets,ns", [([(81.0, 0.18), (40.5, 0.14)], 300),
                                        ([(10.0, 0.02), (5.0, 0.015)], 5)])
def test_calibrate(targets, ns):
    p, r = pt_sm.calibrate(targets, ns), ref_sm.calibrate(targets, ns)
    assert dataclasses.asdict(p) == dataclasses.asdict(r)
    for lam, t in targets:
        assert p.slave_max_time("single", 10, lam, ns) == pytest.approx(t, rel=1e-3)


def _sim_args(pm, sm, cluster):
    c = pm.ClusterConfig(**CLUSTERS[cluster])
    slave = sm.CalibratedSlaveModel(s_base=0.004, lam_cap=300.0)
    return c, pm.QUERY_MIX_DEFAULT, pm.PAPER_TABLE3_MASTER, pm.PAPER_TABLE3_NETWORK, slave


@pytest.mark.parametrize("cluster", ["five-node", "engine-4"])
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_simulate(cluster, seed):
    got = pt_sim.simulate(50.0, 120, *_sim_args(pt_pm, pt_sm, cluster), seed=seed)
    want = ref_sim.simulate(50.0, 120, *_sim_args(ref_pm, ref_sm, cluster), seed=seed)
    for f in ("arrivals", "response", "master_part", "network_part", "slave_sojourn"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert got.kinds == want.kinds
    assert got.mean_response == want.mean_response


def test_simulate_measured_services_and_fixed_kinds():
    c = CLUSTERS["five-node"]
    services = np.random.default_rng(4).lognormal(-5, 0.3, size=(40, c["ns"]))
    kinds = [("single", 10)] * 20 + [("multiple", 1000)] * 20
    outs = []
    for pm, sm, sim in ((pt_pm, pt_sm, pt_sim), (ref_pm, ref_sm, ref_sim)):
        outs.append(sim.simulate(20.0, 40, *_sim_args(pm, sm, "five-node"), seed=2,
                                 slave_services=services, kinds=kinds))
    np.testing.assert_array_equal(outs[0].response, outs[1].response)
    np.testing.assert_array_equal(outs[0].slave_sojourn, outs[1].slave_sojourn)


def test_fifo_queues():
    rng = np.random.default_rng(5)
    arr = np.sort(rng.random(50))
    svc = rng.random(50) * 0.05
    server = rng.integers(0, 3, 50)
    np.testing.assert_array_equal(pt_sim._fifo(arr, svc, server),
                                  ref_sim._fifo(arr, svc, server))
    np.testing.assert_array_equal(pt_sim._fifo_multi(arr, svc, 4),
                                  ref_sim._fifo_multi(arr, svc, 4))
