"""The port's fault tolerance against the JAX package's: ``SetHealth``,
``route_queries``, speculation and ``degraded_recall_mask`` equal on the
same inputs and seeds; ``HealthAwareRouter`` routing the same set sequence
over scripted fail/recover runs; ``SearchService(set_health=, n_sets=2,
device="cpu")`` serving the reference's hits with a set killed mid-flight
and with every set dead; ``rescale`` and ``FailoverRouter``."""
import numpy as np
import pytest

import jax

from repro.core import faults as ref_faults
from repro.core import index as ref_index
from repro.data import corpus as ref_corpus
from repro.launch import elastic as ref_elastic
from repro.serving.router import HealthAwareRouter as RefRouter
from repro.serving.search import SearchService as RefService
from repro_torch.core import faults as pt_faults
from repro_torch.core import index as pt_index
from repro_torch.data import corpus as pt_corpus
from repro_torch.launch import elastic as pt_elastic
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.serving.router import HealthAwareRouter
from repro_torch.serving.scheduler import MasterScheduler, MultiSetRouter
from repro_torch.serving.search import SearchService

CFG = dict(n_docs=400, vocab_size=150, mean_doc_len=25, n_sites=10, seed=13)
QUERIES = [([3], None), ([3, 9], None), ([1, 4, 12], None), ([2], 3),
           ([5, 8], 1), ([140], None), ([0, 7], 5), ([11], None),
           ([6, 2], None), ([9], 2), ([1], None), ([4, 5, 6], None)]


# ------------------------------------------------------------ core.faults --
def test_set_health_notifies_on_actual_transitions_only():
    events = {}
    for name, mod in (("port", pt_faults), ("ref", ref_faults)):
        h = mod.SetHealth.all_alive(3)
        ev = events[name] = []
        h.subscribe(lambda sid, alive, ev=ev: ev.append((sid, alive)))
        for op, sid in (("fail", 1), ("fail", 1), ("recover", 1), ("recover", 0),
                        ("fail", 2), ("fail", 0), ("recover", 2)):
            getattr(h, op)(sid)
        ev.append(h.alive.tolist())
    assert events["port"] == events["ref"]
    assert events["port"][:2] == [(1, False), (1, True)]


def test_set_health_subscribe_once_and_unsubscribe():
    h = pt_faults.SetHealth.all_alive(2)
    seen = []
    h.subscribe(seen.append)
    h.subscribe(seen.append)
    assert len(h.listeners) == 1
    h.unsubscribe(seen.append)
    h.fail(0)
    assert seen == [] and h == pt_faults.SetHealth(2, h.alive)


@pytest.mark.parametrize("dead", [[], [2], [0, 3], [1, 2, 3]])
@pytest.mark.parametrize("seed", [0, 1, 5])
def test_route_queries(dead, seed):
    hp, hr = pt_faults.SetHealth.all_alive(4), ref_faults.SetHealth.all_alive(4)
    for s in dead:
        hp.fail(s)
        hr.fail(s)
    got = pt_faults.route_queries(500, hp, seed=seed)
    np.testing.assert_array_equal(got, ref_faults.route_queries(500, hr, seed=seed))
    assert not set(got.tolist()) & set(dead)


def test_route_queries_all_dead_raises():
    with pytest.raises(RuntimeError, match="no ODYS set alive"):
        pt_faults.route_queries(10, pt_faults.SetHealth(2, np.zeros(2, bool)))


@pytest.mark.parametrize("slo_factor,overhead", [(1.5, 2e-3), (1.0, 0.0), (3.0, 1e-2)])
def test_speculation(slo_factor, overhead):
    rng = np.random.default_rng(0)
    primary = rng.lognormal(np.log(0.05), 0.3, size=(300, 8))
    primary[::17, 3] *= 20.0
    replica = rng.lognormal(np.log(0.05), 0.3, size=(300, 8))
    got = pt_faults.query_latency_with_speculation(
        primary, replica, 0.08, pt_faults.SpeculationPolicy(slo_factor, overhead))
    want = ref_faults.query_latency_with_speculation(
        primary, replica, 0.08, ref_faults.SpeculationPolicy(slo_factor, overhead))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


def test_speculation_edges():
    pol = pt_faults.SpeculationPolicy(slo_factor=1.5, redispatch_overhead=1e-3)
    lat, rate = pt_faults.query_latency_with_speculation(
        np.full((4, 3), 10.0), np.full((4, 3), 0.01), 0.1, pol)
    assert rate == 1.0
    np.testing.assert_allclose(lat, 0.15 + 1e-3 + 0.01)
    lat, rate = pt_faults.query_latency_with_speculation(
        np.array([[0.05, 0.30]]), np.array([[0.05, 9.99]]), 0.1, pol)
    assert lat[0] == pytest.approx(0.30) and rate == pytest.approx(0.5)


@pytest.mark.parametrize("ns,dead", [(4, []), (3, [0, 1, 2]), (4, [2, 2]), (8, [1, 5])])
def test_degraded_recall_mask(ns, dead):
    np.testing.assert_array_equal(pt_faults.degraded_recall_mask(ns, dead),
                                  ref_faults.degraded_recall_mask(ns, dead))


# ------------------------------------------------------- HealthAwareRouter --
SCRIPTS = {
    "flap": [("route", 2), ("fail", 1), ("route", 2), ("route", 2), ("recover", 1),
             ("route", 2), ("fail", 1), ("route", 2), ("recover", 1), ("route", 1)],
    "mid-flight": [("route", 8), ("fail", 0), ("route", 1), ("complete", 0),
                   ("route", 1), ("route", 1), ("recover", 0), ("route", 3)],
    "complete-order": [("route", 5), ("route", 5), ("route", 5), ("complete", 1),
                       ("route", 1), ("fail", 2), ("route", 1), ("complete", 0),
                       ("route", 1)],
}


def _run_script(router, script):
    out, routed = [], {}
    for op, arg in script:
        if op == "route":
            s = router.route(arg)
            routed.setdefault(s.sid, []).append(arg)
            out.append(s.sid)
        elif op == "complete":
            s = router.sets[arg]
            router.complete(s, routed[arg].pop(0))
        else:
            getattr(router, op)(arg)
    return out, [s.in_flight for s in router.sets]


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_health_router_same_sequence_as_reference(name):
    got = _run_script(HealthAwareRouter(3), SCRIPTS[name])
    assert got == _run_script(RefRouter(3), SCRIPTS[name])


def test_health_router_all_dead_and_shared_mask():
    r = HealthAwareRouter(2)
    r.fail(0)
    r.fail(1)
    with pytest.raises(RuntimeError, match="no ODYS set alive"):
        r.route(4)
    r.recover(1)
    assert r.route(4).sid == 1
    h = pt_faults.SetHealth.all_alive(3)
    r = HealthAwareRouter(3, health=h)
    h.alive[0] = h.alive[2] = False          # mutated outside the router
    assert {r.route(1).sid for _ in range(5)} == {1}
    with pytest.raises(ValueError):
        HealthAwareRouter(4, health=pt_faults.SetHealth.all_alive(2))
    assert MultiSetRouter(3).route(1).sid == 0


def test_health_router_registry_rebinding():
    """``bind_registry`` runs twice at construction (the base class binds
    before ``health`` exists); a later scheduler binding moves every
    instrument, the health ones included, to the scheduler's registry."""
    r = HealthAwareRouter(2)
    assert r._registry is not None
    reg = MetricsRegistry()
    MasterScheduler(lambda qs, t, k, sid: [sid for _ in qs], batch_size=1,
                    t_max_buckets=(2,), cache_size=0, router=r, registry=reg)
    assert r._registry is reg
    assert reg.gauge("odys_set_alive", set="1").value == 1.0
    r.fail(1)
    r.fail(1)
    r.recover(1)
    r.fail(0)
    assert reg.counter("odys_set_health_transitions_total", to="dead").value == 2
    assert reg.counter("odys_set_health_transitions_total", to="alive").value == 1
    assert reg.gauge("odys_set_alive", set="0").value == 0.0
    assert reg.gauge("odys_set_alive", set="1").value == 1.0


def test_health_router_through_scheduler_keeps_tickets():
    router = HealthAwareRouter(2)
    s = MasterScheduler(lambda qs, t, k, sid: [sid for _ in qs], batch_size=2,
                        t_max_buckets=(2,), cache_size=0, router=router)
    t1, t2, t3 = s.submit([1]), s.submit([2]), s.submit([3])
    router.fail(0)
    router.fail(1)
    with pytest.raises(RuntimeError, match="no ODYS set alive"):
        s.drain()
    assert s.pending() == 3
    router.recover(1)
    s.drain()
    assert all(t.done and t.set_id == 1 for t in (t1, t2, t3))


# ------------------------------------------------------ SearchService(set_health=)
@pytest.fixture(scope="module")
def setup():
    rcorpus = ref_corpus.generate_corpus(ref_corpus.CorpusConfig(**CFG))
    rsh, meta = ref_index.build_sharded_index(rcorpus, 1)
    pcorpus = pt_corpus.generate_corpus(pt_corpus.CorpusConfig(**CFG))
    psh, pmeta = pt_index.build_sharded_index(pcorpus, 1, device="cpu")
    return rcorpus, rsh, meta, pcorpus, psh, pmeta


def _services(setup, backend, **kw):
    _, rsh, meta, _, psh, pmeta = setup
    kw = dict(ns=1, k=10, window=1024, t_max=4, batch_size=3, t_max_buckets=(2, 4),
              cache_size=0, n_sets=2, **kw)
    rh, ph = ref_faults.SetHealth.all_alive(2), pt_faults.SetHealth.all_alive(2)
    ref = RefService(rsh, meta, jax.make_mesh((1,), ("data",)), backend="jnp",
                     set_health=rh, **kw)
    port = SearchService(psh, pmeta, device="cpu", backend=backend, set_health=ph, **kw)
    return (ref, rh), (port, ph)


def _mid_flight(svc, health):
    """Submit everything; kill set 1 after the first batch, recover it after
    the third; returns the hits and the set of every ticket."""
    tickets = [svc.submit(t, s) for t, s in QUERIES]
    n = 0
    while svc.scheduler.pending():
        svc.scheduler.step()
        n += 1
        if n == 1:
            health.fail(1)
        if n == 3:
            health.recover(1)
    return [(t.result.docids, t.result.n_hits, t.set_id) for t in tickets]


@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_service_set_killed_mid_flight(setup, backend):
    (ref, rh), (port, ph) = _services(setup, backend)
    got, want = _mid_flight(port, ph), _mid_flight(ref, rh)
    assert got == want
    sets = [s for _, _, s in got]
    assert 1 in sets and sets.count(0) > sets.count(1)
    assert port.stats()["sets"][1]["n_batches"] == ref.stats()["sets"][1]["n_batches"]


@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_service_all_sets_dead_keeps_queue(setup, backend):
    out = []
    for svc, health in _services(setup, backend):
        tickets = [svc.submit(t, s) for t, s in QUERIES[:5]]
        health.fail(0)
        health.fail(1)
        with pytest.raises(RuntimeError, match="no ODYS set alive"):
            svc.drain()
        assert svc.scheduler.pending() == 5 and not any(t.done for t in tickets)
        health.recover(0)
        svc.drain()
        out.append([(t.result.docids, t.result.n_hits, t.set_id) for t in tickets])
    assert out[0] == out[1]
    assert {s for *_, s in out[0]} == {0}


def test_service_health_metrics(setup):
    reg = MetricsRegistry()
    (_, _), (port, ph) = _services(setup, "kernel", registry=reg)
    _mid_flight(port, ph)
    assert reg.counter("odys_set_health_transitions_total", to="dead").value == 1
    assert reg.counter("odys_set_health_transitions_total", to="alive").value == 1
    assert reg.gauge("odys_set_alive", set="1").value == 1.0


def test_service_set_meshes_still_refused(setup):
    *_, psh, pmeta = setup
    # per-set ranks have come (tests/test_torch_search_sets.py): a count
    # of slices other than n_sets raises the reference's ValueError
    with pytest.raises(ValueError, match="1 set_meshes for n_sets=2"):
        SearchService(psh, pmeta, ns=1, device="cpu", n_sets=2, set_meshes=[object()])
    with pytest.raises(ValueError, match="health mask covers"):
        SearchService(psh, pmeta, ns=1, device="cpu", n_sets=3,
                      set_health=pt_faults.SetHealth.all_alive(2))


# ---------------------------------------------------------- launch.elastic --
@pytest.mark.parametrize("new_ns", [2, 3])
def test_rescale_equals_reference(setup, new_ns):
    rcorpus, _, _, pcorpus, _, _ = setup
    rsh, rmeta = ref_elastic.rescale(rcorpus, new_ns)
    psh, pmeta = pt_elastic.rescale(pcorpus, new_ns, device="cpu")
    assert pmeta == pt_index.IndexMeta(**vars(rmeta))
    for field, v in rsh._asdict().items():
        np.testing.assert_array_equal(getattr(psh, field).numpy(), np.asarray(v),
                                      err_msg=field)


def test_failover_router_equals_reference():
    samples = np.random.default_rng(2).lognormal(-6, 0.3, size=(6, 4 * 20))
    routers = []
    for mod in (pt_elastic, ref_elastic):
        r = mod.FailoverRouter(n_sets=3, ns=4)
        with pytest.raises(RuntimeError, match="observe_latencies"):
            r.deadline()
        r.observe_latencies(samples)
        r.health.fail(1)
        routers.append((r.slo, r.deadline(), r.route(400, seed=3)))
    assert routers[0][:2] == routers[1][:2]
    np.testing.assert_array_equal(routers[0][2], routers[1][2])
    assert 1 not in set(routers[0][2].tolist())
