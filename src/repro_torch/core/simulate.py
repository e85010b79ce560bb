"""Discrete-event simulator of the ODYS pipeline (the "prototype" role).

The paper validates its hybrid model against a real 5-node build (Fig 11).
Offline, this simulator plays the prototype: masters (CPU + memory-bus
stages), shared-nothing slaves, and network hubs are FIFO queues with the
same service-time structure the analytic model assumes; per-(query, slave)
service times come from :class:`CalibratedSlaveModel` noise (or measured
engine latencies).  A Fig 11 style validation then:

  1. "measures" mean response time from the DES,
  2. predicts it with Formula (17): analytic master/network + the
     partitioning method applied to the DES-observed slave sojourns,
  3. reports the estimation error (paper: <=0.59%).

FIFO single-server queues need no event heap: completion_i =
max(arrival_i, completion_{i-1}) + service_i, per server.

A copy of the JAX package's ``repro.core.simulate`` (numpy only): the same
draws from the same ``default_rng(seed)`` in the same order.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.perfmodel import ClusterConfig, MasterParams, NetworkParams, QueryMix
from repro_torch.core.slave_max import CalibratedSlaveModel


@dataclasses.dataclass
class SimResult:
    arrivals: np.ndarray         # (n,)
    response: np.ndarray         # (n,) total response time per query
    master_part: np.ndarray      # (n,) master sojourn
    network_part: np.ndarray     # (n,) network-stage tail wait
    slave_sojourn: np.ndarray    # (n, ns) per-slave sojourn (queue + service)
    kinds: list                  # (sct, k) per query

    @property
    def mean_response(self) -> float:
        return float(self.response.mean())


def _fifo(arrival: np.ndarray, service: np.ndarray, server: np.ndarray):
    """Sequential FIFO recurrence per pre-assigned server id."""
    completion = np.zeros_like(arrival)
    last = {}
    order = np.argsort(arrival, kind="stable")
    for i in order:
        s = server[i]
        start = max(arrival[i], last.get(s, 0.0))
        completion[i] = start + service[i]
        last[s] = completion[i]
    return completion


def _fifo_multi(arrival: np.ndarray, service: np.ndarray, c: int):
    """FIFO queue with c identical servers (heap of free times)."""
    import heapq

    completion = np.zeros_like(arrival)
    free = [0.0] * c
    heapq.heapify(free)
    order = np.argsort(arrival, kind="stable")
    for i in order:
        t = heapq.heappop(free)
        start = max(arrival[i], t)
        completion[i] = start + service[i]
        heapq.heappush(free, completion[i])
    return completion


def simulate(
    lam: float,
    n_queries: int,
    cluster: ClusterConfig,
    mix: QueryMix,
    master: MasterParams,
    network: NetworkParams,
    slave_model: CalibratedSlaveModel,
    *,
    seed: int = 0,
    slave_services: np.ndarray | None = None,   # (n, ns) measured overrides
    kinds: list | None = None,   # fix the query set across repetitions
) -> SimResult:
    rng = np.random.default_rng(seed)
    c = cluster
    if kinds is None:
        kinds_all = list(mix.qmr.keys())
        probs = np.array([mix.qmr[k] for k in kinds_all])
        choice = rng.choice(len(kinds_all), size=n_queries, p=probs)
        kinds = [kinds_all[i] for i in choice]
    assert len(kinds) == n_queries
    ks = np.array([k for (_, k) in kinds])

    arrivals = np.cumsum(rng.exponential(1.0 / lam, size=n_queries))

    # --- master: ncm*nm CPU servers then nm memory-bus servers -----------
    st_m = np.array([master.ST_master(k, c.ns) for k in ks])
    cpu_ids = np.arange(n_queries) % (c.nm * c.ncm)
    bus_ids = cpu_ids % c.nm
    cpu_done = _fifo(arrivals, st_m * master.alpha, cpu_ids)
    bus_done = _fifo(cpu_done, st_m * (1.0 - master.alpha), bus_ids)
    master_part = bus_done - arrivals

    # --- slaves: every slave processes every query (broadcast) -----------
    if slave_services is None:
        slave_services = np.empty((n_queries, c.ns))
        for i, (sct, k) in enumerate(kinds):
            mu = np.log(slave_model.mean(sct, k, 0.0)) - slave_model.sigma**2 / 2
            slave_services[i] = rng.lognormal(mu, slave_model.sigma, size=c.ns)
    slave_done = np.zeros((n_queries, c.ns))
    for s in range(c.ns):
        # Each slave node runs c.nps Odysseus processes (paper §5.1).
        slave_done[:, s] = _fifo_multi(bus_done, slave_services[:, s], c.nps)
    slave_sojourn = slave_done - bus_done[:, None]

    # --- network hubs: ns results per query, slave s -> hub s % nh -------
    st_n = np.array([network.ST_network[k] for k in ks])
    ev_time = slave_done.reshape(-1)
    ev_query = np.repeat(np.arange(n_queries), c.ns)
    ev_hub = np.tile(np.arange(c.ns) % c.nh, n_queries)
    ev_svc = np.repeat(st_n, c.ns)
    hub_done = _fifo(ev_time, ev_svc, ev_hub)
    per_query_done = hub_done.reshape(n_queries, c.ns).max(axis=1)
    del ev_query  # (kept for clarity: event rows are (time, query, hub))

    response = per_query_done - arrivals
    network_part = per_query_done - slave_done.max(axis=1)
    return SimResult(
        arrivals=arrivals,
        response=response,
        master_part=master_part,
        network_part=network_part,
        slave_sojourn=slave_sojourn,
        kinds=kinds,
    )
