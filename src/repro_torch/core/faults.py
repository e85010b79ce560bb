"""Fault tolerance & straggler mitigation for ODYS sets.

The paper (§3.1) defers fault tolerance to Osprey-style replication:
multiple ODYS sets (full engine replicas) plus a middleware that remaps
work between sets.  We implement the corresponding mechanics natively:

- **set-granular failover**: the query router keeps a health mask over
  ODYS sets; queries headed to a dead set are re-routed to the healthiest
  surviving set (queries are stateless, the index is replicated — exactly
  why the paper's replica design makes failover trivial);
- **speculative re-dispatch (straggler mitigation)**: the partitioning
  method (core/slave_max.py) gives the expected slave max; any shard
  exceeding ``slo_factor x`` that estimate is assumed straggling and its
  *document partition* is speculatively re-issued to the replica set; the
  query completes at ``min(straggler, re-dispatch latency)``;

The router here is an *analytical simulator* driven by per-(query, shard)
latency samples — the same objects the perf model consumes — so mitigation
policies can be evaluated for 1000+-node deployments without hardware.

A copy of the JAX package's ``repro.core.faults`` (numpy only); the port's
:class:`~repro_torch.serving.router.HealthAwareRouter` hangs off
:class:`SetHealth`.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SetHealth:
    """Liveness mask over ODYS sets, with change notification.

    ``listeners`` are called as ``listener(set_id, alive)`` on every
    *actual* transition (a repeated ``fail`` on a dead set notifies no
    one) — the serving router's health-transition metrics hang off this.
    """

    n_sets: int
    alive: np.ndarray  # bool[n_sets]
    listeners: list = dataclasses.field(
        default_factory=list, repr=False, compare=False
    )

    @classmethod
    def all_alive(cls, n_sets: int) -> "SetHealth":
        return cls(n_sets, np.ones(n_sets, dtype=bool))

    def subscribe(self, listener) -> None:
        if listener not in self.listeners:
            self.listeners.append(listener)

    def unsubscribe(self, listener) -> None:
        if listener in self.listeners:
            self.listeners.remove(listener)

    def _set(self, set_id: int, value: bool) -> None:
        if bool(self.alive[set_id]) == value:
            return
        self.alive[set_id] = value
        for listener in self.listeners:
            listener(set_id, value)

    def fail(self, set_id: int) -> None:
        self._set(set_id, False)

    def recover(self, set_id: int) -> None:
        self._set(set_id, True)


def route_queries(
    n_queries: int, health: SetHealth, seed: int = 0
) -> np.ndarray:
    """Assign each query to an alive ODYS set (uniform over survivors)."""
    alive_ids = np.flatnonzero(health.alive)
    if alive_ids.size == 0:
        raise RuntimeError("no ODYS set alive")
    rng = np.random.default_rng(seed)
    return alive_ids[rng.integers(0, alive_ids.size, size=n_queries)]


@dataclasses.dataclass(frozen=True)
class SpeculationPolicy:
    """Re-dispatch a shard's work when it exceeds slo_factor x expected max."""

    slo_factor: float = 1.5
    redispatch_overhead: float = 2e-3  # seconds: re-RPC + queue re-entry


def query_latency_with_speculation(
    shard_latencies: np.ndarray,      # float[n_queries, ns] primary set
    replica_latencies: np.ndarray,    # float[n_queries, ns] replica set
    expected_max: float,              # partitioning-method estimate
    policy: SpeculationPolicy,
) -> tuple[np.ndarray, np.ndarray]:
    """Response time per query with speculative re-dispatch.

    A query completes when every shard's partition has answered — from the
    primary, or (for shards past the SLO) from the replica launched at the
    SLO deadline.  Returns (latency[n_queries], speculation_rate).
    """
    slo = policy.slo_factor * expected_max
    straggling = shard_latencies > slo
    completed = np.where(
        straggling,
        np.minimum(
            shard_latencies,
            slo + policy.redispatch_overhead + replica_latencies,
        ),
        shard_latencies,
    )
    return completed.max(axis=1), float(straggling.mean())


def degraded_recall_mask(ns: int, dead_shards: list[int]) -> np.ndarray:
    """Availability fallback *within* a set (no replica): serve from
    surviving shards only.  Results stay correct per-shard; global recall
    degrades by ~len(dead)/ns — the striped partitioning (index.py)
    guarantees the loss is rank-uniform, not rank-biased."""
    alive = np.ones(ns, dtype=bool)
    alive[dead_shards] = False
    return alive
