"""Elastic scaling & failure handling for the ODYS engine (port of
``repro.launch.elastic``).

The striped document partitioning (global docID d -> shard d % ns, local
d // ns) makes re-sharding deterministic: growing or shrinking ns is a
pure re-stripe of the corpus, embarrassingly parallel per shard, with no
consistent-hashing ring to rebalance.  This module provides:

- ``rescale``: rebuild the sharded index for a new ns (new nodes join /
  failed nodes leave) on a device;
- ``FailoverRouter``: maps the query stream across ODYS sets, re-routing
  around dead sets and speculatively re-dispatching stragglers with the
  SLO derived from the partitioning-method estimate.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.faults import SetHealth, SpeculationPolicy, route_queries
from repro_torch.core.index import build_sharded_index
from repro_torch.core.slave_max import partitioning_method
from repro_torch.data.corpus import Corpus


def rescale(corpus: Corpus, new_ns: int, *, include_site_terms: bool = True,
            device=None):
    """Deterministic re-stripe to a new shard count, on ``device``
    (``cuda`` unless named)."""
    return build_sharded_index(
        corpus, new_ns, include_site_terms=include_site_terms, device=device
    )


@dataclasses.dataclass
class FailoverRouter:
    n_sets: int
    ns: int
    policy: SpeculationPolicy = dataclasses.field(
        default_factory=SpeculationPolicy
    )
    health: SetHealth = None  # type: ignore[assignment]
    slo: float | None = None

    def __post_init__(self):
        if self.health is None:
            self.health = SetHealth.all_alive(self.n_sets)

    def observe_latencies(self, sojourn_samples: np.ndarray) -> None:
        """Derive the straggler SLO from the partitioning-method estimate
        (the hybrid model hands the router its deadline for free)."""
        self.slo = float(partitioning_method(sojourn_samples, self.ns).mean())

    def route(self, n_queries: int, seed: int = 0) -> np.ndarray:
        return route_queries(n_queries, self.health, seed)

    def deadline(self) -> float:
        if self.slo is None:
            raise RuntimeError("observe_latencies() first")
        return self.policy.slo_factor * self.slo
