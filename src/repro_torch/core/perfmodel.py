"""ODYS hybrid performance model (paper §4) — the analytic half.

A copy of the JAX package's ``repro.core.perfmodel`` (which the port may
not import), kept line for line so both packages project alike to the
last bit.  It implements, verbatim, the paper's queuing model for masters
and network:

- query model (§4.1.1): 3 search-condition types x k in {10,50,1000};
  every query is normalized into *unit queries* (single-keyword top-10);
- arrival rates (§4.1.2, Table 2) and weighted arrival rates
  (§4.1.3, Formulas (1)-(3));
- component service times (§4.1.4, Formulas (4)-(8)) with the paper's
  measured constants (Table 3) shipped as :data:`PAPER_TABLE3_MASTER` and
  :data:`PAPER_TABLE3_NETWORK`;
- M/D/1 queue lengths and sojourn times (§4.1.5, Formulas (9)-(16));
- total response time (§4.3, Formula (17)): the larger of the master's and
  the network's total sojourn, plus the expected **slave max time**
  (estimated experimentally — the hybrid's other half, in
  :mod:`repro_torch.core.slave_max` and :mod:`repro_torch.core.calibrate`).

All times are in **seconds**.  The module is plain Python: capacity
planning arithmetic in float64, identical on any hardware.  Table 3 holds
the paper's constants for its 2012 cluster, never a reading of this port.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping

KS = (10, 50, 1000)
SCTS = ("single", "multiple", "limited")

MS = 1e-3
US = 1e-6


@dataclasses.dataclass(frozen=True)
class MasterParams:
    """Paper Formulas (4)-(8) constants (Table 3, master rows)."""

    T_parent_proc: float
    T_child_proc: float
    T_master_rpc: Mapping[int, float]          # per top-k
    t_comparison: float                         # loser-tree compare
    t_base: float                               # per-result base cost
    t_per_context_switch: float
    ncs_base: Mapping[int, float]
    ncs_per_slave: Mapping[int, float]
    alpha: float = 0.25                         # CPU : memory-bus split

    def T_merge(self, k: int, ns: int) -> float:
        """Formula (7): loser-tree merge cost at the master."""
        return k * (math.ceil(math.log2(ns)) * self.t_comparison + self.t_base)

    def T_context_switch(self, k: int, ns: int) -> float:
        """Formula (8)."""
        return self.t_per_context_switch * (
            self.ncs_base[k] + ns * self.ncs_per_slave[k]
        )

    def ST_master(self, k: int, ns: int) -> float:
        """Formula (4): total master service time for a top-k query."""
        return (
            self.T_parent_proc
            + (self.T_child_proc + self.T_master_rpc[k]) * ns
            + self.T_merge(k, ns)
            + self.T_context_switch(k, ns)
        )

    def ST_master_cpu(self, k: int, ns: int) -> float:
        """Formula (5)."""
        return self.ST_master(k, ns) * self.alpha

    def ST_master_membus(self, k: int, ns: int) -> float:
        """Formula (6)."""
        return self.ST_master(k, ns) * (1.0 - self.alpha)

    def w_master(self, k: int, ns: int) -> float:
        """Master weight of a top-k query in unit queries (§4.1.3)."""
        return self.ST_master(k, ns) / self.ST_master(10, ns)


@dataclasses.dataclass(frozen=True)
class NetworkParams:
    ST_network: Mapping[int, float]             # per top-k (Table 3)

    def w_network(self, k: int) -> float:
        return self.ST_network[k] / self.ST_network[10]


#: Table 3 of the paper, verbatim.
PAPER_TABLE3_MASTER = MasterParams(
    T_parent_proc=1.516 * MS,
    T_child_proc=0.0181 * MS,
    T_master_rpc={10: 0.01 * MS, 50: 0.011 * MS, 1000: 0.031 * MS},
    t_comparison=0.191 * US,
    t_base=0.28 * US,
    t_per_context_switch=15.995 * US,
    ncs_base={10: 80.869, 50: 80.869, 1000: 139.903},
    ncs_per_slave={10: 1.991, 50: 1.991, 1000: 3.444},
    alpha=0.25,  # §5.1: fitted on the five-node system
)

PAPER_TABLE3_NETWORK = NetworkParams(
    ST_network={10: 0.129 * MS, 50: 0.222 * MS, 1000: 0.318 * MS},
)


@dataclasses.dataclass(frozen=True)
class QueryMix:
    """qmr(sct, k) of §4.1.1/Fig 7(c).

    The paper's figure does not publish exact ratios; the default below is
    the JAX package's documented assumption (single-keyword dominant,
    top-10 dominant) — it is a *parameter*, and every user prints the mix
    used.
    """

    qmr: Mapping[tuple[str, int], float]

    def __post_init__(self):
        s = sum(self.qmr.values())
        assert abs(s - 1.0) < 1e-9, f"query mix must sum to 1, got {s}"

    def ratio_k(self, k: int) -> float:
        return sum(v for (sct, kk), v in self.qmr.items() if kk == k)


SINGLE_10_ONLY = QueryMix({("single", 10): 1.0})

QUERY_MIX_DEFAULT = QueryMix(
    {
        ("single", 10): 0.30, ("single", 50): 0.10, ("single", 1000): 0.05,
        ("multiple", 10): 0.20, ("multiple", 50): 0.10, ("multiple", 1000): 0.05,
        ("limited", 10): 0.12, ("limited", 50): 0.05, ("limited", 1000): 0.03,
    }
)


# ---------------------------------------------------------------------------
# M/D/1 queue (Formula (9)); deterministic service => E[ST^2] = ST^2.
# ---------------------------------------------------------------------------

def md1_queue_length(lam: float, st: float) -> float:
    """Formula (9).  Requires utilization rho = lam*st < 1."""
    rho = lam * st
    if rho >= 1.0:
        return math.inf
    return (lam**2 * st**2) / (2.0 * (1.0 - rho)) + rho


def sojourn(lam: float, st: float) -> float:
    """Formula (13): E[X] = L / lambda (per unit query)."""
    if lam <= 0.0:
        return st
    length = md1_queue_length(lam, st)
    return length / lam


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """One ODYS set: nm masters (ncm CPUs each), ns slaves, nh hubs.

    ``nps``: Odysseus processes per slave — the paper's §5.1 runs 100 per
    node, making each slave a c-server queue (this is what lets a 5-node
    system absorb 266 q/s broadcast to every slave)."""

    nm: int = 4
    ncm: int = 4
    ns: int = 300
    nh: int = 11
    nps: int = 100


@dataclasses.dataclass(frozen=True)
class OdysPerfModel:
    master: MasterParams = PAPER_TABLE3_MASTER
    network: NetworkParams = PAPER_TABLE3_NETWORK

    # -- weighted arrival rates: Formulas (1)-(3) ---------------------------
    def mix_weight_master(self, mix: QueryMix, ns: int) -> float:
        return sum(
            self.master.w_master(k, ns) * mix.ratio_k(k) for k in KS
        )

    def mix_weight_network(self, mix: QueryMix) -> float:
        return sum(self.network.w_network(k) * mix.ratio_k(k) for k in KS)

    def lambda_master_cpu(self, lam: float, c: ClusterConfig, mix: QueryMix) -> float:
        """Formula (1)."""
        return lam / (c.ncm * c.nm) * self.mix_weight_master(mix, c.ns)

    def lambda_master_membus(self, lam: float, c: ClusterConfig, mix: QueryMix) -> float:
        """Formula (2)."""
        return lam / c.nm * self.mix_weight_master(mix, c.ns)

    def lambda_network(self, lam: float, c: ClusterConfig, mix: QueryMix) -> float:
        """Formula (3)."""
        return (c.ns / c.nh) * lam * self.mix_weight_network(mix)

    # -- sojourn times: Formulas (10)-(16) ----------------------------------
    def x_master_cpu(self, lam, c, mix, k: int) -> float:
        lam_w = self.lambda_master_cpu(lam, c, mix)
        x_unit = sojourn(lam_w, self.master.ST_master_cpu(10, c.ns))
        return x_unit * self.master.w_master(k, c.ns)

    def x_master_membus(self, lam, c, mix, k: int) -> float:
        lam_w = self.lambda_master_membus(lam, c, mix)
        x_unit = sojourn(lam_w, self.master.ST_master_membus(10, c.ns))
        return x_unit * self.master.w_master(k, c.ns)

    def x_network(self, lam, c, mix, k: int) -> float:
        lam_w = self.lambda_network(lam, c, mix)
        x_unit = sojourn(lam_w, self.network.ST_network[10])
        return (c.ns / c.nh) * x_unit * self.network.w_network(k)

    def master_network_time(self, lam, c, mix, k: int) -> float:
        """max(master, network) part of Formula (17)."""
        m = self.x_master_cpu(lam, c, mix, k) + self.x_master_membus(lam, c, mix, k)
        n = self.x_network(lam, c, mix, k)
        return max(m, n)

    # -- Formula (17) --------------------------------------------------------
    def total_response_time(
        self,
        lam: float,
        c: ClusterConfig,
        mix: QueryMix,
        slave_max_time: Callable[[str, int, float, int], float],
    ) -> float:
        """Mix-averaged t_parallel: queuing part + experimental slave max.

        ``slave_max_time(sct, k, lam, ns)`` is the hybrid's experimental
        half (partitioning method — core/slave_max.py, or a fitted
        :class:`~repro_torch.core.calibrate.Calibration`).
        """
        total = 0.0
        for (sct, k), ratio in mix.qmr.items():
            if ratio == 0.0:
                continue
            t = self.master_network_time(lam, c, mix, k) + slave_max_time(
                sct, k, lam, c.ns
            )
            total += ratio * t
        return total

    def max_stable_load(self, c: ClusterConfig, mix: QueryMix) -> float:
        """Largest arrival rate with every queue's utilization < 1."""
        def util(lam):
            return max(
                self.lambda_master_cpu(lam, c, mix)
                * self.master.ST_master_cpu(10, c.ns),
                self.lambda_master_membus(lam, c, mix)
                * self.master.ST_master_membus(10, c.ns),
                self.lambda_network(lam, c, mix) * self.network.ST_network[10],
            )
        lo, hi = 0.0, 1e7
        for _ in range(200):
            mid = 0.5 * (lo + hi)
            if util(mid) < 1.0:
                lo = mid
            else:
                hi = mid
        return lo


def engine_cluster(ns: int, n_sets: int = 1) -> ClusterConfig:
    """ClusterConfig of the in-process engine: each replicated set is a
    single-CPU master pipeline over ``ns`` slaves (on one card, the ns
    shards run in turn), with no hub tier — used when fitting/projecting
    against live measurements (:mod:`repro_torch.core.calibrate`) rather
    than the paper's 5-node system."""
    return ClusterConfig(nm=n_sets, ncm=1, ns=ns, nh=1, nps=1)


def estimation_error(estimated: float, measured: float) -> float:
    """Formula (18)."""
    return abs(estimated - measured) / measured


def nodes_for_service(
    total_queries_per_day: float, queries_per_day_per_set: float, c: ClusterConfig
) -> tuple[int, int]:
    """Paper §5.2.4 arithmetic: (#sets, #nodes) to carry a query load."""
    sets = math.ceil(total_queries_per_day / queries_per_day_per_set)
    return sets, sets * (c.nm + c.ns)


def per_day(queries_per_sec: float) -> float:
    return queries_per_sec * 86400.0


def per_sec(queries_per_day: float) -> float:
    return queries_per_day / 86400.0
