"""The parts of the ODYS performance model (paper §4) that the port needs.

A copy of ``QueryMix``, ``QUERY_MIX_DEFAULT`` and the M/D/1 sojourn
(Formulas (9) and (13)) from the JAX package's ``repro.core.perfmodel``:
the workload generator draws from the mix, and the scheduler's adaptive
formation deadline uses the sojourn.  All times are in seconds.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping


@dataclasses.dataclass(frozen=True)
class QueryMix:
    """qmr(sct, k) of §4.1.1/Fig 7(c).

    The paper's figure does not publish exact ratios; the default below is
    the JAX package's documented assumption (single-keyword dominant,
    top-10 dominant).
    """

    qmr: Mapping[tuple[str, int], float]

    def __post_init__(self):
        s = sum(self.qmr.values())
        assert abs(s - 1.0) < 1e-9, f"query mix must sum to 1, got {s}"

    def ratio_k(self, k: int) -> float:
        return sum(v for (sct, kk), v in self.qmr.items() if kk == k)


QUERY_MIX_DEFAULT = QueryMix(
    {
        ("single", 10): 0.30, ("single", 50): 0.10, ("single", 1000): 0.05,
        ("multiple", 10): 0.20, ("multiple", 50): 0.10, ("multiple", 1000): 0.05,
        ("limited", 10): 0.12, ("limited", 50): 0.05, ("limited", 1000): 0.03,
    }
)


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
