"""Per-query phase tracing: the paper's latency decomposition, per ticket.

ODYS's §4–§5 analysis decomposes response time into queueing, slave, and
master-merge phases.  A :class:`QuerySpan` records that decomposition for
every admitted query as it moves through the serving pipeline
(:mod:`repro_torch.serving.scheduler`); finished spans feed the per-phase
latency histograms and the model-residual monitor
(:mod:`repro_torch.obs.residual`).  A copy of the JAX package's
``repro.obs.trace``.

Span phases (:data:`PHASES`), in pipeline order:

- ``admission_wait``   — submit → the batch former pops the query's bucket
  (the queueing + formation-deadline component; scheduler clock domain, so
  virtual seconds under :meth:`MasterScheduler.replay`);
- ``formation_wait``   — batch formed → service start on the routed set
  (the set-availability wait; scheduler clock domain);
- ``cache_lookup``     — result-cache probe at admission (wall domain);
- ``route``            — multi-set router decision (wall domain);
- ``slave_dispatch``   — host-side batch construction + device dispatch of
  the jitted query program (wall domain);
- ``master_merge``     — the batch-boundary sync: the wait for the device
  batch (slave top-k and the master merge, queued on one CUDA stream).
  Device work is timed **only** here, at the batch boundary — no host
  syncs are added inside the kernel hot path (wall domain);
- ``finalize``         — host-side result extraction (wall domain).

Two clock domains, by design: the waits are measured on the scheduler's
injectable clock (coherent under virtual-time replay), the service phases
on a real monotonic wall clock (:data:`WALL_PHASES` labels which is
which).  Batch-level phases (route, slave_dispatch, master_merge,
finalize) are attributed to every query in the batch via batch membership
— each co-batched span carries the full batch duration plus
``batch_queries`` so aggregators can normalize per query when they want
throughput rather than latency.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.obs.registry import MetricsRegistry, get_registry

__all__ = ["PHASES", "WALL_PHASES", "PhaseAggregator", "QuerySpan"]

PHASES = (
    "admission_wait",
    "formation_wait",
    "cache_lookup",
    "route",
    "slave_dispatch",
    "master_merge",
    "finalize",
)

#: Phases measured on the real monotonic wall clock; the rest are in the
#: scheduler's (possibly virtual) clock domain.
WALL_PHASES = frozenset(
    ("cache_lookup", "route", "slave_dispatch", "master_merge", "finalize")
)


@dataclasses.dataclass
class QuerySpan:
    """One query's phase decomposition (attached to its ``QueryTicket``).

    ``submit_time``/``finish_time`` are in the scheduler's clock domain;
    ``phases`` mixes domains as documented above (:data:`WALL_PHASES`).
    ``batch_queries`` is the number of real queries the span's batch
    served — the batch-membership attribution factor.  ``pad_fraction``
    is the share of the batch that was inert padding clones (0.0 for a
    full bucket): the denominator context for the kernel-side
    ``odys_kernel_grid_occupancy`` gauge and the Formula (17) residual —
    a padded batch *should* show low dense-grid occupancy.
    """

    qid: int
    submit_time: float
    phases: dict[str, float] = dataclasses.field(default_factory=dict)
    from_cache: bool = False
    set_id: int | None = None
    batch_id: int | None = None
    batch_queries: int = 1
    pad_fraction: float = 0.0
    finish_time: float | None = None

    def add(self, phase: str, dt: float) -> None:
        self.phases[phase] = self.phases.get(phase, 0.0) + dt

    @property
    def done(self) -> bool:
        return self.finish_time is not None

    @property
    def response_time(self) -> float:
        assert self.finish_time is not None
        return self.finish_time - self.submit_time

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class PhaseAggregator:
    """Fold finished spans into measured per-phase means.

    Usable standalone (``fold`` + ``means``) or wired as a scheduler
    ``span_sink``; when built on a live registry it keeps one
    ``odys_phase_mean_seconds{phase=...}`` gauge per phase current, plus
    an ``odys_spans_folded_total`` counter.
    """

    def __init__(self, registry: MetricsRegistry | None = None):
        reg = registry if registry is not None else get_registry()
        self._sum: dict[str, float] = {}
        self._n: dict[str, int] = {}
        self._gauges = {
            p: reg.gauge(
                "odys_phase_mean_seconds",
                help="running mean of the span phase, per phase label",
                phase=p,
            )
            for p in PHASES
        }
        self._folded = reg.counter(
            "odys_spans_folded_total", help="finished spans aggregated"
        )

    def fold(self, span: QuerySpan) -> None:
        self._folded.inc()
        for phase, dt in span.phases.items():
            self._sum[phase] = self._sum.get(phase, 0.0) + dt
            self._n[phase] = self._n.get(phase, 0) + 1
            g = self._gauges.get(phase)
            if g is not None:
                g.set(self._sum[phase] / self._n[phase])

    # ``sink`` aliases ``fold`` so an aggregator drops straight into the
    # scheduler's span_sink slot.
    sink: Callable = fold

    def mean(self, phase: str) -> float:
        n = self._n.get(phase, 0)
        return self._sum.get(phase, 0.0) / n if n else float("nan")

    def means(self) -> dict[str, float]:
        return {p: self.mean(p) for p in self._n}
