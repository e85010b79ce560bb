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

**Host spans** (:func:`host_span`, :func:`batch_span`) split the serving path
further.  Each site is a named interval of host code; the port adds these
phases, all on ``time.perf_counter`` and never on the scheduler's
injectable clocks (a replay's readings do not move):

- ``admit``        — one query's whole ``submit`` call, on its own span
  (timed only: a ``record_function`` a query would cost more than it tells);
- ``form``         — ``_dispatch`` up to the executor: batch formation,
  padding, the route, the dispatch-time cache recheck (``odys.form``);
- ``batch_build``  — ``make_query_batch``: host arrays and their
  host-to-device copies (``odys.batch_build``);
- ``slave_launch`` — every slave's plan, join launch, first-k sort and
  docID globalisation, summed over the slaves (``odys.slave``, one a slave);
- ``merge_launch`` — the master merge's launches and the ``n_hits`` sum
  (``odys.merge``);
- ``complete``     — the executor's return through the ticket loop, cache
  puts and counters (``odys.complete``).

A traced batch then closes its query spans (their phases, histograms and
sink) under ``odys.spans``, which no phase holds: that is tracing's own
cost.

``master_merge`` (``odys.device_wait``) and ``finalize``
(``odys.finalize``) keep their keys; ``master_merge`` is the wait for the
device at the batch boundary.  ``batch_build``, ``slave_launch`` and
``merge_launch`` lie inside ``slave_dispatch``.  The new keys stay out of
:data:`PHASES`, so the exposition's ``odys_phase_seconds`` series are the
JAX package's.

A span is gated twice.  While ``torch.profiler`` records it enters
``torch.profiler.record_function(name)``, so the interval sits in the
device trace on the profiler's clock (``perf_counter`` is another clock).
While its batch is timed (the service's live registry, the scheduler's
``trace``) it adds its host seconds to a phase dict.  Otherwise it is a
shared inert object: no allocation, no clock read.  No span waits on the
device; device time stays with the profiler.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable

import torch

from repro_torch.obs.registry import MetricsRegistry, get_registry

__all__ = [
    "PHASES",
    "WALL_PHASES",
    "PhaseAggregator",
    "QuerySpan",
    "batch_span",
    "close_batch",
    "host_span",
    "open_batch",
]

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


# ---------------------------------------------------------------------------
# Host spans
# ---------------------------------------------------------------------------

_profiler = torch.autograd.profiler


class _Open(threading.local):
    """The timed batch's phase dict, per thread (sets on their own ranks
    may serve two batches from two threads); None while none is open."""

    phases: dict | None = None


_open = _Open()


class _Span:
    """An open host span: a ``record_function`` while the profiler records,
    ``phases[phase] += seconds`` while ``phases`` is given."""

    __slots__ = ("_name", "_phase", "_phases", "_rf", "_t0")

    def __init__(self, name: str | None, phase: str, phases: dict | None):
        self._name, self._phase, self._phases = name, phase, phases
        self._rf = None
        self._t0 = 0.0

    def __enter__(self) -> "_Span":
        if self._name is not None:
            self._rf = torch.profiler.record_function(self._name)
            self._rf.__enter__()
        if self._phases is not None:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        if self._phases is not None:
            dt = time.perf_counter() - self._t0
            self._phases[self._phase] = self._phases.get(self._phase, 0.0) + dt
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


class _Inert:
    __slots__ = ()

    def __enter__(self) -> "_Inert":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_INERT = _Inert()


def host_span(name: str, phase: str, phases: dict | None):
    """``with host_span("odys.x", "x", phases): ...`` — a host span (module
    docstring).  ``phases`` is the timed batch's phase dict, or None when
    the batch is not timed; ``phase`` is the key the seconds go to."""
    profiling = _profiler._is_profiler_enabled
    if not profiling and phases is None:
        return _INERT
    return _Span(name if profiling else None, phase, phases)


def batch_span(name: str, phase: str):
    """:func:`host_span` into the batch collector open on this thread
    (:func:`open_batch`), if any: for the engine's sites, which cannot see
    the service that timed the batch."""
    return host_span(name, phase, _open.phases)


def open_batch() -> dict:
    """Open this thread's batch collector; :func:`batch_span` sites add to
    the returned dict until :func:`close_batch`."""
    _open.phases = {}
    return _open.phases


def close_batch() -> None:
    _open.phases = None
