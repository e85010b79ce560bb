"""Observability: metrics registry, per-query phase tracing, model residual
(copies of ``repro.obs``).

The serving pipeline's latency decomposition (paper §4–§5: queueing,
slave top-k, master merge) as a live, exported signal:

- :mod:`repro_torch.obs.registry`   — counters, gauges, fixed log-bucketed
  latency histograms (p50/p95/p99 without storing samples); a no-op
  :class:`NullRegistry` is the process default, so instrumentation is
  zero-cost until :func:`enable` is called;
- :mod:`repro_torch.obs.trace`      — :class:`QuerySpan`, the per-query
  phase record the scheduler populates, plus a folding aggregator;
- :mod:`repro_torch.obs.residual`   — the online Formula (18) monitor
  comparing measured response against the fitted hybrid model;
- :mod:`repro_torch.obs.exposition` — Prometheus text + JSON rendering,
  both behind ``python -m repro_torch.obs``.
"""
from repro_torch.obs.exposition import to_json, to_prometheus  # noqa: F401
from repro_torch.obs.registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    NullRegistry,
    disable,
    enable,
    get_registry,
    set_registry,
)
from repro_torch.obs.residual import ModelResidualMonitor  # noqa: F401
from repro_torch.obs.trace import (  # noqa: F401
    PHASES,
    WALL_PHASES,
    PhaseAggregator,
    QuerySpan,
)
