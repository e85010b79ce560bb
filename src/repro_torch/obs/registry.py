"""Low-overhead metrics registry: counters, gauges, log-bucketed histograms.

A copy of the JAX package's ``repro.obs.registry`` (which the port may not
import), kept line for line so both serving pipelines count alike.  The
serving pipeline's instrumentation all terminates here.  The design
constraints, in order:

- **zero-cost when disabled**: the process-wide default registry is a
  :class:`NullRegistry` whose instruments are shared no-op singletons — an
  instrumented call site costs one attribute lookup plus one empty method
  call, and creates no per-query garbage.  :func:`enable` swaps in a live
  :class:`MetricsRegistry`; components snapshot the registry at
  construction time, so enabling/disabling never races a running pipeline.
- **no sample storage**: histograms are fixed factor-2 log-bucketed
  (:data:`DEFAULT_BUCKETS`, 1 µs … ~134 s); p50/p95/p99 come from the
  bucket counts alone.  :meth:`Histogram.quantile` is exact to within one
  bucket — the estimate and the true sorted-sample quantile always land in
  the same bucket, so they agree within the bucket base (2x); see the
  property test in tests/test_obs.py.
- **single-threaded by design**, like the scheduler it instruments: plain
  int/float adds, no locks on the hot path.

Exposition (Prometheus text + JSON) lives in
:mod:`repro_torch.obs.exposition`; ``python -m repro_torch.obs`` serves both.
"""
from __future__ import annotations

import math
from bisect import bisect_left

__all__ = [
    "DEFAULT_BUCKETS",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NullRegistry",
    "disable",
    "enable",
    "get_registry",
    "set_registry",
]

#: Factor-2 latency ladder: 1 µs, 2 µs, …, ~134 s.  One int per bucket —
#: 28 buckets cover every phase this engine produces, from a cache probe
#: to an interpret-mode CI batch.
DEFAULT_BUCKETS = tuple(1e-6 * 2.0**i for i in range(28))


class Counter:
    """Monotone counter (floats allowed: padded-query fractions etc.)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n


class Histogram:
    """Fixed-bucket latency histogram (Prometheus ``le`` semantics).

    ``counts[i]`` holds observations ``v <= bounds[i]`` (exclusive of the
    previous bound); ``counts[-1]`` is the ``+Inf`` overflow bucket.
    """

    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: tuple[float, ...] = DEFAULT_BUCKETS):
        self.bounds = tuple(float(b) for b in bounds)
        assert all(a < b for a, b in zip(self.bounds, self.bounds[1:]))
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        self.sum += v
        self.count += 1
        self.counts[bisect_left(self.bounds, v)] += 1

    def mean(self) -> float:
        return self.sum / self.count if self.count else math.nan

    def quantile(self, q: float) -> float:
        """Sample quantile from bucket counts, linearly interpolated.

        Targets rank ``q * count``; the chosen bucket provably contains
        the exact order statistic ``sorted(samples)[ceil(q*n) - 1]``, so
        the estimate is within one bucket (a factor of 2 on the default
        ladder) of the exact sample quantile.  Observations above the
        ladder clamp to the top bound; ``nan`` when empty.
        """
        if self.count == 0:
            return math.nan
        target = max(q * self.count, 1e-12)
        cum = 0.0
        lo = 0.0
        for i, hi in enumerate(self.bounds):
            c = self.counts[i]
            if cum + c >= target:
                frac = min(1.0, max(0.0, (target - cum) / c))
                return lo + frac * (hi - lo)
            cum += c
            lo = hi
        return self.bounds[-1]


class _NullCounter(Counter):
    __slots__ = ()

    def inc(self, n: float = 1.0) -> None:
        pass


class _NullGauge(Gauge):
    __slots__ = ()

    def set(self, v: float) -> None:
        pass

    def inc(self, n: float = 1.0) -> None:
        pass

    def dec(self, n: float = 1.0) -> None:
        pass


class _NullHistogram(Histogram):
    __slots__ = ()

    def __init__(self):
        super().__init__(bounds=(1.0,))

    def observe(self, v: float) -> None:
        pass


class MetricsRegistry:
    """Name + label-set keyed instrument store.

    Instruments are created on first use and shared on every later call
    with the same ``(name, labels)``, so call sites can re-resolve them
    cheaply or hold the returned object (the hot paths do the latter).
    A metric name is bound to one kind for the registry's lifetime.
    """

    enabled = True

    def __init__(self):
        self._families: dict[str, tuple[str, str]] = {}  # name -> (kind, help)
        self._instruments: dict[tuple, object] = {}

    def _get(self, kind: str, factory, name: str, help: str, labels: dict):
        fam = self._families.get(name)
        if fam is None:
            self._families[name] = (kind, help)
        elif fam[0] != kind:
            raise ValueError(
                f"metric {name!r} already registered as {fam[0]}, not {kind}"
            )
        key = (name, tuple(sorted(labels.items())))
        inst = self._instruments.get(key)
        if inst is None:
            inst = factory()
            self._instruments[key] = inst
        return inst

    def counter(self, name: str, help: str = "", **labels: str) -> Counter:
        return self._get("counter", Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", **labels: str) -> Gauge:
        return self._get("gauge", Gauge, name, help, labels)

    def histogram(
        self,
        name: str,
        help: str = "",
        buckets: tuple[float, ...] = DEFAULT_BUCKETS,
        **labels: str,
    ) -> Histogram:
        return self._get(
            "histogram", lambda: Histogram(buckets), name, help, labels
        )

    def collect(self):
        """Yield ``(name, kind, help, [(labels_dict, instrument), ...])``
        sorted by name then label set — the exposition layer's input."""
        by_name: dict[str, list] = {}
        for (name, lab_items), inst in self._instruments.items():
            by_name.setdefault(name, []).append((dict(lab_items), inst))
        for name in sorted(by_name):
            kind, help = self._families[name]
            series = sorted(
                by_name[name], key=lambda s: tuple(sorted(s[0].items()))
            )
            yield name, kind, help, series


_NULL_COUNTER = _NullCounter()
_NULL_GAUGE = _NullGauge()
_NULL_HISTOGRAM = _NullHistogram()


class NullRegistry(MetricsRegistry):
    """The disabled path: every lookup returns a shared no-op singleton.

    ``collect()`` is always empty, so exposition of a disabled process is
    an empty document rather than an error.
    """

    enabled = False

    def counter(self, name: str, help: str = "", **labels: str) -> Counter:
        return _NULL_COUNTER

    def gauge(self, name: str, help: str = "", **labels: str) -> Gauge:
        return _NULL_GAUGE

    def histogram(
        self,
        name: str,
        help: str = "",
        buckets: tuple[float, ...] = DEFAULT_BUCKETS,
        **labels: str,
    ) -> Histogram:
        return _NULL_HISTOGRAM


_REGISTRY: MetricsRegistry = NullRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry (a no-op unless :func:`enable`\\ d).

    Components snapshot this at construction — swapping the default later
    affects newly built pipelines, not running ones.
    """
    return _REGISTRY


def set_registry(reg: MetricsRegistry) -> MetricsRegistry:
    """Install ``reg`` as the process default; returns the previous one."""
    global _REGISTRY
    prev = _REGISTRY
    _REGISTRY = reg
    return prev


def enable() -> MetricsRegistry:
    """Install (and return) a fresh live registry as the process default."""
    reg = MetricsRegistry()
    set_registry(reg)
    return reg


def disable() -> None:
    """Restore the no-op default."""
    set_registry(NullRegistry())
