"""Unified master scheduler: the ODYS admission pipeline (paper §3.1, §4.1).

The paper's master is not a one-shot function call — it is a pipeline:
queries arrive at a rate lambda, are weighted into unit queries, queued
(M/D/1, Formulas (1)-(16)), batched to the slaves, and merged.  This module
is that pipeline for the PyTorch port: a copy of the JAX package's
``repro.serving.scheduler``, which is free of JAX but lives in a package
that imports it.  :mod:`repro_torch.serving.search` wraps it around the
distributed query engine.

- **Admission queue + dynamic micro-batch formation**: submitted queries
  are bucketed by ``(t_max, k)`` — the two shape-determining parameters of
  the query path — and dispatched as fixed-size batches.  Partial
  batches are padded with *inert* clones of a real query (results
  discarded), so every dispatch reuses one of a small, fixed set of device
  shapes, whatever the mix of ``t_max`` in the workload.

- **LRU result cache**, keyed on ``(terms, site, k)`` and stamped with the
  index snapshot version at dispatch time (any hashable stamp compared by
  value: the writer's int version, or a multi-master writer's
  ``VectorVersion``; 0 for a read-only service).  A lookup whose stamp no
  longer matches the live version is evicted
  (lazy invalidation), so merge-on-read freshness is preserved: a cached
  result is never served across an insert/delete/update/compaction.
  Orlando et al. (PAPERS.md) put the broker's result cache first among the
  throughput levers; the version stamp is what makes it safe next to the
  paper's online-update story.

- **Multi-set router** (paper §5.2): batches spread across ``n_sets``
  replicated sets with per-set in-flight accounting; the router picks the
  set that can start earliest.  In-process the sets time-share one mesh
  (the accounting still models §5.2's linear scale-out in the replay
  below); a multi-pod deployment dispatches on ``set_id`` instead.

- **Trace-driven replay** (:meth:`MasterScheduler.replay`): an open-loop
  lambda sweep that advances a *virtual* clock over a Poisson arrival trace
  while measuring *real* batch service times — the measured half of the
  paper's hybrid model validation (Formula (18)).

- **Observability** (:mod:`repro_torch.obs`): every stage reports into a metrics
  registry (queue depth, cache hit rate, per-set in-flight, per-phase
  latency histograms) and, when tracing is on, every ticket carries a
  :class:`~repro_torch.obs.trace.QuerySpan` with the paper's §4 latency
  decomposition.  Two clock domains by construction: waits are measured on
  the scheduler's injectable ``clock`` (virtual under replay), measured
  batch service on the injectable ``wall_clock`` (a real monotonic clock),
  and the span schema labels which phase lives in which domain — replay
  traces are never a mix of unlabeled virtual and wall time.  With the
  default :class:`~repro_torch.obs.registry.NullRegistry` all of this is no-op
  singleton calls and no spans are allocated.  The port adds host spans
  (:func:`~repro_torch.obs.trace.host_span`: ``odys.form``,
  ``odys.complete``, and ``admit`` on each query's span), timed on
  ``time.perf_counter`` and never on either injectable clock.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Hashable, Sequence

from repro_torch.core.perfmodel import sojourn
from repro_torch.obs.registry import MetricsRegistry, get_registry
from repro_torch.obs.trace import PHASES, QuerySpan, host_span

__all__ = [
    "CacheStats",
    "MasterScheduler",
    "MultiSetRouter",
    "QueryTicket",
    "ResultCache",
    "SetState",
    "form_batch",
]


def form_batch(queue: list, batch_size: int, *, pad: Callable | None = None):
    """Pop up to ``batch_size`` items off the front of ``queue``.

    Returns ``[]`` on an empty queue (no crash, no dispatch).  With ``pad``,
    a partial batch is filled to exactly ``batch_size`` with ``pad(first)``
    clones of its first element, so downstream device shapes stay fixed.
    Shared by the search scheduler and the LM serving engine
    (:mod:`repro_torch.serving.engine`).
    """
    if not queue:
        return []
    batch = queue[:batch_size]
    del queue[:batch_size]
    if pad is not None:
        first = batch[0]
        while len(batch) < batch_size:
            batch.append(pad(first))
    return batch


@dataclasses.dataclass
class QueryTicket:
    """One admitted query's lifecycle record.

    ``qid < 0`` marks an inert padding clone (never returned to callers).
    Times are in the scheduler's clock domain — wall seconds live, virtual
    seconds under :meth:`MasterScheduler.replay`.
    """

    qid: int
    terms: tuple[int, ...]
    site: int | None
    k: int
    bucket: int                    # t_max bucket the query was admitted to
    submit_time: float
    result: Any = None
    done: bool = False
    from_cache: bool = False
    finish_time: float | None = None
    set_id: int | None = None
    span: "QuerySpan | None" = None   # phase trace (tracing schedulers only)

    @property
    def response_time(self) -> float:
        assert self.done and self.finish_time is not None
        return self.finish_time - self.submit_time


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    stale: int = 0      # entries evicted because the snapshot version moved
    evicted: int = 0    # LRU capacity evictions

    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0


class ResultCache:
    """LRU result cache with snapshot-version invalidation.

    Entries are stored as ``key -> (version, result)``; a version is any
    hashable stamp compared by value (an int, or a ``VectorVersion``).
    ``get`` only returns an entry whose stored version equals the caller's
    current version; a mismatch evicts the entry and counts as ``stale`` (every
    mutation and every compaction bumps the writer version, so staleness
    needs no explicit invalidation hook on the write path).

    ``registry`` (default: the process registry, a no-op unless enabled)
    mirrors the counters as ``odys_cache_*`` metrics plus hit-rate and
    residency gauges, so a scrape sees the cache without calling into it.
    """

    def __init__(self, capacity: int, registry: MetricsRegistry | None = None):
        assert capacity > 0
        self.capacity = capacity
        self._entries: OrderedDict[tuple, tuple[Hashable, float, Any]] = OrderedDict()
        self.stats = CacheStats()
        reg = registry if registry is not None else get_registry()
        self._c_hits = reg.counter(
            "odys_cache_hits_total", help="result-cache hits")
        self._c_misses = reg.counter(
            "odys_cache_misses_total", help="result-cache misses")
        self._c_stale = reg.counter(
            "odys_cache_stale_total",
            help="entries evicted because the snapshot version moved")
        self._c_evicted = reg.counter(
            "odys_cache_evicted_total", help="LRU capacity evictions")
        self._g_hit_rate = reg.gauge(
            "odys_cache_hit_rate", help="hits / (hits + misses), lifetime")
        self._g_entries = reg.gauge(
            "odys_cache_entries", help="resident result-cache entries")

    def __len__(self) -> int:
        return len(self._entries)

    def _miss(self) -> None:
        self.stats.misses += 1
        self._c_misses.inc()
        self._g_hit_rate.set(self.stats.hit_rate())

    def get(self, key: tuple, version: Hashable, now: float = math.inf,
            *, count_miss: bool = True):
        """Version- and maturity-checked lookup.

        ``count_miss=False`` makes a *no-hit* outcome silent in the
        hit/miss stats — the scheduler's dispatch-time recheck uses it so
        a query is not double-counted as a miss (its admission-time lookup
        already was).  Stale evictions and hits always count.
        """
        entry = self._entries.get(key)
        if entry is None:
            if count_miss:
                self._miss()
            return None
        stored_version, available_at, result = entry
        if stored_version != version:
            del self._entries[key]
            self.stats.stale += 1
            self._c_stale.inc()
            self._g_entries.set(len(self._entries))
            if count_miss:
                self._miss()
            return None
        if available_at > now:
            # The producing batch has not finished yet at ``now`` (this
            # happens in virtual-time replay): the result exists on the
            # host but the modeled system could not have served it — treat
            # as a miss, leave the entry for when it matures.
            if count_miss:
                self._miss()
            return None
        self._entries.move_to_end(key)
        self.stats.hits += 1
        self._c_hits.inc()
        self._g_hit_rate.set(self.stats.hit_rate())
        return result

    def put(self, key: tuple, version: Hashable, result,
            available_at: float = 0.0) -> None:
        self._entries[key] = (version, available_at, result)
        self._entries.move_to_end(key)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.stats.evicted += 1
            self._c_evicted.inc()
        self._g_entries.set(len(self._entries))

    def clear(self) -> None:
        self._entries.clear()
        self._g_entries.set(0)


@dataclasses.dataclass
class SetState:
    """Accounting for one replicated set (paper §5.2)."""

    sid: int
    in_flight: int = 0       # queries currently dispatched to this set
    busy_until: float = 0.0  # when the set's current batch finishes
    n_batches: int = 0
    n_queries: int = 0
    first_start: float | None = None  # first dispatch start (throughput base)


class MultiSetRouter:
    """Spread batches across N replicated sets, least-loaded first.

    Routing key: the set that can *start* earliest (min ``busy_until``),
    ties broken toward fewer in-flight queries, then lower sid — the
    paper's multi-set scale-out (§5.2) where each set independently absorbs
    a slice of the arrival stream.
    """

    def __init__(self, n_sets: int):
        assert n_sets >= 1
        self.sets = [SetState(sid) for sid in range(n_sets)]
        self.bind_registry(get_registry())

    def bind_registry(self, reg: MetricsRegistry) -> None:
        """(Re)create the per-set instruments on ``reg``.

        Called at construction with the process registry and again by the
        scheduler with its own — so a router built before the scheduler
        (e.g. a pre-wired :class:`HealthAwareRouter`) still reports into
        the pipeline's registry.  Idempotent; no-op on a null registry.
        """
        self._g_in_flight = {
            s.sid: reg.gauge(
                "odys_set_in_flight",
                help="queries currently dispatched to the set",
                set=str(s.sid),
            )
            for s in self.sets
        }
        self._c_set_batches = {
            s.sid: reg.counter(
                "odys_set_batches_total",
                help="batches routed to the set",
                set=str(s.sid),
            )
            for s in self.sets
        }

    @property
    def n_sets(self) -> int:
        return len(self.sets)

    def _candidates(self) -> list[SetState]:
        """Sets eligible for new batches (health-aware routers narrow
        this; see :class:`repro_torch.serving.router.HealthAwareRouter`)."""
        return self.sets

    def route(self, n_queries: int) -> SetState:
        s = min(
            self._candidates(),
            key=lambda st: (st.busy_until, st.in_flight, st.sid),
        )
        s.in_flight += n_queries
        s.n_batches += 1
        s.n_queries += n_queries
        self._g_in_flight[s.sid].set(s.in_flight)
        self._c_set_batches[s.sid].inc()
        return s

    def complete(self, s: SetState, n_queries: int) -> None:
        s.in_flight -= n_queries
        assert s.in_flight >= 0
        self._g_in_flight[s.sid].set(s.in_flight)

    def snapshot(self) -> list[dict]:
        return [dataclasses.asdict(s) for s in self.sets]


class MasterScheduler:
    """Async-style micro-batching master over a batch executor.

    Parameters
    ----------
    executor:
        ``executor(queries, t_max, k, set_id) -> list[result]`` — runs one
        formed batch (already padded to ``batch_size``) at the given padded
        width ``t_max`` and top-``k``; returns one result per query in
        order.  :class:`repro_torch.serving.search.SearchService` supplies the
        distributed engine here.
    batch_size:
        Queries per dispatched micro-batch (the device batch dimension).
    t_max_buckets:
        Ascending padded-width buckets.  A query of effective width ``w``
        is admitted to the smallest bucket ``>= w``; each ``(bucket, k)``
        pair compiles exactly once.
    default_k:
        Top-k for :meth:`submit` calls that do not override it.
    cache_size:
        LRU result-cache capacity; ``0`` disables caching.
    n_sets:
        Replicated-set count for the router.
    max_wait:
        Batch-formation deadline (seconds): under :meth:`replay`, a partial
        bucket is flushed once its oldest query has waited this long.  Live
        ``drain()`` always flushes.
    adaptive_wait:
        Adaptive formation deadline (closes the ROADMAP adaptive-policy
        item).  ``max_wait`` becomes a *ceiling*; the effective deadline
        per bucket is

        - ``0`` when the estimated arrival rate cannot fill the bucket's
          remainder within ``max_wait`` anyway (the low-load case: waiting
          buys no batching, so don't — this is the formation wait
          bench_serving measures);
        - ``max_wait * st / sojourn(lambda, st)`` otherwise, where
          ``st = 1/mu`` — the deadline is fitted to the M/D/1 sojourn
          target (Formula (13)): the allowance shrinks exactly as queueing
          inflates the expected sojourn over the bare service time, so the
          formation slack stays a constant *fraction of the sojourn
          budget* rather than a linear guess, and collapses to zero at
          saturation (``sojourn -> inf`` as ``rho -> 1``, where full
          batches form by count anyway).

        ``lambda`` is estimated from recent arrival timestamps (virtual
        time under replay); ``mu`` is ``capacity_qps`` when given (e.g.
        ``n_sets * batch_size / st`` from a calibration run),
        otherwise self-fitted from an EWMA of measured batch service times.
    capacity_qps:
        Fitted capacity (queries/second) for the adaptive policy; ``None``
        self-measures.
    router:
        A pre-built router (e.g. a health-aware subclass of
        :class:`MultiSetRouter`).  When given it
        *overrides* ``n_sets`` — the router's own set count is
        authoritative everywhere (dispatch, stats, self-fitted capacity).
    version_fn:
        Snapshot-version source for cache stamping/invalidation (the
        search service wires the writer's ``version`` here).
    width_fn:
        Effective padded width of ``(terms, site)`` — lets the service
        account for the ``site_term`` strategy's extra join term.
    clock:
        The scheduler's time source (waits, deadlines, finish stamps);
        virtual under :meth:`replay`.  Injectable for tests.
    wall_clock:
        The *measurement* time source: batch service and the wall-domain
        span phases are timed here, never on ``clock`` — so replay mixes
        a virtual timeline with real measured service without the two
        bleeding into each other.  Injectable for tests; must be a real
        monotonic clock in production.
    registry:
        Metrics sink (:mod:`repro_torch.obs.registry`).  Default: the process
        registry — a no-op unless ``repro_torch.obs.enable()`` was called.
    trace:
        Allocate a :class:`~repro_torch.obs.trace.QuerySpan` per ticket.
        Default (``None``): trace iff the registry is live.
    exec_phases_fn:
        Called once after each executor return; may yield a
        ``{phase: seconds}`` dict splitting the batch's service into
        wall-domain sub-phases (the search service reports
        slave_dispatch / master_merge / finalize through this).  Without
        it the whole measured batch wall time lands in ``slave_dispatch``.
    span_sink:
        Called with each *finished* span (dispatch completion or cache
        hit) — wire a :class:`~repro_torch.obs.trace.PhaseAggregator` here.
    """

    def __init__(
        self,
        executor: Callable[[list, int, int, int], list],
        *,
        batch_size: int = 8,
        t_max_buckets: Sequence[int] = (4,),
        default_k: int = 10,
        cache_size: int = 1024,
        n_sets: int = 1,
        max_wait: float = 0.0,
        adaptive_wait: bool = False,
        capacity_qps: float | None = None,
        router: "MultiSetRouter | None" = None,
        version_fn: Callable[[], Hashable] | None = None,
        width_fn: Callable[[tuple, int | None], int] | None = None,
        clock: Callable[[], float] = time.perf_counter,
        wall_clock: Callable[[], float] = time.perf_counter,
        registry: MetricsRegistry | None = None,
        trace: bool | None = None,
        exec_phases_fn: Callable[[], "dict[str, float] | None"] | None = None,
        span_sink: Callable[[QuerySpan], None] | None = None,
    ):
        assert batch_size >= 1
        buckets = tuple(sorted(set(int(b) for b in t_max_buckets)))
        assert buckets and buckets[0] >= 1
        reg = registry if registry is not None else get_registry()
        self.registry = reg
        self.trace = bool(reg.enabled) if trace is None else bool(trace)
        self.span_sink = span_sink
        self._exec_phases_fn = exec_phases_fn
        self.executor = executor
        self.batch_size = batch_size
        self.t_max_buckets = buckets
        self.default_k = default_k
        self.max_wait = max_wait
        self.adaptive_wait = adaptive_wait
        self.capacity_qps = capacity_qps
        self.cache = (
            ResultCache(cache_size, registry=reg) if cache_size > 0 else None
        )
        self.router = router if router is not None else MultiSetRouter(n_sets)
        self.router.bind_registry(reg)
        self._version_fn = version_fn or (lambda: 0)
        self._width_fn = width_fn or (lambda terms, site: len(terms))
        self._clock = clock
        self._wall_clock = wall_clock
        self._vclock: float | None = None       # non-None while replaying
        self._queues: dict[tuple[int, int], list[QueryTicket]] = {}
        self._next_qid = 0
        self.n_batches = 0
        self.n_padded = 0
        self.n_short_circuited = 0    # formed batches that launched nothing
        self._pad_fraction_sum = 0.0  # per-batch pad fractions, for stats()
        self._arrivals: deque[float] = deque(maxlen=32)   # aggregate (rho)
        self._key_arrivals: dict[tuple, deque] = {}       # per bucket (fill)
        self._warm_keys: set[tuple] = set()   # buckets past their first batch
        self._service_ewma: float | None = None  # seconds per batch
        self._m_submitted = reg.counter(
            "odys_queries_submitted_total", help="queries admitted")
        self._m_batches = reg.counter(
            "odys_batches_dispatched_total", help="micro-batches executed")
        self._m_padded = reg.counter(
            "odys_padded_queries_total",
            help="inert padding clones dispatched in partial batches")
        self._m_pad_fraction = reg.gauge(
            "odys_batch_pad_fraction",
            help="inert padding share of the last dispatched micro-batch "
                 "(interprets odys_kernel_grid_occupancy under padding)")
        self._m_queue_depth = reg.gauge(
            "odys_queue_depth", help="queries waiting for batch formation")
        self._m_short_circuited = reg.counter(
            "odys_batches_short_circuited_total",
            help="formed batches whose every real query hit the cache at "
                 "dispatch time — nothing launched (the scheduler-level "
                 "analogue of the kernels' all-inert no-launch path)")
        self._g_set_qps = {
            s.sid: reg.gauge(
                "odys_set_throughput_qps",
                help="per-set sustained throughput: completed queries over "
                     "the set's active span (scheduler clock domain)",
                set=str(s.sid),
            )
            for s in self.router.sets
        }
        self._m_response = reg.histogram(
            "odys_response_seconds",
            help="submit-to-finish response time (scheduler clock domain; "
                 "virtual seconds under replay)")
        self._m_service = reg.histogram(
            "odys_batch_service_seconds",
            help="measured batch service wall time (wall domain)")
        self._m_phase = {
            p: reg.histogram(
                "odys_phase_seconds",
                help="per-phase latency decomposition (see span schema for "
                     "clock domains)",
                phase=p,
            )
            for p in PHASES
        }

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------

    def _now(self) -> float:
        return self._vclock if self._vclock is not None else self._clock()

    def _bucket_of(self, width: int) -> int:
        for b in self.t_max_buckets:
            if width <= b:
                return b
        raise ValueError(
            f"query width {width} exceeds the largest t_max bucket "
            f"{self.t_max_buckets[-1]}"
        )

    def submit(
        self, terms: Sequence[int], site: int | None = None, *, k: int | None = None
    ) -> QueryTicket:
        """Admit one query; returns its ticket (completed already on a
        cache hit, otherwise filled in by a later dispatch).  Traced, the
        whole call lands in the query's ``admit`` phase."""
        a0 = time.perf_counter() if self.trace else 0.0
        k = self.default_k if k is None else int(k)
        terms_t = tuple(int(t) for t in terms)
        if not terms_t:
            # reject at admission: a termless query would only fail at
            # dispatch, taking its co-batched queries down with it
            raise ValueError("query must have at least one term")
        bucket = self._bucket_of(self._width_fn(terms_t, site))
        now = self._now()
        self._arrivals.append(now)
        self._key_arrivals.setdefault(
            (bucket, k), deque(maxlen=32)
        ).append(now)
        ticket = QueryTicket(
            qid=self._next_qid, terms=terms_t, site=site, k=k,
            bucket=bucket, submit_time=now,
        )
        self._next_qid += 1
        self._m_submitted.inc()
        span = None
        if self.trace:
            span = QuerySpan(qid=ticket.qid, submit_time=now)
            ticket.span = span
        if self.cache is not None:
            w0 = self._wall_clock() if span is not None else 0.0
            hit = self.cache.get((terms_t, site, k), self._version_fn(), now)
            if span is not None:
                span.add("cache_lookup", self._wall_clock() - w0)
            if hit is not None:
                ticket.result = hit
                ticket.done = True
                ticket.from_cache = True
                ticket.finish_time = now
                self._m_response.observe(0.0)
                if span is not None:
                    span.from_cache = True
                    span.finish_time = now
                    self._m_phase["cache_lookup"].observe(
                        span.phases["cache_lookup"])
                    span.add("admit", time.perf_counter() - a0)
                    if self.span_sink is not None:
                        self.span_sink(span)
                return ticket
        self._queues.setdefault((bucket, k), []).append(ticket)
        self._m_queue_depth.set(self.pending())
        if span is not None:
            span.add("admit", time.perf_counter() - a0)
        return ticket

    def pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    # ------------------------------------------------------------------
    # adaptive formation deadline
    # ------------------------------------------------------------------

    @staticmethod
    def _rate(arrivals: "deque[float] | None") -> float | None:
        """Events/second over a timestamp window (None = unknown)."""
        if arrivals is None or len(arrivals) < 2:
            return None
        span = arrivals[-1] - arrivals[0]
        if span <= 0:
            return None
        return (len(arrivals) - 1) / span

    def _capacity(self) -> float | None:
        """Fitted service capacity (queries/second) across all sets."""
        if self.capacity_qps is not None:
            return self.capacity_qps
        if self._service_ewma is None or self._service_ewma <= 0:
            return None
        return self.router.n_sets * self.batch_size / self._service_ewma

    def effective_wait(self, key: tuple[int, int]) -> float:
        """Formation deadline for bucket ``key`` (see ``adaptive_wait``)."""
        if not self.adaptive_wait or self.max_wait <= 0:
            return self.max_wait
        # The fill estimate is per bucket — with several active buckets,
        # only this bucket's arrivals can fill this bucket's batch.
        lam_key = self._rate(self._key_arrivals.get(key))
        if lam_key is None:
            return self.max_wait
        shortfall = self.batch_size - len(self._queues.get(key, ()))
        if lam_key * self.max_wait < shortfall:
            # Low load: the bucket cannot fill before the ceiling anyway —
            # waiting adds formation latency and buys no batching.
            return 0.0
        # The saturation shrink keys off the aggregate rate: capacity is
        # shared across buckets.
        lam = self._rate(self._arrivals)
        mu = self._capacity()
        if lam is None or mu is None or mu <= 0:
            return self.max_wait
        # M/D/1 sojourn-target fit (Formula (13)): grant the ceiling scaled
        # by how little queueing has inflated the sojourn over the bare
        # service time.  sojourn -> st as rho -> 0 (full ceiling) and
        # -> inf as rho -> 1 (deadline collapses to zero: near saturation
        # full batches form by count and slack only adds sojourn).
        st = 1.0 / mu
        return self.max_wait * st / sojourn(lam, st)

    # ------------------------------------------------------------------
    # dispatch
    # ------------------------------------------------------------------

    def _full_bucket(self) -> tuple[int, int] | None:
        for key, q in self._queues.items():
            if len(q) >= self.batch_size:
                return key
        return None

    def _oldest_bucket(self) -> tuple[tuple[int, int], float] | None:
        """(key, head submit time) of the bucket with the oldest head."""
        best = None
        for key, q in self._queues.items():
            if q and (best is None or q[0].submit_time < best[1]):
                best = (key, q[0].submit_time)
        return best

    def _dispatch(self, key: tuple[int, int]) -> list[QueryTicket]:
        """Form and execute one micro-batch from bucket ``key``."""
        # Traced, the batch's host spans add to ``spent`` (``form``,
        # ``complete``), and its finished spans take them before the sink.
        spent = {} if self.trace else None
        with host_span("odys.form", "form", spent):
            t_max, k = key
            queue = self._queues[key]
            t_form = self._now()        # batch formation instant (scheduler clock)
            batch = form_batch(
                queue, self.batch_size,
                pad=lambda first: dataclasses.replace(first, qid=-1),
            )
            if not queue:
                del self._queues[key]
            if not batch:
                return []
            real = [t for t in batch if t.qid >= 0]
            route_w0 = self._wall_clock() if self.trace else 0.0
            try:
                sref = self.router.route(len(real))
            except BaseException:
                # routing can refuse (e.g. every set dead in a health-aware
                # router): the popped tickets must survive for a later retry
                self._queues.setdefault(key, [])[:0] = real
                raise
            route_wall = self._wall_clock() - route_w0 if self.trace else 0.0
            version = self._version_fn()
            queries = [(list(t.terms), t.site) for t in batch]
            start = max(self._now(), sref.busy_until)
            # Dispatch-time cache recheck: a result produced by an *earlier*
            # batch may have matured between this query's admission (where the
            # submit-path lookup legitimately missed) and its dispatch instant
            # ``start``.  Tickets satisfied here are served from cache at
            # ``start``; a batch whose every real query is satisfied launches
            # nothing at all — the scheduler-level all-inert no-launch path,
            # accounted below so occupancy stats match the kernels'
            # ``odys_kernel_steps_saved_total`` story.
            live = real
            if self.cache is not None:
                live = []
                for ticket in real:
                    hit = self.cache.get(
                        (ticket.terms, ticket.site, ticket.k), version, start,
                        count_miss=False,
                    )
                    if hit is None:
                        live.append(ticket)
                        continue
                    ticket.result = hit
                    ticket.done = True
                    ticket.from_cache = True
                    ticket.finish_time = start
                    ticket.set_id = sref.sid
                    self._m_response.observe(start - ticket.submit_time)
                    span = ticket.span
                    if span is not None:
                        span.from_cache = True
                        span.set_id = sref.sid
                        span.add("admission_wait", t_form - span.submit_time)
                        span.add("formation_wait", start - t_form)
                        span.add("route", route_wall)
                        span.finish_time = start
                        for phase, dt in span.phases.items():
                            hist = self._m_phase.get(phase)
                            if hist is not None:
                                hist.observe(dt)
                        if self.span_sink is not None:
                            self.span_sink(span)
            if not live:
                # Everything in the formed batch is inert (padding clones plus
                # recheck-satisfied tickets): nothing launches, the set stays
                # idle, but the batch still counts toward occupancy accounting
                # with pad_fraction 1.0.
                self.router.complete(sref, len(real))
                if sref.first_start is not None:
                    # the set's cache served these queries without new work:
                    # throughput over the unchanged active span goes up
                    self._g_set_qps[sref.sid].set(
                        sref.n_queries / max(start - sref.first_start, 1e-9)
                    )
                self.n_batches += 1
                self.n_short_circuited += 1
                self._pad_fraction_sum += 1.0
                self._m_batches.inc()
                self._m_short_circuited.inc()
                self._m_pad_fraction.set(1.0)
                self._m_queue_depth.set(self.pending())
                return real
        # Measured service stays on the real monotonic wall clock — never
        # the (possibly virtual) scheduler clock; the span labels it so.
        wall0 = self._wall_clock()
        try:
            results = self.executor(queries, t_max, k, sref.sid)
        except BaseException:
            # keep the pipeline consistent: the un-served tickets go back
            # to the head of their bucket, the set's accounting closes
            self.router.complete(sref, len(real))
            self._queues.setdefault(key, [])[:0] = real
            raise
        wall = self._wall_clock() - wall0
        finished: list[QuerySpan] = []
        with host_span("odys.complete", "complete", spent):
            exec_phases = (
                self._exec_phases_fn() if self._exec_phases_fn is not None
                else None
            )
            if key in self._warm_keys:
                self._service_ewma = (
                    wall if self._service_ewma is None
                    else 0.8 * self._service_ewma + 0.2 * wall
                )
            else:
                # every (t_max, k) bucket's first batch pays one-time set-up
                # (a kernel build, allocator growth): folding that wall time
                # into the EWMA would collapse the self-fitted capacity (and
                # with it the adaptive deadline)
                self._warm_keys.add(key)
            finish = start + wall if self._vclock is not None else self._clock()
            if sref.first_start is None:
                sref.first_start = start
            sref.busy_until = finish
            self.router.complete(sref, len(real))
            self._m_service.observe(wall)
            self._g_set_qps[sref.sid].set(
                sref.n_queries / max(finish - sref.first_start, 1e-9)
            )
            batch_id = self.n_batches
            # Inert share of the launch: padding clones plus any tickets the
            # dispatch-time recheck already served from cache (their kernel
            # slots run but the results are discarded).
            pad_fraction = (len(batch) - len(live)) / len(batch)
            for ticket, res in zip(batch, results):
                if ticket.qid < 0 or ticket.done:
                    continue
                ticket.result = res
                ticket.done = True
                ticket.finish_time = finish
                ticket.set_id = sref.sid
                self._m_response.observe(finish - ticket.submit_time)
                if ticket.span is not None:
                    finished.append(ticket.span)
                if self.cache is not None:
                    # stamped with the batch's finish: under replay a result
                    # must not be served at a virtual time before it existed
                    self.cache.put(
                        (ticket.terms, ticket.site, ticket.k), version, res,
                        available_at=finish,
                    )
            self.n_batches += 1
            self.n_padded += len(batch) - len(real)
            self._pad_fraction_sum += pad_fraction
            self._m_batches.inc()
            self._m_padded.inc(len(batch) - len(real))
            self._m_pad_fraction.set(pad_fraction)
            self._m_queue_depth.set(self.pending())
        if finished:
            # The spans' own bookkeeping follows ``odys.complete``, so that
            # no phase holds it; the profiler names it ``odys.spans``.
            # Batch-level phases, summed per key: an opaque executor's whole
            # measured service is one dispatch phase; ``spent`` is None for a
            # span admitted while traced and dispatched untraced.
            with host_span("odys.spans", "spans", None):
                shared = {"formation_wait": start - t_form, "route": route_wall}
                for part in (exec_phases or {"slave_dispatch": wall}, spent or {}):
                    for phase, dt in part.items():
                        shared[phase] = shared.get(phase, 0.0) + dt
                for span in finished:
                    span.set_id = sref.sid
                    span.batch_id = batch_id
                    span.batch_queries = len(real)
                    span.pad_fraction = pad_fraction
                    phases = span.phases
                    span.add("admission_wait", t_form - span.submit_time)
                    for phase, dt in shared.items():
                        phases[phase] = phases.get(phase, 0.0) + dt
                    span.finish_time = finish
                    for phase, hist in self._m_phase.items():
                        if phase in phases:
                            hist.observe(phases[phase])
                    if self.span_sink is not None:
                        self.span_sink(span)
        return real

    def step(self) -> list[QueryTicket]:
        """Dispatch one micro-batch (a full bucket if any, else the bucket
        with the oldest waiting query, padded).  No-op on an empty queue."""
        key = self._full_bucket()
        if key is None:
            oldest = self._oldest_bucket()
            if oldest is None:
                return []
            key = oldest[0]
        return self._dispatch(key)

    def drain(self) -> list[QueryTicket]:
        """Dispatch until the admission queue is empty."""
        finished: list[QueryTicket] = []
        while self.pending():
            finished.extend(self.step())
        return finished

    # ------------------------------------------------------------------
    # open-loop replay (the measured half of the hybrid model)
    # ------------------------------------------------------------------

    def replay(
        self, trace: Sequence[tuple[float, Sequence[int], int | None]]
    ) -> list[QueryTicket]:
        """Replay an arrival trace against the live engine in virtual time.

        ``trace`` is ``(arrival_time, terms, site)`` tuples, ascending in
        time.  Arrivals, batch-formation deadlines (``max_wait``) and
        completions advance a virtual clock; each dispatched batch's
        *service* time is the real measured wall time of the executor, and
        per-set ``busy_until`` serializes batches within a set while
        letting ``n_sets`` replicas overlap — so the returned tickets'
        ``response_time`` is what an open-loop Poisson client at the
        trace's rate would observe.  Returns every ticket (cache hits
        complete at their arrival instant).
        """
        tickets: list[QueryTicket] = []
        assert not self.pending(), "replay needs an empty admission queue"
        for s in self.router.sets:  # live wall-clock must not leak into
            s.busy_until = 0.0      # the virtual timeline
            s.first_start = None
        self._arrivals.clear()      # ...nor into the arrival-rate estimates
        self._key_arrivals.clear()
        self._vclock = 0.0
        try:
            i = 0
            while i < len(trace) or self.pending():
                next_t = trace[i][0] if i < len(trace) else math.inf
                full = self._full_bucket()
                if full is not None:
                    self._dispatch(full)
                    continue
                oldest = self._oldest_bucket()
                deadline = (
                    oldest[1] + self.effective_wait(oldest[0])
                    if oldest is not None else math.inf
                )
                if next_t <= deadline:
                    arrival, terms, site = trace[i]
                    i += 1
                    self._vclock = max(self._vclock, float(arrival))
                    tickets.append(self.submit(terms, site))
                else:
                    self._vclock = max(self._vclock, deadline)
                    self._dispatch(oldest[0])
            return tickets
        finally:
            self._vclock = None

    # ------------------------------------------------------------------
    # reporting
    # ------------------------------------------------------------------

    def stats(self) -> dict:
        out = {
            "n_batches": self.n_batches,
            "n_padded": self.n_padded,
            "n_short_circuited": self.n_short_circuited,
            "pad_fraction": (
                self._pad_fraction_sum / self.n_batches
                if self.n_batches else 0.0
            ),
            "pending": self.pending(),
            "sets": self.router.snapshot(),
        }
        if self.cache is not None:
            out["cache"] = dataclasses.asdict(self.cache.stats)
            out["cache_entries"] = len(self.cache)
        return out
