"""One run of one cell: set-up, the measured window, the traced reading, the check.

The system under test is the port's served search path:
``repro_torch.serving.search.SearchService`` (``submit``, then the
scheduler's ``step()`` → ``_execute`` → ``distributed_query_topk`` → the
slave join in every slave → the master merge → host extraction), with its
writer under merge-on-read.

A configuration (``odys_bench/configs/<name>.json``) states the deployment:
the corpus's sizes and laws at the top level, ``index`` (the keywords of
the port's ``build_sharded_index``), ``service`` (those of
``SearchService``), ``writer`` under merge-on-read (the pre-fill and the
mutation mix), ``torch_threads``, and its documentation.  ``index`` and
``service`` go to the port as they stand; a key this module does not read
is refused, so a setting can never be dropped unseen.

Set-up draws the corpus on the device, hands it to the port's
``build_sharded_index``, builds the service, pre-fills the writer, draws
the query and mutation streams and serves every batch shape of the mix
twice.  The window is the traffic's loop (``odys_bench/loops/<loop>.py``)
driving a :class:`Session`.  After the window: with ``trace``, the loop
runs on, first with the port's batch phases timed, then under
``torch.profiler``; the device's peak is read, the queries still in flight
are drained, the writes are read back through the same path, the
program's state is freed, and a sample of the window's answers and every
read-back are held against :mod:`odys_bench.reference`.  The window itself
runs alike with and without ``trace``.
"""
from __future__ import annotations

import functools
import gc
import importlib.util
import math
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from odys_bench import data, host, profile, reference, work

HERE = Path(__file__).resolve().parent

#: Top-level keys of a configuration: the corpus's sizes and laws, what
#: goes to the port, and documentation that the run does not read.
CORPUS_KEYS = {"n_docs", "vocab_size", "mean_doc_len", "term_zipf_s", "n_sites",
               "site_zipf_s"}
CONFIG_KEYS = CORPUS_KEYS | {"index", "service", "writer", "torch_threads", "name",
                             "source", "deployment", "reduced", "assumed", "guarantees"}
WRITER_KEYS = {"prefill_fill", "mutation_mix"}
#: ``SearchService`` keywords that the harness gives itself.
OWN_SERVICE_KEYS = {"device", "registry", "span_sink", "corpus", "writer"}
#: Traffic keys read here; a loop adds its own (its ``KEYS``).
TRAFFIC_KEYS = {"why", "loop", "mix", "max_terms", "term_zipf_s", "stream_queries",
                "check_rate", "check_sample", "trace_batches", "trace_phase_s",
                "ingest_ops_per_s", "ingest_period_s", "read_back"}


def _load(kind: str, name: str):
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"no {kind[:-1]} {name!r} ({path} is missing)")
    spec = importlib.util.spec_from_file_location(f"odys_bench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(name: str):
    """The ``read(run)`` function of per-layer metric ``name``."""
    return _load("metrics", name).read


def load_loop(name: str):
    """The module of traffic loop ``name``: ``run(session, stop)`` and its
    ``KEYS``."""
    return _load("loops", name)


def check_keys(config: dict, traffic: dict, loop) -> None:
    """Refuse a key that no part of the run reads."""
    unread = set(config) - CONFIG_KEYS
    unread |= {f"writer.{k}" for k in set(config.get("writer") or {}) - WRITER_KEYS}
    unread |= {f"service.{k}" for k in set(config["service"]) & OWN_SERVICE_KEYS}
    unread |= {f"traffic.{k}" for k in set(traffic) - TRAFFIC_KEYS - set(loop.KEYS)}
    if unread:
        raise ValueError(f"keys that the harness does not read: {sorted(unread)}")
    if int(config["index"]["ns"]) != int(config["service"]["ns"]):
        raise ValueError("index.ns and service.ns differ")
    if (config.get("writer") is None) == bool(config["service"].get("updatable")):
        raise ValueError("a writer needs service.updatable, and service.updatable a writer")


class Run:
    """What a traced run leaves for the per-layer readers."""

    def __init__(self, config):
        self.batch_size = int(config["service"]["batch_size"])
        self.merge_on_read = config.get("writer") is not None
        self.stats_before = self.stats_after = None   # SearchService.stats()
        self.phases: list[dict] = []     # per batch of the phase segment
        self.publish_s: list[float] = []  # per bulk of the window
        self.device: profile.DeviceTrace | None = None
        self.traced_batches: list = []   # (queries, k, m) of the profiled batches
        self.join_least_s: float | None = None
        self.response_s: list[float] = []  # every query answered in the window


class Session:
    """The service under load, as a traffic loop drives it: the query
    stream, the searchers' outstanding queries, the ingest stream's bulks,
    and what the window records (while :attr:`recording`)."""

    def __init__(self, svc, traffic, stream, sampled, mutations, apply_one, applied, dev):
        self.svc, self.sched, self.traffic = svc, svc.scheduler, traffic
        self.stream, self.sampled, self.dev = stream, sampled, dev
        self.mutations, self.apply_one, self.applied = mutations, apply_one, applied
        self.period = float(traffic.get("ingest_period_s") or 0.0)
        self.ops_per_bulk = (0 if mutations is None else int(round(
            float(traffic["ingest_ops_per_s"]) * self.period)))
        self.next_bulk = math.inf
        self.owner: dict[int, tuple] = {}
        self.pos = 0
        self.recording = False
        self.n_batches = self.n_publishes = 0
        self.times: list[float] = []      # response seconds, window only
        self.kept: list[tuple] = []       # (stream position, m, result), window only
        self.step_s: dict[int, list] = {}  # k -> step() seconds, window only
        self.publish_s: list[float] = []  # window only

    span = staticmethod(torch.profiler.record_function)

    @property
    def outstanding(self) -> int:
        return len(self.owner)

    def submit_next(self):
        """Submit the stream's next query; returns its ticket."""
        terms, site, k = self.stream.query(self.pos % len(self.stream))
        t = self.svc.submit(terms, site, k=k)
        self.owner[t.qid] = (self.pos, t)
        self.pos += 1
        return t

    def start_ingest(self, at: float) -> None:
        """Bulks fall due from ``at`` on, one a period (ingest traffic only)."""
        if self.mutations is not None:
            self.next_bulk = at

    def publish_if_due(self) -> bool:
        """Apply the due bulk of mutations and publish it, synchronised."""
        if time.perf_counter() < self.next_bulk:
            return False
        with self.span("bench.publish"):
            p0 = time.perf_counter()
            for m in self.mutations[self.applied:self.applied + self.ops_per_bulk]:
                self.apply_one(m)
            self.applied += self.ops_per_bulk
            self.svc.writer.device_delta()
            _sync(self.dev)
            if self.recording:
                self.publish_s.append(time.perf_counter() - p0)
        self.n_publishes += 1
        self.next_bulk += self.period
        return True

    def step(self) -> list:
        """One scheduler step; the tickets it answered."""
        b0 = time.perf_counter()
        with self.span("port.step"):
            done = self.sched.step()
        if done:
            self.n_batches += 1
            if self.recording:
                self.step_s.setdefault(done[0].k, []).append(time.perf_counter() - b0)
        return done

    def collect(self, done) -> None:
        """Take answered tickets off the searchers' books."""
        for t in done:
            p, _ = self.owner.pop(t.qid)
            if self.recording:
                self.times.append(t.finish_time - t.submit_time)
                if p < len(self.stream) and self.sampled[p]:
                    self.kept.append((p, self.applied, t.result))


class _BatchPhases:
    """Span sink: the port's per-batch phases (``slave_dispatch``,
    ``master_merge``, ``finalize``), once per batch."""

    def __init__(self):
        self.seen: set[int] = set()
        self.phases: list[dict] = []

    def __call__(self, span) -> None:
        if span.batch_id is None or span.batch_id in self.seen:
            return
        self.seen.add(span.batch_id)
        self.phases.append(dict(span.phases))


def _annotate(obj, attr: str, label: str, undo: list, before=None) -> None:
    """Wrap ``obj.attr`` in a ``record_function`` span (the profiled
    segment only); ``undo`` collects what restores it."""
    fn = getattr(obj, attr)

    @functools.wraps(fn)
    def wrapped(*a, **kw):
        if before is not None:
            before(*a, **kw)
        with torch.profiler.record_function(label):
            return fn(*a, **kw)

    undo.append((obj, attr, fn))
    setattr(obj, attr, wrapped)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _Tracer:
    """``torch.profiler`` over whole batches: :meth:`start` opens the
    profiler and the :data:`profile.WINDOW` span, :meth:`stop` closes both
    once the device is done."""

    def __init__(self, dev):
        self.dev, self.prof, self.span, self.on = dev, None, None, False

    def start(self) -> None:
        _sync(self.dev)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        if self.dev.type == "cuda":
            # the profiler can lose a window's first events: spin first
            for _ in range(64):
                torch.cuda._sleep(1000)
            _sync(self.dev)
        self.span = torch.profiler.record_function(profile.WINDOW)
        self.span.__enter__()
        self.on = True

    def stop(self) -> None:
        self.span.__exit__(None, None, None)
        _sync(self.dev)
        self.prof.__exit__(None, None, None)
        self.on = False


def _read_back_queries(corpus, mutations, window_from: int, limit: int, rng, k: int):
    """One query a mutated document: its rarest term (the largest id: ids
    are Zipf ranks) limited to its site, from its newest version, or from
    the version it had when deleted.  Every document the window's bulks
    touched comes first, then a sample of those the pre-fill touched."""
    state = reference.DeltaState(corpus, 1)
    last: dict[int, tuple] = {}
    when: dict[int, int] = {}
    for i, m in enumerate(mutations):
        if m.op == data.DELETE:
            held = state.delta.get(m.gid)
            if held is None:
                held = (corpus.doc_terms[corpus.doc_offsets[m.gid]:corpus.doc_offsets[m.gid + 1]],
                        int(corpus.doc_site[m.gid]))
            last[m.gid] = held
        state.apply(m)
        if m.op != data.DELETE:
            last[m.gid] = state.delta[m.gid]
        when[m.gid] = i
    recent = [g for g in last if when[g] >= window_from]
    older = [g for g in last if when[g] < window_from]
    older = [older[i] for i in rng.permutation(len(older))]
    out = []
    for g in (recent + older)[:limit]:
        terms, site = last[g]
        if len(terms):
            out.append(([int(np.max(terms))], int(site), k))
    return out


def run_cell(config: dict, traffic: dict, *, seed: int, seconds: float, trace: bool,
             device, t0: float, per_layer=(), faults=None) -> dict:
    """One run; returns the result's fields (``metrics`` of the cell's
    end-to-end metrics without ``trace``, of ``per_layer`` with it).
    ``faults`` (the control and the tests) is called with the
    :class:`Session` once set-up has built it, before the warm-up, to
    change the timed path underneath."""
    from repro_torch.core.index import build_sharded_index
    from repro_torch.data.corpus import Corpus
    from repro_torch.obs.registry import MetricsRegistry, NullRegistry
    from repro_torch.serving.search import SearchService
    import repro_torch.serving.search as search_mod

    loop = load_loop(traffic["loop"])
    check_keys(config, traffic, loop)
    if "torch_threads" in config:
        torch.set_num_threads(int(config["torch_threads"]))
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    service = dict(config["service"])
    ns, window = int(service["ns"]), int(service["window"])
    batch_size = int(service["batch_size"])
    writer_cfg = config.get("writer")
    run = Run(config)
    probes_start = host.probes()
    marks = [("start", time.perf_counter())]

    def mark(what: str) -> None:
        _sync(dev)
        marks.append((what, time.perf_counter()))

    arrays = data.make_corpus(config, seed, dev)
    mark("corpus")
    corpus = Corpus(doc_offsets=arrays.doc_offsets, doc_terms=arrays.doc_terms,
                    doc_site=arrays.doc_site, n_docs=arrays.n_docs,
                    vocab_size=arrays.vocab_size, n_sites=arrays.n_sites)
    index, meta = build_sharded_index(corpus, **config["index"], device=dev)
    mark("index")
    svc = SearchService(index, meta, **service, device=dev, registry=NullRegistry(),
                        corpus=corpus if writer_cfg is not None else None)
    sched = svc.scheduler
    rng = np.random.default_rng(data.seed_words(seed, 4))
    mark("service")
    stream = data.make_queries(traffic, config, seed, int(traffic["stream_queries"]))
    sampled = rng.random(len(stream)) < float(traffic["check_rate"])

    mutations = None
    if writer_cfg is not None:
        period = float(traffic["ingest_period_s"])
        per_bulk = int(round(float(traffic["ingest_ops_per_s"]) * period))
        after = seconds + (float(traffic["trace_phase_s"]) + 2 * period if trace else 0.0)
        n_prefill_max = 4 * int(service.get("term_capacity", 256)) * ns
        mutations = data.make_mutations(writer_cfg["mutation_mix"], arrays, seed,
                                        n_prefill_max + per_bulk * (int(after / period) + 2))

    def apply_one(m) -> None:
        if m.op == data.INSERT:
            got = svc.insert([(m.terms, m.site)])
            if got != [m.gid]:
                raise RuntimeError(f"insert took docID {got}, expected {m.gid}")
        elif m.op == data.DELETE:
            svc.delete([m.gid])
        else:
            svc.update([(m.gid, m.terms, None if m.site < 0 else m.site)])

    applied = 0
    if mutations is not None:
        while svc.writer.posting_fill() < float(writer_cfg["prefill_fill"]):
            apply_one(mutations[applied])
            applied += 1
        svc.writer.device_delta()
    prefilled = applied
    s = Session(svc, traffic, stream, sampled, mutations, apply_one, applied, dev)
    mark("streams+prefill")

    if faults is not None:
        faults(s)
    tracer = _Tracer(dev)
    # warm-up: every (t_max, k) bucket of the mix, twice, at the batch size
    warm = data.make_queries(traffic, config, seed, 64 * batch_size, stream=3)
    for k in sorted({int(kk) for _, kk, _ in traffic["mix"]}):
        rows = np.flatnonzero(warm.k == k)[: 2 * batch_size]
        for part in (rows[:batch_size], rows[batch_size:]):
            for i in part:
                terms, site, _ = warm.query(int(i))
                svc.submit(terms, site, k=k)
            sched.drain()
    if trace:
        # the profiler's first start takes seconds: pay it here, on one batch
        tracer.start()
        for i in rows[:batch_size]:
            terms, site, _ = warm.query(int(i))
            svc.submit(terms, site, k=k)
        sched.drain()
        tracer.stop()
    mark("warm-up")

    # ---- the measured window -------------------------------------------
    run.stats_before = svc.stats()
    cpu_start = host.cpu_seconds()
    t_start = time.perf_counter()
    setup_s = t_start - t0
    t_end = t_start + seconds
    s.recording = True
    s.start_ingest(t_start + s.period)
    loop.run(s, lambda: time.perf_counter() >= t_end)
    s.recording = False
    t_stop = time.perf_counter()
    cpu_share = (host.cpu_seconds() - cpu_start) / (t_stop - t_start)
    # ---- the window has closed -------------------------------------------
    run.stats_after = svc.stats()
    fill_close = None if mutations is None else svc.writer.posting_fill()
    traced: list = []
    if trace:
        # the port's batch phases, timed by its own registry and spans
        sink = _BatchPhases()
        svc.registry, sched.trace, sched.span_sink = MetricsRegistry(), True, sink
        t_phase = time.perf_counter() + float(traffic["trace_phase_s"])
        loop.run(s, lambda: time.perf_counter() >= t_phase)
        svc.registry, sched.trace, sched.span_sink = NullRegistry(), False, None
        run.phases = sink.phases
        # the device, under the profiler: one ingest period from a bulk, or
        # the traffic's trace_batches batches
        undo: list = []
        _annotate(sched, "executor", "port.execute", undo,
                  before=lambda q, t_max, k, set_id: traced.append(
                      ([(list(t), st) for t, st in q], k, s.applied)))
        _annotate(svc, "_run_engine", "port.run_engine", undo)
        _annotate(search_mod, "make_query_batch", "port.make_query_batch", undo)
        n0, p0 = s.n_batches, s.n_publishes
        tracer.start()
        if mutations is not None:
            s.next_bulk = time.perf_counter()
            loop.run(s, lambda: s.n_publishes > p0 and time.perf_counter() >= s.next_bulk)
        else:
            loop.run(s, lambda: s.n_batches - n0 >= int(traffic["trace_batches"]))
        tracer.stop()
        for obj, attr, fn in reversed(undo):
            setattr(obj, attr, fn)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    in_flight = list(s.owner.values())
    sched.drain()
    unanswered = sum(1 for _, t in in_flight if not t.done)
    applied = s.applied

    readback, rb_served = [], []
    if mutations is not None:
        k_max = max(int(kk) for _, kk, _ in traffic["mix"])
        readback = _read_back_queries(arrays, mutations[:applied], prefilled,
                                      int(traffic["read_back"]), rng, k_max)
        tickets = [svc.submit(terms, site, k=k) for terms, site, k in readback]
        sched.drain()
        unanswered += sum(1 for t in tickets if not t.done)
        rb_served = [t.result for t in tickets]
    run.response_s = s.times
    run.publish_s = s.publish_s
    run.traced_batches = traced
    kept, step_s, answered, attempted = s.kept, s.step_s, len(s.times), s.pos
    del svc, sched, index, s, in_flight
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    if traced and on_card:
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            tracer.prof.export_chrome_trace(str(path))
            run.device = profile.read_trace(path)
    del tracer

    # ---- the check ----------------------------------------------------------
    take = rng.permutation(len(kept))[: int(traffic["check_sample"])]
    checks = [kept[i] for i in sorted(take)]
    queries = [(*stream.query(p), m) for p, m, _ in checks]
    queries += [(terms, site, k, applied) for terms, site, k in readback]
    terms_needed = [t for q in queries for t in q[0]]
    terms_needed += [t for qs, _, _ in traced for ts, _ in qs for t in ts]
    main = reference.MainLists(arrays, ns, window, terms_needed)
    want = reference.answers(main, arrays, queries, mutations)
    served = [r for _, _, r in checks] + rb_served

    def wrong(got, expect) -> bool:
        return got is None or (list(got.docids), int(got.n_hits)) != (expect[0], expect[1])

    n_win = len(checks)
    window_bad = sum(wrong(g, w) for g, w in zip(served[:n_win], want[:n_win]))
    rb_bad = sum(wrong(g, w) for g, w in zip(served[n_win:], want[n_win:]))
    compared = {"window_mismatch": (window_bad, 0), "unanswered": (unanswered, 0)}
    if mutations is not None:
        compared["readback_mismatch"] = (rb_bad, 0)
    correct = n_win > 0 and all(v <= lim for v, lim in compared.values())

    if traced and run.device is not None:
        run.join_least_s = work.join_least_seconds(main, arrays, traced, mutations)

    window_s = t_stop - t_start
    out = {
        "correct": bool(correct),
        "attempted": attempted,
        "failed": unanswered,
        "answered": answered,
        "window_s": window_s,
        "setup_s": setup_s,
        "peak": int(peak),
        "checked": (n_win, len(readback)),
        "compared": compared,
        "run": run,
        "fill": None if mutations is None else (prefilled, applied),
        "posting_fill": fill_close,
        "setup_parts": [(w, b - a) for (_, a), (w, b) in zip(marks, marks[1:])],
        "step_s": step_s,
        "host": {"start": probes_start, "window": {"cpu_share": cpu_share},
                 "close": host.probes()},
    }
    if not trace:
        out["metrics"] = {
            "queries_per_s": (answered / window_s, "queries/s"),
            "device_peak_gb": (peak / 1e9, "GB"),
            "setup_s": (setup_s, "s"),
        }
    else:
        out["metrics"] = {m["name"]: (load_reader(m["name"])(run), m["unit"])
                          for m in per_layer}
    return out
