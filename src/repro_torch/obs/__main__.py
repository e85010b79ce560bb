"""CLI: ``python -m repro_torch.obs {demo,check,inert} [--device cpu]``.

- ``demo``  — run a small instrumented serving pipeline (tiny corpus,
  calibration on the device, lambda replay, residual monitor) and export
  the registry as ``metrics.prom`` + ``metrics.json`` into ``--out``;
- ``check`` — validate an exported ``metrics.json``: format tag, the
  required metric families, every span phase present, and a finite
  model-residual gauge;
- ``inert`` — run the same pipeline twice, registry disabled vs enabled,
  and fail unless the search results are identical (the zero-cost-when-
  disabled contract, result half).

``demo`` and ``inert`` run on ``--device`` (default ``cuda``: the kernels;
with no card they raise unless given ``--device cpu``, the plain
versions).  A port of the JAX package's ``python -m repro.obs``.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

#: Families ``check`` requires, with the kind they must carry.  Per-phase
#: histogram coverage is checked separately against PHASES.
REQUIRED_FAMILIES = {
    "odys_queue_depth": "gauge",
    "odys_cache_hit_rate": "gauge",
    "odys_set_in_flight": "gauge",
    "odys_phase_seconds": "histogram",
    "odys_response_seconds": "histogram",
    "odys_batch_service_seconds": "histogram",
    "odys_queries_submitted_total": "counter",
    "odys_batches_dispatched_total": "counter",
    "odys_model_residual": "gauge",
}


def _build_pipeline(registry, *, device=None, seed: int = 7):
    """Tiny corpus + calibration + instrumented two-set service on
    ``device`` (``cuda`` unless named)."""
    from repro_torch.core.calibrate import calibrate_from_engine
    from repro_torch.core.index import build_sharded_index
    from repro_torch.data.corpus import CorpusConfig, generate_corpus
    from repro_torch.serving.search import SearchService

    corpus = generate_corpus(
        CorpusConfig(n_docs=300, vocab_size=120, mean_doc_len=30,
                     n_sites=8, seed=seed)
    )
    ns = 1
    sharded, meta = build_sharded_index(corpus, ns, device=device)
    device = sharded.postings.device
    cal = calibrate_from_engine(
        sharded, meta, ns=ns, k_values=(10,), window=256, q=4, reps=2,
    )
    svc = SearchService(
        sharded, meta, ns=ns, k=10, window=256, t_max=2,
        t_max_buckets=(2,), batch_size=4, cache_size=64, n_sets=2,
        registry=registry, device=device,
    )
    return svc, cal


def _demo_queries(n: int, seed: int = 3):
    import numpy as np

    rng = np.random.default_rng(seed)
    # a hot set so the cache-hit path exercises too
    hot = rng.integers(0, 8, size=n)
    cold = rng.integers(0, 100, size=n)
    use_hot = rng.random(n) < 0.4
    return [
        ([int(h if uh else c)], None)
        for h, c, uh in zip(hot, cold, use_hot)
    ]


def _cmd_demo(args) -> int:
    import numpy as np

    from repro_torch.obs.exposition import dump_json, to_prometheus
    from repro_torch.obs.registry import enable
    from repro_torch.obs.residual import ModelResidualMonitor
    from repro_torch.obs.trace import PhaseAggregator

    # process-wide enable: the index build's byte gauges and the work
    # lists' occupancy gauges report through the process default, not a
    # constructor-injected registry
    reg = enable()
    svc, cal = _build_pipeline(reg, device=args.device)
    agg = PhaseAggregator(registry=reg)
    # qps: 200 as in the JAX package's demo, or a quarter of the fitted
    # capacity where that is less (the CPU's plain versions are slow), so
    # the projection stays stable
    lam = min(200.0, 0.25 * cal.max_stable_load())
    monitor = ModelResidualMonitor(
        cal, batch_size=svc.scheduler.batch_size, lam=lam, registry=reg,
    )
    queries = _demo_queries(args.queries)
    # warm the batch shapes (and the kernels' build), then wire the sinks
    # so set-up never lands in the phase means or the residual window
    svc.search(queries[: svc.scheduler.batch_size])
    svc.scheduler.span_sink = lambda s: (agg.fold(s), monitor.sink(s))
    rng = np.random.default_rng(5)
    arrivals = np.cumsum(rng.exponential(1.0 / lam, size=len(queries)))
    svc.scheduler.replay(
        [(float(t), terms, site)
         for t, (terms, site) in zip(arrivals, queries)]
    )
    online = monitor.update()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "metrics.prom").write_text(to_prometheus(reg))
    (out / "metrics.json").write_text(dump_json(reg))
    print(f"obs demo: served {len(queries)} queries on {svc.device}, "
          f"{svc.scheduler.n_batches} batches; "
          f"residual={online['error']:.4f} (n={online['n']}); "
          f"wrote {out}/metrics.prom + metrics.json")
    return 0


def _cmd_check(args) -> int:
    from repro_torch.obs.trace import PHASES

    path = Path(args.out) / "metrics.json"
    if not path.is_file():
        print(f"obs check: missing {path} — run demo first", file=sys.stderr)
        return 1
    doc = json.loads(path.read_text())
    problems: list[str] = []
    if doc.get("format") != "repro.obs/v1":
        problems.append(f"unexpected format tag {doc.get('format')!r}")
    metrics = doc.get("metrics", {})
    for name, kind in REQUIRED_FAMILIES.items():
        fam = metrics.get(name)
        if fam is None:
            problems.append(f"missing family {name}")
        elif fam["kind"] != kind:
            problems.append(
                f"{name}: kind {fam['kind']!r}, expected {kind!r}")
        elif not fam["series"]:
            problems.append(f"{name}: no series")
    phase_series = metrics.get("odys_phase_seconds", {}).get("series", [])
    seen_phases = {s["labels"].get("phase") for s in phase_series}
    for p in PHASES:
        if p not in seen_phases:
            problems.append(f"odys_phase_seconds: phase {p!r} missing")
    residual = metrics.get("odys_model_residual", {}).get("series", [])
    if residual and not math.isfinite(residual[0].get("value", math.nan)):
        problems.append("odys_model_residual: non-finite value")
    prom = Path(args.out) / "metrics.prom"
    if not prom.is_file():
        problems.append(f"missing {prom}")
    elif "odys_phase_seconds_bucket" not in prom.read_text():
        problems.append("metrics.prom: no odys_phase_seconds_bucket lines")
    for p in problems:
        print(f"obs check: {p}", file=sys.stderr)
    print(f"obs check: {len(metrics)} families, {len(problems)} problem(s)")
    return 1 if problems else 0


def _cmd_inert(args) -> int:
    """Disabled-registry run must produce byte-identical search results."""
    from repro_torch.obs.registry import MetricsRegistry, NullRegistry

    queries = _demo_queries(args.queries)

    def run(reg):
        svc, _ = _build_pipeline(reg, device=args.device)
        hits = svc.search(queries)
        return [(h.docids, h.n_hits) for h in hits], svc.scheduler

    res_off, sched_off = run(NullRegistry())
    res_on, sched_on = run(MetricsRegistry())
    if res_off != res_on:
        print("obs inert: results differ between disabled and enabled "
              "registries", file=sys.stderr)
        return 1
    if sched_off.trace:
        print("obs inert: disabled scheduler unexpectedly traced",
              file=sys.stderr)
        return 1
    print(f"obs inert: {len(queries)} queries identical with metrics "
          f"on and off (disabled run traced: {sched_off.trace})")
    return 0


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Observability smoke: export, validate, and prove "
        "inertness of the serving metrics.",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    pd = sub.add_parser("demo", help="instrumented smoke run + export")
    pd.add_argument("--out", default="obs-out", help="export directory")
    pd.add_argument("--queries", type=int, default=32)
    pd.add_argument("--device", default=None,
                    help="device to serve on (default cuda; cpu: the plain "
                    "versions)")
    pd.set_defaults(fn=_cmd_demo)

    pc = sub.add_parser("check", help="validate an exported metrics.json")
    pc.add_argument("--out", default="obs-out", help="export directory")
    pc.set_defaults(fn=_cmd_check)

    pi = sub.add_parser(
        "inert", help="disabled-registry run must match enabled bit-for-bit"
    )
    pi.add_argument("--queries", type=int, default=32)
    pi.add_argument("--device", default=None,
                    help="device to serve on (default cuda; cpu: the plain "
                    "versions)")
    pi.set_defaults(fn=_cmd_inert)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
