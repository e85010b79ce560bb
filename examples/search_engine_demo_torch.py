"""End-to-end ODYS search engine on one device (PyTorch port): ns = 4
slaves, a workload at a Poisson rate, measured latencies fed through the
partitioning method, health-aware serving over two sets with a set
failure, failover + straggler mitigation, and an elastic re-stripe.

    PYTHONPATH=src python examples/search_engine_demo_torch.py                # on the card
    PYTHONPATH=src python examples/search_engine_demo_torch.py --device cpu   # plain versions

The twin of ``examples/search_engine_demo.py``: where that spawns 8 fake
jax devices, this runs the 4 slaves in turn on one device.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core.faults import SetHealth, query_latency_with_speculation
from repro_torch.core.index import INVALID_DOC, build_sharded_index
from repro_torch.core.parallel import distributed_query_topk
from repro_torch.core.perfmodel import QUERY_MIX_DEFAULT
from repro_torch.core.queries import WorkloadConfig, batch_by_k, generate_workload
from repro_torch.core.slave_max import partitioning_method
from repro_torch.data.corpus import CorpusConfig, generate_corpus
from repro_torch.launch.elastic import FailoverRouter, rescale
from repro_torch.serving.search import SearchService


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="device to run on (default cuda; cpu: the plain versions)")
    args = ap.parse_args(argv)
    ns = 4
    corpus = generate_corpus(
        CorpusConfig(n_docs=8_000, vocab_size=1_200, mean_doc_len=50, n_sites=40)
    )
    sharded, meta = build_sharded_index(corpus, ns, device=args.device)
    dev = sharded.postings.device
    print(f"[demo] {ns} slaves x {corpus.n_docs // ns} docs each, in turn on {dev}")

    # workload
    specs = generate_workload(
        meta, QUERY_MIX_DEFAULT, WorkloadConfig(n_queries=48, arrival_rate=50.0)
    )
    groups = batch_by_k(specs, meta=meta, device=dev)

    lat = []
    for k, (qb, ss) in sorted(groups.items()):
        kk = min(k, 50)  # cap for the demo
        kw = dict(ns=ns, k=kk, window=2048, merge="tournament")
        distributed_query_topk(sharded, qb, **kw)
        _sync(dev)
        t0 = time.perf_counter()
        res = distributed_query_topk(sharded, qb, **kw)
        _sync(dev)
        dt = (time.perf_counter() - t0) / qb.n_queries
        lat += [dt] * qb.n_queries
        n_valid = int((res.docids[0] != INVALID_DOC).sum())
        print(f"[demo] k={k}: {qb.n_queries} queries, "
              f"{dt*1e6:.0f} us/query on {dev}, e.g. {n_valid} results for q0")

    # partitioning-method projection from measured latencies
    sj = np.tile(np.array(lat)[:, None], (1, ns * 80)) * \
        np.random.default_rng(0).lognormal(0, 0.25, size=(len(lat), ns * 80))
    for target_ns in (4, 64, 300):
        est = partitioning_method(sj, target_ns).mean()
        print(f"[demo] projected slave max @ {target_ns} slaves: {est*1e6:.0f} us")

    # health-aware serving: two sets time-share the device; set 1 fails
    health = SetHealth.all_alive(2)
    svc = SearchService(sharded, meta, ns=ns, window=2048, batch_size=4,
                        cache_size=0, n_sets=2, set_health=health, device=dev)
    qs = [(list(s.terms), s.site) for s in specs[:16]]

    def served_sets(part):
        tickets = [svc.submit(terms, site) for terms, site in part]
        svc.drain()
        return sorted({t.set_id for t in tickets})

    up = served_sets(qs[:8])
    health.fail(1)
    down = served_sets(qs[8:])
    print(f"[demo] health-aware serving over 2 sets: batches on sets {up}, "
          f"then with set 1 failed on sets {down}")

    # failover + straggler mitigation
    router = FailoverRouter(n_sets=3, ns=ns)
    router.observe_latencies(sj)
    router.health.fail(1)
    routes = router.route(1000)
    rng = np.random.default_rng(1)
    primary = rng.lognormal(np.log(np.mean(lat)), 0.25, size=(500, ns))
    primary[::23, 2] *= 25.0
    replica = rng.lognormal(np.log(np.mean(lat)), 0.25, size=(500, ns))
    with_spec, rate = query_latency_with_speculation(
        primary, replica, router.slo, router.policy
    )
    print(f"[demo] set 1 down -> traffic on sets {sorted(set(routes))}; "
          f"speculation rate {rate:.1%}, "
          f"p99 {np.percentile(primary.max(1), 99)*1e6:.0f} -> "
          f"{np.percentile(with_spec, 99)*1e6:.0f} us")

    # elastic rescale 4 -> 6 shards (deterministic re-stripe)
    sharded6, _ = rescale(corpus, 6, device=dev)
    print(f"[demo] rescaled to 6 shards: postings {tuple(sharded6.postings.shape)}")
    print("[demo] done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
