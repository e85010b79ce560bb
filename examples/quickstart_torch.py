"""Quickstart (PyTorch port): build an index, run all three ODYS query
classes, project scale with the hybrid performance model.

    PYTHONPATH=src python examples/quickstart_torch.py                # on the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu   # plain versions

The twin of ``examples/quickstart.py`` on ``repro_torch``.
"""
import argparse

from repro_torch.core.engine import brute_force_topk, make_query_batch, query_topk
from repro_torch.core.index import INVALID_DOC, build_index
from repro_torch.core.perfmodel import (
    ClusterConfig, OdysPerfModel, QUERY_MIX_DEFAULT, nodes_for_service,
)
from repro_torch.core.slave_max import calibrate
from repro_torch.data.corpus import CorpusConfig, generate_corpus


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="device to run on (default cuda; cpu: the plain versions)")
    args = ap.parse_args(argv)

    # 1. "Crawl" a corpus and build the tightly-integrated IR index.
    corpus = generate_corpus(
        CorpusConfig(n_docs=5_000, vocab_size=800, mean_doc_len=40, n_sites=30)
    )
    index, meta = build_index(corpus, device=args.device)
    print(f"indexed {corpus.n_docs} docs, {meta.n_terms} terms "
          f"({index.postings.shape[0]:,} posting slots) on {index.postings.device}")

    # 2. The paper's three query classes (Fig 1), one batch.
    queries = [
        ([42], None),        # single keyword      — k-prefix read
        ([7, 19], None),     # multi keyword       — ZigZag join w/ skipping
        ([3], 5),            # limited search      — attribute embedding
    ]
    batch = make_query_batch(queries, meta=meta, strategy="embed",
                             device=index.postings.device)
    docs, hits = query_topk(index, batch, k=10, window=2048)
    truth = brute_force_topk(corpus, queries, 10)
    ok = True
    for i, q in enumerate(queries):
        got = [int(d) for d in docs[i].cpu().tolist() if d != INVALID_DOC]
        ok &= got == truth[i]
        status = "OK" if got == truth[i] else "MISMATCH"
        print(f"query {q}: top-{len(got)} = {got[:5]}... ({int(hits[i])} hits) {status}")

    # 3. Capacity planning with the hybrid model (paper §5.2.4 headline).
    model = OdysPerfModel()
    c300 = ClusterConfig(nm=4, ncm=4, ns=300, nh=11)
    mn = {lam: sum(r * model.master_network_time(lam, c300, QUERY_MIX_DEFAULT, k)
                   for (_, k), r in QUERY_MIX_DEFAULT.qmr.items())
          for lam in (81.0, 40.5)}
    slave = calibrate([(81.0, 0.211 - mn[81.0]), (40.5, 0.162 - mn[40.5])], ns=300)
    t = model.total_response_time(
        81.0, c300, QUERY_MIX_DEFAULT,
        lambda sct, k, lam, ns: slave.slave_max_time("single", 10, lam, ns))
    sets, nodes = nodes_for_service(1e9, 7e6, c300)
    print(f"\n1B queries/day over 30B pages: {sets} ODYS sets = {nodes:,} nodes, "
          f"avg response {t*1e3:.0f} ms  (paper: 43,472 nodes @ 211 ms; "
          f"the paper's Table 3 constants, not a reading of this port)")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
