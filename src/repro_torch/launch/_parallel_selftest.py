"""Self-test of the search engine across processes (port of
``repro.launch._parallel_selftest``), and the rank functions that the
tests spawn.

Run as:  python -m repro_torch.launch._parallel_selftest --device cpu|cuda

It spawns a ``gloo`` world of 8 ranks (:func:`~repro_torch.launch.spawn.
run_ranks`; on one card every rank computes on ``cuda:0``) and runs the
reference self-test's checks in its order, each held against the port's
``sequential_reference``: ``distributed_query_topk`` on a ``(4,)``
``("data",)`` mesh over ranks 0–3 under both merges, then under
``backend="kernel"`` (the kernels on a card, their plain versions on the
CPU), ``replicated_query_topk`` on a ``(2, 4)`` ``("pod", "data")`` mesh
over all 8, sharded equal to unsharded, and merge-on-read under
``"torch"`` and ``"kernel"``.  It prints ``PARALLEL_SELFTEST_PASS``.

The rank functions live here, in the package, so that spawned ranks
import neither the tests nor jax: :func:`cases_rank` answers a list of
cases on numpy inputs, :func:`sets_rank` runs a sliced
:class:`~repro_torch.serving.search.SearchService` (the front on rank 0,
:func:`~repro_torch.serving.search.serve_set` on the others),
:func:`vocab_rank` the vocab-sharded top-k.
"""
from __future__ import annotations

import argparse
import sys
import tempfile

import numpy as np
import torch

from repro_torch.launch.mesh import make_mesh

SELFTEST_QUERIES = [([5], None), ([3, 7], None), ([2], 3), ([1, 4], 2),
                    ([11, 29], None), ([0], 0), ([8, 13, 21], None), ([6], None)]
SELFTEST_WORLD = 8


def _setup_device(device) -> torch.device:
    from repro_torch.launch.mesh import rank_device

    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def _np(res) -> tuple[np.ndarray, np.ndarray]:
    return res.docids.cpu().numpy(), res.n_hits.cpu().numpy()


# ---------------------------------------------------------------------------
# The self-test
# ---------------------------------------------------------------------------

def selftest_rank(rank: int, world: int, device) -> list[str]:
    """Every check of the self-test on this rank; raises on a mismatch and
    returns the lines to print."""
    from repro_torch.core.engine import make_query_batch, query_topk
    from repro_torch.core.index import build_index, build_sharded_index, partition_corpus
    from repro_torch.core.parallel import (
        distributed_query_topk, rank_shard, replicated_query_topk, sequential_reference)
    from repro_torch.data.corpus import (
        CorpusConfig, MutationConfig, apply_mutations, generate_corpus,
        generate_mutations)
    from repro_torch.indexing.delta import DeltaWriter

    dev = _setup_device(device)
    cfg = CorpusConfig(n_docs=2000, vocab_size=300, mean_doc_len=40, n_sites=16, seed=7)
    corpus = generate_corpus(cfg)
    ns = 4
    sharded, meta = build_sharded_index(corpus, ns, device=dev)
    shard_idx = [build_index(p, device=dev)[0] for p in partition_corpus(corpus, ns)]
    batch = make_query_batch(SELFTEST_QUERIES, t_max=4, meta=meta, strategy="embed",
                             device=dev)
    mesh = make_mesh([0, 1, 2, 3], ("data",))
    mesh2 = make_mesh([[0, 1, 2, 3], [4, 5, 6, 7]], ("pod", "data"))
    in_mesh = rank < 4
    mine = rank_shard(sharded, rank % ns)
    ref = sequential_reference(shard_idx, batch, ns=ns, k=10, window=1024)
    lines = []

    def same(label, got, want):
        for g, w in zip(got, want):
            if not torch.equal(g.cpu(), w.cpu()):
                raise AssertionError(f"rank {rank}: {label} differs from "
                                     "sequential_reference")
        lines.append(f"{label}: OK")

    for merge in ("allgather", "tournament"):
        if in_mesh:
            got = distributed_query_topk(mine, batch, mesh=mesh, ns=ns, k=10,
                                         window=1024, merge=merge)
            same(f"distributed merge={merge}", got, ref)
    if in_mesh:
        got = distributed_query_topk(mine, batch, mesh=mesh, ns=ns, k=10, window=1024,
                                     merge="tournament", backend="kernel")
        same("distributed backend=kernel", got, ref)
    got = replicated_query_topk(mine, batch, mesh=mesh2, ns=ns, k=10, window=1024,
                                merge="tournament")
    pod = mesh2.get_local_rank("pod")
    rows = slice(pod * 4, pod * 4 + 4)
    same("replicated (2 pods)", (got.docids,), (ref.docids[rows],))
    full_idx, _ = build_index(corpus, device=dev)
    fd, _ = query_topk(full_idx, batch, k=10, window=4096)
    same("sharded == unsharded ground truth", (ref.docids,), (fd,))

    writer = DeltaWriter(corpus, meta, ns, term_capacity=256, doc_headroom=256, device=dev)
    muts = generate_mutations(corpus, MutationConfig(n_ops=40, mean_doc_len=40, seed=3))
    writer.apply(muts)
    rebuilt = apply_mutations(corpus, muts)
    rb_shards = [build_index(p, device=dev)[0] for p in partition_corpus(rebuilt, ns)]
    ref_u = sequential_reference(rb_shards, batch, ns=ns, k=10, window=1024)
    for backend in ("torch", "kernel"):
        if in_mesh:
            got = distributed_query_topk(mine, batch, rank_shard(writer.device_delta(), rank),
                                         mesh=mesh, ns=ns, k=10, window=1024,
                                         merge="tournament", backend=backend)
            same(f"distributed merge-on-read backend={backend}", got, ref_u)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                    help="where every rank computes (cuda: the kernels)")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds for the whole world and for each collective")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device available; pass --device cpu", file=sys.stderr)
        return 2
    from repro_torch.launch.spawn import run_ranks

    with tempfile.TemporaryDirectory() as tmp:
        results = run_ranks(selftest_rank, SELFTEST_WORLD, args.device,
                            rdzv_dir=tmp, timeout=args.timeout)
    for line in results[0]:
        print(line)
    print(f"({SELFTEST_WORLD} gloo ranks on {args.device})")
    print("PARALLEL_SELFTEST_PASS")
    return 0


# ---------------------------------------------------------------------------
# Rank functions of the tests
# ---------------------------------------------------------------------------

def cases_rank(rank: int, world: int, spec: dict) -> dict:
    """Answer ``spec["cases"]`` on this rank; returns ``{name: (docids,
    n_hits)}`` (numpy) for every case whose mesh holds this rank.

    ``spec``: ``device``; ``index`` and ``delta`` (or None), the stacked
    arrays as numpy; ``batch``, the ``QueryBatch`` arrays; ``ns``;
    ``meshes``, ``{name: (ranks, axis names)}``; ``cases``, a list of
    ``(name, form, mesh name, keyword arguments)``, the form one of
    ``distributed``, ``unmerged``, ``replicated``, with ``delta=True`` in
    the keywords to attach the delta.
    """
    from repro_torch.core.engine import QueryBatch
    from repro_torch.core.index import sharded_index_from_numpy
    from repro_torch.core.parallel import (
        distributed_query_topk, rank_shard, replicated_query_topk, slave_topk_unmerged)
    from repro_torch.indexing.delta import sharded_delta_from_numpy

    dev = _setup_device(spec["device"])
    meshes = {name: make_mesh(ranks, names)
              for name, (ranks, names) in spec["meshes"].items()}
    index = sharded_index_from_numpy(spec["index"], device=dev)
    delta = (None if spec["delta"] is None
             else sharded_delta_from_numpy(spec["delta"], device=dev))
    batch = QueryBatch(*(torch.from_numpy(spec["batch"][f]).to(dev)
                         for f in QueryBatch._fields))
    forms = {"distributed": distributed_query_topk, "unmerged": slave_topk_unmerged,
             "replicated": replicated_query_topk}
    out = {}
    for name, form, mesh_name, kw in spec["cases"]:
        mesh = meshes[mesh_name]
        if mesh.get_coordinate() is None:
            continue
        kw = dict(kw)
        s = mesh.get_local_rank("data")
        d = rank_shard(delta, s) if kw.pop("delta", False) else None
        out[name] = _np(forms[form](rank_shard(index, s), batch, d, mesh=mesh,
                                    ns=spec["ns"], **kw))
    return out


def sets_rank(rank: int, world: int, spec: dict):
    """The sliced service's scenarios: rank 0 (the front) builds each
    scenario's :class:`SearchService` over ``set_mesh_slices(n_sets, ns)``
    and runs it; every other rank serves its set (:func:`serve_set`) until
    the front shuts the service down.  Returns the front's record (None on
    the slaves).

    ``spec``: ``device``, ``corpus`` (a ``Corpus``), ``ns``, ``n_sets``,
    ``scenarios`` (names of :data:`SCENARIOS`), and the scenarios' inputs.
    """
    from repro_torch.core.index import build_sharded_index
    from repro_torch.core.parallel import set_mesh_slices
    from repro_torch.serving.search import serve_set

    dev = _setup_device(spec["device"])
    ns = spec["ns"]
    record = {}
    try:
        set_mesh_slices(world, ns)
    except ValueError as e:           # raised on every rank, before any collective
        record["undersized"] = str(e)
    slices = set_mesh_slices(spec["n_sets"], ns)
    record["slices"] = [(dict(zip(m.mesh_dim_names, m.mesh.shape)),
                         m.mesh.flatten().tolist()) for m in slices]
    if rank != 0:                     # a slave: its shards come from the front
        for _ in spec["scenarios"]:
            serve_set(slices, device=dev)
        return None
    index, meta = build_sharded_index(spec["corpus"], ns, device=dev)
    for name in spec["scenarios"]:
        record[name] = SCENARIOS[name](spec, index, meta, slices, dev)
    return record


def _sliced_service(spec, index, meta, slices, dev, **kw):
    from repro_torch.serving.search import SearchService

    return SearchService(index, meta, ns=spec["ns"], k=8, n_sets=spec["n_sets"],
                         set_meshes=slices, cache_size=0, device=dev, **kw)


def _scenario_matches(spec, index, meta, slices, dev):
    svc = _sliced_service(spec, index, meta, slices, dev, batch_size=4)
    try:
        got = svc.search(spec["queries"])
        return {"hits": [(h.docids, h.n_hits) for h in got],
                "n_batches": [s.n_batches for s in svc.scheduler.router.sets]}
    finally:
        svc.shutdown()


def _scenario_fresh(spec, index, meta, slices, dev):
    svc = _sliced_service(spec, index, meta, slices, dev, batch_size=1,
                          corpus=spec["corpus"], updatable=True)
    try:
        probe = spec["probe"]
        gids = svc.insert(spec["inserts"])
        rounds = []
        for _ in range(2):
            tickets = [svc.scheduler.submit(*probe) for _ in range(spec["n_sets"])]
            svc.scheduler.drain()
            rounds.append([(t.set_id, t.result.docids) for t in tickets])
            if len(rounds) == 1:
                svc.compact(verify=True)
        return {"gids": gids, "rounds": rounds}
    finally:
        svc.shutdown()


def _scenario_failover(spec, index, meta, slices, dev):
    from repro_torch.core.faults import SetHealth

    svc = _sliced_service(spec, index, meta, slices, dev, batch_size=2,
                          set_health=SetHealth.all_alive(spec["n_sets"]))
    try:
        router = svc.scheduler.router
        router.fail(0)
        tickets = [svc.scheduler.submit(ts, site) for ts, site in spec["failover_queries"]]
        svc.scheduler.drain()
        dead = [s.n_batches for s in router.sets]
        router.recover(0)
        svc.search(spec["failover_queries"])
        return {"set_ids": [t.set_id for t in tickets],
                "hits": [t.result.docids for t in tickets],
                "n_batches_dead": dead,
                "n_batches_recovered": [s.n_batches for s in router.sets]}
    finally:
        svc.shutdown()


def _scenario_concurrent(spec, index, meta, slices, dev):
    """Each set's batches from a thread of its own, both in flight at once
    (each (front, set) pair has its own group)."""
    from concurrent.futures import ThreadPoolExecutor

    svc = _sliced_service(spec, index, meta, slices, dev, batch_size=4)
    try:
        def run(set_id):
            return [_np(svc._run_engine(spec["queries"], t_max=svc.t_max, k=svc.k,
                                        set_id=set_id)) for _ in range(4)]

        with ThreadPoolExecutor(spec["n_sets"]) as pool:
            return [f.result() for f in [pool.submit(run, s)
                                         for s in range(spec["n_sets"])]]
    finally:
        svc.shutdown()


SCENARIOS = {"matches": _scenario_matches, "fresh": _scenario_fresh,
             "failover": _scenario_failover, "concurrent": _scenario_concurrent}


def vocab_rank(rank: int, world: int, spec: dict) -> dict:
    """``distributed_vocab_topk`` under both strategies and
    ``greedy_token(mesh=)`` on this rank's vocabulary slice of each (B, V)
    array of ``spec["logits"]`` (a dict) over a ``(world,)`` ``("model",)``
    mesh; returns ``{(name, strategy, k): (values, ids)}`` and ``{(name,
    "greedy"): tokens}`` as numpy."""
    from repro_torch.serving.router import distributed_vocab_topk, greedy_token

    dev = _setup_device(spec["device"])
    mesh = make_mesh(list(range(world)), ("model",))
    out = {}
    for name, full in spec["logits"].items():
        v = full.shape[-1] // world
        local = torch.tensor(full[:, rank * v:(rank + 1) * v], device=dev)
        for strategy in ("tournament", "allgather"):
            for k in spec["ks"]:
                val, ids = distributed_vocab_topk(local, mesh=mesh, k=k,
                                                  strategy=strategy)
                out[(name, strategy, k)] = (val.cpu().numpy(), ids.cpu().numpy())
        out[(name, "greedy")] = greedy_token(local, mesh=mesh).cpu().numpy()
    return out


def stall_rank(rank: int, world: int, seconds: float) -> None:
    """Rank 0 waits in a barrier that the others join only after
    ``seconds``: a hung rank, for the spawner's timeout."""
    import time

    import torch.distributed as dist

    if rank:
        time.sleep(seconds)
    dist.barrier()


if __name__ == "__main__":
    sys.exit(main())
