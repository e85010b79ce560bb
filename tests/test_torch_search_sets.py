"""ODYS sets on their own ranks: the twins of ``tests/test_multidevice.py``
in the port, on a spawned ``gloo`` world of 1 + 2·ns CPU ranks (rank 0
the front, ranks 1..2·ns the two sets' slaves), held against the
reference's sliced service on 2·ns XLA host devices (a subprocess, since
the device count is fixed when jax starts) and against the port's
one-process service and the reference's brute-force oracle.

One world runs every scenario (``sets_rank``): ``set_mesh_slices``
carves disjoint slices and refuses a pool that is too small; a sliced
``SearchService`` returns the reference's hits exactly, and both sets
serve; an insert is visible to whichever set serves the next batch,
before and after ``compact(verify=True)``; ``HealthAwareRouter``
failover is slice-granular; two sets' batches in flight from two
threads.  The reference runs the same scenarios, with the same inputs,
on ``set_mesh_slices(2, ns)``.  Also the constructor's refusals of a
wrong count or shape of slices.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch.distributed as dist

from repro.core.engine import brute_force_topk
from repro.data import corpus as ref_corpus
from repro_torch.core.index import build_sharded_index
from repro_torch.data.corpus import CorpusConfig, generate_corpus
from repro_torch.launch import _parallel_selftest as st
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.spawn import run_ranks
from repro_torch.serving.search import SearchService

ROOT = Path(__file__).resolve().parents[1]
NS, N_SETS, K = 2, 2, 8
CFG = dict(n_docs=96, vocab_size=40, mean_doc_len=10, n_sites=4, seed=11)
REFERENCE = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=%d"
    import numpy as np
    from repro.core.faults import SetHealth
    from repro.core.index import build_sharded_index
    from repro.core.parallel import set_mesh_slices
    from repro.data.corpus import CorpusConfig, generate_corpus
    from repro.serving.search import SearchService

    spec = json.load(open(sys.argv[1]))
    ns, n_sets = spec["ns"], spec["n_sets"]
    corpus = generate_corpus(CorpusConfig(**spec["cfg"]))
    index, meta = build_sharded_index(corpus, ns)
    slices = set_mesh_slices(n_sets, ns)
    queries = [tuple(q) for q in spec["queries"]]

    def service(**kw):
        return SearchService(index, meta, slices[0], ns=ns, k=spec["k"],
                             n_sets=n_sets, set_meshes=slices, cache_size=0, **kw)

    def ints(a):
        return np.asarray(a).tolist()

    out = {}
    svc = service(batch_size=4)
    out["matches"] = {"hits": [(h.docids, h.n_hits) for h in svc.search(queries)],
                      "n_batches": [s.n_batches for s in svc.scheduler.router.sets]}
    out["concurrent"] = []
    for set_id in range(n_sets):
        res = svc._run_engine(queries, t_max=svc.t_max, k=svc.k, set_id=set_id)
        out["concurrent"].append((ints(res.docids), ints(res.n_hits)))

    svc = service(batch_size=1, corpus=corpus, updatable=True)
    gids = svc.insert([tuple(q) for q in spec["inserts"]])
    rounds = []
    for _ in range(2):
        tickets = [svc.scheduler.submit(*spec["probe"]) for _ in range(n_sets)]
        svc.scheduler.drain()
        rounds.append([(t.set_id, t.result.docids) for t in tickets])
        if len(rounds) == 1:
            svc.compact(verify=True)
    out["fresh"] = {"gids": ints(gids), "rounds": rounds}

    svc = service(batch_size=2, set_health=SetHealth.all_alive(n_sets))
    router = svc.scheduler.router
    router.fail(0)
    fq = [tuple(q) for q in spec["failover_queries"]]
    tickets = [svc.scheduler.submit(ts, site) for ts, site in fq]
    svc.scheduler.drain()
    dead = [s.n_batches for s in router.sets]
    router.recover(0)
    svc.search(fq)
    out["failover"] = {"set_ids": [t.set_id for t in tickets],
                       "hits": [t.result.docids for t in tickets],
                       "n_batches_dead": dead,
                       "n_batches_recovered": [s.n_batches for s in router.sets]}
    json.dump(out, open(sys.argv[2], "w"))
""" % (N_SETS * NS))


def _queries(n=12, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        terms = [int(t) for t in rng.choice(40, size=2, replace=False)]
        site = int(rng.integers(4)) if i % 3 == 0 else None
        out.append((terms, site))
    return out


def _lists(x):
    """Tuples and numpy arrays as nested lists (the JSON form)."""
    if isinstance(x, (list, tuple)):
        return [_lists(v) for v in x]
    if isinstance(x, dict):
        return {k: _lists(v) for k, v in x.items()}
    if isinstance(x, np.ndarray):
        return x.tolist()
    return int(x) if isinstance(x, np.integer) else x


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    corpus = generate_corpus(CorpusConfig(**CFG))
    inputs = dict(ns=NS, n_sets=N_SETS, k=K, cfg=CFG, queries=_queries(),
                  probe=([38, 39], None), inserts=[([38, 39], 0), ([38, 39], 1)],
                  failover_queries=_queries(n=8, seed=7))
    tmp = tmp_path_factory.mktemp("sets")
    (tmp / "inputs.json").write_text(json.dumps(inputs))
    (tmp / "reference.py").write_text(REFERENCE)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref_proc = subprocess.Popen(
        [sys.executable, str(tmp / "reference.py"), str(tmp / "inputs.json"),
         str(tmp / "reference.json")], env=env, stderr=subprocess.PIPE, text=True)
    try:
        spec = dict(inputs, device="cpu", corpus=corpus, scenarios=list(st.SCENARIOS))
        results = run_ranks(st.sets_rank, 1 + N_SETS * NS, spec,
                            rdzv_dir=tmp_path_factory.mktemp("rdzv"), timeout=240)
        _, err = ref_proc.communicate(timeout=300)
    finally:
        ref_proc.kill()
    assert ref_proc.returncode == 0, err
    assert results[1:] == [None] * (N_SETS * NS)
    ref = ref_corpus.generate_corpus(ref_corpus.CorpusConfig(**CFG))
    return dict(record=results[0], spec=spec, corpus=corpus, ref_corpus=ref,
                reference=json.loads((tmp / "reference.json").read_text()))


def test_set_mesh_slices_are_disjoint(world):
    slices = world["record"]["slices"]
    assert len(slices) == N_SETS
    seen = set()
    for shape, ranks in slices:
        assert shape == {"pod": 1, "data": NS}
        assert not set(ranks) & seen          # no rank serves two sets
        seen |= set(ranks)
    assert seen == set(range(1, 1 + N_SETS * NS))   # rank 0, the front, in none


def test_set_mesh_slices_rejects_undersized_pool(world):
    assert "slave ranks" in world["record"]["undersized"]


def test_sliced_service_matches_shared_service_and_oracle(world):
    got = world["record"]["matches"]
    assert _lists(got) == world["reference"]["matches"]   # the reference's sliced service
    queries = world["spec"]["queries"]
    index, meta = build_sharded_index(world["corpus"], NS, device="cpu")
    shared = SearchService(index, meta, ns=NS, k=K, n_sets=1, cache_size=0,
                           batch_size=4, device="cpu")
    ref = [(h.docids, h.n_hits) for h in shared.search(queries)]
    assert [tuple(h) for h in got["hits"]] == ref
    oracle = brute_force_topk(world["ref_corpus"], queries, K)
    for (docids, _), o in zip(got["hits"], oracle):
        assert set(docids) <= set(o) or len(o) > K
    assert all(n > 0 for n in got["n_batches"])   # the router spread batches


def test_merge_on_read_is_fresh_on_every_slice(world):
    got = world["record"]["fresh"]
    assert _lists(got) == world["reference"]["fresh"]
    gids = set(got["gids"])
    assert len(gids) == 2
    before, after = got["rounds"]
    assert {s for s, _ in before} == {0, 1}        # both slices served the probe
    for _, docids in before + after:               # ... and after the fold
        assert gids <= set(docids)


def test_health_failover_is_slice_granular(world):
    got = world["record"]["failover"]
    assert _lists(got) == world["reference"]["failover"]
    assert set(got["set_ids"]) == {1}              # the dead slice serves nothing
    assert got["n_batches_dead"][0] == 0
    assert got["n_batches_recovered"][0] > 0       # routing resumed
    oracle = brute_force_topk(world["ref_corpus"], world["spec"]["failover_queries"], K)
    for docids, o in zip(got["hits"], oracle):
        assert set(docids) <= set(o) or len(o) > K  # degraded != wrong


def test_two_sets_in_flight_from_two_threads(world):
    got = world["record"]["concurrent"]
    for per_set, (ref_docids, ref_hits) in zip(got, world["reference"]["concurrent"]):
        for docids, n_hits in per_set:
            assert docids.tolist() == ref_docids and n_hits.tolist() == ref_hits
    index, meta = build_sharded_index(world["corpus"], NS, device="cpu")
    shared = SearchService(index, meta, ns=NS, k=K, cache_size=0, device="cpu")
    want = shared.search_batch(world["spec"]["queries"])
    for per_set in got:
        for docids, n_hits in per_set:
            np.testing.assert_array_equal(docids, want.docids.numpy())
            np.testing.assert_array_equal(n_hits, want.n_hits.numpy())


@pytest.fixture
def one_rank_world(tmp_path):
    """A world of one ``gloo`` rank in this process, torn down after."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_wrong_slices_raise_the_references_errors(one_rank_world):
    index, meta = build_sharded_index(generate_corpus(CorpusConfig(**CFG)), NS,
                                      device="cpu")
    mesh = make_mesh([[0]], ("pod", "data"))
    with pytest.raises(ValueError, match="1 set_meshes for n_sets=2"):
        SearchService(index, meta, ns=NS, n_sets=2, set_meshes=[mesh], device="cpu")
    with pytest.raises(ValueError, match=r"set mesh must be \(pod=1, data=2\)"):
        SearchService(index, meta, ns=NS, set_meshes=[mesh], device="cpu")
