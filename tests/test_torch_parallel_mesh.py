"""The search engine across processes: the port's mesh forms on a spawned
world of 8 ``gloo`` CPU ranks, against the JAX package's
``sequential_reference(backend="jnp")`` and the port's one-process forms.

One world answers every case (``cases_rank``), at the reference
self-test's size (2000 pages, its 8 queries, k 10, window 1024, 40
mutations): ``distributed_query_topk`` and ``slave_topk_unmerged`` on a
``(4,)`` ``("data",)`` mesh over ranks 0–3, static and merge-on-read, at
``backend="torch"`` and ``"kernel"`` (the kernels' plain versions on the
CPU), both merges; ``replicated_query_topk`` on a ``(2, 4)`` ``("pod",
"data")`` mesh over all 8.  Each case is checked on every rank that
answered it.  Exact equality.  Also: the spawner's timeout and failure
paths, and the mesh forms' refusals.
"""
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import engine as ref_engine
from repro.core import index as ref_index
from repro.core import parallel as ref_parallel
from repro.data import corpus as ref_corpus
from repro.indexing import delta as ref_delta
from repro_torch.core import engine as pt_engine
from repro_torch.core import index as pt_index
from repro_torch.core import parallel as pt_parallel
from repro_torch.indexing import delta as pt_delta
from repro_torch.launch import _parallel_selftest as st
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.spawn import run_ranks

NS, K, WINDOW, WORLD = 4, 10, 1024, 8
CFG = dict(n_docs=2000, vocab_size=300, mean_doc_len=40, n_sites=16, seed=7)
MESHES = {"data4": ([0, 1, 2, 3], ("data",)),
          "pod2": ([[0, 1, 2, 3], [4, 5, 6, 7]], ("pod", "data"))}
MERGES = ("tournament", "allgather")
BACKENDS = ("torch", "kernel")
KINDS = ("static", "mor")
ENGINE = dict(k=K, window=WINDOW)


def _cases():
    cases = []
    for kind in KINDS:
        mor = kind == "mor"
        for merge in MERGES:
            for backend in BACKENDS:
                cases.append((f"distributed-{merge}-{backend}-{kind}", "distributed",
                              "data4", dict(merge=merge, backend=backend, delta=mor,
                                            **ENGINE)))
            cases.append((f"replicated-{merge}-{kind}", "replicated", "pod2",
                          dict(merge=merge, backend="kernel", delta=mor, **ENGINE)))
        for backend in BACKENDS:
            cases.append((f"unmerged-{backend}-{kind}", "unmerged", "data4",
                          dict(backend=backend, delta=mor, **ENGINE)))
    return cases


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    corpus = ref_corpus.generate_corpus(ref_corpus.CorpusConfig(**CFG))
    rsh, meta = ref_index.build_sharded_index(corpus, NS)
    shards = [ref_index.InvertedIndex(*(x[s] for x in rsh)) for s in range(NS)]
    writer = ref_delta.DeltaWriter(corpus, meta, NS, term_capacity=256,
                                   doc_headroom=256)
    writer.apply(ref_corpus.generate_mutations(
        corpus, ref_corpus.MutationConfig(n_ops=40, mean_doc_len=40, seed=3)))
    rqb = ref_engine.make_query_batch(st.SELFTEST_QUERIES, t_max=4, meta=meta,
                                      strategy="embed")
    index_np = {f: np.asarray(v) for f, v in rsh._asdict().items()}
    delta_np = {f: np.asarray(v) for f, v in writer.device_delta()._asdict().items()}
    batch_np = {f: np.asarray(v) for f, v in rqb._asdict().items()}
    spec = dict(device="cpu", index=index_np, delta=delta_np, batch=batch_np, ns=NS,
                meshes=MESHES, cases=_cases())
    results = run_ranks(st.cases_rank, WORLD, spec,
                        rdzv_dir=tmp_path_factory.mktemp("rdzv"), timeout=240)
    ref = {
        "static": ref_parallel.sequential_reference(
            shards, rqb, ns=NS, k=K, window=WINDOW, backend="jnp"),
        "mor": ref_parallel.sequential_reference(
            shards, rqb, ns=NS, k=K, window=WINDOW, backend="jnp",
            deltas=writer.shard_deltas()),
    }
    local = {"static": [], "mor": []}     # each shard's globalised candidates
    for s in range(NS):
        for kind, dl in (("static", None), ("mor", writer.shard_deltas()[s])):
            d, h = ref_engine.query_topk(shards[s], rqb, delta=dl, k=K, window=WINDOW,
                                         backend="jnp")
            local[kind].append((np.asarray(ref_index.local_to_global_docids(
                d, np.int32(s), NS)), np.asarray(h)))
    psh = pt_index.sharded_index_from_numpy(index_np, device="cpu")
    pdelta = pt_delta.sharded_delta_from_numpy(delta_np, device="cpu")
    pqb = pt_engine.QueryBatch(*(torch.tensor(batch_np[f])
                                 for f in pt_engine.QueryBatch._fields))
    return dict(results=results, ref=ref, local=local, psh=psh,
                pdelta=pdelta, pqb=pqb)


def _answered(world, name):
    got = {r: res[name] for r, res in enumerate(world["results"]) if name in res}
    assert got, name
    return got


def _equal(got, want_docids, want_hits):
    np.testing.assert_array_equal(got[0], np.asarray(want_docids))
    np.testing.assert_array_equal(got[1], np.asarray(want_hits))
    assert got[0].dtype == got[1].dtype == np.int32


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("merge", MERGES)
def test_distributed_on_mesh(world, merge, backend, kind):
    got = _answered(world, f"distributed-{merge}-{backend}-{kind}")
    assert sorted(got) == [0, 1, 2, 3]          # the result is on every rank
    want = world["ref"][kind]
    one = pt_parallel.distributed_query_topk(
        world["psh"], world["pqb"], world["pdelta"] if kind == "mor" else None,
        ns=NS, merge=merge, backend=backend, **ENGINE)
    np.testing.assert_array_equal(one.docids.numpy(), np.asarray(want.docids))
    for res in got.values():
        _equal(res, want.docids, want.n_hits)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_slave_topk_unmerged_on_mesh(world, backend, kind):
    got = _answered(world, f"unmerged-{backend}-{kind}")
    one = pt_parallel.slave_topk_unmerged(
        world["psh"], world["pqb"], world["pdelta"] if kind == "mor" else None,
        ns=NS, backend=backend, **ENGINE)
    for r, (docids, hits) in got.items():
        assert docids.shape == (1, len(st.SELFTEST_QUERIES), K)
        _equal((docids[0], hits[0]), *world["local"][kind][r])
        np.testing.assert_array_equal(docids[0], one.docids[r].numpy())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("merge", MERGES)
def test_replicated_on_pod_mesh(world, merge, kind):
    got = _answered(world, f"replicated-{merge}-{kind}")
    assert sorted(got) == list(range(WORLD))
    want = world["ref"][kind]
    half = len(st.SELFTEST_QUERIES) // 2
    for r, res in got.items():
        rows = slice((r // NS) * half, (r // NS + 1) * half)   # pod r // 4
        _equal(res, np.asarray(want.docids)[rows], np.asarray(want.n_hits)[rows])


def test_hung_rank_fails_within_its_timeout(tmp_path):
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError, match="did not finish"):
        run_ranks(st.stall_rank, 2, 300.0, rdzv_dir=tmp_path, timeout=6)
    assert time.perf_counter() - t0 < 30


def test_failed_rank_fails_the_world(tmp_path):
    with pytest.raises(RuntimeError, match="KeyError"):
        run_ranks(st.cases_rank, 2, {"device": "cpu"}, rdzv_dir=tmp_path, timeout=60)
    with pytest.raises(ValueError, match="fresh directory"):   # the world's files
        run_ranks(st.cases_rank, 2, {}, rdzv_dir=tmp_path)


@pytest.fixture
def one_rank_world(tmp_path):
    """A world of one ``gloo`` rank in this process, torn down after."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_mesh_forms_refuse_what_a_rank_cannot_hold(world, one_rank_world):
    mesh = make_mesh([0], ("data",))
    with pytest.raises(ValueError, match="a rank's index holds 4 shards, not 1"):
        pt_parallel.distributed_query_topk(world["psh"], world["pqb"], mesh=mesh,
                                           ns=1, **ENGINE)
    mine = pt_parallel.rank_shard(world["psh"], 0)
    with pytest.raises(ValueError, match="mesh axis 'data' holds 1 ranks, ns=4"):
        pt_parallel.distributed_query_topk(mine, world["pqb"], mesh=mesh, ns=NS,
                                           **ENGINE)
    # ns = 1 on one rank: the shard's own answer, equal to the one-process form
    got = pt_parallel.distributed_query_topk(mine, world["pqb"], mesh=mesh, ns=1,
                                             **ENGINE)
    want = pt_parallel.distributed_query_topk(mine, world["pqb"], ns=1, **ENGINE)
    assert torch.equal(got.docids, want.docids) and torch.equal(got.n_hits, want.n_hits)
