"""The vocab-sharded top-k across processes: the port's
``distributed_vocab_topk`` and ``greedy_token(mesh=)`` on a spawned world
of 4 ``gloo`` CPU ranks against the reference's on 4 XLA host devices (a
subprocess, since the device count is fixed when jax starts), on logits
full of ties and on logits without.

On a tie the reference's tournament keeps, on each device, that device's
own candidate first, so its four copies differ, and ``shard_map`` hands
back device 0's: the lower token id wins every tie.  The port returns
that on every rank (ROADMAP R11).  Exact equality of values and ids.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from repro_torch.launch import _parallel_selftest as st
from repro_torch.launch.spawn import run_ranks

ROOT = Path(__file__).resolve().parents[1]
WORLD, KS = 4, (1, 3, 8)
STRATEGIES = ("tournament", "allgather")
REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.serving.router import distributed_vocab_topk, greedy_token

    src = np.load(sys.argv[1])
    mesh = jax.make_mesh((4,), ("model",))
    out = {}
    for name in src.files:
        logits = jnp.asarray(src[name])
        for strategy in ("tournament", "allgather"):
            for k in (1, 3, 8):
                v, i = distributed_vocab_topk(logits, mesh=mesh, k=k, strategy=strategy)
                key = f"{name}-{strategy}-{k}"
                out[key + "-v"], out[key + "-i"] = np.asarray(v), np.asarray(i)
                copies = [np.asarray(s.data) for s in i.addressable_shards]
                out[key + "-copies-equal"] = np.array(
                    all(np.array_equal(c, copies[0]) for c in copies))
        out[f"{name}-greedy"] = np.asarray(greedy_token(logits, mesh=mesh))
    np.savez(sys.argv[2], **out)
""")


def _logits():
    rng = np.random.default_rng(0)
    return {"ties": rng.integers(0, 3, size=(4, 64)).astype(np.float32),
            "distinct": rng.standard_normal((4, 256)).astype(np.float32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("vocab")
    logits = _logits()
    np.savez(tmp / "logits.npz", **logits)
    (tmp / "reference.py").write_text(REFERENCE)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref_proc = subprocess.Popen(
        [sys.executable, str(tmp / "reference.py"), str(tmp / "logits.npz"),
         str(tmp / "reference.npz")], env=env, stderr=subprocess.PIPE, text=True)
    try:
        port = run_ranks(st.vocab_rank, WORLD, dict(device="cpu", logits=logits, ks=KS),
                         rdzv_dir=tmp_path_factory.mktemp("rdzv"), timeout=120)
        _, err = ref_proc.communicate(timeout=300)
    finally:
        ref_proc.kill()
    assert ref_proc.returncode == 0, err
    return port, dict(np.load(tmp / "reference.npz")), logits


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("name", ["ties", "distinct"])
def test_vocab_topk_equals_reference_on_every_rank(runs, name, strategy, k):
    port, ref, logits = runs
    key = f"{name}-{strategy}-{k}"
    for rank, res in enumerate(port):
        values, ids = res[(name, strategy, k)]
        np.testing.assert_array_equal(values, ref[key + "-v"], err_msg=f"rank {rank}")
        np.testing.assert_array_equal(ids, ref[key + "-i"], err_msg=f"rank {rank}")
        assert ids.dtype == np.int32
    # the reference's copy is the whole logits' top-k, the lower id first on a tie
    order = np.argsort(-logits[name], axis=-1, kind="stable")[:, :k]
    np.testing.assert_array_equal(ref[key + "-i"], order)


def test_reference_tournament_copies_differ_on_ties(runs):
    """The fact behind R11: on tied logits the reference's devices disagree
    under the tournament (the port's ranks agree, above)."""
    _, ref, _ = runs
    assert not ref["ties-tournament-8-copies-equal"]
    assert ref["ties-allgather-8-copies-equal"]


@pytest.mark.parametrize("name", ["ties", "distinct"])
def test_greedy_token_on_mesh(runs, name):
    port, ref, logits = runs
    for res in port:
        np.testing.assert_array_equal(res[(name, "greedy")], ref[f"{name}-greedy"])
        np.testing.assert_array_equal(res[(name, "greedy")],
                                      np.argmax(logits[name], axis=-1))
