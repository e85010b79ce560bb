"""Tensor parallelism across processes: one spawned world of 4 ``gloo``
CPU ranks on a (data 2, model 2) host mesh (``launch._tp_selftest.
tp_rank``), and the reference under ``make_host_mesh(2, 2)`` on 4 XLA host
devices in a concurrent subprocess (the device count is fixed when jax
starts).

- ``ServingEngine(mesh=)`` on reduced phi4-mini, Moonlight (MoE, the
  experts over ``model``), Mixtral with 3 experts (each expert's d_ff over
  ``model``; a sliding window), recurrentgemma (RG-LRU and local
  attention, one KV head), rwkv6 and whisper-base gives the tokens of
  the port's unsharded engine on every
  rank, every step's logits within a row-relative 1e-4 (float32);
- a (2, 2) train step matches the one-process step from the same weights
  and batch: loss and gradient norm within 1e-5 relative, every parameter
  by relative L2 within 1e-5;
- a checkpoint saved from the sharded state has the one-rank save's
  bytes (its sha256 digest), and restores into a fresh sharded state;
- no rank ran DTensor's functional all-gather (which crashes a rank on
  CUDA tensors under ``gloo``; ``models.sharding.redistribute`` gathers
  explicitly);
- phi4-mini's sharded tokens equal the reference engine's under its mesh,
  and the sharded train step the reference's jitted step under
  ``use_mesh`` (loss within rtol 1e-4, parameters by relative L2 within
  1e-5, as ``tests/test_torch_train_step.py`` holds one process).
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.data.pipeline import DataConfig, TokenStream
from repro_torch.launch import _tp_selftest as st
from repro_torch.launch.spawn import run_ranks
from repro_torch.models.convert import numpy_from_params
from repro_torch.models.model import init_model

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
ARCHS = ["phi4-mini-3.8b", "moonshot-v1-16b-a3b", "mixtral-8x7b@e3", "recurrentgemma-2b",
         "rwkv6-1.6b", "whisper-base"]
NEW_TOKENS, SEQ, BATCH, SEED = 4, 16, 4, 0
REF_ARCH = "phi4-mini-3.8b"
REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.configs import get_config, reduce_for_smoke
    from repro.launch.mesh import make_host_mesh
    from repro.models.sharding import use_mesh
    from repro.serving.engine import Request, ServingEngine
    from repro.training.optimizer import AdamWConfig, init_opt_state
    from repro.training.train_step import TrainState, make_train_step

    src = np.load(sys.argv[1])
    params = {}
    for key in src.files:
        if key.startswith("param/"):
            node = params
            *path, leaf = key.split("/")[1:]
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(src[key])
    cfg = reduce_for_smoke(get_config(sys.argv[3]))
    mesh = make_host_mesh(data=2, model=2)
    prompts = [src[f"prompt{i}"] for i in range(4)]
    eng = ServingEngine(cfg, batch_size=4, max_len=max(map(len, prompts)) + int(src["new"]),
                        mesh=mesh, params=params)
    for i, p in enumerate(prompts):
        eng.submit(Request(i, p, max_new_tokens=int(src["new"])))
    out = {"tokens": np.array([r.output for r in eng.step_batch()])}
    step = jax.jit(make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=2,
                                                    total_steps=50)))
    batch = {k: jnp.asarray(src["batch/" + k]) for k in ("tokens", "labels")}
    with use_mesh(mesh):
        state, m = step(TrainState(params, init_opt_state(params)), batch)
    out["loss"], out["grad_norm"] = np.asarray(m["loss"]), np.asarray(m["grad_norm"])
    flat = jax.tree_util.tree_flatten_with_path(state.params)[0]
    for path, leaf in flat:
        out["param/" + "/".join(str(e.key) for e in path)] = np.asarray(leaf)
    np.savez(sys.argv[2], **out)
""")


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in (5, 9, 7, 12)]


def _flat(tree, prefix="param"):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = v
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    cfg = reduce_for_smoke(get_config(REF_ARCH))
    ref_in = _flat(numpy_from_params(init_model(cfg, seed=SEED, device="cpu"), cfg))
    batch = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH,
                                   seed=SEED)).batch(0)
    ref_in.update({f"batch/{k}": v for k, v in batch.items()})
    prompts = {a: _prompts(st.tp_config(a).vocab) for a in ARCHS}
    ref_in.update({f"prompt{i}": p for i, p in enumerate(prompts[REF_ARCH])})
    ref_in["new"] = np.array(NEW_TOKENS)
    np.savez(tmp / "ref_in.npz", **ref_in)
    (tmp / "reference.py").write_text(REFERENCE)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref_proc = subprocess.Popen(
        [sys.executable, str(tmp / "reference.py"), str(tmp / "ref_in.npz"),
         str(tmp / "reference.npz"), REF_ARCH], env=env, stderr=subprocess.PIPE, text=True)
    try:
        spec = dict(device="cpu", mesh=(2, 2), archs=ARCHS, prompts=prompts,
                    new_tokens=NEW_TOKENS, seq=SEQ, batch=BATCH, seed=SEED,
                    ckpt_dir=str(tmp / "ckpt"), train_archs=ARCHS, ckpt_arch=REF_ARCH)
        port = run_ranks(st.tp_rank, WORLD, spec,
                         rdzv_dir=tmp_path_factory.mktemp("rdzv"), timeout=300)
        _, err = ref_proc.communicate(timeout=300)
    finally:
        ref_proc.kill()
    assert ref_proc.returncode == 0, err
    return port, dict(np.load(tmp / "reference.npz"))


def _row_rel(a, b) -> float:
    return float(np.max(np.abs(a - b) / np.abs(b).max(-1, keepdims=True)))


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_engine_equals_unsharded(runs, arch):
    port, _ = runs
    r0 = port[0]["serve"][arch]
    assert r0["tokens"] == r0["one_tokens"]
    assert all(r["serve"][arch]["tokens"] == r0["tokens"] for r in port)
    assert len(r0["logits"]) == NEW_TOKENS
    for step, (got, want) in enumerate(zip(r0["logits"], r0["one_logits"])):
        assert got.shape == want.shape == (4, 512)
        assert _row_rel(got, want) <= 1e-4, step


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_equals_one_process(runs, arch):
    port, _ = runs
    t = port[0]["train"][arch]
    assert t["loss"] == pytest.approx(t["one_loss"], rel=1e-5)
    assert t["gnorm"] == pytest.approx(t["one_gnorm"], rel=1e-5)
    assert all(r["train"][arch]["loss"] == t["loss"] for r in port)
    assert set(t["params"]) == set(t["one_params"])
    errs = {n: _rel_l2(t["params"][n], t["one_params"][n]) for n in t["params"]}
    assert max(errs.values()) <= 1e-5, max(errs.items(), key=lambda kv: kv[1])


def test_sharded_checkpoint_round_trips(runs):
    port, _ = runs
    for r in port:
        t = r["train"][REF_ARCH]
        assert t["digest"] == t["one_digest"] == t["restored_digest"]
        assert t["restored_sharded"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("what", ["serve", "train"])
def test_no_functional_all_gather_under_gloo(runs, what, arch):
    port, _ = runs
    for r in port:
        counts = r["comms"][(what, arch)]
        assert counts.get("c10d_functional.all_gather_into_tensor", 0) == 0, counts
        assert counts.get("c10d_functional.all_to_all_single", 0) == 0, counts
        assert counts.get("c10d_functional.all_reduce", 0) > 0, counts


def test_phi4_serve_equals_the_reference_under_its_mesh(runs):
    port, ref = runs
    np.testing.assert_array_equal(np.array(port[0]["serve"][REF_ARCH]["tokens"]),
                                  ref["tokens"])


def test_phi4_train_step_equals_the_reference_under_its_mesh(runs):
    port, ref = runs
    t = port[0]["train"][REF_ARCH]
    assert t["loss"] == pytest.approx(float(ref["loss"]), rel=1e-4)
    assert t["gnorm"] == pytest.approx(float(ref["grad_norm"]), rel=1e-3)
    cfg = reduce_for_smoke(get_config(REF_ARCH))
    want = {k[len("param/"):]: v for k, v in ref.items() if k.startswith("param/")}
    n_groups = cfg.n_layers
    for name, got in t["params"].items():
        parts = name.split(".")
        if parts[0] == "groups":
            key, g = "/".join([parts[0]] + parts[2:]), int(parts[1])
            assert want[key].shape[0] == n_groups
            theirs = want[key][g]
        else:
            theirs = want["/".join(parts)]
        assert _rel_l2(got, theirs) <= 1e-5, name
