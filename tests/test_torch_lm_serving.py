"""The port's LM serving engine against the JAX package's, on the CPU.

Both engines serve the same requests (numpy prompts from a seed) on the
same weights (the reference's, carried by ``params_from_numpy``): greedy
outputs equal token for token, full and padded partial batches, for
every dense arch (deepseek-coder's G 7, starcoder2's LayerNorm and GELU
MLP, InternVL2's backbone on text), and for the MoE and hybrid families
(Moonlight; Mixtral with prompts past its reduced sliding window;
recurrentgemma: the RG-LRU state carried in place from prefill through
decode, prompts past the reduced local window).  Also:
identical prompts give identical outputs, ``greedy_token`` ties as
``jnp.argmax``, the CLI runs on the CPU, and with no card and no device
the engine raises."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.configs import reduce_for_smoke as ref_reduce
from repro.models.model import init_model as ref_init_model
from repro.serving import engine as ref_engine
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import Request, ServingEngine, greedy_token

ROOT = Path(__file__).resolve().parents[1]


def _prompts(n, vocab, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(3, 12))).astype(np.int32)
            for _ in range(n)]


def _serve(eng, request_cls, prompts, new_tokens):
    for rid, p in enumerate(prompts):
        eng.submit(request_cls(rid=rid, prompt=p, max_new_tokens=new_tokens))
    done = []
    while eng.queue:
        done += eng.step_batch()
    return {r.rid: r.output for r in done}


#: (arch, requests, batch, new tokens): full and padded partial batches of
#: two dense archs; one padded batch of each other dense one (InternVL2's
#: backbone serves text, as the reference's engine does).
SERVED = [(name, n_req, batch, 10, f"{name}-{kind}")
          for name in ("gemma-2b", "phi4-mini-3.8b")
          for n_req, batch, kind in ((8, 4, "full"), (7, 3, "padded"))] + [
    (name, 3, 4, 6, f"{name}-padded")
    for name in ("deepseek-coder-33b", "starcoder2-7b", "internvl2-76b")]


@pytest.mark.parametrize("name,n_req,batch,new_tokens", [c[:4] for c in SERVED],
                         ids=[c[4] for c in SERVED])
def test_outputs_equal_the_reference(name, n_req, batch, new_tokens):
    ref_cfg = ref_reduce(ref_get_config(name))
    ref_params = ref_init_model(jax.random.PRNGKey(1), ref_cfg)
    cfg = reduce_for_smoke(get_config(name))
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg, "cpu")
    prompts = _prompts(n_req, cfg.vocab, 5)
    want = _serve(ref_engine.ServingEngine(ref_cfg, batch_size=batch, max_len=32,
                                           params=ref_params),
                  ref_engine.Request, prompts, new_tokens)
    got = _serve(ServingEngine(cfg, batch_size=batch, max_len=32, device="cpu",
                               params=params), Request, prompts, new_tokens)
    assert sorted(got) == list(range(n_req))
    assert got == want
    assert all(len(o) == new_tokens and all(0 <= t < cfg.vocab for t in o)
               for o in got.values())


#: Prompts (lengths lo to hi, how many) of the MoE and hybrid cases: past
#: the reduced local window of 32, and for Mixtral past its reduced sliding
#: window of 32 in every prompt, so the window bites in prefill and in
#: decode (one batch).
PROMPTS = {"mixtral-8x7b": (40, 52, 2)}


@pytest.mark.parametrize("name", ["moonshot-v1-16b-a3b", "recurrentgemma-2b",
                                  "mixtral-8x7b"])
def test_moe_and_hybrid_outputs_equal_the_reference(name):
    ref_cfg = ref_reduce(ref_get_config(name))
    ref_params = ref_init_model(jax.random.PRNGKey(2), ref_cfg)
    cfg = reduce_for_smoke(get_config(name))
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg, "cpu")
    rng = np.random.default_rng(7)
    lo, hi, n_req = PROMPTS.get(name, (30, 45, 4))
    prompts = [rng.integers(0, cfg.vocab, size=int(rng.integers(lo, hi))).astype(np.int32)
               for _ in range(n_req)]
    if cfg.sliding_window:
        assert min(len(p) for p in prompts) > cfg.sliding_window
    want = _serve(ref_engine.ServingEngine(ref_cfg, batch_size=2, max_len=64,
                                           params=ref_params),
                  ref_engine.Request, prompts, 8)
    got = _serve(ServingEngine(cfg, batch_size=2, max_len=64, device="cpu",
                               params=params), Request, prompts, 8)
    assert sorted(got) == list(range(n_req))
    assert got == want


def test_identical_prompts_give_identical_outputs():
    cfg = reduce_for_smoke(get_config("phi4-mini-3.8b"))
    eng = ServingEngine(cfg, batch_size=2, max_len=32, rng_seed=4, device="cpu")
    a, b = _prompts(2, cfg.vocab, 9)
    b = np.concatenate([b, b])[: len(a)]  # same length as a: equal padding
    # within a batch, and across batches of the same padded length
    out = _serve(eng, Request, [a, a, b, a], 8)
    assert out[0] == out[1] == out[3]
    assert len(out[2]) == 8
    assert eng.step_batch() == []


def test_greedy_token_ties_and_mesh(tmp_path):
    rng = np.random.default_rng(0)
    logits = rng.integers(0, 4, size=(16, 50)).astype(np.float32)  # many ties
    got = greedy_token(torch.from_numpy(logits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.argmax(logits, axis=-1)))
    # on a 1-rank ("model",) mesh the vocab-sharded top-k equals argmax
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("model",))
        on_mesh = greedy_token(torch.from_numpy(logits), mesh=mesh)
    finally:
        dist.destroy_process_group()
    assert on_mesh.dtype == torch.int32
    np.testing.assert_array_equal(on_mesh.numpy(), got.numpy())


def test_engine_without_card_or_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(reduce_for_smoke(get_config("gemma-2b")), batch_size=2, max_len=16)


def test_serve_cli_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          "--arch", "gemma-2b", "--smoke", "--device", "cpu"],
                         capture_output=True, text=True, env=env, cwd=tmp_path,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "[serve] 8 requests, 128 tokens" in out.stdout
    assert "[serve] K12 launches 0; gemma-2b on no card (cpu)" in out.stdout
