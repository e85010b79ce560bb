"""The port's LM serving engine against the JAX package's, on the CPU.

Both engines serve the same requests (numpy prompts from a seed) on the
same weights (the reference's, carried by ``params_from_numpy``): greedy
outputs equal token for token, full and padded partial batches, and for
the MoE and hybrid families (Moonlight, recurrentgemma: the RG-LRU state
carried in place from prefill through decode, prompts past the reduced
local window).  Also:
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


@pytest.mark.parametrize("n_req,batch", [(8, 4), (7, 3)], ids=["full", "padded"])
@pytest.mark.parametrize("name", ["gemma-2b", "phi4-mini-3.8b"])
def test_outputs_equal_the_reference(name, n_req, batch):
    ref_cfg = ref_reduce(ref_get_config(name))
    ref_params = ref_init_model(jax.random.PRNGKey(1), ref_cfg)
    cfg = reduce_for_smoke(get_config(name))
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg, "cpu")
    prompts = _prompts(n_req, cfg.vocab, 5)
    want = _serve(ref_engine.ServingEngine(ref_cfg, batch_size=batch, max_len=32,
                                           params=ref_params),
                  ref_engine.Request, prompts, 10)
    got = _serve(ServingEngine(cfg, batch_size=batch, max_len=32, device="cpu",
                               params=params), Request, prompts, 10)
    assert sorted(got) == list(range(n_req))
    assert got == want
    assert all(len(o) == 10 and all(0 <= t < cfg.vocab for t in o) for o in got.values())


@pytest.mark.parametrize("name", ["moonshot-v1-16b-a3b", "recurrentgemma-2b"])
def test_moe_and_hybrid_outputs_equal_the_reference(name):
    ref_cfg = ref_reduce(ref_get_config(name))
    ref_params = ref_init_model(jax.random.PRNGKey(2), ref_cfg)
    cfg = reduce_for_smoke(get_config(name))
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg, "cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, size=int(rng.integers(30, 45))).astype(np.int32)
               for _ in range(4)]
    want = _serve(ref_engine.ServingEngine(ref_cfg, batch_size=2, max_len=64,
                                           params=ref_params),
                  ref_engine.Request, prompts, 8)
    got = _serve(ServingEngine(cfg, batch_size=2, max_len=64, device="cpu",
                               params=params), Request, prompts, 8)
    assert sorted(got) == list(range(4))
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


def test_greedy_token_ties_and_mesh():
    rng = np.random.default_rng(0)
    logits = rng.integers(0, 4, size=(16, 50)).astype(np.float32)  # many ties
    got = greedy_token(torch.from_numpy(logits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.argmax(logits, axis=-1)))
    with pytest.raises(NotImplementedError):
        greedy_token(torch.from_numpy(logits), mesh=object())


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
