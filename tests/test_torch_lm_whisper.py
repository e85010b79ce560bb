"""The port's Whisper encoder-decoder (whisper-base) against the JAX
package's, on the CPU.

The reduced config (2 encoder and 2 decoder layers, 16 frames), the
reference's weights carried by ``params_from_numpy`` (the stacked encoder
layers unstacked), the same numpy inputs, float32, within rtol = atol =
1e-4: the sinusoidal positions (to position 1500, where an ulp of
``exp`` in a frequency, which torch's and XLA's differ by in 26 of 256,
moves the angle by up to 9e-5) and the encoder's output; keys, kinds and
parameter count; ``forward_logits`` under ``"flash"`` and ``"naive"``;
prefill plus decode against the reference and the forward, decode seeing
no ``encoder_frames`` (the cross K/V from the cache, written in place, as
the reference's); ``ServingEngine`` outputs equal to the reference
engine's.  Every attention call reaches ``_flash_gqa`` inside K12's
contract (``k12_refusal`` is ``None``): the encoder and the cross
attention non-causal with every key valid, the decoder causal from 0, no
RoPE anywhere; 3 calls a layer pair, none in decode."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.configs import reduce_for_smoke as ref_reduce
from repro.models import model as ref_model
from repro.models import transformer as ref_tf
from repro.serving import engine as ref_engine
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models import layers as L
from repro_torch.models import model as pt_model
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import Request, ServingEngine

NAME = "whisper-base"
CPU = "cpu"
TOL = 1e-4


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def model():
    ref_cfg = ref_reduce(ref_get_config(NAME))
    ref_params = ref_model.init_model(jax.random.PRNGKey(6), ref_cfg)
    cfg = reduce_for_smoke(get_config(NAME))
    return (ref_cfg, ref_params, cfg,
            params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg, CPU))


def _inputs(cfg, S, seed):
    inputs = pt_model.make_inputs(cfg, 2, S, seed=seed, device=CPU)
    return inputs, {k: jnp.asarray(v.numpy()) for k, v in inputs.items()}


def test_sinusoidal_and_encoder_match_the_reference(model):
    ref_cfg, ref_params, cfg, params = model
    pos = np.arange(40, dtype=np.int32)[None] + np.array([[0], [1460]], np.int32)
    _close(tf._sinusoidal(_t(pos), 512), ref_tf._sinusoidal(jnp.asarray(pos), 512))
    inputs, jin = _inputs(cfg, 8, 1)
    want = ref_tf._run_encoder(ref_params, ref_cfg, jin["encoder_frames"])
    got = tf._run_encoder(params, cfg, inputs["encoder_frames"])
    assert got.shape == (2, cfg.encoder_seq, cfg.d_model)
    _close(got, want)


def test_keys_kinds_and_count_as_the_reference(model):
    ref_cfg, ref_params, cfg, params = model
    fresh = pt_model.init_model(cfg, seed=1, device=CPU)
    assert pt_model.count_params(fresh) == ref_model.count_params(ref_params)
    assert sorted(fresh.keys()) == sorted(ref_params) == sorted(params.keys())
    assert "encoder" in fresh and sorted(fresh["encoder"].keys()) == ["final_norm", "layers"]
    assert len(fresh["encoder"]["layers"]) == cfg.encoder_layers == 2
    enc, ref_enc = fresh["encoder"]["layers"][0], ref_params["encoder"]["layers"]
    assert sorted(enc.keys()) == sorted(ref_enc) == ["attn", "mlp", "norm1", "norm2"]
    dec, ref_dec = fresh["groups"][0]["b0"], ref_params["groups"]["b0"]
    assert sorted(dec.keys()) == sorted(ref_dec) == [
        "attn", "cross", "mlp", "norm1", "norm2", "norm_x"]
    for k, v in dec["cross"].items():
        assert tuple(v.shape) == ref_dec["cross"][k].shape[1:]
    cache = pt_model.init_cache(cfg, 2, 12, device=CPU)["groups"][0]["b0"]
    ref_cache = ref_model.init_cache(ref_cfg, 2, 12)["groups"]["b0"]
    assert sorted(cache) == sorted(ref_cache) == ["ck", "cv", "kv"]
    assert tuple(cache["ck"].shape) == ref_cache["ck"].shape[1:] == (
        2, cfg.encoder_seq, cfg.n_kv_heads, cfg.hd)
    inputs = pt_model.make_inputs(cfg, 2, 5, seed=0, device=CPU)
    assert inputs["encoder_frames"].shape == (2, cfg.encoder_seq, cfg.d_model)
    frames = np.random.default_rng(0)
    frames.integers(0, cfg.vocab, size=(2, 5))
    frames.integers(0, cfg.vocab, size=(2, 5))
    _close(inputs["encoder_frames"],
           frames.standard_normal((2, cfg.encoder_seq, cfg.d_model)).astype(np.float32), 0)


@pytest.mark.parametrize("impl", ["flash", "naive"])
def test_forward_logits_match_the_reference(model, impl):
    ref_cfg, ref_params, cfg, params = model
    rc, pc = (dataclasses.replace(c, attn_impl=impl) for c in (ref_cfg, cfg))
    inputs, jin = _inputs(cfg, 20, 2)
    want = ref_model.forward_logits(ref_params, rc, jin)
    got = pt_model.forward_logits(params, pc, inputs)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    _close(got, want)


def test_prefill_and_decode_match_the_reference_and_the_forward(model, monkeypatch):
    """The twin of the reference's ``test_encdec_decode_uses_cached_cross_kv``,
    past the reduced chunks (8) and against the reference step by step."""
    ref_cfg, ref_params, cfg, params = model
    S, split = 16, 13
    inputs, jin = _inputs(cfg, S, 3)
    full = pt_model.forward_logits(params, cfg, inputs)
    calls = []
    real = L._flash_gqa

    def spy(qg, k, v, q_base, k_base, k_len, **kw):
        calls.append((qg.shape[1], k.shape[1], kw["causal"],
                      L.k12_refusal(qg.shape[1], k.shape[1], q_base=q_base, k_base=k_base,
                                    k_len=k_len, causal=kw["causal"], window=kw["window"])))
        return real(qg, k, v, q_base, k_base, k_len, **kw)

    def no_rope(*a, **kw):
        raise AssertionError("RoPE in an encoder-decoder")

    monkeypatch.setattr(L, "_flash_gqa", spy)
    monkeypatch.setattr(L, "apply_rope", no_rope)
    pre = dict(inputs, tokens=inputs["tokens"][:, :split])
    want, ref_cache = ref_model.prefill(
        ref_params, ref_cfg, dict(jin, tokens=jin["tokens"][:, :split]), max_len=S)
    got, cache = pt_model.prefill(params, cfg, pre, max_len=S)
    T = cfg.encoder_seq
    assert calls == [(T, T, False, None)] * cfg.encoder_layers + [
        (split, split, True, None), (split, T, False, None)] * cfg.n_layers
    _close(got, want)
    _close(got, full[:, split - 1])
    ck = cache["groups"][0]["b0"]["ck"]
    for g in range(cfg.n_layers):
        for name in ("ck", "cv"):
            _close(cache["groups"][g]["b0"][name], ref_cache["groups"]["b0"][name][g])
    for t in range(split, S):
        tok = inputs["tokens"][:, t:t + 1]
        want, ref_cache = ref_model.decode_step(ref_params, ref_cfg,
                                                jnp.asarray(tok.numpy()), ref_cache,
                                                jnp.int32(t))
        got, cache = pt_model.decode_step(params, cfg, tok, cache, t)
        _close(got, want)
        _close(got, full[:, t])
    assert len(calls) == cfg.encoder_layers + 2 * cfg.n_layers    # none in decode
    assert cache["groups"][0]["b0"]["ck"] is ck
    _close(cache["groups"][1]["b0"]["kv"]["v"], ref_cache["groups"]["b0"]["kv"]["v"][1])


def test_serving_outputs_equal_the_reference(model):
    ref_cfg, ref_params, cfg, params = model
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, cfg.vocab, size=int(rng.integers(3, 20))).astype(np.int32)
               for _ in range(3)]

    def serve(eng, request_cls):
        for rid, p in enumerate(prompts):
            eng.submit(request_cls(rid=rid, prompt=p, max_new_tokens=4))
        done = []
        while eng.queue:
            done += eng.step_batch()
        return {r.rid: r.output for r in done}

    want = serve(ref_engine.ServingEngine(ref_cfg, batch_size=2, max_len=32,
                                          params=ref_params), ref_engine.Request)
    got = serve(ServingEngine(cfg, batch_size=2, max_len=32, device=CPU, params=params),
                Request)
    assert sorted(got) == list(range(3))
    assert got == want
