"""The port's RG-LRU block and the RecurrentGemma hybrid against the JAX
package's, on the CPU.

The same numpy inputs (from a seed) go through the reference's functions
and the port's, in float32: the causal depthwise conv within 1e-6 (with
and without carried context); the doubling scan against the sequential
recurrence within 1e-6; the RG-LRU scan within rtol = atol = 1e-4
(float32, with and without ``h0``, lengths that are and are not powers of
two): torch's ``exp`` and XLA's differ by an ulp, and where ``a`` lies
within a few ulps of 1 (``a ** 8`` up to 0.999) ``sqrt(1 - a * a)`` turns
that ulp into a relative error of up to 1e-3 in ``b``, which the scan
then sums, besides summing in another order than
``lax.associative_scan``; the block with its state within 1e-4, the
state written in place.
In bfloat16 the carried state is what the reference carries: ``h`` and
the conv window rounded to bf16, held exactly in the port's float32
buffers.  recurrentgemma-2b's ``reduce_for_smoke`` forward, and prefill
plus decode, within rtol = atol = 1e-4 of the reference, at 5 layers (a
group and the remainder group), with prompts past the reduced local
window (32), so the window masks."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.configs import reduce_for_smoke as ref_reduce
from repro.models import model as ref_model
from repro.models import rglru as ref_rg
from repro.models import transformer as ref_tf
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models import model as pt_model
from repro_torch.models import rglru as rg
from repro_torch.models.convert import FLOAT32_LEAVES, params_from_numpy

NAME = "recurrentgemma-2b"
CPU = "cpu"
#: float32 tolerance of the RG-LRU scan against the reference (see above)
SCAN_TOL = 1e-4


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _block_params(rng, D, R, W):
    u = rng.uniform(0.9, 0.999, R)
    uc = u ** (1 / rg.C_FACTOR)
    p = {"w_in": rng.standard_normal((D, R)) / np.sqrt(D),
         "w_gate_br": rng.standard_normal((D, R)) / np.sqrt(D),
         "conv_k": rng.standard_normal((W, R)) / np.sqrt(W),
         "conv_b": rng.standard_normal(R) / 10,
         "gate_wr": rng.standard_normal(R), "gate_br": rng.standard_normal(R) / 10,
         "gate_wi": rng.standard_normal(R), "gate_bi": rng.standard_normal(R) / 10,
         "lam": np.log(uc / (1 - uc)),
         "w_out": rng.standard_normal((R, D)) / np.sqrt(R)}
    return {k: v.astype(np.float32) for k, v in p.items()}


@pytest.fixture(scope="module")
def model():
    """The reduced config at 5 layers: one (rglru, rglru, local) group and
    the (rglru, rglru) remainder, as the full config's 26 = 8 x 3 + 2."""
    ref_cfg = dataclasses.replace(ref_reduce(ref_get_config(NAME)), n_layers=5)
    ref_params = ref_model.init_model(jax.random.PRNGKey(4), ref_cfg)
    cfg = dataclasses.replace(reduce_for_smoke(get_config(NAME)), n_layers=5)
    return (ref_cfg, ref_params, cfg,
            params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg, CPU))


# ---------------------------------------------------------------- the block's parts

@pytest.mark.parametrize("with_state", [False, True], ids=["zero-context", "state"])
def test_depthwise_conv_matches_the_reference(with_state):
    rng = np.random.default_rng(1)
    u = rng.standard_normal((2, 9, 12)).astype(np.float32)
    kern = rng.standard_normal((4, 12)).astype(np.float32)
    bias = rng.standard_normal(12).astype(np.float32)
    state = rng.standard_normal((2, 3, 12)).astype(np.float32) if with_state else None
    want, want_st = ref_rg._depthwise_causal_conv(
        jnp.asarray(u), jnp.asarray(kern), jnp.asarray(bias),
        None if state is None else jnp.asarray(state))
    got, got_st = rg._depthwise_causal_conv(_t(u), _t(kern), _t(bias),
                                            None if state is None else _t(state))
    _close(got, want, 1e-6)
    _close(got_st, want_st, 0)


@pytest.mark.parametrize("S", [1, 2, 7, 64, 100])
@pytest.mark.parametrize("with_h0", [False, True], ids=["no-h0", "h0"])
def test_scan_matches_the_reference(S, with_h0):
    rng = np.random.default_rng(S)
    R = 24
    p = _block_params(rng, 8, R, 4)
    u = (rng.standard_normal((2, S, R)) * 2).astype(np.float32)
    h0 = rng.standard_normal((2, R)).astype(np.float32) if with_h0 else None
    want = ref_rg._rglru_scan(jnp.asarray(u), {k: jnp.asarray(v) for k, v in p.items()},
                              None if h0 is None else jnp.asarray(h0))
    got = rg._rglru_scan(_t(u), {k: _t(v) for k, v in p.items()},
                         None if h0 is None else _t(h0))
    assert got.shape == (2, S, R) and got.dtype == torch.float32
    _close(got, want, SCAN_TOL)


def test_linear_scan_is_the_recurrence():
    """The doubling scan against the sequential loop h_t = a_t h_{t-1} + b_t."""
    rng = np.random.default_rng(2)
    a = _t(rng.uniform(0, 1, (3, 37, 5)).astype(np.float32))
    b = _t(rng.standard_normal((3, 37, 5)).astype(np.float32))
    want = torch.zeros_like(b)
    h = torch.zeros_like(b[:, 0])
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        want[:, t] = h
    _close(rg._linear_scan(a, b), want, 1e-6)


@pytest.mark.parametrize("S", [1, 11])
def test_block_with_state_matches_the_reference(S):
    rng = np.random.default_rng(3)
    D, R, W = 16, 20, 4
    p = _block_params(rng, D, R, W)
    x = rng.standard_normal((2, S, D)).astype(np.float32)
    st = {"h": rng.standard_normal((2, R)).astype(np.float32),
          "conv": rng.standard_normal((2, W - 1, R)).astype(np.float32)}
    want, want_st = ref_rg.apply_rglru_block({k: jnp.asarray(v) for k, v in p.items()},
                                             jnp.asarray(x),
                                             {k: jnp.asarray(v) for k, v in st.items()})
    state = {k: _t(v.copy()) for k, v in st.items()}
    buffers = {k: v.data_ptr() for k, v in state.items()}
    got, got_st = rg.apply_rglru_block({k: _t(v) for k, v in p.items()}, _t(x), state)
    _close(got, want, SCAN_TOL)
    assert got_st is state and {k: v.data_ptr() for k, v in state.items()} == buffers
    _close(state["h"], want_st["h"], SCAN_TOL)
    _close(state["conv"], want_st["conv"], 0)
    # no state: nothing carried
    y, none = rg.apply_rglru_block({k: _t(v) for k, v in p.items()}, _t(x))
    assert none is None
    _close(y, ref_rg.apply_rglru_block({k: jnp.asarray(v) for k, v in p.items()},
                                       jnp.asarray(x))[0], SCAN_TOL)


def test_bf16_state_is_carried_rounded():
    """In bf16 the reference carries ``h`` and the conv window in bf16; the
    port's float32 buffers hold exactly those rounded values."""
    rng = np.random.default_rng(5)
    D, R, W = 16, 20, 4
    p = _block_params(rng, D, R, W)
    bf = {k: _t(v).to(torch.float32 if k in FLOAT32_LEAVES else torch.bfloat16)
          for k, v in p.items()}
    x = _t(rng.standard_normal((2, 9, D)).astype(np.float32)).to(torch.bfloat16)
    state = rg.init_rglru_state(2, R, W, torch.float32, device=CPU)
    rg.apply_rglru_block(bf, x, state)
    assert state["h"].dtype == torch.float32
    for v in state.values():
        assert torch.equal(v, v.to(torch.bfloat16).to(torch.float32))
    # the values are the reference's bf16 ones (within a bf16 step: the scans
    # sum in other orders)
    jp = {k: jnp.asarray(v.float().numpy()).astype(
        jnp.float32 if k in FLOAT32_LEAVES else jnp.bfloat16) for k, v in bf.items()}
    _, ref_st = ref_rg.apply_rglru_block(
        jp, jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
        ref_rg.init_rglru_state(2, R, W, jnp.float32))
    assert ref_st["h"].dtype == jnp.bfloat16 and ref_st["conv"].dtype == jnp.bfloat16
    _close(state["h"], np.asarray(ref_st["h"], np.float32), 2e-2)
    _close(state["conv"], np.asarray(ref_st["conv"], np.float32), 0)


# ---------------------------------------------------------------- whole model

def test_init_keys_kinds_and_count_as_the_reference(model):
    ref_cfg, ref_params, cfg, _ = model
    params = pt_model.init_model(cfg, seed=1, device=CPU)
    assert pt_model.count_params(params) == ref_model.count_params(ref_params)
    assert sorted(params.keys()) == sorted(ref_params)
    for name in ("b0", "b1", "b2"):
        assert sorted(params["groups"][0][name].keys()) == sorted(
            ref_params["groups"][name])
    assert sorted(params["rem"].keys()) == sorted(ref_params["rem"]) == ["b0", "b1"]
    assert "rglru" in params["rem"]["b1"] and "attn" in params["groups"][0]["b2"]
    bf = pt_model.init_model(dataclasses.replace(cfg, param_dtype="bfloat16"), device=CPU)
    blk = bf["groups"][0]["b0"]["rglru"]
    assert all(blk[k].dtype == torch.float32 for k in ("gate_wr", "gate_bi", "lam"))
    assert blk["w_in"].dtype == torch.bfloat16
    cache = pt_model.init_cache(cfg, 2, 16, device=CPU)
    assert set(cache["groups"][0]["b0"]) == {"rg"} and set(cache["rem"]["b1"]) == {"rg"}
    assert cache["groups"][0]["b0"]["rg"]["h"].dtype == torch.float32
    assert cache["groups"][0]["b2"]["kv"]["k"].shape == (2, 16, cfg.n_kv_heads, cfg.hd)


@pytest.mark.parametrize("impl", ["flash", "naive"])
def test_forward_logits_match_the_reference(model, impl):
    ref_cfg, ref_params, cfg, params = model
    tok = np.random.default_rng(6).integers(0, cfg.vocab, size=(2, 45)).astype(np.int32)
    rc, pc = (dataclasses.replace(c, attn_impl=impl) for c in (ref_cfg, cfg))
    want, _, waux = ref_tf.apply_model(ref_params, rc, jnp.asarray(tok))
    got, _, aux = pt_model.apply_model(params, pc, _t(tok))
    _close(got, want, 1e-4)
    assert float(aux) == float(waux) == 0.0


def test_prefill_and_decode_match_the_reference_and_the_forward(model):
    ref_cfg, ref_params, cfg, params = model
    S, split = 45, 38          # past the reduced local window (32)
    tok = np.random.default_rng(8).integers(0, cfg.vocab, size=(2, S)).astype(np.int32)
    full = pt_model.forward_logits(params, cfg, {"tokens": _t(tok)})
    want, ref_cache = ref_model.prefill(ref_params, ref_cfg,
                                        {"tokens": jnp.asarray(tok[:, :split])}, max_len=S)
    got, cache = pt_model.prefill(params, cfg, {"tokens": _t(tok[:, :split])}, max_len=S)
    _close(got, want, 1e-4)
    _close(got, full[:, split - 1], 1e-4)
    h = cache["groups"][0]["b0"]["rg"]["h"]
    for t in range(split, S):
        want, ref_cache = ref_model.decode_step(ref_params, ref_cfg,
                                                jnp.asarray(tok[:, t:t + 1]), ref_cache,
                                                jnp.int32(t))
        got, cache = pt_model.decode_step(params, cfg, _t(tok[:, t:t + 1]), cache, t)
        _close(got, want, 1e-4)
        _close(got, full[:, t], 1e-4)
    assert cache["groups"][0]["b0"]["rg"]["h"] is h           # written in place
    _close(h, ref_cache["groups"]["b0"]["rg"]["h"][0], 1e-4)
    _close(cache["rem"]["b1"]["rg"]["conv"], ref_cache["rem"]["b1"]["rg"]["conv"], 1e-4)
