"""The port's RWKV6 blocks and rwkv6-1.6b against the JAX package's, on
the CPU.

The same numpy inputs (from a seed) go through the reference's functions
and the port's, in float32, the weights carried by ``params_from_numpy``,
within rtol = atol = 1e-4 (the figure of ``test_torch_lm_hybrid.py``):
the chunked recurrence sums in another order than the reference's
``lax.scan``.  The time mix (its output, the final state ``s`` and
``x_prev``, written in place) at S below, at and past the chunk (1, 5, 16
and 2 x 16 + 3), with and without state; the channel mix; a strong decay
(``w0`` raised so that log w is about -50 a step: a factored form would
overflow) that must stay finite and equal the reference; a weak decay (w
about 0.998) at S = 300.  The chunked recurrence against the step-by-step
plain version ``wkv_scan_torch`` within 1e-4 of the output's largest
magnitude (its outputs sum up to S terms).  The reduced rwkv6-1.6b: keys,
float32 leaves and parameter count, ``forward_logits`` under both
``attn_impl`` values, prefill plus decode against the reference and the
forward, and ``ServingEngine`` outputs equal to the reference engine's;
a prefill runs the chunked form and never the step loop."""
import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.configs import reduce_for_smoke as ref_reduce
from repro.models import model as ref_model
from repro.models import rwkv6 as ref_rw
from repro.serving import engine as ref_engine
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models import model as pt_model
from repro_torch.models import rwkv6 as rw
from repro_torch.models.convert import FLOAT32_LEAVES, params_from_numpy
from repro_torch.serving import Request, ServingEngine

NAME = "rwkv6-1.6b"
CPU = "cpu"
TOL = 1e-4
D, HD = 64, 16


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _t(a):
    return torch.from_numpy(np.array(a))


def _time_params(seed, w0=None):
    p = jax.tree.map(np.asarray, ref_rw.init_rwkv_time_mix(
        jax.random.PRNGKey(seed), D, HD, jnp.float32))
    if w0 is not None:
        p["w0"] = np.full_like(p["w0"], w0)
    return p


def _state(rng, B):
    return {"s": rng.standard_normal((B, D // HD, HD, HD)).astype(np.float32),
            "x_prev": rng.standard_normal((B, D)).astype(np.float32)}


def _time_mix_both(p, x, st):
    want, want_st = ref_rw.apply_rwkv_time_mix(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), HD,
        None if st is None else {k: jnp.asarray(v) for k, v in st.items()})
    state = None if st is None else {k: _t(v) for k, v in st.items()}
    got, got_st = rw.apply_rwkv_time_mix({k: _t(v) for k, v in p.items()}, _t(x), HD, state)
    return want, want_st, got, got_st, state


@pytest.fixture(scope="module")
def model():
    ref_cfg = ref_reduce(ref_get_config(NAME))
    ref_params = ref_model.init_model(jax.random.PRNGKey(5), ref_cfg)
    cfg = reduce_for_smoke(get_config(NAME))
    return (ref_cfg, ref_params, cfg,
            params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg, CPU))


# ---------------------------------------------------------------- the blocks

@pytest.mark.parametrize("S", [1, 5, rw.CHUNK, 2 * rw.CHUNK + 3])
@pytest.mark.parametrize("with_state", [False, True], ids=["no-state", "state"])
def test_time_mix_matches_the_reference(S, with_state):
    rng = np.random.default_rng(S)
    p = _time_params(S)
    x = rng.standard_normal((2, S, D)).astype(np.float32)
    st = _state(rng, 2) if with_state else None
    want, want_st, got, got_st, state = _time_mix_both(p, x, st)
    assert got.shape == (2, S, D)
    _close(got, want)
    if not with_state:
        assert got_st is None and want_st is None
        return
    buffers = {k: v.data_ptr() for k, v in state.items()}
    assert got_st is state and {k: v.data_ptr() for k, v in state.items()} == buffers
    _close(state["s"], want_st["s"])
    _close(state["x_prev"], want_st["x_prev"], 0)


@pytest.mark.parametrize("with_state", [False, True], ids=["no-state", "state"])
def test_channel_mix_matches_the_reference(with_state):
    rng = np.random.default_rng(7)
    p = jax.tree.map(np.asarray, ref_rw.init_rwkv_channel_mix(
        jax.random.PRNGKey(7), D, 96, jnp.float32))
    x = rng.standard_normal((2, 9, D)).astype(np.float32)
    st = {"x_prev": rng.standard_normal((2, D)).astype(np.float32)} if with_state else None
    want, want_st = ref_rw.apply_rwkv_channel_mix(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        None if st is None else {"x_prev": jnp.asarray(st["x_prev"])})
    state = None if st is None else {"x_prev": _t(st["x_prev"])}
    got, got_st = rw.apply_rwkv_channel_mix({k: _t(v) for k, v in p.items()}, _t(x), state)
    _close(got, want, 1e-5)
    if with_state:
        assert got_st is state
        _close(state["x_prev"], want_st["x_prev"], 0)


@pytest.mark.parametrize("with_state", [False, True], ids=["no-state", "state"])
def test_strong_decay_stays_finite_and_matches_the_reference(with_state):
    """w0 = log 50, so log w = -50 exp(lora) (median about -50) every step:
    a form dividing by a cumulative decay overflows at the second step."""
    rng = np.random.default_rng(11)
    p = _time_params(11, w0=math.log(50.0))
    x = rng.standard_normal((2, 2 * rw.CHUNK + 3, D)).astype(np.float32)
    zw = x + p["mu"][4] * (np.concatenate([np.zeros((2, 1, D), np.float32), x[:, :-1]], 1)
                           - x)
    log_w = -np.exp(p["w0"] + np.tanh(zw @ p["w_lora_a"]) @ p["w_lora_b"])
    assert -60 < np.median(log_w) < -40
    st = _state(rng, 2) if with_state else None
    want, want_st, got, _, state = _time_mix_both(p, x, st)
    assert bool(torch.isfinite(got).all())
    _close(got, want)
    if with_state:
        assert bool(torch.isfinite(state["s"]).all())
        _close(state["s"], want_st["s"])


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("S", [rw.CHUNK + 1, 3 * rw.CHUNK + 5])
def test_chunked_gradients_at_decays_down_to_103_match_the_step_scan(S):
    """log w spread from -1e-3 down to -103 (the random init's deepest, as
    the card met it in rwkv6-1.6b's layer 0), one channel at -103 every
    step: exp(-103) is a float32 denormal and every product of two such
    decays underflows to 0.  ``wkv_chunked``'s gradients for r, k, v,
    log w and u, through the output and the final state, are finite and
    within a relative L2 of 1e-4 (a leaf) of ``wkv_scan_torch``'s under
    autograd, with w = exp(log w) in its graph."""
    rng = np.random.default_rng(100 + S)
    B, H, K = 2, 3, 8
    r, k, v = (rng.standard_normal((B, S, H, K)).astype(np.float32) for _ in range(3))
    lw = -np.exp(rng.uniform(math.log(1e-3), math.log(103.0), size=(B, S, H, K)))
    lw[..., 0] = -103.0
    u = (0.5 * rng.standard_normal((H, K))).astype(np.float32)
    d_o = rng.standard_normal((B, S, H, K)).astype(np.float32)
    d_s = rng.standard_normal((B, H, K, K)).astype(np.float32)
    grads = {}
    for form in ("chunked", "step"):
        leaves = [_t(a).requires_grad_(True) for a in (r, k, v, lw.astype(np.float32), u)]
        if form == "chunked":
            o, s = rw.wkv_chunked(*leaves)
        else:
            o, s = rw.wkv_scan_torch(*leaves[:3], torch.exp(leaves[3]), leaves[4])
        loss = (o * _t(d_o)).sum() + (s * _t(d_s)).sum()
        grads[form] = torch.autograd.grad(loss, leaves)
    for name, got, want in zip(("r", "k", "v", "log_w", "u"), grads["chunked"],
                               grads["step"]):
        assert bool(torch.isfinite(got).all()), name
        assert _rel_l2(got, want) <= TOL, (name, _rel_l2(got, want))


def test_time_mix_gradients_at_strong_decays_match_the_reference():
    """w0 = log 50, so log w reaches past -103: the time mix's gradients
    for x and every parameter (``jax.grad`` of the reference's ``lax.scan``
    against autograd through ``wkv_chunked``), finite and within a
    relative L2 of 1e-4 a leaf."""
    rng = np.random.default_rng(13)
    p = _time_params(13, w0=math.log(50.0))
    x = rng.standard_normal((2, 2 * rw.CHUNK + 3, D)).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    zw = x + p["mu"][4] * (np.concatenate([np.zeros((2, 1, D), np.float32), x[:, :-1]], 1)
                           - x)
    assert (-np.exp(p["w0"] + np.tanh(zw @ p["w_lora_a"]) @ p["w_lora_b"])).min() < -103

    def ref_loss(params, xx):
        return (ref_rw.apply_rwkv_time_mix(params, xx, HD, None)[0] * dy).sum()

    want_p, want_x = jax.grad(ref_loss, argnums=(0, 1))(
        {name: jnp.asarray(a) for name, a in p.items()}, jnp.asarray(x))
    tp = {name: _t(a).requires_grad_(True) for name, a in p.items()}
    tx = _t(x).requires_grad_(True)
    y, _ = rw.apply_rwkv_time_mix(tp, tx, HD, None)
    got = torch.autograd.grad((y * _t(dy)).sum(), [tx, *tp.values()])
    for name, g, w in zip(["x", *tp], got, [want_x, *(want_p[n] for n in tp)]):
        assert bool(torch.isfinite(g).all()), name
        assert _rel_l2(g, w) <= TOL, (name, _rel_l2(g, w))


def test_weak_decay_long_sequence_matches_the_reference():
    """w0 = log(-log 0.998) with the LoRA off: w = 0.998 every step, so the
    state keeps nearly every one of S = 300 steps."""
    rng = np.random.default_rng(12)
    p = _time_params(12, w0=math.log(-math.log(0.998)))
    p["w_lora_b"] = np.zeros_like(p["w_lora_b"])
    x = rng.standard_normal((1, 300, D)).astype(np.float32)
    st = _state(rng, 1)
    want, want_st, got, _, state = _time_mix_both(p, x, st)
    _close(got, want)
    _close(state["s"], want_st["s"], 1e-4 * float(np.abs(want_st["s"]).max()))


@pytest.mark.parametrize("decay", ["random", "strong", "weak"])
@pytest.mark.parametrize("S", [2, rw.CHUNK - 1, rw.CHUNK, rw.CHUNK + 1, 2 * rw.CHUNK + 3, 70])
def test_chunked_matches_the_step_scan(S, decay):
    rng = np.random.default_rng(S)
    B, H, K = 2, 3, 8
    r, k, v = (_t(rng.standard_normal((B, S, H, K)).astype(np.float32)) for _ in range(3))
    lw = {"random": -np.exp(rng.standard_normal((B, S, H, K))),
          "strong": -50 * np.exp(0.3 * rng.standard_normal((B, S, H, K))),
          "weak": np.full((B, S, H, K), math.log(0.998))}[decay]
    lw = _t(lw.astype(np.float32))
    u = _t((0.5 * rng.standard_normal((H, K))).astype(np.float32))
    for s0 in (None, _t(rng.standard_normal((B, H, K, K)).astype(np.float32))):
        want, want_s = rw.wkv_scan_torch(r, k, v, torch.exp(lw), u, s0)
        got, got_s = rw.wkv_chunked(r, k, v, lw, u, s0)
        assert bool(torch.isfinite(got).all()) and bool(torch.isfinite(got_s).all())
        _close(got, want, TOL * float(want.abs().max()))
        _close(got_s, want_s, TOL * float(want_s.abs().max()))


def test_init_states_and_float32_leaves():
    cfg = dataclasses.replace(reduce_for_smoke(get_config(NAME)), param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    params = pt_model.init_model(cfg, device=CPU)
    blk = params["groups"][0]["b0"]
    for mix, names in (("time", ("mu", "w0", "w_lora_a", "w_lora_b", "u", "ln_scale")),
                       ("chan", ("mu",))):
        assert all(blk[mix][n].dtype == torch.float32 for n in names)
        assert set(names) <= FLOAT32_LEAVES
    assert blk["time"]["wr"].dtype == torch.bfloat16
    a = pt_model.init_cache(cfg, 2, 16, device=CPU)
    b = pt_model.init_cache(cfg, 2, 4096, device=CPU)
    rws = a["groups"][0]["b0"]["rw"]
    assert rws["time"]["s"].shape == (2, cfg.d_model // HD, HD, HD)
    assert rws["time"]["s"].dtype == torch.float32
    assert rws["time"]["x_prev"].dtype == rws["chan"]["x_prev"].dtype == torch.bfloat16
    assert jax.tree.map(lambda t: t.shape, a) == jax.tree.map(lambda t: t.shape, b)
    # bf16 forward with state: the cache keeps its dtypes, values finite
    tok = torch.from_numpy(np.arange(10, dtype=np.int32).reshape(2, 5))
    logits, cache = pt_model.prefill(params, cfg, {"tokens": tok}, max_len=8)
    assert bool(torch.isfinite(logits).all())
    assert cache["groups"][0]["b0"]["rw"]["time"]["s"].dtype == torch.float32


# ---------------------------------------------------------------- whole model

def test_keys_kinds_and_count_as_the_reference(model):
    ref_cfg, ref_params, cfg, params = model
    fresh = pt_model.init_model(cfg, seed=1, device=CPU)
    assert pt_model.count_params(fresh) == ref_model.count_params(ref_params)
    assert sorted(fresh.keys()) == sorted(ref_params) == sorted(params.keys())
    assert len(fresh["groups"]) == cfg.n_layers
    blk, ref_blk = fresh["groups"][0]["b0"], ref_params["groups"]["b0"]
    assert sorted(blk.keys()) == sorted(ref_blk) == ["chan", "norm1", "norm2", "time"]
    for mix in ("time", "chan"):
        assert sorted(blk[mix].keys()) == sorted(ref_blk[mix])
        for k, v in blk[mix].items():
            assert tuple(v.shape) == ref_blk[mix][k].shape[1:]
    cache, ref_cache = pt_model.init_cache(cfg, 2, 16, device=CPU), \
        ref_model.init_cache(ref_cfg, 2, 16)
    assert jax.tree.map(lambda t: tuple(t.shape), cache["groups"][0]) == jax.tree.map(
        lambda a: a.shape[1:], ref_cache["groups"])


@pytest.mark.parametrize("impl", ["flash", "naive"])
def test_forward_logits_match_the_reference(model, impl):
    ref_cfg, ref_params, cfg, params = model
    rc, pc = (dataclasses.replace(c, attn_impl=impl) for c in (ref_cfg, cfg))
    inputs = pt_model.make_inputs(pc, 2, 40, seed=3, device=CPU)
    assert set(inputs) == {"tokens", "labels"}
    want = ref_model.forward_logits(ref_params, rc, {"tokens": jnp.asarray(
        inputs["tokens"].numpy())})
    got = pt_model.forward_logits(params, pc, inputs)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    _close(got, want)


def test_prefill_and_decode_match_the_reference_and_the_forward(model, monkeypatch):
    ref_cfg, ref_params, cfg, params = model
    S, split = 41, 38            # the prompt past two chunks
    tok = np.random.default_rng(8).integers(0, cfg.vocab, size=(2, S)).astype(np.int32)
    full = pt_model.forward_logits(params, cfg, {"tokens": _t(tok)})

    chunked = []
    real = rw.wkv_chunked

    def spy(r, *a, **kw):
        chunked.append(r.shape[1])
        return real(r, *a, **kw)

    def refuse(*a, **kw):
        raise AssertionError("the step loop ran on the model's path")

    monkeypatch.setattr(rw, "wkv_chunked", spy)
    monkeypatch.setattr(rw, "wkv_scan_torch", refuse)
    want, ref_cache = ref_model.prefill(ref_params, ref_cfg,
                                        {"tokens": jnp.asarray(tok[:, :split])}, max_len=S)
    got, cache = pt_model.prefill(params, cfg, {"tokens": _t(tok[:, :split])}, max_len=S)
    assert chunked == [split] * cfg.n_layers
    _close(got, want)
    _close(got, full[:, split - 1])
    s = cache["groups"][0]["b0"]["rw"]["time"]["s"]
    for t in range(split, S):
        want, ref_cache = ref_model.decode_step(ref_params, ref_cfg,
                                                jnp.asarray(tok[:, t:t + 1]), ref_cache,
                                                jnp.int32(t))
        got, cache = pt_model.decode_step(params, cfg, _t(tok[:, t:t + 1]), cache, t)
        _close(got, want)
        _close(got, full[:, t])
    assert chunked == [split] * cfg.n_layers                  # decode: the step
    assert cache["groups"][0]["b0"]["rw"]["time"]["s"] is s   # written in place
    for g in range(cfg.n_layers):
        ours, ref = cache["groups"][g]["b0"]["rw"], ref_cache["groups"]["b0"]["rw"]
        _close(ours["time"]["s"], ref["time"]["s"][g])
        _close(ours["time"]["x_prev"], ref["time"]["x_prev"][g])
        _close(ours["chan"]["x_prev"], ref["chan"]["x_prev"][g])


def test_serving_outputs_equal_the_reference(model):
    ref_cfg, ref_params, cfg, params = model
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab, size=int(rng.integers(3, 40))).astype(np.int32)
               for _ in range(3)]

    def serve(eng, request_cls):
        for rid, p in enumerate(prompts):
            eng.submit(request_cls(rid=rid, prompt=p, max_new_tokens=4))
        done = []
        while eng.queue:
            done += eng.step_batch()
        return {r.rid: r.output for r in done}

    want = serve(ref_engine.ServingEngine(ref_cfg, batch_size=2, max_len=48,
                                          params=ref_params), ref_engine.Request)
    got = serve(ServingEngine(cfg, batch_size=2, max_len=48, device=CPU, params=params),
                Request)
    assert sorted(got) == list(range(3))
    assert got == want
