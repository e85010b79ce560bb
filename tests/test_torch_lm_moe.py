"""The port's MoE layer and MoE decoders against the JAX package's, on the CPU.

The same numpy inputs (from a seed) go through the reference's functions
and the port's, in float32.  The routing plan equals the reference's
``_route_row`` row by row: ``slot_src`` (which pair each expert slot
takes, and so every capacity drop) exactly; ``slot_gate`` and the aux loss
within 1e-6 (the softmax's ``exp`` rounds apart by an ulp or two).  Ties
go to the lower expert index, as ``jax.lax.top_k``.  ``apply_moe`` within
1e-5; its combine sums a token's terms in ascending slot order, bit for
bit a sequential scatter-add in slot order.  Moonlight's and Mixtral's
``reduce_for_smoke`` forward logits and aux loss, and prefill plus
decode, within rtol = atol = 1e-4 of the reference (weights carried by
``params_from_numpy``, the router in float32)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.configs import reduce_for_smoke as ref_reduce
from repro.models import model as ref_model
from repro.models import moe as ref_moe
from repro.models import transformer as ref_tf
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models import model as pt_model
from repro_torch.models import moe
from repro_torch.models.convert import FLOAT32_LEAVES, params_from_numpy

MOE = ["moonshot-v1-16b-a3b", "mixtral-8x7b"]
CPU = "cpu"


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _ref_plan(x, router, E, k, cap):
    rows = [ref_moe._route_row(jnp.asarray(x[b]), jnp.asarray(router), E, k, cap)
            for b in range(x.shape[0])]
    return tuple(np.stack([np.asarray(r[i]) for r in rows]) for i in range(3))


@pytest.fixture(scope="module")
def models():
    out = {}
    for name in MOE:
        ref_cfg = ref_reduce(ref_get_config(name))
        ref_params = ref_model.init_model(jax.random.PRNGKey(2), ref_cfg)
        cfg = reduce_for_smoke(get_config(name))
        out[name] = (ref_cfg, ref_params, cfg,
                     params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg, CPU))
    return out


# ---------------------------------------------------------------- routing

@pytest.mark.parametrize("cf", [1.25, 0.2, 8.0], ids=["cf1.25", "cf0.2-drops-most",
                                                     "cf8-no-drop"])
@pytest.mark.parametrize("B,S,D,E,k", [(3, 37, 32, 8, 2), (2, 64, 48, 64, 6),
                                       (2, 1, 32, 64, 6)],
                         ids=["mixtral-like", "moonlight-like", "decode-row"])
def test_routing_plan_matches_the_reference(B, S, D, E, k, cf):
    rng = np.random.default_rng(S + E)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    router = (rng.standard_normal((D, E)) / np.sqrt(D)).astype(np.float32)
    cap = moe.capacity(cf, S, k, E)
    src, gate, aux = _ref_plan(x, router, E, k, cap)
    got = moe.route(_t(x), _t(router), E, k, cap)
    assert got.slot_src.shape == (B, E * cap)
    np.testing.assert_array_equal(got.slot_src.numpy(), src)
    _close(got.slot_gate, gate, 1e-6)
    _close(got.aux, aux, 1e-6)
    # the inverse map: every kept pair's slot reads its own token
    key = got.slot_key.numpy()
    kept = key < E * cap
    tok = np.repeat(np.arange(S), k)[None].repeat(B, 0)
    for b in range(B):
        assert (src[b][key[b][kept[b]]] == tok[b][kept[b]]).all()
    if cf == 0.2 and S > 1:
        assert (~kept).mean() > 0.5        # most pairs dropped, as the reference
    if cf == 8.0:
        assert kept.all()


def test_routing_ties_take_the_lower_expert():
    """Duplicate router columns give exactly tied probabilities: the lower
    expert index wins, as ``jax.lax.top_k``."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 24, 16)).astype(np.float32)
    base = rng.standard_normal((16, 4)).astype(np.float32) / 4
    router = np.concatenate([base, base], axis=1)        # experts e and e + 4 tie
    src, gate, aux = _ref_plan(x, router, 8, 3, 9)
    got = moe.route(_t(x), _t(router), 8, 3, 9)
    np.testing.assert_array_equal(got.slot_src.numpy(), src)
    _close(got.slot_gate, gate, 1e-6)


@pytest.mark.parametrize("S,cap", [(1, 1), (128, 15), (512, 60)])
def test_capacity_as_the_reference(S, cap):
    cfg = get_config("moonshot-v1-16b-a3b")
    assert moe.capacity(cfg.capacity_factor, S, cfg.topk_experts, cfg.n_experts) == cap
    assert cap == max(1, int(cfg.capacity_factor * S * cfg.topk_experts / cfg.n_experts))


# ---------------------------------------------------------------- apply_moe

def _moe_params(rng, D, F, E, mlp):
    p = {"router": rng.standard_normal((D, E)) / np.sqrt(D),
         "w_in": rng.standard_normal((E, D, F)) / np.sqrt(D),
         "w_out": rng.standard_normal((E, F, D)) / np.sqrt(F)}
    if mlp != "gelu":
        p["w_gate"] = rng.standard_normal((E, D, F)) / np.sqrt(D)
    return {k_: v.astype(np.float32) for k_, v in p.items()}


@pytest.mark.parametrize("mlp", ["swiglu", "geglu", "gelu"])
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_apply_moe_matches_the_reference(mlp, cf):
    rng = np.random.default_rng(7)
    B, S, D, F, E, k = 2, 40, 32, 24, 8, 2
    p = _moe_params(rng, D, F, E, mlp)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    kw = dict(n_experts=E, topk=k, capacity_factor=cf, mlp=mlp)
    want, waux = ref_moe.apply_moe({n: jnp.asarray(v) for n, v in p.items()},
                                   jnp.asarray(x), **kw)
    got, aux = moe.apply_moe({n: _t(v) for n, v in p.items()}, _t(x), **kw)
    assert got.dtype == torch.float32 and got.shape == (B, S, D)
    _close(got, want, 1e-5)
    _close(aux, waux, 1e-6)


def test_combine_sums_in_slot_order():
    """A token's terms are added in ascending slot order, from zero, in the
    output's dtype: bit for bit a sequential scatter-add over the slots."""
    rng = np.random.default_rng(11)
    B, S, D, F, E, k = 2, 30, 16, 8, 8, 3
    p = _moe_params(rng, D, F, E, "swiglu")
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    tp = {n: _t(v) for n, v in p.items()}
    got, _ = moe.apply_moe(tp, _t(x), n_experts=E, topk=k, capacity_factor=1.0,
                           mlp="swiglu")
    cap = moe.capacity(1.0, S, k, E)
    plan = moe.route(_t(x), tp["router"], E, k, cap)
    xs = torch.cat([_t(x), torch.zeros((B, 1, D))], 1)
    want = np.zeros((B, S + 1, D), np.float32)
    for b in range(B):
        buf = xs[b][plan.slot_src[b]].reshape(E, cap, D)
        h = torch.nn.functional.silu(buf @ tp["w_gate"]) * (buf @ tp["w_in"])
        y = ((h @ tp["w_out"]).reshape(E * cap, D)
             * plan.slot_gate[b][:, None]).numpy()
        for slot in range(E * cap):                   # ascending slots
            want[b, int(plan.slot_src[b, slot])] += y[slot]
    np.testing.assert_array_equal(got.numpy(), want[:, :S])


def test_float32_leaves_stay_float32(models):
    """A bf16 model keeps the router in float32, as the reference does."""
    ref_cfg, ref_params, cfg, _ = models["moonshot-v1-16b-a3b"]
    bf = dataclasses.replace(cfg, param_dtype="bfloat16", compute_dtype="bfloat16")
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), bf, CPU)
    for name, prm in params.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        assert prm.dtype == (torch.float32 if leaf in FLOAT32_LEAVES else torch.bfloat16)
    assert params["groups"][0]["b0"]["moe"]["w_in"].shape == (
        cfg.n_experts, cfg.d_model, cfg.d_ff)
    init = pt_model.init_model(bf, device=CPU)
    assert init["groups"][0]["b0"]["moe"]["router"].dtype == torch.float32
    assert init["groups"][0]["b0"]["moe"]["w_in"].dtype == torch.bfloat16


# ---------------------------------------------------------------- whole model

@pytest.mark.parametrize("name", MOE)
def test_init_keys_and_count_as_the_reference(models, name):
    ref_cfg, ref_params, cfg, _ = models[name]
    params = pt_model.init_model(cfg, seed=1, device=CPU)
    assert pt_model.count_params(params) == ref_model.count_params(ref_params)
    assert sorted(params["groups"][0]["b0"].keys()) == sorted(ref_params["groups"]["b0"])
    assert sorted(params["groups"][0]["b0"]["moe"].keys()) == sorted(
        ref_params["groups"]["b0"]["moe"])


@pytest.mark.parametrize("name", MOE)
def test_forward_logits_and_aux_match_the_reference(models, name):
    ref_cfg, ref_params, cfg, params = models[name]
    tok = np.random.default_rng(5).integers(0, cfg.vocab, size=(2, 44)).astype(np.int32)
    want, _, waux = ref_tf.apply_model(ref_params, ref_cfg, jnp.asarray(tok))
    got, _, aux = pt_model.apply_model(params, cfg, _t(tok))
    _close(got, want, 1e-4)
    _close(aux, waux, 1e-5)
    assert float(aux) > 0
    _close(pt_model.forward_logits(params, cfg, {"tokens": _t(tok)}),
           ref_model.forward_logits(ref_params, ref_cfg, {"tokens": jnp.asarray(tok)}),
           1e-4)


@pytest.mark.parametrize("name", MOE)
def test_prefill_and_decode_match_the_reference_and_the_forward(models, name):
    ref_cfg, ref_params, cfg, params = models[name]
    S, split = 44, 36          # past Mixtral's reduced sliding window (32)
    tok = np.random.default_rng(9).integers(0, cfg.vocab, size=(2, S)).astype(np.int32)
    full = pt_model.forward_logits(params, cfg, {"tokens": _t(tok)})
    want, ref_cache = ref_model.prefill(ref_params, ref_cfg,
                                        {"tokens": jnp.asarray(tok[:, :split])}, max_len=S)
    got, cache = pt_model.prefill(params, cfg, {"tokens": _t(tok[:, :split])}, max_len=S)
    _close(got, want, 1e-4)
    _close(got, full[:, split - 1], 1e-4)
    for t in range(split, S):
        want, ref_cache = ref_model.decode_step(ref_params, ref_cfg,
                                                jnp.asarray(tok[:, t:t + 1]), ref_cache,
                                                jnp.int32(t))
        got, cache = pt_model.decode_step(params, cfg, _t(tok[:, t:t + 1]), cache, t)
        _close(got, want, 1e-4)
        _close(got, full[:, t], 1e-4)
