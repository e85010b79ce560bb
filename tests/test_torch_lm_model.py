"""The port's decoders against the JAX package's, on the CPU.

The same numpy inputs (from a seed) go through the reference's functions
and the port's, in float32 at ``reduce_for_smoke`` sizes, the weights
carried over by ``params_from_numpy``: the layers within 1e-6, the
attention core ``_flash_gqa`` and ``attention`` (a window, offset
positions, cross attention through ``memory=`` and ``kv_override=``)
within 1e-5, ``forward_logits``, ``prefill``
and ``decode_step`` within rtol = atol = 1e-4, and the port's flash path
against its naive one within 1e-3 (the reference test's figure).  The MoE
and hybrid configs (Mixtral, Moonlight, recurrentgemma) match the
reference's forward within 1e-4 too (their own files,
``test_torch_lm_moe.py`` and ``test_torch_lm_hybrid.py``, go further, as
``test_torch_lm_rwkv.py`` and ``test_torch_lm_whisper.py`` do for RWKV6
and Whisper); a block kind the port lacks raises
``NotImplementedError``.  K12's contract is
decided from host integers by ``k12_refusal``, tested here as a pure
function (no CUDA tensor can be made on the CPU): a window fits, a query
offset and masked keys do not."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.configs import reduce_for_smoke as ref_reduce
from repro.models import layers as ref_L
from repro.models import model as ref_model
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.kernels import flash_attention as pt_fa
from repro_torch.models import layers as L
from repro_torch.models import model as pt_model
from repro_torch.models.convert import params_from_numpy

DENSE = ["phi4-mini-3.8b", "gemma-2b", "deepseek-coder-33b", "starcoder2-7b",
         "internvl2-76b"]
MOE_HYBRID = ["mixtral-8x7b", "moonshot-v1-16b-a3b", "recurrentgemma-2b"]
CPU = "cpu"


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def models():
    """Reduced configs of both packages, the reference's parameters and the
    port's carried copy."""
    out = {}
    for name in DENSE:
        ref_cfg = ref_reduce(ref_get_config(name))
        ref_params = ref_model.init_model(jax.random.PRNGKey(0), ref_cfg)
        cfg = reduce_for_smoke(get_config(name))
        params = params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg, CPU)
        out[name] = (ref_cfg, ref_params, cfg, params)
    return out


def _inputs(cfg, batch, seq, seed):
    """Numpy inputs: tokens, and the vision prefix where the config has one."""
    rng = np.random.default_rng(seed)
    n_tok = seq - cfg.n_prefix_embeds
    out = {"tokens": rng.integers(0, cfg.vocab, size=(batch, n_tok)).astype(np.int32)}
    if cfg.frontend == "vision":
        out["prefix_embeds"] = rng.standard_normal(
            (batch, cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32)
    return out


def _both(inputs):
    return ({k: jnp.asarray(v) for k, v in inputs.items()},
            {k: _t(v) for k, v in inputs.items()})


# ---------------------------------------------------------------- layers

@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm(kind):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    p = {"scale": rng.standard_normal(64).astype(np.float32)}
    if kind == "layernorm":
        p["bias"] = rng.standard_normal(64).astype(np.float32)
    want = ref_L.apply_norm(kind, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    got = L.apply_norm(kind, {k: _t(v) for k, v in p.items()}, _t(x))
    _close(got, want, 1e-6)


def test_init_norm_keys():
    for kind in ("rmsnorm", "layernorm"):
        got = L.init_norm(kind, 8, torch.float32, device=CPU)
        want = ref_L.init_norm(kind, 8, jnp.float32)
        assert sorted(got.keys()) == sorted(want)
        for k in want:
            _close(got[k].detach(), want[k], 0)


def test_apply_rope():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = (np.arange(7)[None] + np.array([[0], [5]])).astype(np.int32)
    want = ref_L.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    got = L.apply_rope(_t(x), _t(pos), 10_000.0)
    _close(got, want, 1e-6)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_apply_mlp(kind):
    rng = np.random.default_rng(3)
    p = {"w_in": rng.standard_normal((64, 96)) / 8, "w_out": rng.standard_normal((96, 64)) / 10}
    if kind != "gelu":
        p["w_gate"] = rng.standard_normal((64, 96)) / 8
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    want = ref_L.apply_mlp(kind, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    got = L.apply_mlp(kind, {k: _t(v) for k, v in p.items()}, _t(x))
    _close(got, want, 1e-6)
    gen = torch.Generator().manual_seed(0)
    assert sorted(L.init_mlp(gen, kind, 64, 96, torch.float32).keys()) == sorted(p)


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_lm_logits(tied):
    rng = np.random.default_rng(4)
    emb = {"emb": (rng.standard_normal((512, 64))).astype(np.float32)}
    head = None if tied else {"w": (rng.standard_normal((64, 512)) / 8).astype(np.float32)}
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    want = ref_L.lm_logits(None if tied else {"w": jnp.asarray(head["w"])},
                           {"emb": jnp.asarray(emb["emb"])}, jnp.asarray(x))
    got = L.lm_logits(None if tied else {"w": _t(head["w"])}, {"emb": _t(emb["emb"])}, _t(x))
    _close(got, want, 1e-6)
    tok = rng.integers(0, 512, size=(2, 3)).astype(np.int32)
    _close(L.embed({"emb": _t(emb["emb"])}, _t(tok)),
           ref_L.embed({"emb": jnp.asarray(emb["emb"])}, jnp.asarray(tok)), 0)


# ---------------------------------------------------------------- _flash_gqa

FLASH_CASES = {
    # id: (B, S, T, KV, G, q_base, k_base, k_len, causal, window, q_chunk, k_chunk)
    "causal-mha": (2, 16, 16, 4, 1, 0, 0, 16, True, None, 8, 8),
    "noncausal-gqa2": (2, 16, 24, 2, 2, 0, 0, 24, False, None, 8, 8),
    "causal-gqa4-window": (1, 24, 24, 1, 4, 0, 0, 24, True, 5, 8, 8),
    "klen-below-T": (2, 8, 24, 2, 2, 8, 0, 16, True, None, 8, 8),
    "noncausal-klen": (1, 8, 16, 2, 1, 0, 0, 11, False, None, 8, 8),
    "bases": (2, 16, 16, 2, 2, 3, 3, 16, True, 6, 8, 8),
    "padded-S-T": (2, 13, 21, 2, 2, 0, 0, 21, True, None, 8, 8),
    "padded-klen-bases": (1, 10, 19, 1, 4, 9, 0, 17, True, None, 4, 8),
}


@pytest.mark.parametrize("case", list(FLASH_CASES), ids=list(FLASH_CASES))
def test_flash_gqa_matches_the_reference(case):
    B, S, T, KV, G, qb, kb, kl, causal, window, cq, ck = FLASH_CASES[case]
    hd = 16
    rng = np.random.default_rng(len(case))
    qg = rng.standard_normal((B, S, KV, G, hd)).astype(np.float32)
    k = rng.standard_normal((B, T, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, T, KV, hd)).astype(np.float32)
    bases = [np.full((B,), x, np.int32) for x in (qb, kb, kl)]
    kw = dict(causal=causal, window=window, scale=hd ** -0.5, q_chunk=cq, k_chunk=ck)
    want = ref_L._flash_gqa(jnp.asarray(qg), jnp.asarray(k), jnp.asarray(v),
                            *map(jnp.asarray, bases), **kw)
    got = L._flash_gqa(_t(qg), _t(k), _t(v), *map(_t, bases), **kw)
    assert got.shape == (B, S, KV, G, hd)
    _close(got, want, 1e-5)
    # host integers mean the same as (B,) tensors
    _close(L._flash_gqa(_t(qg), _t(k), _t(v), qb, kb, kl, **kw), got, 0)


@pytest.mark.parametrize("impl", ["naive", "flash"])
@pytest.mark.parametrize("mode", ["self-window", "memory", "kv_override"])
def test_attention_matches_the_reference(mode, impl):
    """Self-attention with a window and offset positions, and cross
    attention through ``memory=`` and ``kv_override=``."""
    rng = np.random.default_rng(6)
    D, H, KV, hd, S, T = 32, 4, 2, 8, 11, 7
    p = {k: (rng.standard_normal(s) / 6).astype(np.float32)
         for k, s in (("wq", (D, H * hd)), ("wk", (D, KV * hd)), ("wv", (D, KV * hd)),
                      ("wo", (H * hd, D)))}
    x = rng.standard_normal((2, S, D)).astype(np.float32)
    pos = (np.arange(S)[None] + np.array([[0], [4]])).astype(np.int32)
    mem = rng.standard_normal((2, T, D)).astype(np.float32)
    kv = tuple(rng.standard_normal((2, T, KV, hd)).astype(np.float32) for _ in range(2))
    extra = {"self-window": dict(window=4), "memory": dict(memory=mem),
             "kv_override": dict(kv_override=kv)}[mode]
    kw = dict(n_heads=H, n_kv=KV, hd=hd, impl=impl, q_chunk=4, k_chunk=4)

    def conv(f):
        return {k: (tuple(map(f, v)) if isinstance(v, tuple) else
                    f(v) if isinstance(v, np.ndarray) else v) for k, v in extra.items()}

    want, _ = ref_L.attention({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                              positions=jnp.asarray(pos), **conv(jnp.asarray), **kw)
    got, _ = L.attention({k: _t(v) for k, v in p.items()}, _t(x), positions=_t(pos),
                         **conv(_t), **kw)
    _close(got, want, 1e-5)


# ---------------------------------------------------------------- K12's contract

@pytest.mark.parametrize("call,fits", [
    (dict(S=1000, T=1000, q_base=0, k_base=0, k_len=1000, causal=True, window=None), True),
    (dict(S=992, T=992, q_base=0, k_base=0, k_len=992, causal=True, window=4096), True),
    (dict(S=64, T=96, q_base=0, k_base=0, k_len=96, causal=False, window=None), True),
    (dict(S=8, T=40, q_base=0, k_base=0, k_len=8, causal=True, window=None), True),
    (dict(S=8, T=40, q_base=32, k_base=0, k_len=40, causal=True, window=None), False),
    (dict(S=100, T=100, q_base=0, k_base=0, k_len=100, causal=True, window=32), True),
    (dict(S=16, T=24, q_base=0, k_base=0, k_len=20, causal=False, window=None), False),
    (dict(S=16, T=16, q_base=0, k_base=0, k_len=12, causal=True, window=None), False),
    (dict(S=8, T=40, q_base=32, k_base=0, k_len=40, causal=True, window=16), False),
    (dict(S=100, T=60, q_base=0, k_base=0, k_len=60, causal=True, window=32), False),
], ids=["forward", "wide-window", "cross", "prefill-pos0", "prefill-pos32",
        "narrow-window", "noncausal-masked", "short-klen", "window-prefill-pos32",
        "window-T-below-S"])
def test_k12_contract_from_host_integers(call, fits):
    why = L.k12_refusal(**call)
    assert (why is None) == fits, why
    if why is not None and "no key" not in why:
        assert "no caller in the reference needs one yet" in why


def test_attention_decides_the_contract_from_host_integers():
    """What ``attention`` hands ``_flash_gqa`` for a cached prefill: the
    keys just written at cache_pos 0 (bases 0, k_len S), the valid cache
    rows past it; the CPU tensors never reach the CUDA wrapper."""
    rng = np.random.default_rng(5)
    D, H, KV, hd, S, Lmax = 32, 4, 2, 8, 6, 16
    p = L.Params({k: L._param(_t(rng.standard_normal(s).astype(np.float32) / 6))
                  for k, s in (("wq", (D, H * hd)), ("wk", (D, KV * hd)),
                               ("wv", (D, KV * hd)), ("wo", (H * hd, D)))})
    x = _t(rng.standard_normal((2, S, D)).astype(np.float32))
    seen = []
    real = L._flash_gqa

    def spy(qg, k, v, q_base, k_base, k_len, **kw):
        seen.append((q_base, k_base, k_len, k.shape[1], k.is_contiguous(),
                     L.k12_refusal(qg.shape[1], k.shape[1], q_base=q_base,
                                   k_base=k_base, k_len=k_len, causal=kw["causal"],
                                   window=kw["window"])))
        return real(qg, k, v, q_base, k_base, k_len, **kw)

    cache = L.init_kv_cache(2, Lmax, KV, hd, torch.float32, device=CPU)
    kw = dict(n_heads=H, n_kv=KV, hd=hd, impl="flash", q_chunk=4, k_chunk=4)
    pos = torch.arange(S, dtype=torch.int32)[None].expand(2, S)
    L._flash_gqa = spy
    try:
        out0, _ = L.attention(p, x, positions=pos, cache=cache, cache_pos=0, **kw)
        L.attention(p, x[:, :3], positions=S + pos[:, :3], cache=cache, cache_pos=S, **kw)
        L.attention(p, x, positions=pos + 7, **kw)
    finally:
        L._flash_gqa = real
    assert seen[0] == (0, 0, S, S, True, None)
    assert seen[1][:4] == (S, 0, S + 3, S + 3) and "cache_pos > 0" in seen[1][5]
    assert seen[2] == (0, 0, S, S, True, None)
    # the same result as the naive path over the whole cache
    cache2 = L.init_kv_cache(2, Lmax, KV, hd, torch.float32, device=CPU)
    out1, _ = L.attention(p, x, positions=pos, cache=cache2, cache_pos=0,
                          **{**kw, "impl": "naive"})
    _close(out0, out1, 1e-5)


def test_cpu_tensors_never_reach_the_kernel(models, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached the CUDA wrapper")

    monkeypatch.setattr(pt_fa, "flash_attention_fwd_cuda", refuse)
    _, _, cfg, params = models["phi4-mini-3.8b"]
    logits = pt_model.forward_logits(params, cfg, _both(_inputs(cfg, 2, 16, 0))[1])
    assert logits.shape == (2, 16, cfg.vocab) and bool(torch.isfinite(logits).all())


# ---------------------------------------------------------------- whole model

@pytest.mark.parametrize("name", DENSE)
def test_forward_logits_match_the_reference(models, name):
    ref_cfg, ref_params, cfg, params = models[name]
    jin, tin = _both(_inputs(cfg, 2, 20, 7))
    want = ref_model.forward_logits(ref_params, ref_cfg, jin)
    got = pt_model.forward_logits(params, cfg, tin)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    _close(got, want, 1e-4)


@pytest.mark.parametrize("name", DENSE)
def test_prefill_and_decode_match_the_reference(models, name):
    ref_cfg, ref_params, cfg, params = models[name]
    S, split, n_pre = 14, 9, cfg.n_prefix_embeds
    inputs = _inputs(cfg, 2, S + n_pre, 11)
    pre = dict(inputs, tokens=inputs["tokens"][:, :split])
    jin, tin = _both(pre)
    want, ref_cache = ref_model.prefill(ref_params, ref_cfg, jin, max_len=S + n_pre)
    got, cache = pt_model.prefill(params, cfg, tin, max_len=S + n_pre)
    _close(got, want, 1e-4)
    pos = split + n_pre
    for t in range(split, split + 3):
        tok = inputs["tokens"][:, t:t + 1]
        want, ref_cache = ref_model.decode_step(ref_params, ref_cfg, jnp.asarray(tok),
                                                ref_cache, jnp.int32(pos))
        got, cache = pt_model.decode_step(params, cfg, _t(tok), cache, pos)
        _close(got, want, 1e-4)
        pos += 1
    _close(cache["groups"][0]["b0"]["kv"]["k"],
           np.asarray(ref_cache["groups"]["b0"]["kv"]["k"][0]), 1e-4)


@pytest.mark.parametrize("name", ["phi4-mini-3.8b", "gemma-2b", "starcoder2-7b"])
def test_flash_matches_naive_in_the_port(models, name):
    _, _, cfg, params = models[name]
    tin = _both(_inputs(cfg, 2, 24, 3))[1]
    lf = pt_model.forward_logits(params, dataclasses.replace(cfg, attn_impl="flash"), tin)
    ln = pt_model.forward_logits(params, dataclasses.replace(cfg, attn_impl="naive"), tin)
    _close(lf, ln, 1e-3)


def test_init_model_counts_and_seeds():
    cfg = reduce_for_smoke(get_config("phi4-mini-3.8b"))
    a = pt_model.init_model(cfg, seed=3, device=CPU)
    b = pt_model.init_model(cfg, seed=3, device=CPU)
    ref = ref_model.init_model(jax.random.PRNGKey(0), ref_reduce(ref_get_config(cfg.name)))
    assert pt_model.count_params(a) == ref_model.count_params(ref)
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    assert not any(p.requires_grad for p in a.parameters())
    assert sorted(a.keys()) == sorted(ref)
    assert sorted(a["groups"][0]["b0"].keys()) == sorted(ref["groups"]["b0"])
    inputs = pt_model.make_inputs(get_config("internvl2-76b"), 2, 300, seed=1, device=CPU)
    assert inputs["tokens"].shape == (2, 44) and inputs["tokens"].dtype == torch.int32
    assert inputs["prefix_embeds"].shape == (2, 256, 8192)


@pytest.mark.parametrize("name", MOE_HYBRID)
def test_moe_and_hybrid_families_match_the_reference(name):
    """Ported in a later slice than the dense decoders: the reduced config's
    forward logits and aux loss as the reference's."""
    ref_cfg = ref_reduce(ref_get_config(name))
    ref_params = ref_model.init_model(jax.random.PRNGKey(3), ref_cfg)
    cfg = reduce_for_smoke(get_config(name))
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg, CPU)
    jin, tin = _both(_inputs(cfg, 2, 40, 13))
    want, _, waux = ref_model.apply_model(ref_params, ref_cfg, jin["tokens"])
    got, _, aux = pt_model.apply_model(params, cfg, tin["tokens"])
    _close(got, want, 1e-4)
    _close(aux, waux, 1e-5)
    assert pt_model.count_params(pt_model.init_model(cfg, device=CPU)) == \
        ref_model.count_params(ref_params)


@pytest.mark.parametrize("entry", ["init_model", "forward_logits"])
def test_unknown_block_kind_raises(entry):
    cfg = dataclasses.replace(reduce_for_smoke(get_config("recurrentgemma-2b")),
                              block_pattern=("rglru", "mamba"))
    dense = pt_model.init_model(reduce_for_smoke(get_config("phi4-mini-3.8b")), device=CPU)
    call = {"init_model": lambda: pt_model.init_model(cfg, device=CPU),
            "forward_logits": lambda: pt_model.forward_logits(
                dense, cfg, {"tokens": torch.zeros((1, 4), dtype=torch.int32)})}[entry]
    with pytest.raises(NotImplementedError, match="ROADMAP") as err:
        call()
    assert "mamba" in str(err.value)
