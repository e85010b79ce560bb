"""The port's training gradients against the JAX package's, on the CPU.

K12 under a gradient: ``flash_attention_bwd`` (the attention gradient in
torch ops over row tiles) against ``jax.vjp`` of the reference's
``_flash_gqa`` and against torch autograd through K12's plain
online-softmax recurrence, within 1e-5: causal, windowed and non-causal
attention, G > 1 and MQA, and S past a row tile and no multiple of it.
``K12Attention`` on CPU tensors runs that plain forward and that backward.

The whole model: for every config of the registry (dense, MoE, the
RG-LRU hybrid with and without a ``rem`` group, RWKV6, Whisper, the
InternVL prefix) at ``reduce_for_smoke`` sizes in float32, the
reference's weights carried by ``params_from_numpy``: ``train_loss``
within rtol 1e-5 of the reference's, and every gradient leaf, brought back
to the reference's layout by ``numpy_from_params``, within a relative L2
of 1e-4 of ``jax.grad``'s.  Remat (``"nothing"`` and ``"dots"``) gives the
loss and gradients of no remat; with it K12's forward runs twice per
attention layer (the recompute), and without grad ``_flash_gqa`` keeps
the serving path."""
import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.configs import list_archs
from repro.configs import reduce_for_smoke as ref_reduce
from repro.models import layers as ref_L
from repro.models import model as ref_model
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import layers as L
from repro_torch.models import model as pt_model
from repro_torch.models.convert import numpy_from_params, params_from_numpy

CPU = "cpu"

BWD_CASES = {
    # id: (B, S, T, KV, G, causal, window, chunk)
    "causal-mha": (2, 40, 40, 4, 1, True, None, 8),
    "causal-gqa3-S200": (1, 200, 200, 2, 3, True, None, 40),
    "window-mqa": (1, 300, 300, 1, 4, True, 37, 60),
    "window-past-S": (1, 150, 150, 2, 2, True, 400, 30),
    "noncausal-gqa2": (2, 150, 90, 2, 2, False, None, 30),
    "mqa-causal-S130": (2, 130, 130, 1, 4, True, None, 26),
}


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _bwd_inputs(case):
    B, S, T, KV, G, causal, window, chunk = BWD_CASES[case]
    hd = 16
    rng = np.random.default_rng(len(case) + S)
    qg, dout = (rng.standard_normal((B, S, KV, G, hd)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, T, KV, hd)).astype(np.float32) for _ in range(2))
    return qg, k, v, dout


@pytest.mark.parametrize("case", list(BWD_CASES), ids=list(BWD_CASES))
def test_flash_attention_bwd_matches_the_reference(case):
    B, S, T, KV, G, causal, window, chunk = BWD_CASES[case]
    qg, k, v, dout = _bwd_inputs(case)
    hd = qg.shape[-1]
    H = KV * G

    def ref(qg, k, v):
        zero = jnp.zeros((B,), jnp.int32)
        return ref_L._flash_gqa(qg, k, v, zero, zero, jnp.full((B,), T, jnp.int32),
                                causal=causal, window=window, scale=hd ** -0.5,
                                q_chunk=chunk, k_chunk=chunk)

    _, vjp = jax.vjp(ref, jnp.asarray(qg), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(x) for x in vjp(jnp.asarray(dout))]

    q = torch.from_numpy(qg).reshape(B, S, H, hd)
    kt, vt, dot = torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(dout)
    out = fa.flash_attention_fwd_torch(q, kt, vt, causal=causal, q_chunk=S, k_chunk=T,
                                       window=window)
    got = fa.flash_attention_bwd(q, kt, vt, out, dot.reshape(B, S, H, hd), causal=causal,
                                 window=window)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.reshape(w.shape).numpy(), w, rtol=1e-5, atol=1e-5)

    # torch autograd through K12's plain recurrence, in (chunk, chunk) tiles
    leaves = [x.clone().requires_grad_(True) for x in (q, kt, vt)]
    out_c = fa.flash_attention_fwd_torch(*leaves, causal=causal, q_chunk=chunk,
                                         k_chunk=chunk, window=window)
    auto = torch.autograd.grad(out_c, leaves, dot.reshape(B, S, H, hd))
    for g, a in zip(got, auto):
        np.testing.assert_allclose(g.numpy(), a.numpy(), rtol=1e-5, atol=1e-5)

    # K12Attention on CPU tensors: the plain forward, this backward
    leaves = [x.clone().requires_grad_(True) for x in (q, kt, vt)]
    out_f = fa.K12Attention.apply(*leaves, causal, window)
    assert torch.equal(out_f, out)
    for g, a in zip(got, torch.autograd.grad(out_f, leaves, dot.reshape(B, S, H, hd))):
        assert torch.equal(g, a)


def test_flash_attention_bwd_reads_one_row_tile_of_logits(monkeypatch):
    """The backward's logits are one tile's (B, KV, G, rows, keys), the keys
    cut to the tile's causal and window range, never (B, H, S, T)."""
    B, S, KV, G, hd, W = 1, 300, 1, 2, 16, 37
    rng = np.random.default_rng(3)
    q, dout = (torch.from_numpy(rng.standard_normal((B, S, KV * G, hd)).astype(np.float32))
               for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, S, KV, hd)).astype(np.float32))
            for _ in range(2))
    shapes, real = [], torch.softmax

    def spy(x, dim):
        shapes.append(tuple(x.shape))
        return real(x, dim=dim)

    monkeypatch.setattr(torch, "softmax", spy)
    out = fa.flash_attention_fwd_torch(q, k, v, q_chunk=S, k_chunk=S, window=W)
    fa.flash_attention_bwd(q, k, v, out, dout, causal=True, window=W)
    R = fa.BWD_ROW_TILE
    want = [(B, KV, G, min(S, r0 + R) - r0, min(S, r0 + R) - max(0, r0 - W + 1))
            for r0 in range(0, S, R)]
    assert shapes == want


@pytest.mark.parametrize("call", [
    dict(q_base=4, k_base=0, k_len=16, causal=True),
    dict(q_base=0, k_base=0, k_len=11, causal=False),
], ids=["query-offset", "masked-keys"])
def test_flash_gqa_under_a_gradient_refuses_outside_the_contract(call):
    rng = np.random.default_rng(0)
    qg = torch.from_numpy(rng.standard_normal((1, 8, 2, 2, 16)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, 16, 2, 16)).astype(np.float32))
            for _ in range(2))
    kw = dict(window=None, scale=0.25, q_chunk=8, k_chunk=8)
    q_base, k_base, k_len, causal = (call[n] for n in ("q_base", "k_base", "k_len",
                                                       "causal"))
    # without a gradient it is the serving path's recurrence
    L._flash_gqa(qg, k, v, q_base, k_base, k_len, causal=causal, **kw)
    with pytest.raises(NotImplementedError, match="outside K12's contract"):
        L._flash_gqa(qg.requires_grad_(True), k, v, q_base, k_base, k_len,
                     causal=causal, **kw)


# ---------------------------------------------------------------- whole model

ARCHS = list_archs()
HYBRID_REM = "recurrentgemma-2b+rem"


def _configs(name):
    arch = name.split("+")[0]
    ref_cfg, cfg = ref_reduce(ref_get_config(arch)), reduce_for_smoke(get_config(arch))
    if name == HYBRID_REM:  # 5 layers: a group of 3 and a rem group of 2
        ref_cfg = dataclasses.replace(ref_cfg, n_layers=5)
        cfg = dataclasses.replace(cfg, n_layers=5)
    return ref_cfg, cfg


def _inputs(cfg, batch, seq, seed):
    rng = np.random.default_rng(seed)
    n_tok = seq - cfg.n_prefix_embeds
    out = {name: rng.integers(0, cfg.vocab, size=(batch, n_tok)).astype(np.int32)
           for name in ("tokens", "labels")}
    if cfg.frontend == "vision":
        out["prefix_embeds"] = rng.standard_normal(
            (batch, cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32)
    if cfg.kind == "encdec":
        out["encoder_frames"] = rng.standard_normal(
            (batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


@pytest.fixture(scope="module", params=ARCHS + [HYBRID_REM])
def model(request):
    name = request.param
    ref_cfg, cfg = _configs(name)
    ref_params = ref_model.init_model(jax.random.PRNGKey(len(name)), ref_cfg)
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg, CPU)
    return name, ref_cfg, ref_params, cfg, params.requires_grad_(True)


def _port_grads(params, cfg, inputs):
    named = dict(params.named_parameters())
    loss = pt_model.train_loss(params, cfg, inputs)
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True,
                                materialize_grads=True)
    gm = copy.deepcopy(params)
    with torch.no_grad():
        for p, g in zip(gm.parameters(), grads):
            p.copy_(g)
    return float(loss.detach()), numpy_from_params(gm, cfg)


def test_train_loss_and_every_gradient_leaf_match_the_reference(model):
    name, ref_cfg, ref_params, cfg, params = model
    inputs = _inputs(cfg, 2, 16, seed=len(name))
    want_loss, want = jax.value_and_grad(ref_model.train_loss)(
        ref_params, ref_cfg, {k: jnp.asarray(v) for k, v in inputs.items()})
    got_loss, got = _port_grads(params, cfg, {k: torch.from_numpy(v)
                                              for k, v in inputs.items()})
    np.testing.assert_allclose(got_loss, float(want_loss), rtol=1e-5)
    errs = jax.tree.map(lambda g, w: _rel_l2(g, w), got, jax.tree.map(np.asarray, want))
    worst = max(jax.tree.leaves(errs))
    assert worst <= 1e-4, errs


@pytest.mark.parametrize("policy", ["nothing", "dots"])
@pytest.mark.parametrize("name", ["phi4-mini-3.8b", "moonshot-v1-16b-a3b",
                                  HYBRID_REM, "rwkv6-1.6b", "whisper-base"])
def test_remat_gives_the_loss_and_gradients_of_no_remat(name, policy, monkeypatch):
    ref_cfg, cfg = _configs(name)
    ref_params = ref_model.init_model(jax.random.PRNGKey(1), ref_cfg)
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg,
                               CPU).requires_grad_(True)
    inputs = {k: torch.from_numpy(v) for k, v in _inputs(cfg, 2, 16, seed=2).items()}
    calls = []
    real = fa.flash_attention_fwd_torch

    def count(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(fa, "flash_attention_fwd_torch", count)
    runs = {}
    for remat in (False, True):
        calls.clear()
        c = dataclasses.replace(cfg, remat_layers=remat, remat_policy=policy)
        runs[remat] = (_port_grads(params, c, inputs), len(calls))
    (loss0, g0), n0 = runs[False]
    (loss1, g1), n1 = runs[True]
    assert loss1 == loss0
    jax.tree.map(np.testing.assert_array_equal, g1, g0)
    # K12's forward: once per attention call without remat; with it, again
    # in the recompute of every group's attention (Whisper's encoder is not
    # rematerialised; RWKV6 has no attention)
    assert n1 == 2 * n0 - cfg.encoder_layers
    assert (n0 == 0) == (cfg.kind == "rwkv")


def test_serving_without_grad_keeps_the_recurrence(monkeypatch):
    """No gradient: ``_flash_gqa`` on CPU tensors is the reference's
    recurrence, with no autograd Function and no K12 plain version."""
    _, cfg = _configs("phi4-mini-3.8b")
    params = pt_model.init_model(cfg, seed=0, device=CPU).requires_grad_(True)
    inputs = {k: torch.from_numpy(v) for k, v in _inputs(cfg, 2, 16, seed=0).items()}

    def refuse(*a, **kw):
        raise AssertionError("K12's plain version on the serving path")

    monkeypatch.setattr(fa, "flash_attention_fwd_torch", refuse)
    with torch.no_grad():
        logits = pt_model.forward_logits(params, cfg, inputs)
    assert logits.shape == (2, 16, cfg.vocab) and not logits.requires_grad
