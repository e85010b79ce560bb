"""The port's token stream, AdamW and train step against the JAX
package's, on the CPU.

``TokenStream`` batches equal the reference's for the same (seed, step,
host), host sharding included.  ``lr_schedule`` agrees over steps 0 to
``total_steps`` within 1e-6, and ``adamw_update`` on the same given
gradients (float32, three steps, with and without clipping) within 1e-6
in the parameters, both moments and the metrics.  Five ``make_train_step``
steps from the same weights (``params_from_numpy``) and batches: losses
within rtol 1e-4, and the parameters by relative L2 within 1e-5 (not
elementwise: AdamW's first step is about ``lr * sign(g)``, so a gradient
near zero can flip).  ``microbatches=4`` matches ``microbatches=1`` (the
reference's own test and tolerances), the loss falls over steps
(``tests/test_substrate.py:41``), and a frozen parameter is refused."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.configs import reduce_for_smoke as ref_reduce
from repro.data import pipeline as ref_pipe
from repro.models import model as ref_model
from repro.training import optimizer as ref_opt
from repro.training import train_step as ref_step
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.data import pipeline as pt_pipe
from repro_torch.models.convert import numpy_from_params, params_from_numpy
from repro_torch.models.model import init_model
from repro_torch.training import optimizer as pt_opt
from repro_torch.training import train_step as pt_step

CPU = "cpu"
NAME = "phi4-mini-3.8b"


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.fixture(scope="module")
def model():
    ref_cfg = ref_reduce(ref_get_config(NAME))
    ref_params = ref_model.init_model(jax.random.PRNGKey(0), ref_cfg)
    cfg = reduce_for_smoke(get_config(NAME))
    return ref_cfg, ref_params, cfg


def _port_state(ref_params, cfg):
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg,
                               CPU).requires_grad_(True)
    return pt_step.TrainState(params, pt_opt.init_opt_state(params))


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("vocab,seq,global_batch,seed,n_hosts", [
    (512, 32, 8, 0, 1), (512, 64, 8, 3, 2), (200064, 17, 12, 7, 4), (50, 5, 3, 1, 3)])
def test_token_stream_equals_the_reference(vocab, seq, global_batch, seed, n_hosts):
    kw = dict(vocab=vocab, seq_len=seq, global_batch=global_batch, seed=seed)
    for host in range(n_hosts):
        ref = ref_pipe.TokenStream(ref_pipe.DataConfig(**kw), host, n_hosts)
        pt = pt_pipe.TokenStream(pt_pipe.DataConfig(**kw), host, n_hosts)
        assert pt.local_batch == ref.local_batch == global_batch // n_hosts
        for step in (0, 1, 17):
            want, got = ref.batch(step), pt.batch(step)
            assert sorted(got) == ["labels", "tokens"]
            for key in want:
                assert got[key].dtype == want[key].dtype
                np.testing.assert_array_equal(got[key], want[key])
        for got, want in zip(pt, [ref.batch(i) for i in range(3)]):
            np.testing.assert_array_equal(got["tokens"], want["tokens"])


@pytest.mark.parametrize("warmup,total,min_frac", [(100, 10_000, 0.1), (10, 100, 0.1),
                                                   (1, 8, 0.0), (20, 120, 0.25)])
def test_lr_schedule_agrees_over_every_step(warmup, total, min_frac):
    cfg = dict(lr=3e-4, warmup_steps=warmup, total_steps=total, min_lr_frac=min_frac)
    ref_cfg, cfg = ref_opt.AdamWConfig(**cfg), pt_opt.AdamWConfig(**cfg)
    steps = sorted(set(np.linspace(0, total, 400).astype(int).tolist()) | {0, warmup, total})
    for step in steps:
        want = float(ref_opt.lr_schedule(ref_cfg, jnp.int32(step)))
        got = pt_opt.lr_schedule(cfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-12), step
        assert float(pt_opt.lr_schedule(cfg, step)) == float(got)


@pytest.mark.parametrize("clip", [1.0, 1e9], ids=["clipped", "unclipped"])
def test_adamw_update_matches_the_reference(model, clip):
    ref_cfg, ref_params, cfg = model
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=clip)
    ref_ocfg, ocfg = ref_opt.AdamWConfig(**kw), pt_opt.AdamWConfig(**kw)
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg, CPU)
    opt = pt_opt.init_opt_state(params)
    ref_p, ref_state = ref_params, ref_opt.init_opt_state(ref_params)
    rng = np.random.default_rng(0)
    for _ in range(3):
        grads_np = jax.tree.map(
            lambda x: rng.standard_normal(x.shape).astype(np.float32) * 0.3, ref_p)
        ref_p, ref_state, ref_m = ref_opt.adamw_update(
            ref_ocfg, ref_p, jax.tree.map(jnp.asarray, grads_np), ref_state)
        # the same gradients keyed like named_parameters()
        gm = params_from_numpy(grads_np, cfg, CPU)
        grads = {n: g.clone() for n, g in gm.named_parameters()}
        kept = {n: g.clone() for n, g in grads.items()}
        params, opt, m = pt_opt.adamw_update(ocfg, params, grads, opt)
        assert all(torch.equal(grads[n], kept[n]) for n in grads)  # not consumed
        assert int(opt.step) == int(ref_state.step) and opt.step.dtype == torch.int32
        for key in ("grad_norm", "lr"):
            assert float(m[key]) == pytest.approx(float(ref_m[key]), rel=1e-6)
        close = dict(rtol=1e-6, atol=1e-6)
        jax.tree.map(lambda g, w: np.testing.assert_allclose(g, np.asarray(w), **close),
                     numpy_from_params(params, cfg), ref_p)
        for mine, theirs in ((opt.mu, ref_state.mu), (opt.nu, ref_state.nu)):
            mod = params_from_numpy(jax.tree.map(np.asarray, theirs), cfg, CPU)
            for n, want in mod.named_parameters():
                np.testing.assert_allclose(mine[n].numpy(), want.numpy(), **close)


def test_five_train_steps_match_the_reference(model):
    ref_cfg, ref_params, cfg = model
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=50)
    ref_fn = jax.jit(ref_step.make_train_step(ref_cfg, ref_opt.AdamWConfig(**kw)))
    fn = pt_step.make_train_step(cfg, pt_opt.AdamWConfig(**kw))
    ds = pt_pipe.TokenStream(pt_pipe.DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4))
    ref_state = ref_step.TrainState(ref_params, ref_opt.init_opt_state(ref_params))
    state = _port_state(ref_params, cfg)
    for i in range(5):
        batch = ds.batch(i)
        ref_state, ref_m = ref_fn(ref_state, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = fn(state, _torch_batch(batch))
        assert float(m["loss"]) == pytest.approx(float(ref_m["loss"]), rel=1e-4)
        assert float(m["grad_norm"]) == pytest.approx(float(ref_m["grad_norm"]), rel=1e-3)
        errs = jax.tree.map(_rel_l2, numpy_from_params(state.params, cfg),
                            jax.tree.map(np.asarray, ref_state.params))
        assert max(jax.tree.leaves(errs)) <= 1e-5, (i, errs)


def test_grad_accumulation_matches_full_batch(model):
    """Microbatched gradient == full-batch gradient (same update): the
    reference's ``test_grad_accumulation_matches_full_batch``."""
    _, ref_params, cfg = model
    opt = pt_opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10, grad_clip=1e9)
    ds = pt_pipe.TokenStream(pt_pipe.DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=8))
    batch = _torch_batch(ds.batch(0))
    s1, m1 = pt_step.make_train_step(cfg, opt, microbatches=1)(
        _port_state(ref_params, cfg), batch)
    s2, m2 = pt_step.make_train_step(cfg, opt, microbatches=4)(
        _port_state(ref_params, cfg), batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-4)
    for a, b in zip(s1.params.parameters(), s2.params.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=2e-3, atol=2e-5)
    with pytest.raises(ValueError, match="microbatches"):
        pt_step.make_train_step(cfg, opt, microbatches=3)(_port_state(ref_params, cfg),
                                                          batch)


def test_loss_decreases_and_frozen_parameters_are_refused():
    cfg = reduce_for_smoke(get_config(NAME))
    opt = pt_opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50)
    step = pt_step.make_train_step(cfg, opt)
    ds = pt_pipe.TokenStream(pt_pipe.DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8))
    params = init_model(cfg, seed=0, device=CPU)
    with pytest.raises(ValueError, match="requires_grad_"):
        step(pt_step.TrainState(params, pt_opt.init_opt_state(params)),
             _torch_batch(ds.batch(0)))
    s = pt_step.TrainState(params.requires_grad_(True), pt_opt.init_opt_state(params))
    losses = []
    for i in range(8):
        s, m = step(s, _torch_batch(ds.batch(i)))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    assert all(np.isfinite(losses))
    assert s.params is params  # updated in place


@pytest.mark.parametrize("name", ["moonshot-v1-16b-a3b", "whisper-base", "internvl2-76b",
                                  "rwkv6-1.6b", "recurrentgemma-2b", "mixtral-8x7b"])
def test_a_train_step_of_the_other_families_matches_the_reference(name):
    """MoE (the aux loss; Mixtral's with its sliding window), the
    encoder-decoder (frames), the vision prefix, RWKV6 (the chunked
    recurrence under autograd) and the RG-LRU/local hybrid (the doubling
    scan under remat) through one step of both packages."""
    ref_cfg = ref_reduce(ref_get_config(name))
    cfg = reduce_for_smoke(get_config(name))
    ref_params = ref_model.init_model(jax.random.PRNGKey(3), ref_cfg)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    rng = np.random.default_rng(4)
    n_tok = 16 - cfg.n_prefix_embeds
    batch = {k: rng.integers(0, cfg.vocab, size=(2, n_tok)).astype(np.int32)
             for k in ("tokens", "labels")}
    if cfg.frontend == "vision":
        batch["prefix_embeds"] = rng.standard_normal(
            (2, cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32)
    if cfg.kind == "encdec":
        batch["encoder_frames"] = rng.standard_normal(
            (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    ref_state, ref_m = jax.jit(ref_step.make_train_step(ref_cfg, ref_opt.AdamWConfig(**kw)))(
        ref_step.TrainState(ref_params, ref_opt.init_opt_state(ref_params)),
        {k: jnp.asarray(v) for k, v in batch.items()})
    state, m = pt_step.make_train_step(cfg, pt_opt.AdamWConfig(**kw))(
        _port_state(ref_params, cfg), _torch_batch(batch))
    assert float(m["loss"]) == pytest.approx(float(ref_m["loss"]), rel=1e-5)
    errs = jax.tree.map(_rel_l2, numpy_from_params(state.params, cfg),
                        jax.tree.map(np.asarray, ref_state.params))
    assert max(jax.tree.leaves(errs)) <= 1e-5, errs
