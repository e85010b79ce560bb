"""Rank functions of the tensor-parallel world (``tests/test_torch_tp.py``
spawns them with :func:`repro_torch.launch.spawn.run_ranks`).

:func:`tp_rank` runs, on one ``(data, model)`` host mesh of the world's
ranks, for each reduced config it is given:

- the unsharded ``ServingEngine`` and ``ServingEngine(mesh=)`` on the same
  prompts, every step's whole logits recorded;
- the unsharded train step and the sharded one (parameters by
  ``param_pspecs``, moments by ``opt_pspecs``, the batch by ``io_pspec``)
  from the same weights and batch;
- a checkpoint of the sharded state (every rank), its digest against the
  one-rank digest of the gathered state, and a restore into a fresh
  sharded state;

and counts, under ``CommDebugMode``, the collectives of the sharded serve
and step.  What it returns is numpy or plain Python (picklable); rank 0
adds the logits and parameters the test compares.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from repro_torch.models.sharding import full
from repro_torch.serving.engine import Request, ServingEngine


def _count(fn):
    from torch.distributed.tensor.debug import CommDebugMode

    with CommDebugMode() as c:
        out = fn()
    return out, {str(k): int(v) for k, v in c.get_comm_counts().items()}


class RecordingEngine(ServingEngine):
    """A ``ServingEngine`` that keeps each step's whole float32 logits on
    the host (``self.logits``; under a mesh gathered from the ranks)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.logits: list[np.ndarray] = []

    def _next(self, logits, batch):
        self.logits.append(full(logits).float().cpu().numpy())
        return super()._next(logits, batch)


def _serve(cfg, prompts, new_tokens, mesh, device, params):
    eng = RecordingEngine(cfg, batch_size=len(prompts), max_len=max(map(len, prompts))
                          + new_tokens, device=device, params=params, mesh=mesh)
    for i, p in enumerate(prompts):
        eng.submit(Request(i, np.asarray(p, np.int32), max_new_tokens=new_tokens))
    done = eng.step_batch()
    return [r.output for r in done], eng.logits


def _state(cfg, device, mesh, seed):
    from repro_torch.launch.shardings import distribute_train_state
    from repro_torch.models.model import init_model
    from repro_torch.training.optimizer import init_opt_state
    from repro_torch.training.train_step import TrainState

    params = init_model(cfg, seed=seed, device=device)
    if mesh is not None:
        return distribute_train_state(params, mesh)
    return TrainState(params.requires_grad_(True), init_opt_state(params))


def _named_full(params) -> dict:
    from repro_torch.models.sharding import full

    return {n: full(p.detach()).float().cpu().numpy()
            for n, p in params.named_parameters()}


def tp_config(name: str):
    """The reduced config of arch ``name``; ``"<arch>@e<n>"`` gives it n
    experts (3 on a 2-wide ``model`` axis: the experts do not divide it,
    so each expert's d_ff is split)."""
    from repro_torch.configs import get_config, reduce_for_smoke

    arch, _, experts = name.partition("@e")
    cfg = reduce_for_smoke(get_config(arch))
    return dataclasses.replace(cfg, n_experts=int(experts)) if experts else cfg


def tp_rank(rank: int, world: int, spec: dict) -> dict:
    """One rank of the TP world; ``spec``: ``device``, ``mesh`` ((data,
    model)), ``archs``, ``prompts`` {arch: [prompt arrays]}, ``new_tokens``,
    ``seq``, ``batch``, ``seed``, ``ckpt_dir``, ``train_archs``."""
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.mesh import make_host_mesh, rank_device
    from repro_torch.models.sharding import full, use_mesh
    from repro_torch.training.checkpoint import (restore_checkpoint, save_checkpoint,
                                                 state_digest)
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import make_train_step

    dev = rank_device(spec["device"])
    mesh = make_host_mesh(*spec["mesh"], device_type=dev.type)
    out: dict = {"serve": {}, "train": {}, "comms": {}}
    for arch in spec["archs"]:
        cfg = tp_config(arch)
        prompts = spec["prompts"][arch]
        from repro_torch.models.model import init_model

        one = _serve(cfg, prompts, spec["new_tokens"], None, dev,
                     init_model(cfg, seed=spec["seed"], device=dev))
        (tp, c) = _count(lambda: _serve(cfg, prompts, spec["new_tokens"], mesh, dev,
                                        init_model(cfg, seed=spec["seed"], device=dev)))
        out["comms"][("serve", arch)] = c
        out["serve"][arch] = {"tokens": tp[0], "one_tokens": one[0]}
        if rank == 0:
            out["serve"][arch].update(logits=tp[1], one_logits=one[1])

    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50)
    for arch in spec["train_archs"]:
        cfg = tp_config(arch)
        ds = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=spec["seq"],
                                    global_batch=spec["batch"], seed=spec["seed"]))
        batch = {k: torch.from_numpy(v).to(dev) for k, v in ds.batch(0).items()}
        if cfg.kind == "encdec":
            batch["encoder_frames"] = torch.from_numpy(np.random.default_rng(
                spec["seed"]).standard_normal((spec["batch"], cfg.encoder_seq,
                                               cfg.d_model)).astype(np.float32)).to(dev)
        step = make_train_step(cfg, opt_cfg)
        one_state, one_m = step(_state(cfg, dev, None, spec["seed"]), batch)
        state = _state(cfg, dev, mesh, spec["seed"])
        dbatch = {k: sh.distribute(v, sh.io_pspec(mesh, tuple(v.shape)), mesh)
                  for k, v in batch.items()}
        with use_mesh(mesh):
            (state, m), c = _count(lambda: step(state, dbatch))
        out["comms"][("train", arch)] = c
        res = {"loss": float(full(m["loss"])), "one_loss": float(one_m["loss"]),
               "gnorm": float(full(m["grad_norm"])),
               "one_gnorm": float(one_m["grad_norm"])}
        whole = _named_full(state.params)          # a collective: every rank
        if rank == 0:
            res.update(params=whole, one_params=_named_full(one_state.params))
        if arch == spec["ckpt_arch"]:
            d = os.path.join(spec["ckpt_dir"], arch)
            save_checkpoint(d, 1, state, cfg)
            res["digest"] = state_digest(state, cfg)
            # the one-rank digest of the same (gathered) state
            plain = _state(cfg, "cpu", None, spec["seed"])
            with torch.no_grad():
                for (_, a), (_, b) in zip(plain.params.named_parameters(),
                                          state.params.named_parameters()):
                    a.copy_(full(b))
                for tree_a, tree_b in ((plain.opt.mu, state.opt.mu),
                                       (plain.opt.nu, state.opt.nu)):
                    for n in tree_a:
                        tree_a[n].copy_(full(tree_b[n]))
                plain.opt.step.copy_(state.opt.step)
            res["one_digest"] = state_digest(plain, cfg)
            fresh = _state(cfg, dev, mesh, spec["seed"] + 1)
            fresh = restore_checkpoint(d, 1, fresh, cfg)
            res["restored_digest"] = state_digest(fresh, cfg)
            res["restored_sharded"] = all(
                type(p).__name__ == "DTensor" for p in fresh.params.parameters())
        out["train"][arch] = res
    return out
