"""Training step: loss + gradients + AdamW, with remat and gradient
accumulation.

Port of ``repro.training.train_step``.  ``make_train_step`` builds the step
the trainer (``launch/train.py``) runs.  Layer remat lives in the model
(``cfg.remat_layers``, ``models/transformer.py``), as in the reference, so
``remat`` is kept for the signature only.  With ``microbatches > 1`` the
batch is split on its leading axis as the reference splits it, each
microbatch's gradients are taken by ``torch.autograd.grad`` and summed in
float32 buffers, then the sums and the loss are divided by the count (the
reference's ``lax.scan``); ``.backward()`` into ``.grad`` would sum in
the parameters' dtype.  The state is updated in place (the twin of
``donate_argnums``); the parameters must require grad
(``params.requires_grad_(True)``: they are created frozen).  Under a
mesh (``models.sharding.use_mesh``, DTensor state and batch) the step runs
as it is, each op a DTensor op (``launch/train.py --mesh host``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import train_loss
from repro_torch.models.sharding import mesh_ops
from repro_torch.training.optimizer import AdamWConfig, OptState, adamw_update


class TrainState(NamedTuple):
    params: torch.nn.Module
    opt: OptState


def _grads(loss: torch.Tensor, named: dict) -> list:
    """d loss / d parameter for every parameter (zeros where unused, as
    ``jax.grad`` gives)."""
    return list(torch.autograd.grad(loss, list(named.values()), allow_unused=True,
                                    materialize_grads=True))


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, *, remat: bool = True,
                    microbatches: int = 1):
    """``step(state, inputs) -> (state, metrics)``: metrics ``loss``,
    ``grad_norm`` and ``lr`` as tensors (the caller reads host floats)."""
    del remat  # the reference's signature: remat is cfg.remat_layers

    def step(state: TrainState, inputs: dict) -> tuple[TrainState, dict]:
        with mesh_ops():
            return _step(state, inputs)

    def _step(state: TrainState, inputs: dict) -> tuple[TrainState, dict]:
        named = dict(state.params.named_parameters())
        frozen = [n for n, p in named.items() if not p.requires_grad]
        if frozen:
            raise ValueError(f"parameters {frozen[:3]}... do not require grad; call "
                             f"params.requires_grad_(True) first")
        if microbatches == 1:
            loss = train_loss(state.params, cfg, inputs)
            grads = dict(zip(named, _grads(loss, named)))
            loss = loss.detach()
        else:
            b = inputs["tokens"].shape[0]
            if b % microbatches:
                raise ValueError(f"batch {b} does not split into {microbatches} "
                                 f"microbatches")
            loss = torch.zeros((), dtype=torch.float32, device=inputs["tokens"].device)
            grads = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in named.items()}
            for mb in zip(*(x.chunk(microbatches) for x in inputs.values())):
                mb_loss = train_loss(state.params, cfg, dict(zip(inputs, mb)))
                for acc, g in zip(grads.values(), _grads(mb_loss, named)):
                    acc.add_(g)
                loss += mb_loss.detach()
            loss /= microbatches
            for acc in grads.values():
                acc.div_(microbatches)
        params, opt, metrics = adamw_update(opt_cfg, state.params, grads, state.opt)
        metrics["loss"] = loss
        return TrainState(params, opt), metrics

    return step
