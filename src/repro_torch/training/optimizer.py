"""AdamW with global-norm clipping, written by hand in torch.

Port of ``repro.training.optimizer`` with the same arithmetic: float32
moments, the clip scale ``min(1, clip / (gnorm + 1e-9))``, the step
incremented before the learning rate is read, float32 bias corrections,
``delta = mhat / (sqrt(vhat) + eps) + wd * p`` and ``p - lr * delta`` cast
back to the parameter's dtype.  ``torch.optim.AdamW`` is not used: it
keeps its moments in the parameter's dtype.

The reference casts every gradient to float32 at once
(``optimizer.py:64``); here the scale and the update run one leaf at a
time, in place where the arithmetic allows, so a bfloat16 model of 4.45 B
parameters needs two float32 temporaries of its largest leaf, not a
float32 copy of every gradient.  Moments are float32 tensors keyed like
``named_parameters()``, ``step`` an int32 tensor; :func:`adamw_update`
writes the parameters and the moments in place.

Under a mesh the parameters and moments are DTensors (moments placed by
``launch.shardings.opt_pspecs``, ZeRO-1): a leaf's gradient is
redistributed to its moments' placement (a reduce-scatter of a partial
gradient), the update computed there, and the new value redistributed to
the parameter's placement (``models.sharding.redistribute``) before it is
written.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models.sharding import full, is_dtensor, redistribute

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor   # int32 scalar
    mu: dict             # first moment, float32, keyed like named_parameters()
    nu: dict             # second moment


def init_opt_state(params: torch.nn.Module) -> OptState:
    named = dict(params.named_parameters())
    dev = next(iter(named.values())).device
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        mu={n: torch.zeros(p.shape, dtype=F32, device=p.device) for n, p in named.items()},
        nu={n: torch.zeros(p.shape, dtype=F32, device=p.device) for n, p in named.items()})


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_frac``, float32 (``step``
    an int or an int32 tensor)."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = torch.clamp(step.to(F32) / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps).to(F32)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def _placed_as(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``x`` redistributed to ``like``'s placements (DTensors), else as it is."""
    return redistribute(x, like.placements) if is_dtensor(x) else x


def _sq_norm(g: torch.Tensor) -> torch.Tensor:
    """The float32 sum of squares of ``g``; of a DTensor (no partial
    placement), each rank's block's, summed over the mesh dims that shard
    it (an all-reduce)."""
    if not is_dtensor(g):
        return torch.linalg.vector_norm(g, dtype=F32).square()

    local = torch.linalg.vector_norm(g.to_local(), dtype=F32).square()
    pls = [Partial() if isinstance(p, Shard) else Replicate() for p in g.placements]
    return full(DTensor.from_local(local, g.device_mesh, pls, run_check=False))


def global_norm(grads: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in float32."""
    return torch.sqrt(torch.stack([_sq_norm(g) for g in grads.values()]).sum())


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: torch.nn.Module, grads: dict,
                 state: OptState) -> tuple[torch.nn.Module, OptState, dict]:
    """One AdamW step over ``grads`` (keyed like ``named_parameters()``,
    any floating dtype; not modified).  The parameters and the moments are
    written in place; returns them with the new step and the metrics
    ``grad_norm`` and ``lr`` (tensors)."""
    named = dict(params.named_parameters())
    if set(grads) != set(named):
        raise ValueError(f"gradients for {sorted(set(grads) ^ set(named))} missing or extra")
    # under a mesh: each gradient reduced into its moments' placement
    grads = {n: _placed_as(g, state.mu[n]) for n, g in grads.items()}
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    stepf = step.to(F32)
    b1c = 1.0 - torch.tensor(cfg.b1, dtype=F32, device=stepf.device) ** stepf
    b2c = 1.0 - torch.tensor(cfg.b2, dtype=F32, device=stepf.device) ** stepf
    for name, p in named.items():
        m, v = state.mu[name], state.nu[name]
        g = grads[name].to(F32, copy=True).mul_(scale)
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        del g
        denom = (v / b2c).sqrt_().add_(cfg.eps)
        pm = _placed_as(p, m)
        delta = (m / b1c).div_(denom).add_(pm, alpha=cfg.weight_decay).mul_(lr)
        p.copy_(_placed_as(denom.copy_(pm).sub_(delta), p))
        del denom, delta, pm
    return params, OptState(step, state.mu, state.nu), {"grad_norm": gnorm, "lr": lr}
