"""Mixture-of-Experts FFN with top-k routing and capacity-based dispatch.

Port of ``repro.models.moe``: ``init_moe`` (:28-37), ``_route_row``
(:40-73) as :func:`route`, batched over B without a vmap, and
``apply_moe`` (:76-118).  The reference's ``constrain`` calls are sharding
hints, no-ops on one card, and are dropped.

Per batch row: capacity ``cap = max(1, int(cf * S * topk / E))``; each
expert takes its first ``cap`` assigned (token, slot) pairs in token order,
and the pairs past it pass through the residual only.  Routing matches the
reference's decisions:

- the router logits are ``x.float() @ router`` in float32 at full
  precision (TF32 is switched off around the product on the card: its 11
  significant bits would flip near-tied experts);
- ``jax.lax.top_k`` takes the lower expert index on a tie; ``torch.topk``
  promises no order, so the top k come from a stable descending sort;
- a pair's rank in its expert's queue is its position in a stable
  ``argsort`` of the experts less the ``searchsorted(side="left")`` of its
  expert, as in the reference; a dropped pair goes to the sacrificial slot
  ``E * cap`` and an empty slot reads the zero row ``S``.

The expert products are batched products of the dispatch buffer (B, E,
cap, D) with the stacked weights (E, D, F), which the reference leaves to
XLA outside any Pallas kernel: here they go to ``torch.matmul``.

**Combine, deterministic.**  The reference scatter-adds every slot's
gated output into its token's row, so a token's at most ``topk`` terms
are summed in slot order (ascending expert) in the output's dtype.  On
the card ``index_add_`` would sum them with atomics, in an order that
changes from run to run in bf16.  Here an inverse map gives each token its
kept slots in ascending order (a dropped pair reads a zero row) and the
terms are added in that fixed order: the reference's order, and the same
bits every run.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Params, _init_w


def init_moe(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             mlp: str, dtype) -> Params:
    """The router in float32 (as the reference keeps it), the experts'
    stacked (E, D, F) and (E, F, D) weights in ``dtype``."""
    p = Params({
        "router": _init_w(gen, (d_model, n_experts), torch.float32),
        "w_in": _init_w(gen, (n_experts, d_model, d_ff), dtype),
        "w_out": _init_w(gen, (n_experts, d_ff, d_model), dtype),
    })
    if mlp in ("swiglu", "geglu"):
        p["w_gate"] = _init_w(gen, (n_experts, d_model, d_ff), dtype)
    return p


def capacity(capacity_factor: float, S: int, topk: int, n_experts: int) -> int:
    return max(1, int(capacity_factor * S * topk / n_experts))


@dataclasses.dataclass
class Route:
    """The dispatch plan of every batch row.

    ``slot_src`` (B, E * cap) int64: the token each expert slot reads
    (``S``, the zero row, for an empty slot); ``slot_gate`` (B, E * cap)
    float32: its gate; ``aux`` (B,) float32: the Switch-style
    load-balancing loss of each row; ``slot_key`` (B, S * topk) int64: the
    slot of each (token, k) pair, ``E * cap`` where it was dropped."""
    slot_src: torch.Tensor
    slot_gate: torch.Tensor
    aux: torch.Tensor
    slot_key: torch.Tensor


def _router_logits(xf: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    if not xf.is_cuda:
        return xf @ router
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return xf @ router
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def route(x: torch.Tensor, router: torch.Tensor, n_experts: int, topk: int,
          cap: int) -> Route:
    """The reference's ``_route_row`` for every row of x (B, S, D)."""
    B, S, _ = x.shape
    dev, i64 = x.device, torch.int64
    logits = _router_logits(x.to(torch.float32), router.to(torch.float32))  # (B,S,E)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[..., :topk], idx[..., :topk]         # (B,S,k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    me = probs.mean(dim=1)                                          # (B,E)
    flat_expert = gate_idx.reshape(B, S * topk)
    ce = torch.zeros((B, n_experts), dtype=torch.float32, device=dev).scatter_add_(
        1, flat_expert, torch.full(flat_expert.shape, 1.0 / (S * topk),
                                   dtype=torch.float32, device=dev))
    aux = n_experts * (me * ce).sum(-1)

    flat_token = torch.arange(S, device=dev).repeat_interleave(topk).expand(B, -1)
    order = torch.argsort(flat_expert, dim=-1, stable=True)
    grouped = torch.gather(flat_expert, 1, order)
    pos_in_group = (torch.arange(S * topk, device=dev)
                    - torch.searchsorted(grouped, grouped, side="left"))
    rank = torch.empty_like(pos_in_group).scatter_(1, order, pos_in_group)
    keep = rank < cap
    slot_key = torch.where(keep, flat_expert * cap + rank, n_experts * cap)
    # dropped pairs all land in the sacrificial last slot, which is cut off
    slot_src = torch.full((B, n_experts * cap + 1), S, dtype=i64, device=dev)
    slot_gate = torch.zeros((B, n_experts * cap + 1), dtype=torch.float32, device=dev)
    slot_src.scatter_(1, slot_key, flat_token)
    slot_gate.scatter_(1, slot_key, gate_vals.reshape(B, S * topk))
    return Route(slot_src[:, :-1], slot_gate[:, :-1], aux, slot_key)


def apply_moe(p, x: torch.Tensor, *, n_experts: int, topk: int,
              capacity_factor: float, mlp: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B, S, D) in x's dtype, the mean aux loss, float32)."""
    B, S, D = x.shape
    E = n_experts
    cap = capacity(capacity_factor, S, topk, E)
    plan = route(x, p["router"], E, topk, cap)

    rows = torch.arange(B, device=x.device)[:, None]
    xpad = torch.cat([x, x.new_zeros((B, 1, D))], dim=1)
    buf = xpad[rows, plan.slot_src]                                 # (B,E*cap,D)
    # (E, B * cap, D): one batched product an expert weight
    buf = buf.reshape(B, E, cap, D).transpose(0, 1).reshape(E, B * cap, D)
    h = buf @ p["w_in"]
    if mlp in ("swiglu", "geglu"):
        g = buf @ p["w_gate"]
        act = F.silu(g) if mlp == "swiglu" else F.gelu(g, approximate="tanh")
        h = act * h
    else:
        h = F.gelu(h, approximate="tanh")
    y = (h @ p["w_out"]).reshape(E, B, cap, D).transpose(0, 1)      # (B,E,cap,D)
    yflat = y.reshape(B, E * cap, D) * plan.slot_gate[..., None].to(y.dtype)

    # combine: each token's kept slots in ascending order (the reference's
    # scatter order), a dropped pair reading the zero row E * cap
    ypad = torch.cat([yflat, yflat.new_zeros((B, 1, D))], dim=1)
    keys = plan.slot_key.reshape(B, S, topk).sort(dim=-1).values
    out = torch.zeros((B, S, D), dtype=y.dtype, device=x.device)
    for j in range(topk):
        out = out + ypad[rows, keys[..., j]]
    return out.to(x.dtype), plan.aux.mean()
