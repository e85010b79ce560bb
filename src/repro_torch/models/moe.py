"""Mixture-of-Experts FFN with top-k routing and capacity-based dispatch.

Port of ``repro.models.moe``: ``init_moe`` (:28-37), ``_route_row``
(:40-73) as :func:`route`, batched over B without a vmap, and
``apply_moe`` (:76-118), with the reference's ``constrain`` calls at
their sites.  Under a mesh the routing (stable sort, ``searchsorted``,
scatters), the dispatch gather and the combine run on each rank's batch
rows through ``local_map`` (``models.sharding.rows_local``): the router
is replicated, and the combine takes every expert's slots, so ``y`` is
gathered over ``model`` first.  The expert products run on each rank's
blocks too (:func:`_expert_ffn`): the experts over ``model`` when E
divides it, else each expert's d_ff.

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
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.models.layers import Params, _init_w
from repro_torch.models.sharding import (constrain, grad_placements, is_dtensor, redistribute,
                                         reduce_grad, rows_local)


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
    plan = Route(*rows_local(lambda x, r: _fields(route(x, r, E, topk, cap)),
                             (x,), (p["router"],), n_out=4))
    buf = rows_local(_dispatch, (x, plan.slot_src))                 # (B,E*cap,D)
    buf = constrain(buf.reshape(B, E, cap, D), "batch", "expert", None, None)
    y = _expert_ffn(buf, p["w_in"], p["w_gate"] if "w_gate" in p else None, p["w_out"],
                    mlp)                                            # (B,E,cap,D)
    y = constrain(y, "batch", "expert", None, None)
    yflat = y.reshape(B, E * cap, D)
    gate = plan.slot_gate[..., None].to(y.dtype)
    if is_dtensor(gate):   # placed as the expert slots (the gather back explicit)
        gate = redistribute(gate, yflat.placements)
    yflat = yflat * gate
    out = rows_local(lambda yf, key: _combine(yf, key, S, topk), (yflat, plan.slot_key))
    aux = plan.aux.mean()
    if is_dtensor(aux):   # the rows' mean, whole on every rank
        aux = redistribute(aux, [Replicate()] * aux.device_mesh.ndim)
    return out.to(x.dtype), aux


def _experts(buf, w_in, w_gate, w_out, mlp: str) -> torch.Tensor:
    """The expert MLPs of the dispatch buffer (B, E, cap, D): one batched
    product an expert weight over (E, B * cap, D)."""
    B, E, cap, D = buf.shape
    x = buf.transpose(0, 1).reshape(E, B * cap, D)
    h = x @ w_in
    if mlp in ("swiglu", "geglu"):
        g = x @ w_gate
        act = F.silu(g) if mlp == "swiglu" else F.gelu(g, approximate="tanh")
        h = act * h
    else:
        h = F.gelu(h, approximate="tanh")
    return (h @ w_out).reshape(E, B, cap, D).transpose(0, 1)


def _expert_ffn(buf, w_in, w_gate, w_out, mlp: str) -> torch.Tensor:
    """:func:`_experts`; under a mesh on each rank's blocks through
    ``local_map`` (a DTensor reshape would merge the batch, split over
    two mesh dims on two pods, with the slots): the experts over
    ``model`` (the output sharded on them) or each expert's d_ff (the
    output a partial sum, and so is the buffer's gradient)."""
    if not is_dtensor(buf):
        return _experts(buf, w_in, w_gate, w_out, mlp)
    mesh = buf.device_mesh
    names = mesh.mesh_dim_names
    mi = names.index("model") if "model" in names else None
    ff_split = mi is not None and w_in.placements[mi] == Shard(2)
    out = [Partial() if i == mi and ff_split else p for i, p in enumerate(buf.placements)]
    ws = (w_in, w_gate, w_out)
    in_pl = (list(buf.placements),) + tuple(None if w is None else list(w.placements)
                                            for w in ws)
    grads = grad_placements(in_pl, buf.placements)
    grads = (out,) + grads[1:]
    return local_map(lambda b, wi, wg, wo: _experts(b, wi, wg, wo, mlp),
                     out_placements=out, in_placements=in_pl,
                     in_grad_placements=grads, device_mesh=mesh)(reduce_grad(buf), *ws)


def _fields(plan: Route) -> tuple:
    return tuple(getattr(plan, f.name) for f in dataclasses.fields(plan))


def _dispatch(x: torch.Tensor, slot_src: torch.Tensor) -> torch.Tensor:
    """(B, E * cap, D): each slot's token row (the zero row S for an empty
    slot)."""
    B, _, D = x.shape
    rows = torch.arange(B, device=x.device)[:, None]
    return torch.cat([x, x.new_zeros((B, 1, D))], dim=1)[rows, slot_src]


def _combine(yflat: torch.Tensor, slot_key: torch.Tensor, S: int, topk: int
             ) -> torch.Tensor:
    """Each token's kept slots of ``yflat`` (B, E * cap, D) summed in
    ascending order (the reference's scatter order), a dropped pair
    reading the zero row E * cap."""
    B, _, D = yflat.shape
    rows = torch.arange(B, device=yflat.device)[:, None]
    ypad = torch.cat([yflat, yflat.new_zeros((B, 1, D))], dim=1)
    keys = slot_key.reshape(B, S, topk).sort(dim=-1).values
    out = torch.zeros((B, S, D), dtype=yflat.dtype, device=yflat.device)
    for j in range(topk):
        out = out + ypad[rows, keys[..., j]]
    return out
