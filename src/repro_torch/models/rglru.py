"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

Port of ``repro.models.rglru``: ``init_rglru_block`` (:34-50),
``_depthwise_causal_conv`` (:53-66), ``_rglru_scan`` (:69-90),
``apply_rglru_block`` (:93-110) and ``init_rglru_state`` (:112-116).
Recurrence (per channel):

    r_t = sigmoid(w_r * u_t + b_r)              (recurrence gate)
    i_t = sigmoid(w_i * u_t + b_i)              (input gate)
    log a_t = c * r_t * log sigmoid(lam)        (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

The gates and ``lam`` are float32 leaves whatever the parameter dtype, as
in the reference.  Block: x -> [gate branch: Linear -> GeLU] * [rec
branch: Linear -> causal depthwise conv -> RG-LRU] -> Linear out.

**The scan.**  The reference runs ``lax.associative_scan`` over S (h_t =
a_t h_{t-1} + b_t composes associatively).  Here it is a Hillis-Steele
doubling scan in plain torch: round d combines every step with the one d
back, ``ceil(log2 S)`` rounds (12 at S = 4096) of whole-tensor
operations, where a loop over S would launch thousands of small steps a
layer.  The sums are taken in another order than XLA's, so the port
holds to the reference within a float32 tolerance, not bit for bit.

**Carried state, in place.**  ``state`` holds float32 buffers ``h`` (B, R)
and ``conv`` (B, W - 1, R), which :func:`apply_rglru_block` reads and then
overwrites.  The reference returns ``h`` in the compute dtype and the conv
window in ``u``'s dtype, so what it carries after a step is rounded to
that dtype (bf16 in the full configs); the port stores those rounded
values in its float32 buffers, which hold them exactly.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Params, _init_w, _param

C_FACTOR = 8.0


def init_rglru_block(gen: torch.Generator, d_model: int, r_dim: int,
                     conv_width: int, dtype) -> Params:
    dev, f32 = gen.device, torch.float32
    # lam so that a^c lies in (0.9, 0.999): the standard LRU init
    u = 0.9 + 0.099 * torch.rand((r_dim,), generator=gen, dtype=f32, device=dev)
    uc = u ** (1.0 / C_FACTOR)
    return Params({
        "w_in": _init_w(gen, (d_model, r_dim), dtype),
        "w_gate_br": _init_w(gen, (d_model, r_dim), dtype),
        "conv_k": _init_w(gen, (conv_width, r_dim), dtype, scale=1.0 / math.sqrt(conv_width)),
        "conv_b": _param(torch.zeros((r_dim,), dtype=dtype, device=dev)),
        "gate_wr": _init_w(gen, (r_dim,), f32, scale=1.0),
        "gate_br": _param(torch.zeros((r_dim,), dtype=f32, device=dev)),
        "gate_wi": _init_w(gen, (r_dim,), f32, scale=1.0),
        "gate_bi": _param(torch.zeros((r_dim,), dtype=f32, device=dev)),
        "lam": _param(torch.log(uc / (1 - uc))),
        "w_out": _init_w(gen, (r_dim, d_model), dtype),
    })


def _depthwise_causal_conv(u: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                           state: Optional[torch.Tensor] = None):
    """u: (B, S, R); kernel: (W, R); state: (B, W - 1, R) trailing context.
    Returns the output and the new trailing context, both in u's dtype."""
    W = kernel.shape[0]
    if state is None:
        pad = u.new_zeros((u.shape[0], W - 1, u.shape[2]))
    else:
        pad = state.to(u.dtype)
    full = torch.cat([pad, u], dim=1)                       # (B, S+W-1, R)
    S = u.shape[1]
    out = full[:, 0:S] * kernel[0]
    for i in range(1, W):
        out = out + full[:, i:i + S] * kernel[i]
    return out + bias, full[:, -(W - 1):]


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over dim 1 from h_{-1} = 0: Hillis-Steele
    doubling, ``ceil(log2 S)`` rounds.  Round d combines step t with the
    prefix ending at t - d: (a, b)_t <- (a_{t-d} a_t, a_t b_{t-d} + b_t)."""
    S = a.shape[1]
    d = 1
    while d < S:
        b = torch.cat([b[:, :d], torch.addcmul(b[:, d:], a[:, d:], b[:, :-d])], dim=1)
        if 2 * d < S:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def _rglru_scan(u: torch.Tensor, p, h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """u: (B, S, R) -> h (B, S, R) in u's dtype; h0 (B, R) is folded in as
    a virtual step 0 (a = 0, b = h0), as in the reference."""
    uf = u.to(torch.float32)
    r = torch.sigmoid(uf * p["gate_wr"] + p["gate_br"])
    i = torch.sigmoid(uf * p["gate_wi"] + p["gate_bi"])
    log_a = C_FACTOR * r * F.logsigmoid(p["lam"])
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * uf)
    if h0 is not None:
        a = torch.cat([torch.zeros_like(a[:, :1]), a], dim=1)
        b = torch.cat([h0.to(torch.float32)[:, None, :], b], dim=1)
    h = _linear_scan(a, b)
    if h0 is not None:
        h = h[:, 1:]
    return h.to(u.dtype)


def apply_rglru_block(p, x: torch.Tensor, state: Optional[dict] = None
                      ) -> tuple[torch.Tensor, Optional[dict]]:
    """x (B, S, D) -> (y (B, S, D), state).  ``state`` ({"h": (B, R),
    "conv": (B, W - 1, R)}, float32) is read, then overwritten in place
    with the values the reference would carry (see the module note)."""
    gate = F.gelu(x @ p["w_gate_br"], approximate="tanh")
    u = x @ p["w_in"]
    u, conv_state = _depthwise_causal_conv(
        u, p["conv_k"], p["conv_b"], None if state is None else state["conv"])
    h = _rglru_scan(u, p, None if state is None else state["h"])
    y = (h * gate) @ p["w_out"]
    if state is not None:
        state["h"].copy_(h[:, -1, :])
        state["conv"].copy_(conv_state)
    return y, state


def init_rglru_state(batch: int, r_dim: int, conv_width: int, dtype, *,
                     device=None) -> dict:
    return {"h": torch.zeros((batch, r_dim), dtype=dtype, device=device),
            "conv": torch.zeros((batch, conv_width - 1, r_dim), dtype=dtype,
                                device=device)}
