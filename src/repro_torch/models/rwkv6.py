"""RWKV6 "Finch" block (arXiv:2404.05892): attention-free token mixing
with data-dependent decay.

Port of ``repro.models.rwkv6``: ``init_rwkv_time_mix`` (:33),
``_shift`` (:51), ``apply_rwkv_time_mix`` (:57), ``init_rwkv_channel_mix``
(:118), ``apply_rwkv_channel_mix`` (:128) and ``init_rwkv_states`` (:146).
Time mixing, per head of width ``hd`` (64):

    token shift:  z_t = lerp(x_t, x_{t-1}, mu_*)         per projection
    decay:        w_t = exp(-exp(w0 + tanh(z_w A) B))     (float32, in (0, 1))
    state:        S_t = diag(w_t) S_{t-1} + k_t v_t^T     (float32, hd x hd)
    out:          o_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
    y = W_o (groupnorm(o) * silu(g))

Channel mixing: token shift and a squared-ReLU MLP gated by a sigmoid
receptance.  Precision is the reference's: r, k, v and g in the compute
dtype, cast to float32 for the recurrence; ``mu``, ``w0``, the LoRA, ``u``
and ``ln_scale`` are float32 leaves whatever the parameter dtype; the
per-head group norm in float32 (eps 1e-5); ``o`` cast to the compute dtype
before ``silu(g)`` and ``W_o``.

**The recurrence, chunked.**  The reference runs it as a ``lax.scan`` over
S.  Here a prompt (S > 1) goes through :func:`wkv_chunked`: the sequence
is cut into chunks of :data:`CHUNK` (16) steps, all chunks at once.  With
``A`` the inclusive cumulative sum of ``log w`` inside a chunk (per
channel) and ``A_{-1} = 0``:

- the intra-chunk term: o_t += sum_{s<t} (sum_i r_ti k_si exp(A_{t-1,i} -
  A_{s,i})) v_s, the decay of every (t, s, i) formed on its own as a
  (C, C, hd) tensor a chunk and head;
- the ``u`` bonus on the diagonal: o_t += (r_t . (u * k_t)) v_t;
- the carry-in: o_t += (r_t * exp(A_{t-1})) S_in, with S_in the state
  before the chunk;
- between chunks the state is carried as S_out = exp(A_last) * S_in + U,
  U = sum_s (k_s * exp(A_last - A_s)) v_s^T, a linear recurrence over the
  chunks run by RG-LRU's Hillis-Steele doubling scan
  (:func:`repro_torch.models.rglru._linear_scan`), ``ceil(log2(n + 1))``
  rounds for n chunks (the carried state a virtual chunk 0).

**Every decay is exp of a non-positive difference of cumulative
log-decays.**  Under the random init ``log w`` reaches about -50 a step
(w0 ~ N(0, 0.5^2) plus a LoRA term of the same order), so a factored form
that divides by a cumulative decay (k / prod w) overflows within a few
steps; here the only rounding such a decay can suffer is underflow to 0.
Pairs with nothing between them (s = t - 1 inside a chunk, s = the
chunk's last step towards its end) take the constant 0, not the
difference: in float32 the backward of that difference adds an order-1
gradient into a cumulative sum and takes it out again, and at strong
decays the true gradient of ``log w`` (of order e^-50) drowned in that
rounding: 1.3% of ``w0``'s gradient (ROADMAP Queue 3).  Every other pair
spans a decay, so its gradient is as small as the true one.

**Launches.**  Counted as the non-view torch operations a call
dispatches (on the CPU), each one kernel on the card: :func:`wkv_chunked`
is about 37 whatever S, plus 4 for each of the scan's ``ceil(log2(n +
1))`` rounds (66 at S = 1024: 7 rounds; 78 at S = 8192); a prompt's time
mix 110 at S = 1024, its channel mix 17.  A decode step (S = 1) takes
the reference's step as it is (:func:`_wkv_step`): 51 for the time mix.
:func:`wkv_scan_torch` is the reference's step-by-step recurrence, the
plain version the tests and the card-side check hold the chunked form
against; the model never calls it.

**Under a mesh** ``r`` is constrained to (batch, None, model, None) as
in the reference (heads over ``model``) and :func:`wkv_chunked` runs on
each rank's heads through ``local_map`` (heads are independent), with
``k``, ``v``, ``log w``, ``u`` and the carried state placed as ``r``'s
heads; ``h`` of the channel mix is constrained to (batch, None, model).

**Carried state, in place.**  ``state`` holds ``s`` (B, H, hd, hd) float32
and ``x_prev`` (B, D) in the compute dtype; :func:`apply_rwkv_time_mix`
and :func:`apply_rwkv_channel_mix` read them, then overwrite them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.models.layers import Params, _init_w, _param, _split
from repro_torch.models.rglru import _linear_scan
from repro_torch.models.sharding import (constrain, grad_placements, is_dtensor,
                                         redistribute)

LORA_R = 64
#: Steps of a chunk of :func:`wkv_chunked`.
CHUNK = 16
GROUP_NORM_EPS = 1e-5


def init_rwkv_time_mix(gen: torch.Generator, d_model: int, head_dim: int,
                       dtype) -> Params:
    f32 = torch.float32
    n_heads = d_model // head_dim
    return Params({
        "mu": _init_w(gen, (5, d_model), f32, scale=0.1),  # r, k, v, g, w
        "w0": _init_w(gen, (d_model,), f32, scale=0.5),
        "w_lora_a": _init_w(gen, (d_model, LORA_R), f32),
        "w_lora_b": _init_w(gen, (LORA_R, d_model), f32),
        "u": _init_w(gen, (n_heads, head_dim), f32, scale=0.5),
        "wr": _init_w(gen, (d_model, d_model), dtype),
        "wk": _init_w(gen, (d_model, d_model), dtype),
        "wv": _init_w(gen, (d_model, d_model), dtype),
        "wg": _init_w(gen, (d_model, d_model), dtype),
        "wo": _init_w(gen, (d_model, d_model), dtype),
        "ln_scale": _param(torch.ones((d_model,), dtype=f32, device=gen.device)),
    })


def _shift(x: torch.Tensor, mu: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """lerp(x_t, x_{t-1}, mu); ``x_prev`` is the token before x[:, 0]."""
    prev = torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)
    return x + mu.to(x.dtype) * (prev - x)


def _wkv_step(s, r_t, k_t, v_t, w_t, u):
    """One step of the reference's scan body: (B, H, hd) inputs, state
    (B, H, hd, hd); returns (o_t, the new state)."""
    kv = k_t[..., :, None] * v_t[..., None, :]
    o_t = torch.einsum("bhk,bhkv->bhv", r_t, s + u[None, :, :, None] * kv)
    return o_t, w_t[..., :, None] * s + kv


def wkv_scan_torch(r, k, v, w, u, s0: Optional[torch.Tensor] = None):
    """The reference's recurrence, step by step over S (the plain version
    of :func:`wkv_chunked`).  r, k, v, w: (B, S, H, hd) float32; u (H, hd);
    s0 (B, H, hd, hd) or None for zeros.  Returns (o (B, S, H, hd), the
    final state)."""
    B, S, H, K = r.shape
    s = r.new_zeros((B, H, K, K)) if s0 is None else s0
    outs = []
    for t in range(S):
        o_t, s = _wkv_step(s, r[:, t], k[:, t], v[:, t], w[:, t], u)
        outs.append(o_t)
    return torch.stack(outs, dim=1), s


def wkv_chunked(r, k, v, log_w, u, s0: Optional[torch.Tensor] = None):
    """The recurrence of :func:`wkv_scan_torch` in chunks of :data:`CHUNK`
    (see the module note), given ``log w`` (<= 0) instead of ``w``.
    Returns (o (B, S, H, hd), the final state (B, H, hd, hd))."""
    B, S, H, K = r.shape
    C = CHUNK
    n = -(-S // C)
    pad = n * C - S
    if pad:  # r = k = v = 0, w = 1: the padded steps leave the state as it is
        r, k, v, log_w = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v, log_w))
    # (B, n, H, C, hd)
    r, k, v, log_w = (t.reshape(B, n, C, H, K).transpose(2, 3) for t in (r, k, v, log_w))
    A = log_w.cumsum(3)                                   # A_t, inclusive
    A_ex = F.pad(A, (0, 0, 1, 0))[..., :C, :]             # A_{t-1}, A_{-1} = 0
    ti = torch.arange(C, device=r.device)
    # (t, s, 1): the difference where s < t - 1, else a constant (see the
    # module note): 0 at s = t - 1, -inf (masked before exp) at s >= t
    between = (ti[:, None] - 1 > ti[None, :])[..., None]
    fill = A.new_zeros((C, C, 1)).masked_fill_((ti[None, :] >= ti[:, None])[..., None],
                                               -math.inf)
    decay = torch.where(between, A_ex[..., :, None, :] - A[..., None, :, :], fill)
    decay.exp_()                                          # (B, n, H, C, C, hd)
    # decay is not written again: autograd reads it in the backward
    att = torch.einsum("bnhtsd,bnhtd,bnhsd->bnhts", decay, r, k)
    del decay
    o = att @ v + (r * u[:, None, :] * k).sum(-1, keepdim=True) * v
    A_last = A[..., -1:, :]                               # (B, n, H, 1, hd)
    rest = torch.where((ti < C - 1)[:, None], A_last - A, 0.0)  # 0 at the last step
    U = (k * torch.exp(rest)).transpose(-1, -2) @ v       # (B, n, H, hd, hd)
    g = torch.exp(A_last).transpose(-1, -2)               # (B, n, H, hd, 1)
    if s0 is None:
        s0 = U.new_zeros((B, H, K, K))
    # the carried state as a virtual chunk 0 (decay 0), then chunk c's state
    # after it at position c + 1
    states = _linear_scan(torch.cat([torch.zeros_like(g[:, :1]), g], dim=1),
                          torch.cat([s0[:, None], U], dim=1))
    o = o + (r * torch.exp(A_ex)) @ states[:, :n]
    o = o.transpose(2, 3).reshape(B, n * C, H, K)[:, :S]
    return o, states[:, n]


def _wkv_one(r, k, v, log_w, u, s0=None):
    """A decode step's recurrence (S = 1): the reference's step as it is
    (:func:`_wkv_step`), inputs and output (B, 1, H, hd)."""
    if s0 is None:
        B, _, H, K = r.shape
        s0 = r.new_zeros((B, H, K, K))
    o, s = _wkv_step(s0, r[:, 0], k[:, 0], v[:, 0], torch.exp(log_w[:, 0]), u)
    return o[:, None], s


def _prev(state: dict, x: torch.Tensor) -> torch.Tensor:
    """The carried ``x_prev`` in x's dtype, whole on every rank of
    ``model`` (the cache keeps it sharded there)."""
    return constrain(state["x_prev"].to(x.dtype), "batch", None)


def _wkv_heads(fn, r, k, v, log_w, u, s0):
    """``fn`` (:func:`wkv_chunked` or :func:`_wkv_one`) on DTensors
    through ``local_map``: every input placed as ``r`` (B, S, H, hd) on
    the batch and the heads, ``u`` (H, hd) and the state (B, H, hd, hd) on
    the same heads."""

    mesh = r.device_mesh
    pl = list(r.placements)
    u_pl = [Shard(0) if p == Shard(2) else Replicate() for p in pl]
    s_pl = [Shard(1) if p == Shard(2) else p for p in pl]
    k, v, log_w = (redistribute(t, pl) for t in (k, v, log_w))
    u = redistribute(u, u_pl)
    if s0 is None:
        B, _, H, K = r.shape
        s0 = r.new_zeros((B, H, K, K))
    s0 = redistribute(s0, s_pl)
    in_pl = (pl, pl, pl, pl, u_pl, s_pl)
    return local_map(fn, out_placements=(pl, s_pl), in_placements=in_pl,
                     in_grad_placements=grad_placements(in_pl, pl),
                     device_mesh=mesh)(r, k, v, log_w, u, s0)


def apply_rwkv_time_mix(p, x: torch.Tensor, head_dim: int,
                        state: Optional[dict] = None
                        ) -> tuple[torch.Tensor, Optional[dict]]:
    """x (B, S, D) -> (y (B, S, D), state).  ``state`` ({"s": (B, H, hd,
    hd) float32, "x_prev": (B, D)}) is read, then overwritten in place."""
    B, S, D = x.shape
    H = D // head_dim
    f32 = torch.float32
    x_prev = x.new_zeros((B, D)) if state is None else _prev(state, x)
    zr, zk, zv, zg, zw = (_shift(x, p["mu"][i], x_prev) for i in range(5))
    r, k, v = (_split(z @ p[name], -1, H, head_dim).to(f32)
               for z, name in ((zr, "wr"), (zk, "wk"), (zv, "wv")))
    r = constrain(r, "batch", None, "model", None)
    g = zg @ p["wg"]
    lora = torch.tanh(zw.to(f32) @ p["w_lora_a"]) @ p["w_lora_b"]
    log_w = -torch.exp(p["w0"] + lora).reshape(B, S, H, head_dim)
    s0 = None if state is None else state["s"].to(f32)
    fn = _wkv_one if S == 1 else wkv_chunked
    if is_dtensor(r):
        o, s_final = _wkv_heads(fn, r, k, v, log_w, p["u"], s0)
    else:
        o, s_final = fn(r, k, v, log_w, p["u"], s0)
    # per-head group norm, float32
    mu = o.mean(-1, keepdim=True)
    var = ((o - mu) ** 2).mean(-1, keepdim=True)
    o = ((o - mu) * torch.rsqrt(var + GROUP_NORM_EPS)).reshape(B, S, D) * p["ln_scale"]
    y = (o.to(x.dtype) * F.silu(g)) @ p["wo"]
    if state is not None:
        state["s"].copy_(s_final)
        state["x_prev"].copy_(x[:, -1, :])
    return y, state


def init_rwkv_channel_mix(gen: torch.Generator, d_model: int, d_ff: int,
                          dtype) -> Params:
    return Params({
        "mu": _init_w(gen, (2, d_model), torch.float32, scale=0.1),  # k, r
        "wk": _init_w(gen, (d_model, d_ff), dtype),
        "wv": _init_w(gen, (d_ff, d_model), dtype),
        "wr": _init_w(gen, (d_model, d_model), dtype),
    })


def apply_rwkv_channel_mix(p, x: torch.Tensor, state: Optional[dict] = None
                           ) -> tuple[torch.Tensor, Optional[dict]]:
    """x (B, S, D) -> (y, state); ``state`` ({"x_prev": (B, D)}) is read,
    then overwritten in place."""
    B, S, D = x.shape
    x_prev = x.new_zeros((B, D)) if state is None else _prev(state, x)
    zk = _shift(x, p["mu"][0], x_prev)
    zr = _shift(x, p["mu"][1], x_prev)
    h = constrain(torch.square(F.relu(zk @ p["wk"])), "batch", None, "model")
    # wv is sharded on its output dim (the rules' ``wv``): h whole for it
    y = torch.sigmoid(zr @ p["wr"]) * (constrain(h, "batch", None, None) @ p["wv"])
    if state is not None:
        state["x_prev"].copy_(x[:, -1, :])
    return y, state


def init_rwkv_states(batch: int, d_model: int, head_dim: int, dtype, *,
                     device=None) -> dict:
    H = d_model // head_dim
    return {
        "time": {"s": torch.zeros((batch, H, head_dim, head_dim), dtype=torch.float32,
                                  device=device),
                 "x_prev": torch.zeros((batch, d_model), dtype=dtype, device=device)},
        "chan": {"x_prev": torch.zeros((batch, d_model), dtype=dtype, device=device)},
    }
