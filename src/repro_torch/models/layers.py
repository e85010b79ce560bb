"""Shared neural layers of the dense decoders: norms, RoPE, GQA/MQA
attention (KV cache, sliding window, cross attention), gated MLPs,
embeddings and the LM head.

Port of ``repro.models.layers``.  Parameters are ``nn.ParameterDict``s
keyed as the reference's dicts (``wq wk wv wo``, ``w_in w_gate w_out``,
``scale bias``, ``emb``, ``w``); matmul weights keep the reference's
``(in, out)`` layout, so ``x @ w`` means the same in both.  ``init_*``
functions draw from an explicit ``torch.Generator`` on the target device
(the reference's JAX keys cannot be reproduced: parity goes through
:func:`repro_torch.models.convert.params_from_numpy`).  The reference's
``constrain`` calls stand at the same sites (:mod:`repro_torch.models.
sharding`): without a mesh they do nothing.

**Under a mesh** (parameters and activations DTensors, ``use_mesh``)
every op is a DTensor op, except the attention core that K12 computes:
:func:`_local_heads` runs :func:`_flash_gqa` through ``local_map`` on each
rank's local query heads and the K/V heads they read.  Where the heads do
not divide the ``model`` axis (24 or 56 heads on 16) every rank computes
them all; where the K/V heads do not (one KV head, or 8 on 16) they are
gathered and each rank picks the ones its heads read.  A reshape that
would split or merge a sharded dim in a way DTensor cannot express
(:func:`_split`, :func:`_merge_last`) first replicates it.  A decode
step over a head_dim-sharded cache follows the reference's plan: q is
sharded on head_dim too, the logits are partial sums reduced over
``model``, and P·V stays head_dim-sharded.

What each part replaces in ``src/repro/models/layers.py``: ``init_norm``
/ ``apply_norm`` (:32-52, float32 inside, eps 1e-6); ``apply_rope``
(:59-71, float32 angles, then cast); ``_flash_gqa`` (:78-172);
``attention`` (:189-316, the naive and flash paths, the KV cache, the
window, cross attention through ``memory=`` / ``kv_override=``);
``init_kv_cache`` (:319); ``init_mlp`` / ``apply_mlp`` (:328-348;
``jax.nn.gelu`` is the tanh approximation); ``embed``, ``init_head``,
``lm_logits`` (:355-374, the tied head scaled by ``d ** -0.5``).

**K12 on the path.**  ``attention(impl="flash")`` with S > 1 goes through
:func:`_flash_gqa`.  On CPU tensors that is the plain version: the
reference's online-softmax recurrence over (q_chunk, k_chunk) tiles, with
its padding, masks and precision (logits in float32, P and the
accumulator in the compute dtype).  On CUDA tensors it launches K12,
:func:`~repro_torch.kernels.flash_attention.flash_attention_fwd_cuda`, on
``q`` reshaped to (B, S, H, hd): the reference's (KV, G) grouping
flattens to head ``kv * G + g``, which is K12's ``h // G`` rule.  The
config's chunks are the plain version's loop tiles; K12 tiles on its own,
so it is called with one chunk spanning S and T and nothing is padded.

K12's contract, as the model uses it: causal attention whose query and
key positions start at the same base (the masks ``kpos <= qpos`` and
``kpos > qpos - window`` are then relative, so the positions themselves
only enter RoPE), with or without a window (the ``"local"`` blocks'
``local_window``, Mixtral's ``sliding_window``), or non-causal attention
with no masked key.  :func:`k12_refusal` decides from host integers that
:func:`attention` knows (``cache_pos``, whether there is a ``memory``, S),
never by reading ``positions`` back from the device.  No-cache
self-attention (the reference's ``q_base = k_base = positions[:, 0]``)
fits, and so does a cached prefill at ``cache_pos = 0``, where every
caller's positions start at 0.  A CUDA call outside the contract (a
cached prefill at ``cache_pos > 0``, a causal or non-causal call with
masked keys) raises ``NotImplementedError``; it never runs the plain
version.  No caller of the port or the reference makes either (ROADMAP
R8): prefill runs at ``cache_pos = 0`` only (``repro/models/model.py:80``),
every later call is a decode step (S = 1, the einsum path), and Whisper's
encoder and cross attention are non-causal with every key valid (the
cross attention's ``kv_override`` comes with no cache, so ``k_len = T``):
K12's non-causal path at q_base = k_base = 0, T = 1500 keys.

**Under a gradient** (training: no cache, ``q_base = k_base``, every key
valid, so always inside the contract) ``_flash_gqa`` goes through
:class:`~repro_torch.kernels.flash_attention.K12Attention` on both
devices: K12's forward (its plain version on CPU tensors) and the
attention gradient in torch ops, ``flash_attention_bwd``; a call outside
the contract raises there too.  Without a gradient (serving) nothing
changes.

**Cache handling: sliced.**  The cache is written in place at
``cache_pos`` and returned.  A flash call with a cache attends to the
first ``cache_pos + S`` cache rows with ``k_len = cache_pos + S``, not to
the whole ``max_len`` cache as the reference does; both give the same
result, since the rows past ``cache_pos + S`` are masked.  At
``cache_pos = 0`` those rows are the ``k`` and ``v`` just written, so they
are passed as they are (contiguous: no copy), where ``cache[:, :S]``
would be copied by the wrapper for B > 1.

**Decode stays on ``torch.matmul``.**  A decode step (S = 1) takes the
reference's einsum path (:288-316), as the reference does: one query row
against the cache, read-bound on the cache, with no Pallas kernel in the
reference either.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch._subclasses.fake_tensor import is_fake
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.models.sharding import constrain, is_dtensor, redistribute, replicate_partials

Params = nn.ParameterDict
NEG_INF = -1e30


def _param(t: torch.Tensor) -> nn.Parameter:
    # created frozen, so serving builds no autograd graph over the weights;
    # the trainer turns their gradients on (``params.requires_grad_(True)``)
    return nn.Parameter(t, requires_grad=False)


def _init_w(gen: torch.Generator, shape, dtype, scale: float | None = None):
    if gen.device.type == "meta":  # abstract parameters: shapes and dtypes only
        return _param(torch.empty(shape, dtype=dtype, device="meta"))
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return _param((w * std).to(dtype))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(kind: str, dim: int, dtype, *, device=None) -> Params:
    p = Params({"scale": _param(torch.ones(dim, dtype=dtype, device=device))})
    if kind == "layernorm":
        p["bias"] = _param(torch.zeros(dim, dtype=dtype, device=device))
    return p


def apply_norm(kind: str, p, x: torch.Tensor, eps: float = 1e-6):
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    elif kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
    else:
        raise ValueError(kind)
    y = y * p["scale"].to(torch.float32)
    if "bias" in p:
        y = y + p["bias"].to(torch.float32)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (B, S, H, hd); positions: (B, S) int32."""
    hd = x.shape[-1]
    half = hd // 2
    f32 = torch.float32
    freqs = theta ** (-torch.arange(0, half, dtype=f32, device=x.device) / half)
    ang = positions[..., None].to(f32) * freqs               # (B,S,half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Flash (chunked online-softmax) attention core
# ---------------------------------------------------------------------------

def k12_refusal(S: int, T: int, *, q_base: int, k_base: int, k_len: int,
                causal: bool, window: Optional[int]) -> Optional[str]:
    """Why K12 cannot compute this :func:`_flash_gqa` call, or ``None``
    when it can.  Host integers only: ``q_base`` and ``k_base`` are the
    positions of query 0 and key 0, ``k_len`` the number of valid keys of
    the T passed."""
    if q_base != k_base:
        return (f"query positions start {q_base - k_base} past the keys' (a "
                f"cached prefill at cache_pos > 0); K12 has no query offset, and no "
                f"caller in the reference needs one yet")
    if causal:
        if window is not None and T < S:
            return (f"window {window} with {T} keys for {S} queries: rows past "
                    f"T + window - 1 would see no key")
        if k_len < min(S, T):
            return (f"{k_len} valid keys for {S} causal queries; K12 has no key "
                    f"length, and no caller in the reference needs one yet")
    elif k_len < T:
        return (f"non-causal with {T - k_len} masked keys; K12 has no key length, and "
                f"no caller in the reference needs one yet")
    return None


def _flash_gqa(
    qg: torch.Tensor,        # (B, S, KV, G, hd)
    k: torch.Tensor,         # (B, T, KV, hd)
    v: torch.Tensor,         # (B, T, KV, hd)
    q_base,                  # int or (B,) position of query 0
    k_base,                  # int or (B,) position of key 0
    k_len,                   # int or (B,) number of valid keys
    *,
    causal: bool,
    window: Optional[int],
    scale: float,
    q_chunk: int,
    k_chunk: int,
) -> torch.Tensor:
    """Online-softmax attention: K12 on CUDA tensors, the reference's
    recurrence on CPU tensors (every chunk computed, masked ones too, as
    the reference's scans do).  While autograd records (grad enabled and
    q, k or v requiring grad) it is :class:`~repro_torch.kernels.
    flash_attention.K12Attention` on both devices, inside K12's contract
    or raising."""
    B, S, KV, G, hd = qg.shape
    T = k.shape[1]
    recording = torch.is_grad_enabled() and any(x.requires_grad for x in (qg, k, v))
    fake = is_fake(qg)   # the dry run: counted as K12, its plain version one tile
    if qg.is_cuda or recording or fake:
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import registry

        if not all(isinstance(b, int) for b in (q_base, k_base, k_len)):
            raise NotImplementedError("K12 takes host-integer bases and key length")
        why = k12_refusal(S, T, q_base=q_base, k_base=k_base, k_len=k_len,
                          causal=causal, window=window)
        if why is None and scale != 1.0 / math.sqrt(hd):
            why = f"scale {scale}; K12 scales by 1/sqrt(hd)"
        if why is not None:
            raise NotImplementedError(f"outside K12's contract: {why}")
        q = qg.reshape(B, S, KV * G, hd)
        if recording:  # K12 forward, its gradient in torch ops (both devices)
            out = fa.K12Attention.apply(q, k, v, causal, window)
        else:
            kw = dict(causal=causal, q_chunk=S, k_chunk=T, window=window)
            fwd = fa.flash_attention_fwd_cuda if qg.is_cuda else fa.flash_attention_fwd_torch
            with registry.dispatched(fa.k12_entry(q), q, k, v, **kw):
                out = fwd(q, k, v, **kw)
        return out.reshape(B, S, KV, G, hd)

    dev, i32, f32 = qg.device, torch.int32, torch.float32
    q_base, k_base, k_len = (torch.as_tensor(b, dtype=i32, device=dev).expand(B)
                             for b in (q_base, k_base, k_len))
    q_chunk, k_chunk = min(q_chunk, S), min(k_chunk, T)
    s_pad, t_pad = (-S) % q_chunk, (-T) % k_chunk
    if s_pad:
        qg = F.pad(qg, (0, 0, 0, 0, 0, 0, 0, s_pad))
    if t_pad:
        k = F.pad(k, (0, 0, 0, 0, 0, t_pad))
        v = F.pad(v, (0, 0, 0, 0, 0, t_pad))
        k_len = torch.clamp(k_len, max=T)
    nq, nk = qg.shape[1] // q_chunk, k.shape[1] // k_chunk
    ci = torch.arange(q_chunk, dtype=i32, device=dev)
    cj = torch.arange(k_chunk, dtype=i32, device=dev)
    dt = qg.dtype
    outs = []
    for qi in range(nq):
        qc = qg[:, qi * q_chunk:(qi + 1) * q_chunk]          # (B,Cq,KV,G,hd)
        qpos = q_base[:, None] + qi * q_chunk + ci[None, :]   # (B,Cq)
        m = torch.full((B, KV, G, q_chunk), -math.inf, dtype=f32, device=dev)
        l = torch.zeros((B, KV, G, q_chunk), dtype=f32, device=dev)
        acc = torch.zeros((B, KV, G, q_chunk, hd), dtype=dt, device=dev)
        for ki in range(nk):
            kc = k[:, ki * k_chunk:(ki + 1) * k_chunk]
            vc = v[:, ki * k_chunk:(ki + 1) * k_chunk]
            kpos = k_base[:, None] + ki * k_chunk + cj[None, :]   # (B,Ck)
            # products of the compute dtype, summed in float32
            logits = torch.einsum("bckgh,bdkh->bkgcd", qc.to(f32), kc.to(f32)) * scale
            kid = ki * k_chunk + cj[None, :]
            mask = (kid < k_len[:, None])[:, None, None, None, :]
            if causal:
                cm = kpos[:, None, :] <= qpos[:, :, None]          # (B,Cq,Ck)
                if window is not None:
                    cm &= kpos[:, None, :] > (qpos[:, :, None] - window)
                mask = mask & cm[:, None, None, :, :]
            logits = torch.where(mask, logits, NEG_INF)
            m_new = torch.maximum(m, logits.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(logits - m_new[..., None])
            l = l * alpha + p.sum(-1)
            pv = torch.einsum("bkgcd,bdkh->bkgch", p.to(dt).to(f32),
                              vc.to(f32)).to(dt)
            acc = acc * alpha[..., None].to(dt) + pv
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None].to(dt)
        outs.append(out.permute(0, 3, 1, 2, 4))               # (B,Cq,KV,G,hd)
    return torch.cat(outs, dim=1)[:, :S]


# ---------------------------------------------------------------------------
# Reshapes and the attention core under a mesh (DTensor inputs)
# ---------------------------------------------------------------------------

def _replicated_on(t, dims):
    """``t`` with every mesh dim that shards one of tensor dims ``dims``
    replicated (a no-op for a plain tensor or when none does)."""

    if not is_dtensor(t):
        return t
    want = [Replicate() if isinstance(pl, Shard) and pl.dim in dims else pl
            for pl in t.placements]
    return redistribute(t, want)


def _split(t: torch.Tensor, dim: int, *sizes: int) -> torch.Tensor:
    """Dim ``dim`` split into ``sizes``.  DTensor keeps a shard of it on
    the first new dim only when ``sizes[0]`` divides over its mesh dim;
    otherwise the dim is replicated first."""

    dim %= t.ndim
    if is_dtensor(t):
        mesh = t.device_mesh
        if any(isinstance(pl, Shard) and pl.dim == dim and sizes[0] % mesh.size(i)
               for i, pl in enumerate(t.placements)):
            t = _replicated_on(t, (dim,))
    return t.reshape(*t.shape[:dim], *sizes, *t.shape[dim + 1:])


def _merge_last(t: torch.Tensor, k: int) -> torch.Tensor:
    """The last ``k`` dims merged into one.  DTensor keeps a shard of the
    first of them only; a shard of a later one is replicated first."""
    nd = t.ndim
    t = _replicated_on(t, tuple(range(nd - k + 1, nd)))
    return t.reshape(*t.shape[:nd - k], -1)


def _local_heads(q, k, v, core, *rows):
    """``core(qg, k, v, *rows)`` (an attention core on plain tensors: qg
    (B, S, KV, G, hd) in, the same shape out) on DTensors q (B, S, H, hd)
    and k, v (B, T, KV, hd) through ``local_map``: each rank runs it (K12
    on the card, for :func:`_flash_gqa`) over its local query heads and
    the K/V heads they read; ``rows`` (B, ...) enter as q's batch.
    Returns (B, S, H, hd), sharded on heads as q is.

    Heads go over ``model`` when H divides it (else every rank takes all
    H); K/V heads stay sharded when KV divides it too (a rank's query
    heads then read exactly its K/V shard), else they are gathered and
    each rank takes the heads its queries read: one K/V head when its
    heads sit inside one group (``G % H_local == 0``), one a query head
    otherwise (their gradients are then partial sums over ``model``).
    The batch keeps q's placement."""

    mesh = q.device_mesh
    names = mesh.mesh_dim_names
    H, KV = q.shape[2], k.shape[2]
    G = H // KV
    mi = names.index("model") if "model" in names else None
    n = 1 if mi is None else mesh.size(mi)
    heads_split = n > 1 and H % n == 0
    kv_split = heads_split and KV % n == 0
    coord = 0 if mi is None else mesh.get_local_rank("model")

    def pl(split):
        return [((Shard(2) if split else Replicate()) if i == mi else
                 (p if isinstance(p, Shard) and p.dim == 0 else Replicate()))
                for i, p in enumerate(q.placements)]

    q_pl, kv_pl = pl(heads_split), pl(kv_split)
    rows_pl = pl(False)
    q = redistribute(q, q_pl)
    k = redistribute(k, kv_pl)
    v = redistribute(v, kv_pl)
    rows = tuple(redistribute(r, rows_pl) for r in rows)

    def body(ql, kl, vl, *rl):
        B, S, Hl, hd = ql.shape
        h0 = coord * Hl if heads_split else 0
        if kv_split or Hl == H:
            kvl, g = kl.shape[2], G
        elif G % Hl == 0:                     # every local head in one group
            kl, vl = (t[:, :, h0 // G:h0 // G + 1] for t in (kl, vl))
            kvl, g = 1, Hl
        else:                                 # one K/V head a query head
            idx = torch.arange(h0, h0 + Hl, device=kl.device) // G
            kl, vl = kl.index_select(2, idx), vl.index_select(2, idx)
            kvl, g = Hl, 1
        out = core(ql.reshape(B, S, kvl, g, hd), kl.contiguous(), vl.contiguous(), *rl)
        return out.reshape(B, S, Hl, hd)

    # K/V gathered for split heads: each rank's gradient covers its heads
    # only, a partial sum over ``model``
    kv_grad = [Partial() if i == mi and heads_split and not kv_split else p
               for i, p in enumerate(kv_pl)]
    n_rows = len(rows)
    return local_map(body, out_placements=q_pl,
                     in_placements=(q_pl, kv_pl, kv_pl) + (rows_pl,) * n_rows,
                     in_grad_placements=(q_pl, kv_grad, kv_grad) + (rows_pl,) * n_rows,
                     device_mesh=mesh)(q, k, v, *rows)


def _hd_plan(kv, q_model, out_model):
    """Placements for a product of ``x`` with the head_dim-sharded cache
    tensor ``kv`` (B, T, KV, hd): on ``model`` ``x`` takes ``q_model`` and
    the result ``out_model``; on the other mesh dims ``x`` and the result
    follow the cache (batch rows, or, for a length-sharded cache,
    ``x``'s T slice and a partial result)."""

    mi = kv.device_mesh.mesh_dim_names.index("model")
    x_pl, out_pl = [], []
    for i, p in enumerate(kv.placements):
        if i == mi:
            x_pl.append(q_model)
            out_pl.append(out_model)
        elif p == Shard(0):
            x_pl.append(Shard(0))
            out_pl.append(Shard(0))
        elif p == Shard(1):
            x_pl.append(None)
            out_pl.append(None)
        else:
            x_pl.append(Replicate())
            out_pl.append(Replicate())
    return x_pl, out_pl


def _hd_partial(qg, k):
    """Logits (B, KV, G, S, T) of head_dim-sharded qg and k, each rank
    contracting its head_dim slice: partial sums over ``model``."""

    q_pl, out_pl = _hd_plan(k, Shard(4), Partial())
    q_pl = [Replicate() if p is None else p for p in q_pl]
    out_pl = [Shard(4) if p is None else p for p in out_pl]   # a T slice
    qg = redistribute(qg, q_pl)
    return local_map(lambda a, b: torch.einsum("bskgh,btkh->bkgst", a, b),
                     out_placements=out_pl, in_placements=(q_pl, list(k.placements)),
                     device_mesh=k.device_mesh)(qg, k)


def _hd_local(probs, v):
    """P·V (B, S, KV, G, hd) of probs (B, KV, G, S, T) and a
    head_dim-sharded v, each rank its head_dim slice."""

    p_pl, out_pl = _hd_plan(v, Replicate(), Shard(4))
    p_pl = [Shard(4) if p is None else p for p in p_pl]       # its T slice
    out_pl = [Partial() if p is None else p for p in out_pl]
    probs = redistribute(probs, p_pl)
    return local_map(lambda a, b: torch.einsum("bkgst,btkh->bskgh", a, b),
                     out_placements=out_pl, in_placements=(p_pl, list(v.placements)),
                     device_mesh=v.device_mesh)(probs, v)


def _model_shards_dim(t, dim: int) -> bool:
    """Whether DTensor ``t`` is sharded on tensor dim ``dim`` over ``model``."""

    if not is_dtensor(t) or "model" not in t.device_mesh.mesh_dim_names:
        return False
    pl = t.placements[t.device_mesh.mesh_dim_names.index("model")]
    return isinstance(pl, Shard) and pl.dim == dim


# ---------------------------------------------------------------------------
# Attention (GQA / MQA / cross) with optional KV cache & sliding window
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, d_model: int, n_heads: int, n_kv: int,
                   hd: int, dtype) -> Params:
    return Params({
        "wq": _init_w(gen, (d_model, n_heads * hd), dtype),
        "wk": _init_w(gen, (d_model, n_kv * hd), dtype),
        "wv": _init_w(gen, (d_model, n_kv * hd), dtype),
        "wo": _init_w(gen, (n_heads * hd, d_model), dtype),
    })


def attention(
    p,
    x: torch.Tensor,                     # (B, S, D)
    *,
    n_heads: int,
    n_kv: int,
    hd: int,
    positions: torch.Tensor,             # (B, S) query positions
    rope_theta: Optional[float] = 10_000.0,   # None => no RoPE (Whisper)
    causal: bool = True,
    window: Optional[int] = None,
    cache: Optional[dict] = None,        # {"k","v": (B, L, n_kv, hd)}, written in place
    cache_pos: Optional[int] = None,     # host int write offset (= positions[:, 0])
    memory: Optional[torch.Tensor] = None,    # (B, T, D) cross-attn source
    kv_override: Optional[tuple] = None,      # precomputed (k, v) (cross cache)
    impl: str = "naive",                      # naive | flash (chunked)
    q_chunk: int = 1024,
    k_chunk: int = 1024,
) -> tuple[torch.Tensor, Optional[dict]]:
    B, S, D = x.shape
    # q/k/v carry no explicit constraints, as in the reference: their
    # heads are sharded as wq/wk/wv's flat feature dim allows
    q = _split(x @ p["wq"], -1, n_heads, hd)
    if kv_override is not None:
        k, v = kv_override
        memory = k  # mark as cross-attention (no causal/rope path below)
    else:
        kv_src = memory if memory is not None else x
        k = _split(kv_src @ p["wk"], -1, n_kv, hd)
        v = _split(kv_src @ p["wv"], -1, n_kv, hd)

    if rope_theta is not None and memory is None:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)

    new_cache = None
    if cache is not None:
        k = k.to(cache["k"].dtype)
        v = v.to(cache["v"].dtype)
        cache["k"][:, cache_pos:cache_pos + S] = k
        cache["v"][:, cache_pos:cache_pos + S] = v
        new_cache = cache

    g = n_heads // n_kv
    scale = 1.0 / math.sqrt(hd)
    use_causal = causal and memory is None

    if impl == "flash" and S > 1:
        if cache is not None:
            # sliced: the valid rows only (at cache_pos 0, the k, v just written)
            q_base, k_len = cache_pos, cache_pos + S
            if cache_pos:
                k, v = cache["k"][:, :k_len], cache["v"][:, :k_len]
            # cached prefill: K/V gathered once a layer over ``model``
            k = constrain(k, "batch", None, None, None)
            v = constrain(v, "batch", None, None, None)
        else:
            # no cache: query and key positions share their base, so the
            # masks are relative (the reference's q_base = k_base)
            q_base, k_len = 0, k.shape[1]
        kw = dict(causal=use_causal, window=window, scale=scale, q_chunk=q_chunk,
                  k_chunk=k_chunk)
        if is_dtensor(q):
            out = _local_heads(q, k, v, lambda qg, kl, vl: _flash_gqa(
                qg, kl, vl, q_base, 0, k_len, **kw))
        else:
            out = _flash_gqa(q.reshape(B, S, n_kv, g, hd), k, v, q_base, 0, k_len,
                             **kw)
        out = constrain(_merge_last(out, out.ndim - 2), "batch", None, "model")
        return out @ p["wo"], new_cache

    if cache is not None:
        k, v = cache["k"], cache["v"]
    mask_kw = dict(valid_upto=None if cache is None else cache_pos + S - 1,
                   cross=memory is not None, causal=use_causal, window=window)
    if S == 1 and _model_shards_dim(k, 3):
        # decode over a head_dim-sharded cache: q sharded on head_dim too, so
        # the logits are local partial contractions reduced over ``model``,
        # and P·V stays head_dim-sharded like v
        qg = constrain(_split(q, 2, n_kv, g), "batch", None, None, None, "model")
        logits = _hd_partial(qg.to(torch.float32), k.to(torch.float32)) * scale
        logits = redistribute(logits, replicate_partials(logits.placements))
        mask = _key_mask(positions, k.shape[1], **mask_kw)
        logits = torch.where(mask[:, None, None, :, :], logits, NEG_INF)
        out = _merge_last(_hd_local(torch.softmax(logits, dim=-1).to(x.dtype),
                                    v.to(x.dtype)), 3)
    elif is_dtensor(q):
        out = _merge_last(_local_heads(
            q, k, v, lambda qg, kl, vl, pos: _naive_core(qg, kl, vl, pos, scale, x.dtype,
                                                         **mask_kw), positions), 2)
    else:
        out = _naive_core(q.reshape(B, S, n_kv, g, hd), k, v, positions, scale, x.dtype,
                          **mask_kw).reshape(B, S, n_heads * hd)
    out = constrain(out, "batch", None, "model")
    return out @ p["wo"], new_cache


def _key_mask(positions, T: int, *, valid_upto, cross: bool, causal: bool, window):
    """(B, S, T) the keys each query may read: cached rows up to
    ``valid_upto``, a cross attention's every key, causal and windowed by
    position."""
    B, S = positions.shape
    dev = positions.device
    if valid_upto is not None or cross:
        k_pos = torch.arange(T, dtype=torch.int32, device=dev)[None, :].expand(B, -1)
    else:
        k_pos = positions[:, :T].expand(B, T)
    mask = (k_pos <= valid_upto if valid_upto is not None
            else torch.ones((B, T), dtype=torch.bool, device=dev))
    mask = mask[:, None, :].expand(B, S, T)
    if causal:
        qpos = positions[:, :, None]                 # (B,S,1)
        kpos = k_pos[:, None, :]                     # (B,1,T)
        mask = mask & (kpos <= qpos)
        if window is not None:
            mask = mask & (kpos > qpos - window)
    return mask


def _naive_core(qg, k, v, positions, scale: float, dtype, **mask_kw):
    """The reference's einsum attention of qg (B, S, KV, G, hd) over k, v
    (B, T, KV, hd): logits in float32, masked, softmax, P·V in ``dtype``."""
    f32 = torch.float32
    logits = torch.einsum("bskgh,btkh->bkgst", qg.to(f32), k.to(f32)) * scale
    mask = _key_mask(positions, k.shape[1], **mask_kw)
    logits = torch.where(mask[:, None, None, :, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(dtype)
    return torch.einsum("bkgst,btkh->bskgh", probs, v.to(dtype))


def init_kv_cache(batch: int, length: int, n_kv: int, hd: int, dtype, *,
                  device=None) -> dict:
    shape = (batch, length, n_kv, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, kind: str, d_model: int, d_ff: int, dtype) -> Params:
    p = Params({"w_in": _init_w(gen, (d_model, d_ff), dtype),
                "w_out": _init_w(gen, (d_ff, d_model), dtype)})
    if kind in ("swiglu", "geglu"):
        p["w_gate"] = _init_w(gen, (d_model, d_ff), dtype)
    return p


def apply_mlp(kind: str, p, x: torch.Tensor) -> torch.Tensor:
    h = x @ p["w_in"]
    if kind == "swiglu":
        h = F.silu(x @ p["w_gate"]) * h
    elif kind == "geglu":
        h = F.gelu(x @ p["w_gate"], approximate="tanh") * h
    elif kind == "gelu":
        h = F.gelu(h, approximate="tanh")
    else:
        raise ValueError(kind)
    h = constrain(h, "batch", None, "model")
    return h @ p["w_out"]


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------

def init_embedding(gen: torch.Generator, vocab: int, d_model: int, dtype) -> Params:
    return Params({"emb": _init_w(gen, (vocab, d_model), dtype, scale=1.0)})


def embed(p, tokens: torch.Tensor) -> torch.Tensor:
    # a vocab-sharded table gives each rank's rows and a partial sum
    return F.embedding(tokens, p["emb"])


def init_head(gen: torch.Generator, d_model: int, vocab: int, dtype) -> Params:
    return Params({"w": _init_w(gen, (d_model, vocab), dtype)})


def lm_logits(head, emb, x: torch.Tensor) -> torch.Tensor:
    if head is not None:
        logits = x @ head["w"]
    else:  # tied embeddings (gemma-style 1/sqrt(d) logit scaling)
        logits = (x @ emb["emb"].T) * (x.shape[-1] ** -0.5)
    return constrain(logits, "batch", None, "model")
