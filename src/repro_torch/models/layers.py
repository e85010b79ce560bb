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
``constrain`` calls are sharding hints, no-ops on one card, and are
dropped.

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

Params = nn.ParameterDict
NEG_INF = -1e30


def _param(t: torch.Tensor) -> nn.Parameter:
    # created frozen, so serving builds no autograd graph over the weights;
    # the trainer turns their gradients on (``params.requires_grad_(True)``)
    return nn.Parameter(t, requires_grad=False)


def _init_w(gen: torch.Generator, shape, dtype, scale: float | None = None):
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
    if qg.is_cuda or recording:
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
            with registry.dispatched(fa.k12_entry(q), q, k, v, **kw):
                out = fa.flash_attention_fwd_cuda(q, k, v, **kw)
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
    q = (x @ p["wq"]).reshape(B, S, n_heads, hd)
    if kv_override is not None:
        k, v = kv_override
        memory = k  # mark as cross-attention (no causal/rope path below)
    else:
        kv_src = memory if memory is not None else x
        k = (kv_src @ p["wk"]).reshape(B, kv_src.shape[1], n_kv, hd)
        v = (kv_src @ p["wv"]).reshape(B, kv_src.shape[1], n_kv, hd)

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
    qg = q.reshape(B, S, n_kv, g, hd)
    scale = 1.0 / math.sqrt(hd)
    use_causal = causal and memory is None

    if impl == "flash" and S > 1:
        if cache is not None:
            # sliced: the valid rows only (at cache_pos 0, the k, v just written)
            q_base, k_len = cache_pos, cache_pos + S
            if cache_pos:
                k, v = cache["k"][:, :k_len], cache["v"][:, :k_len]
        else:
            # no cache: query and key positions share their base, so the
            # masks are relative (the reference's q_base = k_base)
            q_base, k_len = 0, k.shape[1]
        out = _flash_gqa(
            qg, k, v, q_base, 0, k_len,
            causal=use_causal, window=window, scale=scale,
            q_chunk=q_chunk, k_chunk=k_chunk,
        ).reshape(B, S, n_heads * hd)
        return out @ p["wo"], new_cache

    if cache is not None:
        k, v = cache["k"], cache["v"]
        k_pos = torch.arange(k.shape[1], dtype=torch.int32, device=x.device)
        k_pos = k_pos[None, :].expand(B, -1)
        k_valid = k_pos <= (cache_pos + S - 1)
    elif memory is not None:
        k_pos = torch.arange(k.shape[1], dtype=torch.int32, device=x.device)
        k_pos = k_pos[None, :].expand(B, -1)
        k_valid = torch.ones(k.shape[:2], dtype=torch.bool, device=x.device)
    else:
        k_pos = positions[:, : k.shape[1]].expand(B, k.shape[1])
        k_valid = torch.ones(k.shape[:2], dtype=torch.bool, device=x.device)

    f32 = torch.float32
    logits = torch.einsum("bskgh,btkh->bkgst", qg.to(f32), k.to(f32)) * scale
    mask = k_valid[:, None, :].expand(B, S, k.shape[1])
    if use_causal:
        qpos = positions[:, :, None]                 # (B,S,1)
        kpos = k_pos[:, None, :]                     # (B,1,T)
        mask = mask & (kpos <= qpos)
        if window is not None:
            mask = mask & (kpos > qpos - window)
    logits = torch.where(mask[:, None, None, :, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out5 = torch.einsum("bkgst,btkh->bskgh", probs, v.to(x.dtype))
    out = out5.reshape(B, S, n_heads * hd)
    return out @ p["wo"], new_cache


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
    return h @ p["w_out"]


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------

def init_embedding(gen: torch.Generator, vocab: int, d_model: int, dtype) -> Params:
    return Params({"emb": _init_w(gen, (vocab, d_model), dtype, scale=1.0)})


def embed(p, tokens: torch.Tensor) -> torch.Tensor:
    return p["emb"][tokens]


def init_head(gen: torch.Generator, d_model: int, vocab: int, dtype) -> Params:
    return Params({"w": _init_w(gen, (d_model, vocab), dtype)})


def lm_logits(head, emb, x: torch.Tensor) -> torch.Tensor:
    if head is not None:
        return x @ head["w"]
    # tied embeddings (gemma-style 1/sqrt(d) logit scaling)
    return (x @ emb["emb"].T) * (x.shape[-1] ** -0.5)
