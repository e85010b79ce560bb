"""Model assembly for every family of the configs: the dense decoders
(phi4-mini, deepseek-coder, starcoder2, gemma, and the InternVL2 backbone
with its vision prefix), the MoE decoders (Moonlight-16B-A3B, Mixtral),
the RecurrentGemma hybrid (RG-LRU and local attention, 2:1), RWKV6 and the
Whisper encoder-decoder.

Port of ``repro.models.transformer``.  The reference stacks each group's
parameters and scans over the stack; here ``params["groups"]`` is an
``nn.ModuleList`` with one ``ModuleDict`` a group (``{"b0": block,
...}``) and the forward is a Python loop over it.  A remainder group
(``rem``, RecurrentGemma's 26 = 8 x 3 + 2 layers) keeps the reference's
form and runs its own kinds.  Whisper's encoder (``params["encoder"]``:
``layers``, a ``ModuleList`` of non-causal ``"attn"`` blocks, and
``final_norm``) runs over the frame embeddings with sinusoidal positions;
every decoder block then has a cross attention (``norm_x``, ``cross``)
whose K/V prefill computes from the encoder's output and writes to the
cache (``ck``, ``cv``), where decode reads them.  Every attention of an
encoder-decoder runs without RoPE.

Remat as the reference does it (``transformer.py:338-344``): with no
cache, ``cfg.remat_layers`` set and grad enabled, each ``groups[i]`` runs
under ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``;
``remat_policy`` ``"nothing"`` saves nothing, ``"dots"`` saves the matmul
outputs (:func:`_dots_policy`).  The ``rem`` group and Whisper's encoder
are not rematerialised.  K12 then launches twice per attention layer of a
training step (the forward and its recompute) and not in the backward.

The same :func:`apply_model` serves the no-cache forward, prefill (cache
and ``cache_pos = 0``) and decode (S = 1, ``cache_pos = t``).
``cache_pos`` is a host integer; the cache (KV rows, cross K/V, RG-LRU and
RWKV6 state) is written in place.
"""
from __future__ import annotations

import functools
import math
import operator
from typing import Optional

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models import rwkv6 as RW
from repro_torch.models.sharding import (constrain, current_mesh, mesh_ops, rows_like,
                                         use_mesh)

BLOCK_KINDS = ("attn", "local", "rglru", "rwkv")


def effective_pattern(cfg: ArchConfig) -> tuple[str, ...]:
    if cfg.kind == "rwkv":
        return ("rwkv",)
    return cfg.block_pattern


def _split_groups(cfg: ArchConfig) -> tuple[int, tuple[str, ...]]:
    pat = effective_pattern(cfg)
    n_groups = cfg.n_layers // len(pat)
    rem = cfg.n_layers - n_groups * len(pat)
    return n_groups, pat[:rem]


def check_ported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a block kind the port does not
    have (every config of the registry is ported)."""
    other = sorted(set(effective_pattern(cfg)) - set(BLOCK_KINDS))
    if other:
        raise NotImplementedError(
            f"{cfg.name}: blocks of kind {other}: not ported (ported kinds "
            f"{BLOCK_KINDS}; see ROADMAP.md, Queue 1)")


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _init_block(gen: torch.Generator, cfg: ArchConfig, kind: str,
                cross: bool) -> nn.ModuleDict:
    dt, dev = cfg.pdtype, gen.device
    p = nn.ModuleDict({"norm1": L.init_norm(cfg.norm, cfg.d_model, dt, device=dev)})
    if kind in ("attn", "local"):
        p["attn"] = L.init_attention(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                     cfg.hd, dt)
    elif kind == "rglru":
        p["rglru"] = RG.init_rglru_block(gen, cfg.d_model, cfg.lru_dim or cfg.d_model,
                                         cfg.conv_width, dt)
    elif kind == "rwkv":
        p["time"] = RW.init_rwkv_time_mix(gen, cfg.d_model, cfg.rwkv_head_dim, dt)
    else:
        raise ValueError(kind)
    if cross:
        p["norm_x"] = L.init_norm(cfg.norm, cfg.d_model, dt, device=dev)
        p["cross"] = L.init_attention(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                      cfg.hd, dt)
    p["norm2"] = L.init_norm(cfg.norm, cfg.d_model, dt, device=dev)
    if kind == "rwkv":
        p["chan"] = RW.init_rwkv_channel_mix(gen, cfg.d_model, cfg.d_ff, dt)
    elif cfg.is_moe:
        p["moe"] = MOE.init_moe(gen, cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.mlp, dt)
    else:
        p["mlp"] = L.init_mlp(gen, cfg.mlp, cfg.d_model, cfg.d_ff, dt)
    return p


def _init_block_cache(cfg: ArchConfig, kind: str, cross: bool, batch: int,
                      max_len: int, device) -> dict:
    dt = cfg.cdtype
    if kind in ("attn", "local"):
        # a window layer keeps a full-length cache and relies on the window
        # mask, as the reference does
        c = {"kv": L.init_kv_cache(batch, max_len, cfg.n_kv_heads, cfg.hd, dt,
                                   device=device)}
    elif kind == "rglru":
        c = {"rg": RG.init_rglru_state(batch, cfg.lru_dim or cfg.d_model,
                                       cfg.conv_width, torch.float32, device=device)}
    elif kind == "rwkv":
        c = {"rw": RW.init_rwkv_states(batch, cfg.d_model, cfg.rwkv_head_dim, dt,
                                       device=device)}
    else:
        raise ValueError(kind)
    if cross:
        shape = (batch, cfg.encoder_seq, cfg.n_kv_heads, cfg.hd)
        c["ck"] = torch.zeros(shape, dtype=dt, device=device)
        c["cv"] = torch.zeros(shape, dtype=dt, device=device)
    return c


def _apply_block(
    p,
    cfg: ArchConfig,
    kind: str,
    x: torch.Tensor,
    positions: torch.Tensor,
    cache: Optional[dict],
    cache_pos: Optional[int],
    memory: Optional[torch.Tensor],
    causal: bool,
) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One block; its cache (KV rows, cross K/V, RG-LRU or RWKV6 state) is
    written in place.  ``memory`` is the encoder's output (prefill and the
    no-cache forward of an encoder-decoder; decode reads the cross K/V
    from the cache).  Returns (x, the block's MoE aux loss; None without
    MoE)."""
    h = L.apply_norm(cfg.norm, p["norm1"], x)
    if kind in ("attn", "local"):
        window = cfg.local_window if kind == "local" else (cfg.sliding_window or None)
        out, _ = L.attention(
            p["attn"], h,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, hd=cfg.hd,
            positions=positions,
            rope_theta=cfg.rope_theta if cfg.kind != "encdec" else None,
            causal=causal, window=window,
            cache=None if cache is None else cache["kv"],
            cache_pos=cache_pos,
            impl=cfg.attn_impl, q_chunk=cfg.q_chunk, k_chunk=cfg.k_chunk,
        )
    elif kind == "rglru":
        out, _ = RG.apply_rglru_block(p["rglru"], h, None if cache is None else cache["rg"])
    elif kind == "rwkv":
        out, _ = RW.apply_rwkv_time_mix(p["time"], h, cfg.rwkv_head_dim,
                                        None if cache is None else cache["rw"]["time"])
    else:
        raise ValueError(kind)
    x = x + constrain(out, "batch", None, None)

    if "cross" in p:
        hx = L.apply_norm(cfg.norm, p["norm_x"], x)
        if memory is not None:  # prefill / no cache: the cross K/V from memory
            ck = L._split(memory @ p["cross"]["wk"], -1, cfg.n_kv_heads, cfg.hd)
            cv = L._split(memory @ p["cross"]["wv"], -1, cfg.n_kv_heads, cfg.hd)
            if cache is not None:
                cache["ck"].copy_(ck)
                cache["cv"].copy_(cv)
        else:
            ck, cv = cache["ck"], cache["cv"]
        out, _ = L.attention(
            p["cross"], hx,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, hd=cfg.hd,
            positions=positions, rope_theta=None, causal=False,
            kv_override=(ck, cv),
            impl=cfg.attn_impl, q_chunk=cfg.q_chunk, k_chunk=cfg.k_chunk,
        )
        x = x + constrain(out, "batch", None, None)

    h = L.apply_norm(cfg.norm, p["norm2"], x)
    aux = None
    if kind == "rwkv":
        out, _ = RW.apply_rwkv_channel_mix(p["chan"], h,
                                           None if cache is None else cache["rw"]["chan"])
    elif cfg.is_moe:
        out, aux = MOE.apply_moe(p["moe"], h, n_experts=cfg.n_experts,
                                 topk=cfg.topk_experts,
                                 capacity_factor=cfg.capacity_factor, mlp=cfg.mlp)
    else:
        out = L.apply_mlp(cfg.mlp, p["mlp"], h)
    # a row-parallel product's partial sums are reduced before the residual
    # add, as GSPMD reduces them (a DTensor would carry them on)
    x = x + constrain(out, "batch", None, None)
    return constrain(x, "batch", None, None), aux


# ---------------------------------------------------------------------------
# Whole-model init
# ---------------------------------------------------------------------------

def init_params(gen: torch.Generator, cfg: ArchConfig) -> nn.ModuleDict:
    check_ported(cfg)
    n_groups, rem_pat = _split_groups(cfg)
    pat = effective_pattern(cfg)
    dev = gen.device
    cross = cfg.kind == "encdec"

    def init_group(kinds):
        return nn.ModuleDict({f"b{i}": _init_block(gen, cfg, kind, cross)
                              for i, kind in enumerate(kinds)})

    p = nn.ModuleDict({
        "emb": L.init_embedding(gen, cfg.vocab, cfg.d_model, cfg.pdtype),
        "groups": nn.ModuleList(init_group(pat) for _ in range(n_groups)),
        "final_norm": L.init_norm(cfg.norm, cfg.d_model, cfg.pdtype, device=dev),
    })
    if rem_pat:
        p["rem"] = init_group(rem_pat)
    if not cfg.tie_embeddings:
        p["head"] = L.init_head(gen, cfg.d_model, cfg.vocab, cfg.pdtype)
    if cross:
        p["encoder"] = nn.ModuleDict({
            "layers": nn.ModuleList(_init_block(gen, cfg, "attn", cross=False)
                                    for _ in range(cfg.encoder_layers)),
            "final_norm": L.init_norm(cfg.norm, cfg.d_model, cfg.pdtype, device=dev),
        })
    return p


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *, device=None) -> dict:
    """The decode cache; an RWKV6 model's holds no row per position, so its
    size does not depend on ``max_len``."""
    check_ported(cfg)
    n_groups, rem_pat = _split_groups(cfg)
    pat = effective_pattern(cfg)
    cross = cfg.kind == "encdec"

    def group_cache(kinds):
        return {f"b{i}": _init_block_cache(cfg, kind, cross, batch, max_len, device)
                for i, kind in enumerate(kinds)}

    c = {"groups": [group_cache(pat) for _ in range(n_groups)]}
    if rem_pat:
        c["rem"] = group_cache(rem_pat)
    return c


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

#: The ops whose outputs ``remat_policy="dots"`` saves (``dots_saveable``).
_DOTS = frozenset(getattr(torch.ops.aten, name).default
                  for name in ("mm", "bmm", "addmm", "baddbmm"))


def _dots_policy(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_context(policy: str):
    if policy == "nothing":
        return ckpt.noop_context_fn
    if policy == "dots":
        return functools.partial(ckpt.create_selective_checkpoint_contexts, _dots_policy)
    raise ValueError(f"remat_policy {policy!r}: nothing | dots")


def _sinusoidal(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(..., d) float32: sin then cos of ``positions`` over d / 2
    frequencies 10000 ** (-i / (d / 2))."""
    half = d // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32, device=positions.device)
                      * (math.log(10000.0) / half))
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _run_encoder(p, cfg: ArchConfig, frames: torch.Tensor) -> torch.Tensor:
    """Whisper-style encoder over precomputed (stub) frame embeddings
    (B, T, D): non-causal ``"attn"`` blocks, no cache."""
    B, T, _ = frames.shape
    pos = rows_like(torch.arange(T, dtype=torch.int32, device=frames.device)[None]
                    .expand(B, T), frames)
    x = frames.to(cfg.cdtype) + _sinusoidal(pos, cfg.d_model).to(cfg.cdtype)
    for lp in p["encoder"]["layers"]:
        x, _ = _apply_block(lp, cfg, "attn", x, pos, None, None, None, causal=False)
    return L.apply_norm(cfg.norm, p["encoder"]["final_norm"], x)


def apply_model(
    params,
    cfg: ArchConfig,
    tokens: torch.Tensor,                          # (B, S) int
    *,
    prefix_embeds: Optional[torch.Tensor] = None,  # (B, P, D) vision stub
    encoder_frames: Optional[torch.Tensor] = None, # (B, T, D) audio stub
    cache: Optional[dict] = None,
    cache_pos: Optional[int] = None,
    positions: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, Optional[dict], torch.Tensor]:
    """Returns (logits (B,S,V) float32, the cache written in place, aux).
    Under a mesh (``models.sharding.use_mesh``) ``tokens``, the
    parameters and the cache are DTensors and so are the results."""
    check_ported(cfg)
    with mesh_ops():
        return _apply_model(params, cfg, tokens, prefix_embeds, encoder_frames, cache,
                            cache_pos, positions)


def _apply_model(params, cfg, tokens, prefix_embeds, encoder_frames, cache, cache_pos,
                 positions):
    if cache_pos is not None:
        cache_pos = operator.index(cache_pos)
    B, S = tokens.shape
    x = L.embed(params["emb"], tokens).to(cfg.cdtype)
    if prefix_embeds is not None:
        # the lookup's partial sums reduced first: a cat takes like placements
        x = torch.cat([prefix_embeds.to(cfg.cdtype), constrain(x, "batch", None, None)],
                      dim=1)
        S = x.shape[1]
    if positions is None:
        base = cache_pos if cache_pos is not None else 0
        positions = (base + torch.arange(S, dtype=torch.int32, device=x.device))
        positions = rows_like(positions[None].expand(B, S), x)
    memory = None
    if cfg.kind == "encdec":
        x = x + _sinusoidal(positions, cfg.d_model).to(cfg.cdtype)
    x = constrain(x, "batch", None, None)
    if cfg.kind == "encdec":
        if encoder_frames is not None:  # else a decode step: cross K/V cached
            memory = _run_encoder(params, cfg, encoder_frames)

    mesh = current_mesh()

    def run_group(gp, kinds, gc, x, aux):
        # the mesh again: remat recomputes this in the backward's thread
        with use_mesh(mesh), mesh_ops():
            for i, kind in enumerate(kinds):
                name = f"b{i}"
                x, a = _apply_block(gp[name], cfg, kind, x, positions,
                                    None if gc is None else gc[name], cache_pos, memory,
                                    causal=True)
                if a is not None:
                    aux = aux + a
        return x, aux

    _, rem_pat = _split_groups(cfg)
    pat = effective_pattern(cfg)
    caches = [None] * len(params["groups"]) if cache is None else cache["groups"]
    remat = cache is None and cfg.remat_layers and torch.is_grad_enabled()
    context_fn = _remat_context(cfg.remat_policy) if remat else None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for gp, gc in zip(params["groups"], caches):
        if remat:
            x, aux = ckpt.checkpoint(run_group, gp, pat, gc, x, aux, use_reentrant=False,
                                     context_fn=context_fn)
        else:
            x, aux = run_group(gp, pat, gc, x, aux)
    if rem_pat:
        x, aux = run_group(params["rem"], rem_pat, None if cache is None else cache["rem"],
                           x, aux)

    x = L.apply_norm(cfg.norm, params["final_norm"], x)
    head = params["head"] if "head" in params else None
    logits = L.lm_logits(head, params["emb"], x)
    return logits.to(torch.float32), cache, aux
