"""Model assembly for the dense decoders (phi4-mini, deepseek-coder,
starcoder2, gemma, and the InternVL2 backbone with its vision prefix),
the MoE decoders (Moonlight-16B-A3B, Mixtral) and the RecurrentGemma
hybrid (RG-LRU and local attention, 2:1).

Port of ``repro.models.transformer`` for blocks of kind ``"attn"``,
``"local"`` and ``"rglru"``, with an MLP or an MoE FFN.  The reference
stacks each group's parameters and scans over the stack; here
``params["groups"]`` is an ``nn.ModuleList`` with one ``ModuleDict`` a
group (``{"b0": block, ...}``) and the forward is a Python loop over it.
A remainder group (``rem``, RecurrentGemma's 26 = 8 x 3 + 2 layers) keeps
the reference's form and runs its own kinds.  Remat is a training concern
and is not ported.

RWKV6 blocks and the encoder-decoder (Whisper) raise
``NotImplementedError``: they are later items of ROADMAP.md's Queue 1.

The same :func:`apply_model` serves the no-cache forward, prefill (cache
and ``cache_pos = 0``) and decode (S = 1, ``cache_pos = t``).
``cache_pos`` is a host integer; the cache (KV rows, RG-LRU state) is
written in place.
"""
from __future__ import annotations

import operator
from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG

BLOCK_KINDS = ("attn", "local", "rglru")


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
    """Raise ``NotImplementedError`` for a config outside the serving
    path's families (dense, MoE, the RG-LRU/local hybrid)."""
    what = None
    if cfg.kind == "encdec":
        what = "the encoder-decoder (Whisper)"
    elif cfg.kind == "rwkv":
        what = "RWKV6 blocks"
    else:
        other = sorted(set(effective_pattern(cfg)) - set(BLOCK_KINDS))
        if other:
            what = f"blocks of kind {other}"
    if what is not None:
        raise NotImplementedError(
            f"{cfg.name}: {what}: not ported yet (ROADMAP.md, Queue 1, item 5, "
            f"the LM substrate)")


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _init_block(gen: torch.Generator, cfg: ArchConfig, kind: str) -> nn.ModuleDict:
    dt, dev = cfg.pdtype, gen.device
    p = nn.ModuleDict({"norm1": L.init_norm(cfg.norm, cfg.d_model, dt, device=dev)})
    if kind in ("attn", "local"):
        p["attn"] = L.init_attention(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                     cfg.hd, dt)
    elif kind == "rglru":
        p["rglru"] = RG.init_rglru_block(gen, cfg.d_model, cfg.lru_dim or cfg.d_model,
                                         cfg.conv_width, dt)
    else:
        raise ValueError(kind)
    p["norm2"] = L.init_norm(cfg.norm, cfg.d_model, dt, device=dev)
    if cfg.is_moe:
        p["moe"] = MOE.init_moe(gen, cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.mlp, dt)
    else:
        p["mlp"] = L.init_mlp(gen, cfg.mlp, cfg.d_model, cfg.d_ff, dt)
    return p


def _init_block_cache(cfg: ArchConfig, kind: str, batch: int, max_len: int,
                      device) -> dict:
    if kind in ("attn", "local"):
        # a window layer keeps a full-length cache and relies on the window
        # mask, as the reference does
        return {"kv": L.init_kv_cache(batch, max_len, cfg.n_kv_heads, cfg.hd,
                                      cfg.cdtype, device=device)}
    if kind == "rglru":
        return {"rg": RG.init_rglru_state(batch, cfg.lru_dim or cfg.d_model,
                                          cfg.conv_width, torch.float32, device=device)}
    raise ValueError(kind)


def _apply_block(
    p,
    cfg: ArchConfig,
    kind: str,
    x: torch.Tensor,
    positions: torch.Tensor,
    cache: Optional[dict],
    cache_pos: Optional[int],
    causal: bool,
) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One block; its cache (KV rows or RG-LRU state) is written in place.
    Returns (x, the block's MoE aux loss; None without MoE)."""
    h = L.apply_norm(cfg.norm, p["norm1"], x)
    if kind in ("attn", "local"):
        window = cfg.local_window if kind == "local" else (cfg.sliding_window or None)
        out, _ = L.attention(
            p["attn"], h,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, hd=cfg.hd,
            positions=positions, rope_theta=cfg.rope_theta,
            causal=causal, window=window,
            cache=None if cache is None else cache["kv"],
            cache_pos=cache_pos,
            impl=cfg.attn_impl, q_chunk=cfg.q_chunk, k_chunk=cfg.k_chunk,
        )
    elif kind == "rglru":
        out, _ = RG.apply_rglru_block(p["rglru"], h, None if cache is None else cache["rg"])
    else:
        raise ValueError(kind)
    x = x + out
    h = L.apply_norm(cfg.norm, p["norm2"], x)
    if cfg.is_moe:
        out, aux = MOE.apply_moe(p["moe"], h, n_experts=cfg.n_experts,
                                 topk=cfg.topk_experts,
                                 capacity_factor=cfg.capacity_factor, mlp=cfg.mlp)
    else:
        out, aux = L.apply_mlp(cfg.mlp, p["mlp"], h), None
    return x + out, aux


# ---------------------------------------------------------------------------
# Whole-model init
# ---------------------------------------------------------------------------

def init_params(gen: torch.Generator, cfg: ArchConfig) -> nn.ModuleDict:
    check_ported(cfg)
    n_groups, rem_pat = _split_groups(cfg)
    pat = effective_pattern(cfg)
    dev = gen.device

    def init_group(kinds):
        return nn.ModuleDict({f"b{i}": _init_block(gen, cfg, kind)
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
    return p


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *, device=None) -> dict:
    check_ported(cfg)
    n_groups, rem_pat = _split_groups(cfg)
    pat = effective_pattern(cfg)

    def group_cache(kinds):
        return {f"b{i}": _init_block_cache(cfg, kind, batch, max_len, device)
                for i, kind in enumerate(kinds)}

    c = {"groups": [group_cache(pat) for _ in range(n_groups)]}
    if rem_pat:
        c["rem"] = group_cache(rem_pat)
    return c


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def apply_model(
    params,
    cfg: ArchConfig,
    tokens: torch.Tensor,                          # (B, S) int
    *,
    prefix_embeds: Optional[torch.Tensor] = None,  # (B, P, D) vision stub
    cache: Optional[dict] = None,
    cache_pos: Optional[int] = None,
    positions: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, Optional[dict], torch.Tensor]:
    """Returns (logits (B,S,V) float32, the cache written in place, aux)."""
    check_ported(cfg)
    if cache_pos is not None:
        cache_pos = operator.index(cache_pos)
    B, S = tokens.shape
    x = L.embed(params["emb"], tokens).to(cfg.cdtype)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(cfg.cdtype), x], dim=1)
        S = x.shape[1]
    if positions is None:
        base = cache_pos if cache_pos is not None else 0
        positions = (base + torch.arange(S, dtype=torch.int32, device=x.device))
        positions = positions[None].expand(B, S)

    _, rem_pat = _split_groups(cfg)
    groups = [(gp, effective_pattern(cfg)) for gp in params["groups"]]
    if rem_pat:
        groups.append((params["rem"], rem_pat))
    caches = ([None] * len(groups) if cache is None
              else cache["groups"] + ([cache["rem"]] if rem_pat else []))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for (gp, kinds), gc in zip(groups, caches):
        for i, kind in enumerate(kinds):
            name = f"b{i}"
            x, a = _apply_block(gp[name], cfg, kind, x, positions,
                                None if gc is None else gc[name], cache_pos, causal=True)
            if a is not None:
                aux = aux + a

    x = L.apply_norm(cfg.norm, params["final_norm"], x)
    head = params["head"] if "head" in params else None
    logits = L.lm_logits(head, params["emb"], x)
    return logits.to(torch.float32), cache, aux
