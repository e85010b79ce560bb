"""Public model API: inputs, init, forward, prefill and decode for the
dense, MoE and RG-LRU/local hybrid decoders.

Port of ``repro.models.model`` without ``train_loss`` (the training
slice's) and ``abstract_params`` (the dry run's).  Entry points run on the
card unless the caller names a device (:func:`init_model`'s ``device``);
``make_inputs`` draws from numpy's ``default_rng(seed)``, so the same
inputs can be handed to the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.index import resolve_device
from repro_torch.models.transformer import apply_model, init_cache, init_params


def make_inputs(cfg: ArchConfig, batch: int, seq: int, *, seed: int = 0,
                device=None) -> dict:
    """Concrete inputs for one step: ``tokens`` and ``labels`` (B, seq -
    n_prefix_embeds) int32 and, for a vision frontend, ``prefix_embeds``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_tok = seq - cfg.n_prefix_embeds
    out = {name: torch.from_numpy(
        rng.integers(0, cfg.vocab, size=(batch, n_tok)).astype(np.int32)).to(dev)
        for name in ("tokens", "labels")}
    if cfg.frontend == "vision":
        emb = rng.standard_normal((batch, cfg.n_prefix_embeds, cfg.d_model))
        out["prefix_embeds"] = torch.from_numpy(emb.astype(np.float32)).to(
            dev, cfg.cdtype)
    return out


def forward_logits(params, cfg: ArchConfig, inputs: dict) -> torch.Tensor:
    logits, _, _ = apply_model(params, cfg, inputs["tokens"],
                               prefix_embeds=inputs.get("prefix_embeds"))
    return logits


def prefill(params, cfg: ArchConfig, inputs: dict,
            max_len: int) -> tuple[torch.Tensor, dict]:
    """Run the prompt through the model, filling a max_len KV cache."""
    tokens = inputs["tokens"]
    cache = init_cache(cfg, tokens.shape[0], max_len, device=tokens.device)
    logits, cache, _ = apply_model(params, cfg, tokens,
                                   prefix_embeds=inputs.get("prefix_embeds"),
                                   cache=cache, cache_pos=0)
    return logits[:, -1, :], cache


def decode_step(params, cfg: ArchConfig, tokens: torch.Tensor, cache: dict,
                pos: int) -> tuple[torch.Tensor, dict]:
    """One new token (B, 1) against a filled KV cache at host position
    ``pos``; the cache is written in place and returned."""
    logits, cache, _ = apply_model(params, cfg, tokens, cache=cache, cache_pos=pos)
    return logits[:, -1, :], cache


def init_model(cfg: ArchConfig, *, seed: int = 0, device=None):
    """Parameters drawn from a ``torch.Generator`` seeded with ``seed`` on
    the device (``cuda`` unless the caller names another)."""
    dev = resolve_device(device)
    return init_params(torch.Generator(device=dev).manual_seed(seed), cfg)


def count_params(params) -> int:
    return sum(p.numel() for p in params.parameters())
