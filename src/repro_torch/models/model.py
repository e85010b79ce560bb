"""Public model API: inputs, init, the training loss, forward, prefill and
decode for every family of the configs (dense, MoE, RG-LRU/local hybrid,
RWKV6, the Whisper encoder-decoder).

Port of ``repro.models.model``.  Entry points run on the card unless the
caller names a device (:func:`init_model`'s ``device``);
:func:`abstract_params` builds the same modules on the ``meta`` device
(shapes and dtypes, no storage) for the dry run;
``make_inputs`` draws from numpy's ``default_rng(seed)``, so the same
inputs can be handed to the reference.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ArchConfig
from repro_torch.core.index import resolve_device
from repro_torch.models.sharding import (all_reduce, current_mesh, is_dtensor, redistribute,
                                         rows_placements)
from repro_torch.models.transformer import apply_model, init_cache, init_params

AUX_LOSS_COEF = 0.01


def make_inputs(cfg: ArchConfig, batch: int, seq: int, *, seed: int = 0,
                device=None) -> dict:
    """Concrete inputs for one step: ``tokens`` and ``labels`` (B, seq -
    n_prefix_embeds) int32; for a vision frontend ``prefix_embeds`` and for
    an encoder-decoder ``encoder_frames`` (B, encoder_seq, D), drawn in
    that order from the same generator."""
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
    if cfg.kind == "encdec":
        frames = rng.standard_normal((batch, cfg.encoder_seq, cfg.d_model))
        out["encoder_frames"] = torch.from_numpy(frames.astype(np.float32)).to(
            dev, cfg.cdtype)
    return out


def forward_logits(params, cfg: ArchConfig, inputs: dict) -> torch.Tensor:
    logits, _, _ = apply_model(params, cfg, inputs["tokens"],
                               prefix_embeds=inputs.get("prefix_embeds"),
                               encoder_frames=inputs.get("encoder_frames"))
    return logits


def train_loss(params, cfg: ArchConfig, inputs: dict) -> torch.Tensor:
    """Next-token cross entropy (+ the MoE aux loss), float32.  Loss over
    token positions only (vision prefix positions are context, not
    targets)."""
    logits, _, aux = apply_model(params, cfg, inputs["tokens"],
                                 prefix_embeds=inputs.get("prefix_embeds"),
                                 encoder_frames=inputs.get("encoder_frames"))
    n_prefix = cfg.n_prefix_embeds if inputs.get("prefix_embeds") is not None else 0
    logits = logits[:, n_prefix:, :]
    if is_dtensor(logits):
        loss = _vocab_parallel_nll(logits, inputs["labels"])
    else:
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, inputs["labels"][..., None].long())[..., 0]
        loss = nll.mean()
    if cfg.is_moe:
        loss = loss + AUX_LOSS_COEF * aux
    return loss


class _VocabNLL(torch.autograd.Function):
    """The mean next-token NLL of one rank's block of logits (B, S, V_l),
    its vocabulary ``[v0, v0 + V_l)`` of the whole: the rows' max, their
    sum of exponentials and the label's logit reduced over ``model_group``
    (no rank holds a whole row), the sum over the rows over
    ``batch_groups``.  The gradient is the block's (softmax - one-hot) / N."""

    @staticmethod
    def forward(ctx, logits, labels, v0: int, n_total: int, model_group, batch_groups):
        lf = logits.float()
        m = lf.amax(-1, keepdim=True)
        if model_group is not None:
            m = all_reduce(m, model_group, "max")
        e = torch.exp(lf - m)
        s = e.sum(-1, keepdim=True)
        if model_group is not None:
            s = all_reduce(s, model_group, "sum")
        V = lf.shape[-1]
        y = labels.long() - v0
        own = (y >= 0) & (y < V)
        y = y.clamp(0, V - 1)[..., None]
        target = torch.gather(lf, -1, y) * own[..., None]
        if model_group is not None:
            target = all_reduce(target, model_group, "sum")
        total = (torch.log(s) + m - target).sum()
        for g in batch_groups:
            total = all_reduce(total, g, "sum")
        ctx.save_for_backward(e.div_(s), y, own)
        ctx.n_total, ctx.dtype = n_total, logits.dtype
        return total / n_total

    @staticmethod
    def backward(ctx, grad):
        p, y, own = ctx.saved_tensors
        g = p.scatter_add(-1, y, -own[..., None].to(p.dtype)) * (grad / ctx.n_total)
        return g.to(ctx.dtype), None, None, None, None, None


def _vocab_parallel_nll(logits, labels):
    """``-log_softmax(logits)[labels].mean()`` of DTensor logits (B, S, V)
    placed (batch, None, model), without a whole row on any rank: each rank
    computes :class:`_VocabNLL` on its block through ``local_map``; the
    result is replicated."""

    mesh = logits.device_mesh
    rows = rows_placements(logits)
    names = mesh.mesh_dim_names
    mi = names.index("model") if "model" in names else None
    split = mi is not None and logits.placements[mi] == Shard(2)
    l_pl = [Shard(2) if i == mi and split else p for i, p in enumerate(rows)]
    logits, labels = redistribute(logits, l_pl), redistribute(labels, rows)
    v0 = mesh.get_local_rank("model") * (logits.shape[-1] // mesh.size(mi)) if split else 0
    model_group = mesh.get_group(mi) if split else None
    batch_groups = [mesh.get_group(i) for i, p in enumerate(rows) if p == Shard(0)]
    n_total = labels.numel()
    return local_map(
        lambda lg, lb: _VocabNLL.apply(lg, lb, v0, n_total, model_group, batch_groups),
        out_placements=[Replicate()] * mesh.ndim, in_placements=(l_pl, rows),
        device_mesh=mesh)(logits, labels)


def prefill(params, cfg: ArchConfig, inputs: dict,
            max_len: int) -> tuple[torch.Tensor, dict]:
    """Run the prompt through the model, filling a max_len KV cache (and
    an encoder-decoder's cross K/V from ``encoder_frames``).  Under a mesh
    with DTensor inputs the cache is placed by ``cache_pspecs``."""
    tokens = inputs["tokens"]
    mesh = current_mesh()
    if mesh is not None and is_dtensor(tokens):   # each rank's block of the cache
        from repro_torch.launch.shardings import distribute_cache

        cache = distribute_cache(init_cache(cfg, tokens.shape[0], max_len,
                                            device="meta"), mesh,
                                 device=tokens.to_local().device)
    else:
        cache = init_cache(cfg, tokens.shape[0], max_len, device=tokens.device)
    logits, cache, _ = apply_model(params, cfg, tokens,
                                   prefix_embeds=inputs.get("prefix_embeds"),
                                   encoder_frames=inputs.get("encoder_frames"),
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


class _MetaGenerator:
    """Stands in for a ``torch.Generator`` (which cannot draw on ``meta``):
    the init functions give an empty ``meta`` tensor for every draw."""
    device = torch.device("meta")


def abstract_params(cfg: ArchConfig):
    """The parameters' ``ModuleDict`` (names, shapes, dtypes) on the
    ``meta`` device, without storage (the dry run's)."""
    return init_params(_MetaGenerator(), cfg)


def count_params(params) -> int:
    return sum(p.numel() for p in params.parameters())
