"""Abstract input and state specs for every (arch x shape) dry-run cell
(port of ``repro.launch.specs``).

``meta`` tensors stand in for the reference's ``ShapeDtypeStruct``s:
shapes and dtypes, no storage.  For each mode:

- train:   ``train_step(state, batch)``          batch = tokens/labels (+stubs)
- prefill: ``prefill_fn(params, batch)``         cache built inside
- decode:  ``decode_fn(params, cache, tokens, pos)``   cache = seq_len KV

Modality frontends are stubs: the vision and audio cells take
precomputed patch or frame embeddings.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models.model import abstract_params
from repro_torch.models.transformer import init_cache
from repro_torch.training.optimizer import init_opt_state
from repro_torch.training.train_step import TrainState

META = torch.device("meta")


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict[str, torch.Tensor]:
    B = shape.global_batch
    if shape.is_decode:
        return {"tokens": _sds((B, 1), torch.int32)}
    n_tok = shape.seq_len - cfg.n_prefix_embeds
    out = {"tokens": _sds((B, n_tok), torch.int32)}
    if shape.mode == "train":
        out["labels"] = _sds((B, n_tok), torch.int32)
    if cfg.frontend == "vision":
        out["prefix_embeds"] = _sds((B, cfg.n_prefix_embeds, cfg.d_model), cfg.cdtype)
    if cfg.kind == "encdec":
        out["encoder_frames"] = _sds((B, cfg.encoder_seq, cfg.d_model), cfg.cdtype)
    return out


def abstract_train_state(cfg: ArchConfig) -> TrainState:
    params = abstract_params(cfg)
    return TrainState(params, init_opt_state(params))


def abstract_cache(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    return init_cache(cfg, shape.global_batch, shape.seq_len, device=META)


def decode_pos_spec() -> torch.Tensor:
    return _sds((), torch.int32)
