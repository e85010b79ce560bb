"""Batched LM serving engine: request queue -> prefill -> decode loop.

Port of ``repro.serving.engine``.  Host-side front end in the ODYS master
role: it admits requests through the shared micro-batch formation of
:func:`repro_torch.serving.scheduler.form_batch` (fixed-size batches
padded with inert ``rid = -1`` clones), runs prefill once (K12 in every
layer on the card) and then the greedy decode loop
(:func:`repro_torch.serving.router.greedy_token`).  Prompts are
left-padded with token 0 and positions run from 0 on every row, as in the
reference: the padding is attended.  The batch's cache (KV rows, and for
RecurrentGemma the RG-LRU blocks' ``h`` and conv state) is made by
``prefill`` and written in place by every decode step.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.index import resolve_device
from repro_torch.models.model import decode_step, init_model, prefill
from repro_torch.serving.router import greedy_token
from repro_torch.serving.scheduler import form_batch


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (S,) int32
    max_new_tokens: int = 16
    output: list[int] = dataclasses.field(default_factory=list)


class ServingEngine:
    def __init__(self, cfg: ArchConfig, *, batch_size: int, max_len: int,
                 rng_seed: int = 0, device=None, params=None):
        self.cfg = cfg
        self.batch_size = batch_size
        self.max_len = max_len
        self.device = resolve_device(device)
        self.params = (params if params is not None
                       else init_model(cfg, seed=rng_seed, device=self.device))
        self.queue: list[Request] = []

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _form_batch(self) -> list[Request]:
        """Pop one micro-batch; [] on an empty queue, padded when partial."""
        return form_batch(
            self.queue, self.batch_size,
            pad=lambda first: Request(rid=-1, prompt=first.prompt,
                                      max_new_tokens=first.max_new_tokens),
        )

    def step_batch(self) -> list[Request]:
        """Serve one full batch to completion (prefill + decode loop).

        No-op (returns ``[]``) when the queue is empty."""
        batch = self._form_batch()
        if not batch:
            return []
        plen = max(len(r.prompt) for r in batch)
        toks = np.zeros((self.batch_size, plen), np.int32)
        for i, r in enumerate(batch):
            toks[i, plen - len(r.prompt):] = r.prompt  # left-pad
        inputs = {"tokens": torch.from_numpy(toks).to(self.device)}
        logits, cache = prefill(self.params, self.cfg, inputs, self.max_len)
        pos = plen
        n_new = max(r.max_new_tokens for r in batch)
        tok = greedy_token(logits)
        for r, t in zip(batch, tok.tolist()):
            r.output.append(t)
        for _ in range(n_new - 1):
            logits, cache = decode_step(self.params, self.cfg, tok[:, None], cache, pos)
            tok = greedy_token(logits)
            pos += 1
            for r, t in zip(batch, tok.tolist()):
                r.output.append(t)
        return [r for r in batch if r.rid >= 0]
