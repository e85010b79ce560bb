"""Batched LM serving engine: request queue -> prefill -> decode loop.

Port of ``repro.serving.engine``.  Host-side front end in the ODYS master
role: it admits requests through the shared micro-batch formation of
:func:`repro_torch.serving.scheduler.form_batch` (fixed-size batches
padded with inert ``rid = -1`` clones), runs prefill once (K12 in every
layer on the card) and then the greedy decode loop
(:func:`repro_torch.serving.router.greedy_token`).  Prompts are
left-padded with token 0 and positions run from 0 on every row, as in the
reference: the padding is attended.  The batch's cache (KV rows; for
RecurrentGemma the RG-LRU blocks' ``h`` and conv state; for RWKV6 each
layer's float32 state ``s`` and the ``x_prev`` of its time and channel
mix; for Whisper also the cross K/V, which decode only reads) is made by
``prefill`` and written in place by every decode step.  An encoder-decoder's prefill runs the
encoder over zero frames (B, encoder_seq, D) in the compute dtype, as the
reference's engine does.

**Tensor parallel** (``mesh=``, a ``DeviceMesh`` with ``data`` and
``model`` axes, one process a rank, every rank building the engine with
the same arguments): the parameters are placed as DTensors by
``launch.shardings.param_pspecs`` (each rank keeps its block of the
weights drawn from the seed), the prompt batch by ``io_pspec`` and the
cache by ``cache_pspecs``; prefill and decode run under
``models.sharding.use_mesh``.  Each rank's logits are its vocabulary
slice of its batch rows, which go to ``greedy_token(mesh=)``: the
tokens are the same on every rank.  The reference's engine passes its
mesh to ``greedy_token`` only and places no parameters (ROADMAP R12).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Shard

from repro_torch.configs.base import ArchConfig
from repro_torch.core.index import resolve_device
from repro_torch.launch.shardings import distribute, distribute_params, io_pspec
from repro_torch.models.model import decode_step, init_model, prefill
from repro_torch.models.sharding import full, is_dtensor, rows_placements, use_mesh
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
                 rng_seed: int = 0, device=None, params=None, mesh=None):
        self.cfg = cfg
        self.batch_size = batch_size
        self.max_len = max_len
        self.device = resolve_device(device)
        self.mesh = mesh
        self.params = (params if params is not None
                       else init_model(cfg, seed=rng_seed, device=self.device))
        if mesh is not None:
            distribute_params(self.params, mesh)
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
        if self.cfg.kind == "encdec":
            inputs["encoder_frames"] = torch.zeros(
                (self.batch_size, self.cfg.encoder_seq, self.cfg.d_model),
                dtype=self.cfg.cdtype, device=self.device)
        if self.mesh is not None:
            inputs = {k: distribute(v, io_pspec(self.mesh, tuple(v.shape)), self.mesh)
                      for k, v in inputs.items()}
        with use_mesh(self.mesh):
            logits, cache = prefill(self.params, self.cfg, inputs, self.max_len)
            pos = plen
            n_new = max(r.max_new_tokens for r in batch)
            tok = self._next(logits, batch)
            for _ in range(n_new - 1):
                logits, cache = decode_step(self.params, self.cfg, tok[:, None], cache,
                                            pos)
                tok = self._next(logits, batch)
                pos += 1
        return [r for r in batch if r.rid >= 0]

    def _next(self, logits: torch.Tensor, batch: list[Request]) -> torch.Tensor:
        """The greedy tokens of ``logits`` (B, V), appended to the requests'
        outputs; under a mesh a DTensor placed as the logits' batch."""
        if not is_dtensor(logits):
            tok = greedy_token(logits)
            host = tok.tolist()
        else:
            names = self.mesh.mesh_dim_names
            vocab_split = ("model" in names and logits.placements[
                names.index("model")] == Shard(1))
            local = greedy_token(logits.to_local(),
                                 mesh=self.mesh if vocab_split else None)
            tok = DTensor.from_local(local, self.mesh, rows_placements(logits),
                                     run_check=False, shape=logits.shape[:1], stride=(1,))
            host = full(tok).tolist()
        for r, t in zip(batch, host):
            r.output.append(t)
        return tok
