"""Production and host meshes over a ``torch.distributed`` world (port of
``repro.launch.mesh``).

The reference's meshes are TPU v5e pods: one pod of 16x16 = 256 chips,
meshed ``(data=16, model=16)``; two pods, 512 chips, meshed ``(pod=2,
data=16, model=16)``.  ``pod`` carries ODYS-set semantics: replicas only
(serving keeps pods independent).  In the port a mesh is a
:class:`~torch.distributed.device_mesh.DeviceMesh` over the ranks of the
process group, one process a rank (SPMD), with the same axis names.

``device_type`` names where a mesh's collectives carry their payloads:
``"cuda"`` (the card, under ``nccl``) unless the caller asks for
``"cpu"`` (the host, under ``gloo``).  It is not the device a rank
computes on: that is :func:`rank_device`'s.

Functions only: importing this module creates no process group and
touches no device.
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """``(16, 16)`` ``("data", "model")``, or ``(2, 16, 16)`` ``("pod",
    "data", "model")`` with ``multi_pod``, over a world of 256 or 512."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(data: int = 4, model: int = 2, pod: int | None = None, *,
                   device_type: str = "cuda") -> DeviceMesh:
    """A small ``(data, model)`` or ``(pod, data, model)`` mesh over the
    first ranks of the world that exists (tests and host examples)."""
    if pod:
        shape, axes = (pod, data, model), ("pod", "data", "model")
    else:
        shape, axes = (data, model), ("data", "model")
    n = math.prod(shape)
    world = dist.get_world_size()
    if n > world:
        raise ValueError(f"a {shape} mesh needs {n} ranks, the world has {world}")
    return make_mesh(torch.arange(n).reshape(shape).tolist(), axes,
                     device_type=device_type)


def make_mesh(ranks, names, *, device_type: str | None = None) -> DeviceMesh:
    """A mesh of the given global ranks (nested lists: their shape is the
    mesh's) with axis names ``names``.  ``device_type`` defaults to the
    world's: ``"cuda"`` under ``nccl``, ``"cpu"`` under ``gloo`` (whose
    collectives move host memory)."""
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.tensor(ranks, dtype=torch.int32),
                      mesh_dim_names=tuple(names))


def rank_device(device=None) -> torch.device:
    """The device this rank computes on: ``device`` when the caller names
    one with its index (or the CPU); otherwise a card,
    ``cuda:{local_rank % device_count}``, the local rank being
    ``LOCAL_RANK`` when a launcher set it and the global rank otherwise.
    With no card and no ``device`` it raises: a rank never falls back to
    the host on its own."""
    dev = None if device is None else torch.device(device)
    if dev is not None and (dev.type != "cuda" or dev.index is not None):
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to run "
                           "the ranks' plain PyTorch path on the CPU")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())
