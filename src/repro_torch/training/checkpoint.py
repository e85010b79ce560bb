"""Sharded, atomic, manifest-based checkpoints in the reference's layout.

Port of ``repro.training.checkpoint``; each package restores the other's
checkpoint.  Layout:

    <dir>/step_000123/
        manifest.json            # step, shards, leaf assignment, shapes, dtypes
        shard_000.npz ...        # leaf_<i>, leaves assigned by descending
                                 # bytes to the least-loaded shard

Writes go to ``<dir>/.tmp.step_X`` and then ``os.rename`` (atomic on
POSIX); :func:`latest_step` ignores temporary directories.  Shapes are
checked on restore.

Leaves come in ``jax.tree.flatten``'s order: a dict's values by sorted
key, a tuple's in order.  A :class:`~repro_torch.training.train_step.
TrainState` is written as the reference's: the parameters with
``groups`` and ``encoder.layers`` restacked on the leading axis
(``models.convert.restack``), then ``opt.step``, then ``mu`` and ``nu`` in
the parameters' order; it needs the model's config.  Other trees are
nested dicts and tuples of tensors or numpy arrays.

A sharded state (DTensor leaves, ``launch/train.py --mesh host``) is
written whole: every rank gathers each leaf (a collective), rank 0 writes
the bytes of the one-rank save, and every rank waits for it; a restore
reads the whole leaves on every rank and copies each rank's block into
its DTensors.

bfloat16: the reference (numpy with ``ml_dtypes``) writes a bfloat16 leaf
as npz ``|V2`` and reads it back as ``|V2`` (ROADMAP R10).  The port writes
the same 2-byte values with ``"bfloat16"`` in the manifest, and reads a
``|V2`` leaf whose manifest dtype is ``bfloat16`` back as
``torch.bfloat16``.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.models.convert import restack, to_numpy
from repro_torch.models.sharding import full, is_dtensor, local_block


def _tree(tree, cfg):
    """A TrainState as the reference's tree (restacked lists as leaves)."""
    from repro_torch.training.train_step import TrainState

    if not isinstance(tree, TrainState):
        return tree
    if cfg is None:
        raise ValueError("a TrainState is written in the reference's layout: pass cfg")
    params = dict(tree.params.named_parameters())
    opt = tree.opt
    return (restack(params, cfg), opt.step, restack(opt.mu, cfg), restack(opt.nu, cfg))


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, np.ndarray):
        return np.asarray(leaf)
    return to_numpy([full(t) for t in leaf] if isinstance(leaf, list) else full(leaf))


def _rank0() -> bool:
    """Whether this process writes: rank 0 of a world, or no world."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _into(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Copy the whole ``src`` into ``dst``: a DTensor takes its own block."""
    if is_dtensor(dst):
        src = local_block(src, dst.placements, dst.device_mesh)
        dst = dst.to_local()
    dst.copy_(src)


def state_digest(tree, cfg=None) -> str:
    """sha256 of the leaves' bytes as a checkpoint writes them, in order."""
    h = hashlib.sha256()
    for leaf in _leaves(_tree(tree, cfg)):
        h.update(np.ascontiguousarray(_host(leaf)).tobytes())
    return h.hexdigest()


def save_checkpoint(directory: str, step: int, tree, cfg=None, *,
                    n_shards: int = 4) -> str:
    final = os.path.join(directory, f"step_{step:09d}")
    tmp = os.path.join(directory, f".tmp.step_{step:09d}")
    arrays = [_host(x) for x in _leaves(_tree(tree, cfg))]
    if not _rank0():
        dist.barrier()
        return final
    os.makedirs(directory, exist_ok=True)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    order = sorted(range(len(arrays)), key=lambda i: -arrays[i].nbytes)
    assignment, loads = {}, [0] * n_shards
    for i in order:
        s = loads.index(min(loads))
        assignment[i] = s
        loads[s] += arrays[i].nbytes
    for s in range(n_shards):
        np.savez(os.path.join(tmp, f"shard_{s:03d}.npz"),
                 **{f"leaf_{i}": arrays[i] for i, ss in assignment.items() if ss == s})
    manifest = {
        "step": step,
        "n_shards": n_shards,
        "n_leaves": len(arrays),
        "assignment": {str(i): s for i, s in assignment.items()},
        "shapes": [list(a.shape) for a in arrays],
        "dtypes": ["bfloat16" if a.dtype == np.dtype("V2") else str(a.dtype)
                   for a in arrays],
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    if dist.is_initialized():
        dist.barrier()
    return final


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_")
             and os.path.isfile(os.path.join(directory, d, "manifest.json"))]
    return max(steps) if steps else None


def _tensor(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16" and a.dtype == np.dtype("V2"):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def restore_checkpoint(directory: str, step: int, like, cfg=None):
    """Restore step ``step`` into the shape of ``like``.  A TrainState
    (with its ``cfg``) is written in place, on its device, and returned;
    another tree comes back with the same structure and CPU tensors."""
    path = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    tree = _tree(like, cfg)
    leaves = _leaves(tree)
    if manifest["n_leaves"] != len(leaves):
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                         f"target tree has {len(leaves)}")
    out = [None] * len(leaves)
    for s in range(manifest["n_shards"]):
        with np.load(os.path.join(path, f"shard_{s:03d}.npz")) as z:
            for key in z.files:
                i = int(key.split("_")[1])
                out[i] = _tensor(z[key], manifest["dtypes"][i])
    for i, (a, like_leaf) in enumerate(zip(out, leaves)):
        want = ((len(like_leaf), *like_leaf[0].shape) if isinstance(like_leaf, list)
                else tuple(like_leaf.shape))
        if tuple(a.shape) != tuple(want):
            raise ValueError(f"leaf {i}: shape {tuple(a.shape)} != expected {tuple(want)}")
    if tree is like:
        return _rebuild(like, iter(out))
    with torch.no_grad():
        for a, like_leaf in zip(out, leaves):
            for dst, src in (zip(like_leaf, a) if isinstance(like_leaf, list)
                             else [(like_leaf, a)]):
                _into(dst, src)
    return like


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, tuple):
        items = [_rebuild(t, it) for t in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return next(it)
