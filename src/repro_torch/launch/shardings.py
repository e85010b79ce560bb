"""Spec assignment for parameters, optimizer state, inputs and caches, and
their placement as DTensors (port of ``repro.launch.shardings``).

Rules, as the reference's:

- 2D projection weights: input-proj (D, F) -> (None, model); output-proj
  (F, D) -> (model, None)  [Megatron TP];
- embeddings / LM head: vocab dim -> model (the vocab-sharded head feeds
  the ODYS top-k router, ``serving.router.greedy_token(mesh=)``);
- MoE expert tensors (E, D, F): expert dim -> model when E divides the
  axis [expert parallelism], else d_ff -> model (Megatron TP within each
  expert: Mixtral's 8 experts on a 16-wide axis);
- optimizer moments: the parameter's spec, plus dim 0 -> data when
  divisible [ZeRO-1];
- batch dims -> ("pod", "data") when divisible;
- KV caches: kv-head dim -> model when divisible, else head_dim -> model;
  for an unshardable batch (``long_500k``, B = 1) the cache length dim ->
  data [sequence-sharded cache].

Every rule checks divisibility and degrades to replication.  A spec is a
tuple with one entry a dim (``models.sharding``); a mesh a ``DeviceMesh``
or a mapping of axis sizes.

The reference stacks each group's parameters (and an encoder's layers)
on a leading axis and left-pads a leaf's spec for it; the port keeps one
module a group (``models/convert.py``), walks ``named_parameters()``
names, and a leaf's spec is the tail of the reference's (its rules are
applied to the stacked shape, then the stack's entry dropped).  ZeRO-1's
``data`` on a stacked moment's leading (layer) axis therefore has no
counterpart: an unstacked moment takes ``data`` on its own dim 0 only
where the reference's spec has it there too.  Caches are ``{"groups":
[one dict a group], "rem": ...}`` (``models/transformer.py:init_cache``),
specs keyed the same.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.sharding import axis_sizes, is_dtensor, place, placements

_IN_PROJ = ("wq", "wk", "wv", "wg", "w_in", "w_gate", "w_gate_br")
_OUT_PROJ = ("wo", "w_out")


def _axis_ok(mesh, axis: str | None, size: int) -> bool:
    if axis is None:
        return True
    sizes = axis_sizes(mesh)
    return axis in sizes and size % sizes[axis] == 0


def _base_spec(name: str, in_moe: bool, shape: tuple[int, ...], mesh):
    nd = len(shape)
    sizes = axis_sizes(mesh)
    if name == "emb":
        return ("model", None)
    if name == "w":           # LM head (D, V)
        return (None, "model")
    if name == "router":
        return (None, None)
    if in_moe and name in ("w_in", "w_gate", "w_out"):
        e = shape[-3]
        if "model" in sizes and e % sizes["model"] == 0:
            return ("model", None, None)
        if name == "w_out":            # (E, F, D): shard F
            return (None, "model", None)
        return (None, None, "model")   # (E, D, F): shard F
    if name in _IN_PROJ and nd >= 2:
        return (None, "model")
    if name in _OUT_PROJ and nd >= 2:
        return ("model", None)
    if name == "conv_k":
        return (None, "model")
    if name in ("gate_wr", "gate_br", "gate_wi", "gate_bi", "lam", "conv_b"):
        return ("model",)
    return (None,) * nd


def _stacked(parts: list[str]) -> bool:
    """A leaf the reference stacks on a leading axis (a group's, or an
    encoder layer's)."""
    return parts[0] == "groups" or parts[:2] == ["encoder", "layers"]


def _leaf_spec(parts: list[str], shape: tuple[int, ...], mesh) -> tuple:
    """The reference's ``param_pspecs`` rule for one leaf, named by its
    path ``parts``, on the reference's (stacked) shape; the stack's entry
    dropped again."""
    lead = 1 if _stacked(parts) else 0
    shape = (1,) * lead + tuple(shape)
    keys = [p for p in parts if not p.isdigit()]
    base = _base_spec(keys[-1] if keys else "", "moe" in keys, shape, mesh)
    pad = len(shape) - len(base)
    spec = (None,) * max(pad, 0) + tuple(base[-len(shape):] if pad < 0 else base)
    spec = tuple(ax if _axis_ok(mesh, ax, shape[i]) else None
                 for i, ax in enumerate(spec))
    return spec[lead:]


def _named(params) -> dict:
    return (dict(params.named_parameters()) if isinstance(params, torch.nn.Module)
            else dict(params))


def param_pspecs(params, mesh) -> dict[str, tuple]:
    """``{name: spec}`` for a model's parameters (a module, or a mapping
    keyed like its ``named_parameters()``)."""
    return {n: _leaf_spec(n.split("."), tuple(p.shape), mesh)
            for n, p in _named(params).items()}


def opt_pspecs(params, param_specs: dict, mesh) -> dict[str, tuple]:
    """ZeRO-1: a moment inherits its parameter's spec, plus dim 0 -> data
    when free and divisible (on the reference's stacked shape: a stacked
    leaf's dim 0 is the layer axis, which the port does not have)."""
    sizes = axis_sizes(mesh)
    out = {}
    for n, p in _named(params).items():
        lead = 1 if _stacked(n.split(".")) else 0
        s = list(param_specs[n]) + [None] * (p.dim() - len(param_specs[n]))
        if (not lead and p.dim() >= 2 and s[0] is None and "data" in sizes
                and p.shape[0] % sizes["data"] == 0):
            s[0] = "data"
        out[n] = tuple(s)
    return out


def batch_axes(mesh, b: int):
    """Largest prefix of (pod, data) that divides the batch."""
    sizes = axis_sizes(mesh)
    axes = [a for a in ("pod", "data") if a in sizes]
    total = 1
    for a in axes:
        total *= sizes[a]
    if b % total == 0:
        return tuple(axes) if axes else None
    if "data" in sizes and b % sizes["data"] == 0:
        return ("data",)
    return None


def io_pspec(mesh, shape: tuple[int, ...]) -> tuple:
    """Spec for a (B, ...) input: batch-shard dim 0 when divisible."""
    return (batch_axes(mesh, shape[0]),) + (None,) * (len(shape) - 1)


def kv_cache_pspec(mesh, shape: tuple[int, ...]) -> tuple:
    """(B, L, KV, hd) cache spec per the module docstring."""
    B, Lc, KV, hd = shape
    b_ax = batch_axes(mesh, B)
    used_data = b_ax is not None and "data" in b_ax
    l_ax = "data" if not used_data and _axis_ok(mesh, "data", Lc) and Lc > 1 else None
    if _axis_ok(mesh, "model", KV) and KV > 1:
        kv_ax, hd_ax = "model", None
    elif _axis_ok(mesh, "model", hd):
        kv_ax, hd_ax = None, "model"
    else:
        kv_ax, hd_ax = None, None
    return (b_ax, l_ax, kv_ax, hd_ax)


def _cache_leaf_spec(name: str, shape: tuple[int, ...], mesh) -> tuple:
    if name in ("k", "v", "ck", "cv") and len(shape) == 4:
        return kv_cache_pspec(mesh, shape)
    if name == "s" and len(shape) == 4:            # rwkv state (B, H, hd, hd)
        h_ax = "model" if _axis_ok(mesh, "model", shape[1]) and shape[1] > 1 else None
        return (batch_axes(mesh, shape[0]), h_ax, None, None)
    if name in ("h", "x_prev") and len(shape) == 2:
        f_ax = "model" if _axis_ok(mesh, "model", shape[1]) else None
        return (batch_axes(mesh, shape[0]), f_ax)
    if name == "conv" and len(shape) == 3:
        f_ax = "model" if _axis_ok(mesh, "model", shape[2]) else None
        return (batch_axes(mesh, shape[0]), None, f_ax)
    return (None,) * len(shape)


def _map_tree(tree, fn, name=None):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tree(v, fn, name) for v in tree]
    return fn(name, tree)


def cache_pspecs(cache: Any, mesh) -> Any:
    """Spec tree for a decode cache (KV rows, cross K/V, RG-LRU and RWKV6
    states), keyed as the cache; a leaf is named by its last dict key."""
    return _map_tree(cache, lambda name, t: _cache_leaf_spec(name, tuple(t.shape), mesh))


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

def distribute(t: torch.Tensor, pspec: tuple, mesh, device=None):
    """``t`` (the whole tensor, the same on every rank) as a DTensor under
    ``pspec``: each rank keeps its own block, and nothing is sent.  A
    ``meta`` tensor stands for zeros: the block is made on ``device``."""
    return place(t, placements(pspec, mesh), mesh, device)


def distribute_params(params: torch.nn.Module, mesh, specs: dict | None = None,
                      device=None) -> torch.nn.Module:
    """Replace every parameter of ``params`` by a DTensor parameter placed
    by ``param_pspecs`` (or ``specs``), in place; ``requires_grad`` is
    kept (``meta`` parameters become zeros on ``device``).  Returns
    ``params``."""
    specs = param_pspecs(params, mesh) if specs is None else specs
    for name, p in list(params.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        module = params.get_submodule(owner) if owner else params
        d = distribute(p.detach(), specs[name], mesh, device)
        module[leaf] = torch.nn.Parameter(d, requires_grad=p.requires_grad)
    return params


def distribute_tree(tree, specs, mesh, device=None):
    """A nested dict/list of whole tensors (a cache, optimizer moments, a
    batch) as DTensors under ``specs`` keyed alike (``meta`` leaves: zeros
    on ``device``)."""
    if isinstance(tree, dict):
        return {k: distribute_tree(tree[k], specs[k], mesh, device) for k in tree}
    if isinstance(tree, list):
        return [distribute_tree(a, b, mesh, device) for a, b in zip(tree, specs)]
    return tree if is_dtensor(tree) else distribute(tree, specs, mesh, device)


def distribute_cache(cache, mesh, specs=None, device=None):
    """The cache with every tensor a DTensor placed by ``cache_pspecs``
    (a ``meta`` cache: zeros made on ``device``, each rank its block)."""
    return distribute_tree(cache, cache_pspecs(cache, mesh) if specs is None else specs,
                           mesh, device)


def distribute_train_state(params: torch.nn.Module, mesh, device=None):
    """A ``TrainState`` of whole parameters placed on ``mesh``: the
    parameters (in place, made trainable) by ``param_pspecs``, zero AdamW
    moments by ``opt_pspecs`` (ZeRO-1), each rank making only its block;
    ``device`` is where a ``meta`` model's blocks are made (default: the
    parameters' device)."""
    from repro_torch.training.optimizer import OptState
    from repro_torch.training.train_step import TrainState

    dev = torch.device(device) if device is not None else next(params.parameters()).device
    p_specs = param_pspecs(params, mesh)
    moments = {n: torch.empty(p.shape, dtype=torch.float32, device="meta")
               for n, p in params.named_parameters()}
    distribute_params(params, mesh, p_specs, dev)
    params.requires_grad_(True)
    o_specs = opt_pspecs(params, p_specs, mesh)
    return TrainState(params, OptState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        mu=distribute_tree(moments, o_specs, mesh, dev),
        nu=distribute_tree(moments, o_specs, mesh, dev)))
