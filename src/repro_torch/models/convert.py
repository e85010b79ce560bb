"""Carry the JAX package's parameters into the port's model.

``params_from_numpy(tree, cfg, device)`` takes the reference's
``init_model`` output as a nested dict of numpy arrays
(``jax.tree.map(np.asarray, params)``) and builds the port's
``nn.ModuleDict`` with the same keys.  The reference stacks each group's
parameters on a leading axis (``transformer.py:213-223``), and an
encoder-decoder's encoder layers too (``encoder.layers``, :226-235); here
that axis is unstacked into one module a group or layer (an MoE block's
stacked expert weights, (G, E, D, F) there, become (E, D, F)), and a
``rem`` group and ``encoder.final_norm`` are carried as they are.
Weights keep the reference's ``(in, out)`` layout, so nothing is
transposed.  Leaves are carried in ``cfg.pdtype`` except those
the reference keeps in float32 whatever the parameter dtype
(:data:`FLOAT32_LEAVES`: the MoE router, ``repro/models/moe.py:31``, the
RG-LRU gates and ``lam``, ``repro/models/rglru.py:37-48``, and RWKV6's
``mu`` (time and channel mix), ``w0``, LoRA, ``u`` and ``ln_scale``,
``repro/models/rwkv6.py:37-47,121``).

``numpy_from_params(params, cfg)`` is the inverse: the port's parameters
as the reference's nested dict of numpy arrays, ``groups`` and
``encoder.layers`` restacked on the leading axis.  numpy has no bfloat16
without ``ml_dtypes``, so a bfloat16 leaf comes back bit for bit as raw
2-byte values (dtype ``V2``, as ``np.load`` gives the reference's own
bfloat16 checkpoint leaves).  :func:`restack` is the same regrouping over
any tensors keyed like ``named_parameters()`` (the optimizer's moments).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core.index import resolve_device
from repro_torch.models.transformer import _split_groups, check_ported

#: Leaf names the reference holds in float32 whatever ``cfg.pdtype``.
FLOAT32_LEAVES = frozenset({"router", "gate_wr", "gate_br", "gate_wi", "gate_bi", "lam",
                            "mu", "w0", "w_lora_a", "w_lora_b", "u", "ln_scale"})


def params_from_numpy(tree: dict, cfg: ArchConfig, device=None) -> nn.ModuleDict:
    """The port's parameters from the reference's, in ``cfg.pdtype`` (the
    :data:`FLOAT32_LEAVES` in float32)."""
    check_ported(cfg)
    dev = resolve_device(device)

    def module(d: dict, pick=lambda a: a):
        if all(isinstance(v, dict) for v in d.values()):
            return nn.ModuleDict({k: module(v, pick) for k, v in d.items()})
        return nn.ParameterDict({
            k: nn.Parameter(torch.from_numpy(
                np.array(pick(v), np.float32)).to(
                    dev, torch.float32 if k in FLOAT32_LEAVES else cfg.pdtype),
                requires_grad=False)
            for k, v in d.items()})

    def unstack(d: dict, n: int, what: str) -> nn.ModuleList:
        leaf = d
        while isinstance(leaf, dict):
            leaf = next(iter(leaf.values()))
        if len(leaf) != n:
            raise ValueError(f"{cfg.name}: expected {n} stacked {what}, got {len(leaf)}")
        return nn.ModuleList(module(d, lambda a, g=g: a[g]) for g in range(n))

    n_groups, rem_pat = _split_groups(cfg)
    if bool(rem_pat) != ("rem" in tree) or (cfg.kind == "encdec") != ("encoder" in tree):
        raise ValueError(f"{cfg.name}: remainder {rem_pat}, kind {cfg.kind}: unexpected "
                         f"keys {sorted(tree)}")
    out = nn.ModuleDict({k: unstack(v, n_groups, "groups") if k == "groups" else module(v)
                         for k, v in tree.items() if k != "encoder"})
    if "encoder" in tree:
        enc = tree["encoder"]
        out["encoder"] = nn.ModuleDict({
            "layers": unstack(enc["layers"], cfg.encoder_layers, "encoder layers"),
            "final_norm": module(enc["final_norm"])})
    return out


def restack(named: dict, cfg: ArchConfig) -> dict:
    """The reference's nested tree over tensors keyed like the port's
    ``named_parameters()``: ``groups.<g>.<path>`` and
    ``encoder.layers.<l>.<path>`` become one leaf each, a list of the
    per-group (per-layer) tensors in order, stacked on a leading axis in
    the reference."""
    n_groups, _ = _split_groups(cfg)
    tree: dict = {}
    for name, t in named.items():
        parts = name.split(".")
        idx = n = None
        if parts[0] == "groups":
            idx, n, parts = int(parts[1]), n_groups, parts[:1] + parts[2:]
        elif parts[:2] == ["encoder", "layers"]:
            idx, n, parts = int(parts[2]), cfg.encoder_layers, parts[:2] + parts[3:]
        node = tree
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        if idx is None:
            node[parts[-1]] = t
        else:
            node.setdefault(parts[-1], [None] * n)[idx] = t
    return tree


def to_numpy(leaf) -> np.ndarray:
    """A host copy of a tensor, or of a :func:`restack` list stacked on a
    leading axis; bfloat16 as raw 2-byte values (dtype ``V2``)."""
    t = (torch.stack(leaf) if isinstance(leaf, list) else leaf).detach().to(
        "cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def numpy_from_params(params: nn.Module, cfg: ArchConfig) -> dict:
    """The port's parameters as the reference's nested dict of numpy arrays
    (bfloat16 leaves as raw 2-byte values), the inverse of
    :func:`params_from_numpy`."""
    check_ported(cfg)

    def walk(node):
        return ({k: walk(v) for k, v in node.items()} if isinstance(node, dict)
                else to_numpy(node))

    return walk(restack(dict(params.named_parameters()), cfg))
