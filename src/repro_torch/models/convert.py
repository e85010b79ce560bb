"""Carry the JAX package's parameters into the port's model.

``params_from_numpy(tree, cfg, device)`` takes the reference's
``init_model`` output as a nested dict of numpy arrays
(``jax.tree.map(np.asarray, params)``) and builds the port's
``nn.ModuleDict`` with the same keys.  The reference stacks each group's
parameters on a leading axis (``transformer.py:213-223``); here that axis
is unstacked into one module a group, and a ``rem`` group is carried as it
is.  Weights keep the reference's ``(in, out)`` layout, so nothing is
transposed.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core.index import resolve_device
from repro_torch.models.transformer import _split_groups, check_ported


def params_from_numpy(tree: dict, cfg: ArchConfig, device=None) -> nn.ModuleDict:
    """The port's parameters from the reference's, in ``cfg.pdtype``."""
    check_ported(cfg)
    dev = resolve_device(device)

    def module(d: dict, pick=lambda a: a):
        if all(isinstance(v, dict) for v in d.values()):
            return nn.ModuleDict({k: module(v, pick) for k, v in d.items()})
        return nn.ParameterDict({
            k: nn.Parameter(torch.from_numpy(
                np.array(pick(v), np.float32)).to(dev, cfg.pdtype),
                requires_grad=False)
            for k, v in d.items()})

    n_groups, rem_pat = _split_groups(cfg)
    leaf = tree["groups"]
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    if len(leaf) != n_groups or bool(rem_pat) != ("rem" in tree):
        raise ValueError(f"{cfg.name}: expected {n_groups} stacked groups and "
                         f"remainder {rem_pat}, got {len(leaf)} and keys {sorted(tree)}")
    return nn.ModuleDict({
        k: nn.ModuleList(module(v, lambda a, g=g: a[g]) for g in range(n_groups))
        if k == "groups" else module(v)
        for k, v in tree.items()})
