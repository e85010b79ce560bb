"""Roofline terms on the H100: the port's counterpart of ``repro.roofline``.

- :mod:`repro_torch.roofline.analysis` — the H100 rates, :class:`Roofline`,
  :func:`model_flops_for`, :func:`kernel_bound` (a launch contract's
  ``work`` over the card's rates);
- :mod:`repro_torch.roofline.op_cost` — :func:`count_cost`: FLOPs and HBM
  bytes of an eager PyTorch function, counted op by op under a dispatch
  mode, the port's kernels reporting their contracts' ``work``.
"""
from repro_torch.roofline.analysis import (Roofline, bound_ms, kernel_bound,
                                           model_flops_for, roofline_from_cost)

__all__ = ["Roofline", "bound_ms", "kernel_bound", "model_flops_for",
           "roofline_from_cost"]
