"""FLOPs and HBM bytes of an eager PyTorch function, counted op by op (the
port's counterpart of ``repro.roofline.hlo_cost``).

The reference parses a compiled HLO module and multiplies loop bodies by
their trip counts.  The port runs eagerly, so :func:`count_cost` runs the
function under a ``TorchDispatchMode`` and sees every op that executes,
every loop iteration included:

- **FLOPs** of the matmul family and of convolutions, by
  ``torch.utils.flop_counter``'s per-op formulas (a counter, not a
  kernel), as the reference counts ``dot`` and ``convolution`` only;
- **HBM bytes**: the bytes of each op's tensor inputs and outputs; views
  (``OpOverload.is_view``) and the bookkeeping ops in :data:`FREE_OPS` are
  free, as the reference's ``_FREE_OPS``;
- **kernels**: the port's CUDA kernels launch through ctypes, which the
  dispatcher never sees.  So each dispatcher that picks a kernel or its
  plain version reports the launch contract's ``work`` once
  (:func:`repro_torch.kernels.registry.dispatched`) and the ops inside are
  not counted: the cost is the same whichever implementation ran.  Kernel
  bytes count as HBM bytes and kernel operations apart (``kernel_ops``, by
  kind), since integer compares are not FLOPs.

Collective bytes are 0: one card.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import registry

aten = torch.ops.aten

#: Ops that move no data (the reference's ``_FREE_OPS``), beyond views.
FREE_OPS = {
    aten.detach.default, aten.lift_fresh.default, aten.empty.memory_format,
    aten.empty_like.default, aten.empty_strided.default, aten.sym_size.int,
    aten.sym_stride.int, aten.sym_numel.default, aten._local_scalar_dense.default,
}


def _flop_ops() -> dict:
    """The matmul-family and convolution formulas of torch's flop counter."""
    from torch.utils.flop_counter import flop_registry

    keep = ("mm", "addmm", "bmm", "baddbmm", "convolution", "_convolution",
            "convolution_backward")
    return {packet: fn for packet, fn in flop_registry.items()
            if getattr(packet, "__name__", "").split(".")[-1] in keep}


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    link_bytes: float = 0.0
    kernel_ops: dict = dataclasses.field(default_factory=dict)
    kernels: dict = dataclasses.field(default_factory=dict)   # entry -> launches
    by_op: dict = dataclasses.field(default_factory=dict)     # op -> (calls, flops, bytes)


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.suspended = 0
        self._flops = _flop_ops()

    def add_kernel(self, entry: str, work) -> None:
        c = self.cost
        c.hbm_bytes += work.bytes
        c.kernel_ops[work.unit] = c.kernel_ops.get(work.unit, 0) + work.ops
        c.kernels[entry] = c.kernels.get(entry, 0) + 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.suspended or func.is_view or func in FREE_OPS:
            return out
        flops = 0
        fn = self._flops.get(func.overloadpacket)
        if fn is not None:
            flops = fn(*args, **kwargs, out_val=out)
        n_bytes = sum(x.numel() * x.element_size()
                      for x in tree_flatten((args, kwargs, out))[0]
                      if isinstance(x, torch.Tensor))
        c = self.cost
        c.flops += flops
        c.hbm_bytes += n_bytes
        name = str(func.overloadpacket)
        calls, f, b = c.by_op.get(name, (0, 0, 0))
        c.by_op[name] = (calls + 1, f + flops, b + n_bytes)
        return out


def count_cost(fn, *args, **kwargs) -> tuple[object, Cost]:
    """Run ``fn(*args, **kwargs)`` and count its cost; returns ``(result,
    cost)``."""
    counter = _Counter()
    registry.COUNTERS.append(counter)
    try:
        with counter:
            out = fn(*args, **kwargs)
    finally:
        registry.COUNTERS.remove(counter)
    return out, counter.cost
