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

**Collectives** (a mesh's DTensor ops, counted per rank): an op on
DTensors is handed back to DTensor first (``NotImplemented``, as
``CommDebugMode`` does), so the counter sees each rank's local ops, on
local shapes (per-device FLOPs and bytes, as the reference's post-SPMD
module), and the collectives they issue.  Each functional collective
(and a ``c10d`` all-gather or send) adds its operand bytes times the
reference's ring factor (:func:`repro_torch.roofline.analysis.
link_factor`: all-gather's operand is the local block, reduce-scatter's
the whole input) to ``link_bytes``, by kind, and no HBM bytes.  On one
card there are none.
"""
from __future__ import annotations

import contextlib
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
    torch.ops.prim.device.default,
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
    collectives: dict = dataclasses.field(default_factory=dict)  # kind -> (count, link bytes)


#: Functional collectives and c10d ops by the reference's kind names; the
#: all-gathers and reduce-scatters name their group size, the others a group.
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all", "allgather_": "all-gather",
    "allreduce_": "all-reduce", "send": "collective-permute",
}
_WAITS = ("wait_tensor", "recv_", "barrier")


def _collective(func, args) -> tuple[str, float, int] | None:
    """``(kind, operand bytes, group size)`` of a collective op, else None."""
    ns, name = func.namespace, func.overloadpacket.__name__
    if ns not in ("_c10d_functional", "c10d") or name not in _COLLECTIVES:
        return None
    from torch.distributed.distributed_c10d import _resolve_process_group

    kind = _COLLECTIVES[name]
    if name == "allgather_":                        # (outputs, inputs, group, ...)
        return kind, sum(t.numel() * t.element_size() for t in args[1]), len(args[0][0])
    if name == "allreduce_":                        # (tensors, group, op, ...)
        from torch._C._distributed_c10d import ProcessGroup

        n = ProcessGroup.unbox(args[1]).size()
        return kind, sum(t.numel() * t.element_size() for t in args[0]), n
    if name == "send":                              # (tensors, group, dst, tag)
        return kind, sum(t.numel() * t.element_size() for t in args[0]), 2
    t = args[0]
    n_bytes = t.numel() * t.element_size()
    if name in ("all_gather_into_tensor", "reduce_scatter_tensor"):
        n = int(args[-2])
    else:
        n = _resolve_process_group(args[-1]).size()
    return kind, n_bytes, n


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
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented           # DTensor runs it; its local ops come back
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.suspended or func.is_view or func in FREE_OPS:
            return out
        coll = _collective(func, args)
        if coll is not None or func.overloadpacket.__name__ in _WAITS:
            if coll is not None and not self.suspended:
                from repro_torch.roofline.analysis import link_factor

                kind, n_bytes, n = coll
                link = n_bytes * link_factor(kind, n)
                c = self.cost
                c.link_bytes += link
                cnt, b = c.collectives.get(kind, (0, 0.0))
                c.collectives[kind] = (cnt + 1, b + link)
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
        with counter, _uncounted_shape_propagation(counter):
            out = fn(*args, **kwargs)
    finally:
        registry.COUNTERS.remove(counter)
    return out, counter.cost


@contextlib.contextmanager
def _uncounted_shape_propagation(counter):
    """DTensor derives an op's global output shape by running the op once on
    fake tensors of the global shapes (cached by signature); those runs are
    no rank's work, so the counter is suspended for them."""
    try:
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
    except ImportError:
        yield
        return
    name = "_propagate_tensor_meta_non_cached"
    orig = getattr(ShardingPropagator, name, None)
    if orig is None:
        yield
        return

    def suspended(self, *a, **k):
        counter.suspended += 1
        try:
            return orig(self, *a, **k)
        finally:
            counter.suspended -= 1

    setattr(ShardingPropagator, name, suspended)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)
