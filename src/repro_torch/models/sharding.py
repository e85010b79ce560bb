"""Logical-axis sharding for the model zoo, on DTensor (port of
``repro.models.sharding``).

Model code annotates tensors with *logical* dim names (``"batch"``,
``"model"``, ``None``); an active mesh (:func:`use_mesh`) resolves them to
mesh axes.  Without a mesh the annotations do nothing, so the same model
code runs on one card and on a mesh unchanged.

Mesh conventions, as the reference's:

- ``"batch"``  -> ``("pod", "data")``, whichever of those axes exist;
- ``"model"``  -> the tensor-parallel axis;
- ``"expert"`` -> the MoE expert dim, also mapped to ``"model"``.

GSPMD's terms in DTensor's: a ``PartitionSpec`` is a tuple with one entry
a tensor dim (``None``, an axis name, or a tuple of axis names), turned
into one DTensor placement a mesh dim by :func:`placements` (``Shard(d)``
on every mesh dim that splits tensor dim ``d``, ``Replicate()`` on the
others); ``with_sharding_constraint`` is ``DTensor.redistribute``
(:func:`constrain`); ``jit(in_shardings=)`` is
:func:`repro_torch.launch.shardings.distribute_params` /
``distribute_cache``.

A "mesh" is a :class:`~torch.distributed.device_mesh.DeviceMesh`, or for
the spec functions a plain mapping of axis name to size (the rules depend
on the names and sizes only).

**Gathers under ``gloo``.**  DTensor's own all-gather (the functional
``all_gather_into_tensor``, also its all-to-all fallback on ``gloo``)
crashes the rank on CUDA tensors under ``gloo`` (torch 2.11, H100:
SIGSEGV), while its all-reduce and reduce-scatter work, and so does the
plain ``dist.all_gather``.  So in a ``gloo`` world :func:`redistribute`
takes every step that leaves a shard (Shard -> Replicate, Shard ->
Shard) itself: the blocks are gathered through
``core.parallel.gather`` (staged on the host, the backend's wire), and
the rest is DTensor's.  Model code redistributes through it, never
through ``DTensor.redistribute``, and is written so that DTensor's ops
never gather on their own; the TP tests count the functional gathers of
a ``gloo`` run and want none.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Mapping

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication, local_map

_state = threading.local()


def current_mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh`` or ``None``) the active mesh of this
    thread for the body."""
    prev = current_mesh()
    _state.mesh = mesh
    try:
        yield
    finally:
        _state.mesh = prev


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or a mapping, in mesh
    order."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _resolve(dim: str | None, mesh) -> str | tuple[str, ...] | None:
    names = axis_sizes(mesh)
    if dim is None:
        return None
    if dim == "batch":
        axes = tuple(a for a in ("pod", "data") if a in names)
        return axes if axes else None
    if dim in ("model", "expert"):
        return "model" if "model" in names else None
    if dim == "data":
        return "data" if "data" in names else None
    raise ValueError(f"unknown logical dim {dim!r}")


def spec(*dims: str | None) -> tuple:
    """The spec of ``dims`` under the active mesh; ``()`` without one (the
    reference's ``P()``)."""
    mesh = current_mesh()
    if mesh is None:
        return ()
    return tuple(_resolve(d, mesh) for d in dims)


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(pspec, mesh) -> list:
    """One DTensor placement a mesh dim for the spec ``pspec``: ``Shard(d)``
    on each mesh dim named in entry ``d`` (both of ``("pod", "data")``),
    ``Replicate()`` elsewhere."""

    out = [Replicate() for _ in axis_sizes(mesh)]
    names = list(axis_sizes(mesh))
    for d, entry in enumerate(pspec):
        for a in _axes(entry):
            out[names.index(a)] = Shard(d)
    return out


def divisible_spec(dims, shape, mesh) -> tuple:
    """The resolved spec of logical ``dims`` over ``shape``, an axis
    dropped where it does not divide its dim (GSPMD would pad unevenly)."""
    sizes = axis_sizes(mesh)
    resolved = []
    for d, size in zip(dims, shape):
        ax = _resolve(d, mesh)
        n = 1
        for a in _axes(ax):
            n *= sizes[a]
        resolved.append(ax if size % n == 0 else None)
    return tuple(resolved)


def mesh_ops():
    """The context model code runs under: with an active mesh, plain
    tensors made inside (positions, masks, iotas; global shapes) meet
    DTensors as replicated ones (``implicit_replication``); without one,
    nothing."""
    if current_mesh() is None:
        return contextlib.nullcontext()

    return implicit_replication()


def is_dtensor(x) -> bool:

    return isinstance(x, DTensor)


def local_apply(fn, *args, n_out: int = 1):
    """``fn(*args)`` on each rank's local blocks, for ops without a DTensor
    sharding rule (sorts, scans, scatters): every DTensor argument enters
    as it is placed, and the outputs (``n_out`` of them) are placed as
    ``args[0]``.  With no DTensor argument it is ``fn(*args)``."""
    if not any(is_dtensor(a) for a in args):
        return fn(*args)

    like = args[0]
    out_pl = list(like.placements)   # a tuple would mean one entry an output
    in_pl = tuple(list(a.placements) if is_dtensor(a) else None for a in args)
    return local_map(fn, out_placements=out_pl if n_out == 1 else (out_pl,) * n_out,
                     in_placements=in_pl,
                     in_grad_placements=grad_placements(in_pl, like.placements),
                     device_mesh=like.device_mesh)(*args)


def grad_placements(in_pl, batch_pl) -> tuple:
    """The placements of the gradients of ``local_map`` inputs placed
    ``in_pl``, when the batch is placed ``batch_pl``: an input replicated
    on a mesh dim that splits the batch (a weight) gets, on each rank,
    the gradient of that rank's rows only, a partial sum there."""

    def one(pls):
        if pls is None:
            return None
        return [Partial() if b == Shard(0) and p == Replicate() else p
                for p, b in zip(pls, batch_pl)]

    return tuple(one(p) for p in in_pl)


def local_block(t: torch.Tensor, pls, mesh) -> torch.Tensor:
    """This rank's block of the whole tensor ``t`` under placements
    ``pls``: the mesh dims in order, each splitting its tensor dim in even
    chunks (the major-to-minor order of a ``("pod", "data")`` entry)."""
    for i, pl in enumerate(pls):
        if isinstance(pl, Shard):
            t = t.chunk(mesh.size(i), pl.dim)[mesh.get_local_rank(i)]
    return t


def place(t: torch.Tensor, pls, mesh, device=None):
    """The whole tensor ``t`` (the same on every rank) as a DTensor with
    placements ``pls``: each rank keeps its block (:func:`local_block`),
    and nothing is sent.  A ``meta`` ``t`` stands for zeros, made on
    ``device``."""

    local = local_block(t, pls, mesh)
    if t.is_meta and device is not None:
        local = torch.zeros(local.shape, dtype=t.dtype, device=device)
    elif local.numel() < t.numel():    # a copy: the whole tensor's storage can go
        local = local.clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(local.contiguous(), mesh, list(pls), run_check=False,
                              shape=t.shape, stride=t.contiguous().stride())


def rows_like(t: torch.Tensor, ref) -> torch.Tensor:
    """A plain (B, ...) tensor made inside the model (positions) placed as
    DTensor ``ref``'s batch rows; ``t`` itself when ``ref`` is plain.  A
    DTensor the backward meets needs no implicit replication."""
    if not is_dtensor(ref):
        return t
    return place(t, rows_placements(ref), ref.device_mesh)


def rows_placements(x) -> list:
    """``x``'s placements with only its batch (dim 0) shards kept."""

    return [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in x.placements]


def rows_local(fn, rows: tuple, replicated: tuple = (), n_out: int = 1):
    """``fn(*rows, *replicated)`` on each rank's batch rows: the ``rows``
    tensors (B, ...) placed as the first one's batch and replicated on
    every other mesh dim, the ``replicated`` ones replicated, and the
    outputs (B, ...) placed as the rows."""
    if not is_dtensor(rows[0]):
        return fn(*rows, *replicated)

    mesh = rows[0].device_mesh
    pl = rows_placements(rows[0])
    rep = [Replicate()] * len(pl)
    rows = tuple(redistribute(r, pl) for r in rows)
    replicated = tuple(redistribute(r, rep) for r in replicated)
    return local_apply(fn, *rows, *replicated, n_out=n_out)


def _gloo(mesh) -> bool:
    import torch.distributed as dist

    return dist.get_backend(mesh.get_group(0)) == "gloo"


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``t`` reduced (``"sum"`` or ``"max"``) over ``group``, on the
    backend's wire (``core.parallel.wire_device``: the host under
    ``gloo``), back on ``t``'s device."""
    import torch.distributed as dist

    from repro_torch.core.parallel import wire_device

    wire = wire_device(group, t.device)
    out = t.to(wire, copy=True).contiguous()
    dist.all_reduce(out, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                    group=group)
    return out.to(t.device)


def _gather_dim(x, i: int):
    """Mesh dim ``i``'s Shard(d) of DTensor ``x`` made Replicate by an
    explicit gather of the blocks, in coordinate order (no autograd)."""

    from repro_torch.core.parallel import gather

    mesh, pl = x.device_mesh, list(x.placements)
    d = pl[i].dim
    whole = torch.cat(gather(x.to_local(), mesh.get_group(i)), dim=d)
    pl[i] = Replicate()
    return DTensor.from_local(whole, mesh, pl, run_check=False, shape=x.shape,
                              stride=x.stride())


def _to(x, want: list):
    """``x`` redistributed to ``want`` without autograd; in a ``gloo``
    world every step that leaves a shard is an explicit gather."""

    if list(x.placements) == want:
        return x
    mesh = x.device_mesh
    if _gloo(mesh):
        for i in reversed(range(len(want))):     # innermost mesh dim first
            pl = x.placements[i]
            if isinstance(pl, Shard) and want[i] != pl:
                x = _gather_dim(x, i)
        if list(x.placements) == want:
            return x
    return x.redistribute(mesh, want)


def replicate_partials(pls) -> list:
    """``pls`` with every partial placement replicated (what a reduction
    of it gives)."""

    return [Replicate() if p.is_partial() else p for p in pls]


class _Redistribute(torch.autograd.Function):
    """GSPMD's sharding constraint on DTensors: the value goes to the
    target placements, and so does its gradient on the way back (a partial
    gradient is reduced there, as the transposed constraint reduces it)
    before it takes the input's placements (a replicated gradient for a
    partial input)."""

    @staticmethod
    def forward(ctx, x, want):
        ctx.src, ctx.want = list(x.placements), list(want)
        return _to(x, list(want))

    @staticmethod
    def backward(ctx, grad):
        # a partial gradient is reduced into the target placement first
        # (a reduce-scatter for a shard); the rest moves once
        mid = [w if g.is_partial() else g for g, w in zip(grad.placements,
                                                          replicate_partials(ctx.want))]
        return _to(_to(grad, mid), replicate_partials(ctx.src)), None


def redistribute(x, want):
    """``x`` redistributed to placements ``want``, its gradient as
    :class:`_Redistribute` says, the gathers explicit in a ``gloo`` world
    (see the module note)."""
    if list(x.placements) == list(want):
        return x
    return _Redistribute.apply(x, list(want))


def reduce_grad(x):
    """``x`` itself, whose gradient (a partial sum from a ``local_map``)
    is reduced into ``x``'s placements right there, by :func:`redistribute`'s
    path, before DTensor's own ops can carry it on."""
    return _Redistribute.apply(x, list(x.placements))


def full(x) -> torch.Tensor:
    """The whole tensor of a DTensor on every rank (through
    :func:`redistribute`); a plain tensor as it is."""
    if not is_dtensor(x):
        return x

    return redistribute(x, [Replicate()] * x.device_mesh.ndim).to_local()


def constrain(x: torch.Tensor, *dims: str | None) -> torch.Tensor:
    """``redistribute`` a DTensor to the placements of ``dims`` under the
    active mesh; a plain tensor, or any tensor without a mesh, is returned
    as it is.  Axes that do not divide their dim are dropped, as in the
    reference."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    assert len(dims) == x.ndim, (dims, x.shape)
    return redistribute(x, placements(divisible_spec(dims, x.shape, mesh), mesh))
