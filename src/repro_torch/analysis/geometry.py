"""Launch geometry: grid enumeration, access ranges, launch limits.

The counterpart of the reference's ``repro.analysis.blockspec``.  It takes
another name because a BlockSpec does not exist on Hopper: a CUDA kernel
has no block shape or index map for a checker to evaluate.  What a launch
reads and writes is stated by its contract
(:class:`repro_torch.kernels.registry.Launch`) as flat element ranges per
block, and this module turns those into what the checks compare:

- :func:`segments` — an :class:`~repro_torch.kernels.registry.Access`'s
  ranges (a strided access is ``count`` ranges);
- :func:`launch_limit_errors` — the card's launch limits (threads a block,
  grid extents, dynamic shared memory with and without the opt-in): the
  counterpart of the reference's VMEM budget (``vmem_bytes``);
- :func:`alignment_errors` — the 16-byte rule of bulk copies and TMA (the
  counterpart of the (8, 128) tile alignment, which has no Hopper
  meaning).
"""
from __future__ import annotations

import numpy as np

from repro_torch.kernels.registry import (MAX_GRID_X, MAX_GRID_YZ, MAX_THREADS,
                                          SMEM_OPTIN, SMEM_STATIC_LIMIT, Access,
                                          Launch, Operand)

#: The bytes a bulk copy's or TMA box's ends and a TMA stride align to.
BULK_ALIGN = 16


def segments(acc: Access) -> np.ndarray:
    """``[count, 2]`` int64: the ``[lo, hi)`` ranges of an access."""
    starts = acc.lo + np.arange(acc.count, dtype=np.int64) * acc.stride
    return np.stack([starts, starts + (acc.hi - acc.lo)], axis=1)


def extent(acc: Access) -> tuple[int, int]:
    """The first and one-past-the-last element an access touches."""
    if acc.hi <= acc.lo or acc.count <= 0:
        return acc.lo, acc.lo
    return acc.lo, acc.hi + (acc.count - 1) * acc.stride


def launch_limit_errors(launch: Launch, *, smem_budget: int = SMEM_OPTIN) -> list[str]:
    """The card's limits a launch breaks: threads a block, grid extents,
    dynamic shared memory above 48 KB without the opt-in, or above the
    budget with it."""
    errs = []
    if not 1 <= launch.threads <= MAX_THREADS:
        errs.append(f"{launch.threads} threads a block (1 .. {MAX_THREADS})")
    gx, gy, gz = launch.grid
    if not 1 <= gx <= MAX_GRID_X or not 1 <= gy <= MAX_GRID_YZ or not 1 <= gz <= MAX_GRID_YZ:
        errs.append(f"grid {launch.grid} outside (2**31 - 1, 65535, 65535)")
    if launch.smem > SMEM_STATIC_LIMIT and not launch.opt_in:
        errs.append(f"{launch.smem} bytes of dynamic shared memory without the opt-in "
                    f"(limit {SMEM_STATIC_LIMIT})")
    if launch.smem > smem_budget:
        errs.append(f"{launch.smem} bytes of dynamic shared memory exceed the "
                    f"{smem_budget}-byte budget")
    return errs


def alignment_errors(op: Operand, acc: Access) -> list[str]:
    """A bulk access's ends (each segment's) must lie on 16 bytes, and so
    must its stride."""
    if not acc.bulk or acc.hi <= acc.lo:
        return []
    errs = []
    size = op.itemsize
    if (acc.lo * size) % BULK_ALIGN or (acc.hi * size) % BULK_ALIGN:
        errs.append(f"bulk range [{acc.lo}, {acc.hi}) of {size}-byte elements is not "
                    f"on {BULK_ALIGN} bytes")
    if acc.count > 1 and (acc.stride * size) % BULK_ALIGN:
        errs.append(f"stride {acc.stride * size} bytes is not a multiple of "
                    f"{BULK_ALIGN}")
    return errs


def stride_errors(op: Operand) -> list[str]:
    """A TMA operand's global strides must be multiples of 16 bytes."""
    bad = [s for s in op.strides if s % BULK_ALIGN]
    return [f"TMA strides {op.strides} bytes: {bad} not multiples of {BULK_ALIGN}"] if bad else []
