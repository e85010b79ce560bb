"""The contract checker: prove each CUDA launch's contract without a card.

For every :class:`repro_torch.kernels.registry.LaunchContract` the checker
enumerates each canonical instance's launches block by block and proves:

- **bounds**: every read and write range lies inside its operand's
  allocation (and names a declared operand);
- **live-extent** (the counterpart of the reference's clamp-escape): a
  read past an operand's live extent (``padding_from``) lands only in the
  pad the operand declares, and the kernel does not consume it, unless
  the contract declares the pad's value a sentinel the kernel reads on
  purpose, and the pad holds that value;
- **spare** (the reference's spare-tile): an operand that declares a pad
  has at least the spare that pad promises past its live extent (a whole
  TILE for ``flat_tile_pad``, ``TILE + chunk_rows * BLOCK`` words for
  ``packed_word_pad``, one descriptor row for ``worklist_pad``), and at
  least its largest read past the live extent;
- **alias**: no two blocks of one launch write the same output element
  (no Hopper kernel of the port accumulates across blocks, so there are
  no revisit dimensions);
- **alignment**: every bulk-copied range, TMA box and TMA stride lies on
  16 bytes (the reference's (8, 128) tile rule has no Hopper meaning);
- **launch-limits** (the counterpart of the VMEM budget): at most 1024
  threads a block, grid y and z at most 65535, dynamic shared memory at
  most 48 KB unless the launch opts in, and at most the budget (default
  232448 bytes, H100's per-block opt-in maximum) when it does.

Every finding carries the contract's sites: its ``extern "C"`` launch
function and its Python wrapper.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.analysis import geometry
from repro_torch.kernels.registry import (SMEM_OPTIN, LaunchContract,
                                          load_contracts)

#: Default dynamic shared memory budget (bytes) of one block.
DEFAULT_SMEM_BUDGET = SMEM_OPTIN

#: Cap on the blocks enumerated per instance; canonical instances are tiny.
MAX_GRID_POINTS = 1 << 16


@dataclasses.dataclass(frozen=True)
class Finding:
    kernel: str
    check: str      # bounds | live-extent | spare | alias | alignment | launch-limits
    message: str
    site: str       # "csrc/<source>.cu:line (wrapper file:line)"

    def __str__(self) -> str:
        return f"{self.site}: [{self.kernel}/{self.check}] {self.message}"


def _alias(launch, writes_by_block, emit) -> None:
    """No element of an output written by two blocks."""
    by_op: dict[str, list] = {}
    for blk, accs in writes_by_block:
        for acc in accs:
            for lo, hi in geometry.segments(acc).tolist():
                if hi > lo:
                    by_op.setdefault(acc.operand, []).append((lo, hi, blk))
    for name, segs in by_op.items():
        segs.sort()
        # the largest end seen so far, and the largest from another block
        best = (-1, None)
        other = (-1, None)
        for lo, hi, blk in segs:
            for end, owner in (best, other):
                if owner is not None and owner != blk and lo < end:
                    emit("alias", f"launch {launch.kernel}: output {name!r} elements "
                                  f"[{lo}, {min(hi, end)}) written by blocks {owner} "
                                  f"and {blk}")
                    return
            if hi > best[0]:
                if best[1] != blk:
                    other = best
                best = (hi, blk)
            elif blk != best[1] and hi > other[0]:
                other = (hi, blk)


def _check_instance(c: LaunchContract, inst, smem_budget: int, emit) -> None:
    ops = {op.name: op for op in inst.operands}
    past: dict[str, int] = {}
    where = f"instance {inst.label!r}"
    for op in ops.values():
        for err in geometry.stride_errors(op):
            emit("alignment", f"{where}: operand {op.name!r}: {err}")
    n_blocks = sum(launch.n_blocks for launch in inst.launches)
    if n_blocks > MAX_GRID_POINTS:
        emit("bounds", f"{where}: {n_blocks} blocks, beyond the {MAX_GRID_POINTS}-block "
                       f"enumeration cap; register a smaller canonical instance")
        return
    for launch in inst.launches:
        for err in geometry.launch_limit_errors(launch, smem_budget=smem_budget):
            emit("launch-limits", f"{where}: launch {launch.kernel}: {err}")
        writes_by_block = []
        for blk in launch.blocks():
            writes = launch.writes(blk)
            writes_by_block.append((blk, writes))
            for role, accs in (("read", launch.reads(blk)), ("write", writes)):
                for acc in accs:
                    op = ops.get(acc.operand)
                    at = f"{where}: launch {launch.kernel} block {blk}"
                    if op is None:
                        emit("bounds", f"{at}: {role} of undeclared operand {acc.operand!r}")
                        continue
                    lo, hi = geometry.extent(acc)
                    if hi <= lo:
                        continue
                    if lo < 0 or hi > op.elems:
                        emit("bounds", f"{at}: {role} [{lo}, {hi}) of {op.name!r} leaves "
                                       f"its {op.elems} elements")
                        continue
                    for err in geometry.alignment_errors(op, acc):
                        emit("alignment", f"{at}: {role} of {op.name!r}: {err}")
                    if role == "read" and op.padding_from is not None and hi > op.padding_from:
                        _live_extent(op, acc, at, past, emit)
        _alias(launch, writes_by_block, emit)
    for op in ops.values():
        if op.pad is None:
            continue
        if op.padding_from is None:
            emit("spare", f"{where}: {op.name!r} declares pad {op.pad!r} but no live extent")
            continue
        slack = op.elems - op.padding_from
        need = max(op.spare, past.get(op.name, 0))
        if slack < need:
            emit("spare", f"{where}: {op.name!r}: {slack} padded elements past the live "
                          f"extent {op.padding_from}, need {need} (the {op.pad!r} pad's "
                          f"spare {op.spare}, reads reaching {past.get(op.name, 0)} past)")


def _live_extent(op, acc, at, past, emit) -> None:
    pf = op.padding_from
    for lo, hi in geometry.segments(acc).tolist():
        if hi <= pf:
            continue
        past[op.name] = max(past.get(op.name, 0), hi - pf)
        if op.pad is None:
            emit("live-extent", f"{at}: read [{lo}, {hi}) of {op.name!r} passes its live "
                                f"extent {pf}, which declares no pad")
            return
        if not acc.consumed:
            continue
        if op.sentinel is None:
            emit("live-extent", f"{at}: read [{lo}, {hi}) of {op.name!r} consumes "
                                f"positions past its live extent {pf} (pad {op.pad!r}, "
                                f"no sentinel declared)")
            return
        held = op.host[max(lo, pf):min(hi, op.elems)]
        if held.size and not np.all(held == op.sentinel):
            emit("live-extent", f"{at}: read [{lo}, {hi}) of {op.name!r} consumes the pad "
                                f"past {pf} as the sentinel {op.sentinel}, but the pad "
                                f"holds other values")
            return


def check_contract(c: LaunchContract, *,
                   smem_budget: int = DEFAULT_SMEM_BUDGET) -> list[Finding]:
    """All findings for one contract (empty: every instance proven)."""
    finds: list[Finding] = []
    seen: set = set()

    def emit(check: str, message: str) -> None:
        key = (check, message.split(": ")[0])
        if key not in seen:        # one finding per check and instance
            seen.add(key)
            finds.append(Finding(c.name, check, message, c.where))

    for inst in c.instances:
        _check_instance(c, inst, smem_budget, emit)
    return finds


def check_all(
    names: Sequence[str] | None = None,
    *,
    smem_budget: int = DEFAULT_SMEM_BUDGET,
) -> tuple[list[LaunchContract], list[Finding]]:
    """Build and check every registered contract (or the named subset)."""
    contracts = load_contracts(names)
    finds: list[Finding] = []
    for c in contracts:
        finds.extend(check_contract(c, smem_budget=smem_budget))
    return contracts, finds
