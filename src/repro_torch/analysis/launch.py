"""Launch every launch contract's canonical instances on the card.

Each instance's arguments (CPU tensors, block-codec twins) are copied to
the card, the entry's ``*_cuda`` wrapper launches on them, and the result
is held against the plain version on the CPU: bit for bit, except K12
(float32 within rtol = atol = 2e-5; bfloat16 within 2e-2 and a
row-relative 0.05, :data:`~repro_torch.kernels.flash_attention.BF16_ROW_REL_TOL`).
``python -m repro_torch.analysis launch`` runs this, the process
``chip_smoke.py`` runs under ``compute-sanitizer --tool memcheck``;
:func:`memcheck_verdict` reads that run's output.
"""
from __future__ import annotations

import dataclasses
import re

import torch

from repro_torch.core.index import PackedFlatArrays

#: K12's tolerances against its plain version, by dtype.
K12_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def to_device(x, device):
    """``x`` (a tensor, a twin, a tuple of them, or anything else) on
    ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, PackedFlatArrays):
        return PackedFlatArrays(*(a.to(device) for a in x.arrays()),
                                chunk_rows=x.chunk_rows)
    if isinstance(x, tuple):
        return tuple(to_device(y, device) for y in x)
    return x


def _outputs(x) -> tuple:
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


@dataclasses.dataclass
class LaunchResult:
    name: str
    label: str
    ok: bool
    max_abs_err: float


def compare(got, want) -> tuple[bool, float]:
    """``(ok, max abs error)`` of a wrapper's outputs against the plain
    version's."""
    from repro_torch.kernels.flash_attention import BF16_ROW_REL_TOL, max_row_rel_err

    ok, err = True, 0.0
    for g, w in zip(_outputs(got), _outputs(want)):
        g = g.cpu()
        if g.shape != w.shape or g.dtype != w.dtype:
            return False, float("inf")
        if g.dtype in K12_TOL:
            err = max(err, float((g.float() - w.float()).abs().max()) if g.numel() else 0.0)
            tol = K12_TOL[g.dtype]
            ok &= bool(torch.allclose(g.float(), w.float(), rtol=tol, atol=tol))
            if g.dtype == torch.bfloat16:
                ok &= max_row_rel_err(g, w) < BF16_ROW_REL_TOL
        else:
            diff = (g.long() - w.long()).abs()
            err = max(err, float(diff.max()) if diff.numel() else 0.0)
            ok &= bool(torch.equal(g, w))
    return ok, err


def launch_instance(c, inst, device="cuda"):
    """The wrapper's result on the card and the plain version's on the CPU
    for one instance."""
    got = c.wrapper(*to_device(inst.args, device), **inst.kwargs)
    torch.cuda.synchronize()
    want = c.plain(*inst.args, **inst.kwargs)
    return got, want


def launch_all(names=None, device="cuda") -> list[LaunchResult]:
    """Every instance of every (named) contract, launched and compared."""
    from repro_torch.kernels.registry import load_contracts

    out = []
    for c in load_contracts(names):
        for inst in c.instances:
            got, want = launch_instance(c, inst, device)
            ok, err = compare(got, want)
            out.append(LaunchResult(c.name, inst.label, ok, err))
    return out


#: The sanitizer's own refusal to run on a device (its first lines, before
#: its target runs).
MEMCHECK_REFUSAL = re.compile(r"^=+ Error: (Device not supported.*)$", re.MULTILINE)
#: The first line of a memcheck report: an invalid access, a failed CUDA
#: call, an out-of-range or misaligned address.
MEMCHECK_FAULT = re.compile(r"^=+ (Invalid|Program hit|Out-of-range|Misaligned)",
                            re.MULTILINE)
#: The last line ``python -m repro_torch.analysis launch`` prints.
LAUNCH_DONE = re.compile(r"^launch: (\d+) instance\(s\), (\d+) mismatch", re.MULTILINE)


@dataclasses.dataclass
class MemcheckVerdict:
    status: str              # "clean" | "faults" | "not run"
    errors: int | None       # the sanitizer's error count (None: not run)
    by_kernel: dict          # kernel -> fault reports naming it
    detail: str              # the refusal line, the summary, or why it failed


def memcheck_verdict(text: str, rc: int) -> MemcheckVerdict:
    """Read ``compute-sanitizer --tool memcheck python -m
    repro_torch.analysis launch``'s output ``text`` and exit code ``rc``.

    "not run" only when the sanitizer refused the device in its own words
    and its target printed nothing of its own (no launch ran): then the
    target's failed CUDA calls are the refusal's, not the kernels'.  Else
    the run is "clean" only with the target's own summary line, exit code
    0, no fault report and an ``ERROR SUMMARY`` of 0 errors; anything else
    is "faults", whatever the cause (a fault kills the target with a
    sticky error, so a missing summary or a non-zero exit is one too)."""
    refusal = MEMCHECK_REFUSAL.search(text)
    done = LAUNCH_DONE.search(text)
    if refusal and done is None and "[launch]" not in text:
        return MemcheckVerdict("not run", None, {}, refusal.group(0).lstrip("= "))
    summary = re.search(r"ERROR SUMMARY: (\d+) error", text)
    errors = int(summary.group(1)) if summary else None
    lines = text.splitlines()
    by_kernel: dict = {}
    n_faults = 0
    for i, line in enumerate(lines):
        if not MEMCHECK_FAULT.match(line):
            continue
        n_faults += 1
        for nxt in lines[i + 1:i + 8]:
            k = re.search(r"(?:at|in) (?:void )?([A-Za-z_]\w*)", nxt.split("=")[-1])
            if k and ("_kernel" in k.group(1) or "flat_sort" in k.group(1)):
                by_kernel[k.group(1)] = by_kernel.get(k.group(1), 0) + 1
                break
    why = []
    if refusal:
        why.append(f"the sanitizer said {refusal.group(0).lstrip('= ')!r} after launches ran")
    if done is None:
        why.append("the target printed no launch summary")
    elif int(done.group(2)):
        why.append(f"{done.group(2)} output mismatch(es)")
    if rc != 0:
        why.append(f"rc {rc}")
    if summary is None:
        why.append("no ERROR SUMMARY")
    elif errors:
        why.append(summary.group(0))
    if n_faults:
        why.append(f"{n_faults} fault report(s)")
    if why:
        return MemcheckVerdict("faults", errors if errors is not None else n_faults,
                               by_kernel, "; ".join(why))
    return MemcheckVerdict("clean", 0, {}, summary.group(0))
