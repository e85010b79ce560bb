"""Deliberately broken launch contracts and sources the checks must reject.

Each fixture carries exactly one violation and the check id (or lint
rule) expected to fire.  ``tests/test_torch_analysis.py`` asserts each is
rejected with a location-bearing diagnostic, and ``python -m
repro_torch.analysis selftest`` runs them, so that a refactor that quietly
disables a check fails even on a clean tree.
"""
from __future__ import annotations

import numpy as np

from repro_torch.kernels.registry import (SMEM_OPTIN, SMEM_STATIC_LIMIT, TILE, Access,
                                          Instance, Launch, LaunchContract, Operand, Work)

_SITE = "src/repro_torch/analysis/fixtures.py"
_INVALID = 2**31 - 1


def _contract(name: str, operands, launches) -> LaunchContract:
    return LaunchContract(
        name=name, kid="fixture", site=f"{_SITE}:{name}", wrapper_site=f"{_SITE}:{name}",
        kernels=tuple(l.kernel for l in launches),
        instances=(Instance("fixture", tuple(operands), tuple(launches), (), {}),),
        wrapper=None, plain=None, work=lambda *a, **k: Work(0, 0, "int32"))


def _launch(reads, writes=None, *, blocks=4, threads=128, smem=0, opt_in=False,
            kernel="fixture_kernel"):
    """A launch of ``blocks`` blocks, block ``b`` writing ``out[8b, 8b+8)``
    unless ``writes`` says otherwise."""
    if writes is None:
        def writes(b):
            return [Access("out", 8 * b[0], 8 * b[0] + 8)]
    return Launch(kernel, (blocks, 1, 1), threads, smem, opt_in, reads, writes)


def _out(n: int = 32) -> Operand:
    return Operand("out", "int32", n)


def broken_contracts() -> list[tuple[LaunchContract, str]]:
    """``(contract, expected_check)`` pairs, one violation each."""
    out: list[tuple[LaunchContract, str]] = []

    # block 3 reads one row past a 32-element array
    out.append((_contract(
        "fx_read_out_of_bounds", [Operand("x", "int32", 32), _out()],
        [_launch(lambda b: [Access("x", 8 * b[0] + 8, 8 * b[0] + 16)])]), "bounds"))

    # reads past the live extent of an operand that declares no pad
    out.append((_contract(
        "fx_read_past_live_no_pad",
        [Operand("x", "int32", 64, padding_from=32), _out()],
        [_launch(lambda b: [Access("x", 16 * b[0], 16 * b[0] + 16)])]), "live-extent"))

    # consumes the tile pad as if it were live, with no sentinel declared
    out.append((_contract(
        "fx_consumed_pad_read",
        [Operand("x", "int32", 64, padding_from=32, pad="tile"), _out()],
        [_launch(lambda b: [Access("x", 16 * b[0], 16 * b[0] + 16)])]), "live-extent"))

    # declares INVALID the pad's sentinel, but the pad holds live-looking data
    host = np.arange(64, dtype=np.int32)
    out.append((_contract(
        "fx_sentinel_pad_not_invalid",
        [Operand("x", "int32", 64, padding_from=32, pad="tile", sentinel=_INVALID,
                 host=host), _out()],
        [_launch(lambda b: [Access("x", 16 * b[0], 16 * b[0] + 16)])]), "live-extent"))

    # a flat array padded floor+1: less than a whole spare TILE past its
    # live extent
    out.append((_contract(
        "fx_missing_spare_tile",
        [Operand("postings", "int32", 2 * TILE, padding_from=TILE + 512, pad="tile",
                 spare=TILE), _out()],
        [_launch(lambda b: [Access("postings", 256 * b[0], 256 * b[0] + 256)])]), "spare"))

    # packed words truncated to their live extent: no spare chunk
    out.append((_contract(
        "fx_packed_words_no_spare_chunk",
        [Operand("words", "int32", 2 * TILE, padding_from=2 * TILE - 40,
                 pad="packed_chunk", spare=TILE + 8 * 128), _out()],
        [_launch(lambda b: [Access("words", 4 * b[0], 4 * b[0] + 4)])]), "spare"))

    # a work list sized exactly to its items: no spare entry
    out.append((_contract(
        "fx_worklist_missing_spare",
        [Operand("desc", "int32", 4 * 8, padding_from=4 * 8, pad="worklist_entry",
                 spare=8), _out()],
        [_launch(lambda b: [Access("desc", 8 * b[0], 8 * b[0] + 8)])]), "spare"))

    # blocks 0/1 and 2/3 write the same output rows
    out.append((_contract(
        "fx_aliased_output", [Operand("x", "int32", 32), _out()],
        [_launch(lambda b: [Access("x", 8 * b[0], 8 * b[0] + 8)],
                 lambda b: [Access("out", 8 * (b[0] // 2), 8 * (b[0] // 2) + 8)])]), "alias"))

    # a bulk copy starting 4 bytes off a 16-byte boundary
    out.append((_contract(
        "fx_misaligned_bulk_copy", [Operand("x", "int32", 64), _out()],
        [_launch(lambda b: [Access("x", 8 * b[0] + 1, 8 * b[0] + 9, False, True)])]),
        "alignment"))

    # a TMA tensor whose row stride is 100 bytes
    out.append((_contract(
        "fx_misaligned_tma_stride",
        [Operand("q", "float32", 64, strides=(100, 1600)), _out()],
        [_launch(lambda b: [Access("q", 8 * b[0], 8 * b[0] + 8)])]), "alignment"))

    # 2048 threads a block
    out.append((_contract(
        "fx_threads_over_limit", [Operand("x", "int32", 32), _out()],
        [_launch(lambda b: [Access("x", 8 * b[0], 8 * b[0] + 8)], threads=2048)]),
        "launch-limits"))

    # 64 KB of dynamic shared memory with no opt-in
    out.append((_contract(
        "fx_smem_without_opt_in", [Operand("x", "int32", 32), _out()],
        [_launch(lambda b: [Access("x", 8 * b[0], 8 * b[0] + 8)],
                 smem=SMEM_STATIC_LIMIT + 16 * 1024)]), "launch-limits"))

    # past the per-block opt-in maximum
    out.append((_contract(
        "fx_smem_over_budget", [Operand("x", "int32", 32), _out()],
        [_launch(lambda b: [Access("x", 8 * b[0], 8 * b[0] + 8)], smem=SMEM_OPTIN + 1024,
                 opt_in=True)]), "launch-limits"))

    return out


def broken_lint_sources() -> list[tuple[str, str, str, str]]:
    """``(name, rel_path, source, expected_rule)``: deliberately bad
    sources each lint rule must flag, the lint-side twin of
    :func:`broken_contracts`."""
    return [
        ("fx_lint_handrolled_pad", "repro_torch/core/bad_pad.py",
         "TILE = 1024\n"
         "def pad(n):\n"
         "    return (n // TILE + 1) * TILE\n",
         "flat-pad"),
        ("fx_lint_adhoc_posting_alloc", "repro_torch/indexing/bad_alloc.py",
         "import torch\n"
         "def build(n):\n"
         "    postings = torch.full((n * 1024,), -1, dtype=torch.int32)\n"
         "    return postings\n",
         "posting-alloc"),
        ("fx_lint_adhoc_worklist_alloc", "repro_torch/kernels/bad_worklist.py",
         "import numpy as np\n"
         "def build(n):\n"
         "    desc = np.zeros((n + 1, 8), dtype=np.int32)\n"
         "    return desc\n",
         "worklist-pad"),
        ("fx_lint_gather_in_wrapper", "repro_torch/kernels/bad_gather.py",
         "def join_cuda(postings, idx):\n"
         "    return postings[idx]\n",
         "posting-gather"),
        ("fx_lint_fallback_on_error", "repro_torch/kernels/bad_fallback.py",
         "def join(x):\n"
         "    try:\n"
         "        return join_cuda(x)\n"
         "    except RuntimeError:\n"
         "        return join_torch(x)\n",
         "cpu-fallback"),
        ("fx_lint_fallback_by_machine", "repro_torch/kernels/bad_pick.py",
         "import torch\n"
         "def join(x):\n"
         "    fn = join_cuda if torch.cuda.is_available() else join_torch\n"
         "    return fn(x)\n",
         "cpu-fallback"),
        ("fx_lint_uncounted_launch", "repro_torch/kernels/bad_count.py",
         "def join_cuda(x):\n"
         "    from repro_torch.kernels import _build\n"
         "    launch = _build.kernel('driver_streamed')\n"
         "    return launch(x)\n",
         "launch-counter"),
        ("fx_lint_import_time_build", "repro_torch/kernels/bad_build.py",
         "from repro_torch.kernels import _build\n"
         "_LAUNCH = _build.kernel('driver_streamed')\n",
         "import-time-build"),
    ]
