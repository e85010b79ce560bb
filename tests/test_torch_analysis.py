"""The port's launch-contract checker and lints (repro_torch.analysis),
case for case the twin of tests/test_analysis.py, and held against the
reference's checker on the same fixtures."""
import re

import numpy as np
import pytest

from repro_torch.analysis import check_all, check_contract
from repro_torch.analysis.__main__ import main as analysis_main
from repro_torch.analysis.fixtures import broken_contracts, broken_lint_sources
from repro_torch.analysis.lint import default_root, lint_file, lint_source, lint_tree
from repro_torch.core import index as core_index
from repro_torch.kernels import _build, registry
from repro_torch.kernels import worklist as wl_mod

# the 21 entries and the kernel ids they replace
EXPECTED = {
    "driver_streamed": "K1", "driver_streamed_packed": "K1p", "topk_merge_rows": "K2",
    "delta_merge": "K3", "delta_merge_packed": "K3p", "delta_merge_packed_row": "K3p",
    "streamed_join": "K4", "streamed_join_packed": "K4p", "driver_compact": "K6",
    "driver_compact_packed": "K6p", "streamed_compact": "K7",
    "streamed_compact_packed": "K7p", "merge_compact": "K8",
    "merge_compact_packed": "K8p", "merge_compact_packed_row": "K8p",
    "batched_block_skip": "K9", "block_skip": "K10", "flat_sort_i32": "K11",
    "flat_sort_f32": "K11", "flash_attention_f32": "K12", "flash_attention_bf16": "K12",
}


@pytest.fixture(scope="module")
def contracts():
    return registry.load_contracts()


def _define(source: str, name: str) -> int:
    text = (_build.CSRC / source).read_text()
    return int(re.search(rf"^#define {name} (\d+)", text, re.MULTILINE).group(1))


# ------------------------------------------------------------- registry --
def test_every_entry_point_has_a_contract(contracts):
    assert {c.name: c.kid for c in contracts} == EXPECTED
    assert set(EXPECTED) == set(_build.KERNELS)


def test_every_extern_launch_is_an_entry():
    """Every ``extern "C" int *_launch`` in csrc/ is a KERNELS entry, and
    the reverse."""
    found = set()
    for path in _build.CSRC.glob("*.cu"):
        found |= {(path.stem, m) for m in re.findall(
            r'^extern "C" int (\w+_launch)\(', path.read_text(), re.MULTILINE)}
    assert found == {(k.source, k.entry) for k in _build.KERNELS.values()}


def test_contract_sites_are_real(contracts):
    root = _build.CSRC.parents[3]
    for c in contracts:
        path, _, line = c.site.rpartition(":")
        assert path.startswith("src/repro_torch/kernels/csrc/") and int(line) > 0
        text = (root / path).read_text().splitlines()[int(line) - 1]
        assert text.startswith(f'extern "C" int {_build.KERNELS[c.name].entry}(')
        w_path, _, w_line = c.wrapper_site.rpartition(":")
        w_text = (root / w_path).read_text().splitlines()[int(w_line) - 1]
        assert re.match(r"def \w+_cuda\(", w_text), (c.name, w_text)


@pytest.mark.parametrize("source,name,value", [
    ("probe_async.cuh", "TILE", registry.TILE),
    ("probe_async.cuh", "JOIN_SUB", registry.JOIN_SUB),
    ("probe_async.cuh", "RAW_CAP", registry.RAW_CAP),
    ("probe_async.cuh", "WORD_CAP", registry.WORD_CAP),
    ("probe_async.cuh", "DEC_BLKS", registry.DEC_BLKS),
    ("probe_async.cuh", "MAX_SEG", registry.MAX_SEG),
    ("decode.cuh", "PBLOCK", registry.PBLOCK),
    ("delta_merge.cu", "ROW_THREADS", registry.ROW_THREADS),
    ("merge_compact.cu", "ROW_THREADS", registry.ROW_THREADS),
    ("topk_merge_rows.cu", "ROWS_PER_BLOCK", registry.ROWS_PER_BLOCK),
    ("flat_sort.cu", "KPT", registry.KPT),
    ("flat_sort.cu", "TILE_THREADS", registry.TILE_THREADS),
    ("flash_attention.cu", "TC_BQ", registry.TC_BQ),
    ("flash_attention.cu", "TC_THREADS", registry.TC_THREADS),
    ("flash_attention.cu", "F_STAGES", registry.F_STAGES),
])
def test_contract_constants_are_the_sources(source, name, value):
    assert _define(source, name) == value


def test_launch_names_are_the_sources(contracts):
    """Every launch a contract states names a ``__global__`` of its
    source (or of a header it includes)."""
    for c in contracts:
        text = "".join(p.read_text() for p in _build.CSRC.iterdir())
        for inst in c.instances:
            for launch in inst.launches:
                assert launch.kernel in c.kernels
                assert re.search(rf"\b{launch.kernel}\s*\(", text), launch.kernel


def test_canonical_instances_hit_the_edges(contracts):
    by = {c.name: c for c in contracts}
    # a live extent ending exactly on a TILE, and one inside a tile
    k1 = by["driver_streamed"].instances
    lives = {i.operand("postings").padding_from % core_index.TILE for i in k1}
    assert 0 in lives and len(lives) == 2
    # a packed width-32 last block
    pk = by["driver_streamed_packed"].instances[1].args[4]
    last = int(np.flatnonzero(pk.blk_meta[:pk.n_blocks].numpy() >> 6).max())
    assert int(pk.blk_meta[last]) & 63 == 32
    # a work list whose item count is a power of two
    for name in ("driver_compact", "streamed_compact", "merge_compact"):
        items = [int(i.args[1][-1]) for i in by[name].instances]
        assert any(n & (n - 1) == 0 for n in items), (name, items)
    # K3p/K8p at both their forms, the row in shared memory and in a scratch
    for name in ("delta_merge_packed_row", "merge_compact_packed_row"):
        smems = [i.launches[0].smem for i in by[name].instances]
        assert 0 in smems and max(smems) > registry.SMEM_STATIC_LIMIT
    # K12 at S, T not multiples of its tiles: causal, windowed and cross
    labels = " ".join(i.label for i in by["flash_attention_bf16"].instances)
    assert "993" in labels and "1500" in labels and "windowed" in labels
    assert "cross" in labels


# -------------------------------------------------------------- checker --
def test_all_registered_contracts_pass(contracts):
    findings = [f for c in contracts for f in check_contract(c)]
    assert findings == []


def test_historical_floor_pad_bug_is_caught(monkeypatch):
    """flat_tile_pad's historical floor+1 form leaves less than a whole
    spare TILE past a live extent that ends inside a tile."""
    monkeypatch.setattr(core_index, "flat_tile_pad",
                        lambda n: (n // core_index.TILE + 1) * core_index.TILE)
    names = ["driver_streamed", "streamed_join", "delta_merge_packed", "driver_compact"]
    _, findings = check_all(names)
    assert {f.check for f in findings} <= {"spare", "live-extent"}
    assert {f.kernel for f in findings} == set(names)


def test_exact_worklist_pad_is_caught(monkeypatch):
    monkeypatch.setattr(wl_mod, "worklist_pad", lambda n: n)
    _, findings = check_all(["driver_compact", "streamed_compact", "merge_compact"])
    assert findings and {f.check for f in findings} <= {"spare", "live-extent"}
    assert {f.kernel for f in findings} == {"driver_compact", "streamed_compact",
                                            "merge_compact"}


def test_packed_word_pad_without_spare_chunk_is_caught(monkeypatch):
    monkeypatch.setattr(core_index, "packed_word_pad",
                        lambda n, chunk_rows: core_index.flat_tile_pad(n))
    _, findings = check_all(["driver_streamed_packed", "delta_merge_packed"])
    assert {f.check for f in findings} == {"spare"}
    assert {f.kernel for f in findings} == {"driver_streamed_packed", "delta_merge_packed"}


def test_smem_budget_is_enforced():
    # 8 KiB: no launch that stages fits
    _, findings = check_all(["driver_streamed", "delta_merge", "topk_merge_rows",
                             "flash_attention_bf16"], smem_budget=8 * 1024)
    assert findings
    assert all(f.check == "launch-limits" for f in findings)


def test_launch_geometry_is_within_the_card(contracts):
    for c in contracts:
        for inst in c.instances:
            for launch in inst.launches:
                assert 1 <= launch.threads <= 1024
                assert launch.smem <= registry.SMEM_OPTIN
                assert launch.opt_in or launch.smem <= registry.SMEM_STATIC_LIMIT


def test_probe_smem_layout():
    """probe_layout's arithmetic: head, 40-byte stream entries rounded to
    128, two round buffers, a decode buffer for packed sources."""
    assert registry.probe_smem(4, False) == 1664 + 32768
    assert registry.probe_smem(8, True) == 1792 + 32768 + 16384
    assert registry.probe_smem(8, True) > registry.SMEM_STATIC_LIMIT


def test_work_is_the_registry_work(contracts):
    for c in contracts:
        inst = c.instances[0]
        assert registry.work(c.name, *inst.args, **inst.kwargs) == c.work(
            *inst.args, **inst.kwargs)


# ---------------------------------------------------- negative fixtures --
@pytest.mark.parametrize("contract,expected", broken_contracts(),
                         ids=[c.name for c, _ in broken_contracts()])
def test_negative_fixture_rejected_with_diagnostic(contract, expected):
    findings = check_contract(contract)
    hits = [f for f in findings if f.check == expected]
    assert hits, f"{contract.name}: expected a {expected!r} finding"
    for f in hits:
        assert "fixtures.py" in f.site
        assert str(f).startswith(f.site)
        assert f.kernel == contract.name


def test_fixture_violations_are_precise():
    """Each fixture trips only its intended check."""
    for contract, expected in broken_contracts():
        checks = {f.check for f in check_contract(contract)}
        assert checks == {expected}, (contract.name, checks)


def test_sentinel_pad_that_holds_the_sentinel_passes():
    contract, _ = next((c, e) for c, e in broken_contracts()
                       if c.name == "fx_sentinel_pad_not_invalid")
    inst = contract.instances[0]
    op = inst.operand("x")
    host = op.host.copy()
    host[op.padding_from:] = op.sentinel
    fixed = type(op)(**{**op.__dict__, "host": host})
    ok = type(contract)(**{**contract.__dict__, "instances": (type(inst)(
        **{**inst.__dict__, "operands": (fixed, inst.operand("out"))}),)})
    assert check_contract(ok) == []


# ----------------------------------------------------------------- lint --
def test_src_tree_is_lint_clean():
    assert lint_tree(default_root()) == []


@pytest.mark.parametrize("name,rel,source,expected", broken_lint_sources(),
                         ids=[n for n, _, _, _ in broken_lint_sources()])
def test_lint_fixture_rejected(name, rel, source, expected):
    assert [f.rule for f in lint_source(source, rel)] == [expected], name


def test_lint_flags_handrolled_tile_padding(tmp_path):
    p = tmp_path / "bad.py"
    p.write_text("TILE = 1024\n"
                 "def pad(n):\n"
                 "    return (n // TILE + 1) * TILE\n")
    findings = lint_file(str(p), "repro_torch/core/bad.py")
    assert [f.rule for f in findings] == ["flat-pad"]
    assert findings[0].line == 3


def test_lint_pragma_suppresses(tmp_path):
    p = tmp_path / "ok.py"
    p.write_text("TILE = 1024\n"
                 "def pad(n):\n"
                 "    # lint: allow(flat-pad) — deliberate\n"
                 "    return (n // TILE + 1) * TILE\n")
    assert lint_file(str(p), "repro_torch/core/ok.py") == []


def test_lint_flat_tile_pad_itself_is_exempt():
    src = ("TILE = 1024\n"
           "def flat_tile_pad(n):\n"
           "    return (-(-n // TILE) + 1) * TILE\n")
    assert lint_source(src, "repro_torch/core/index.py") == []


def test_lint_posting_alloc_torch_and_numpy():
    for mod in ("np", "torch"):
        bad = (f"import {'numpy as np' if mod == 'np' else 'torch'}\n"
               "def build(n):\n"
               f"    attrs = {mod}.zeros(n)\n")
        assert [f.rule for f in lint_source(bad, "repro_torch/indexing/x.py")] == [
            "posting-alloc"]
        assert lint_source(bad, "repro_torch/core/index.py") == []
    ok = ("import torch\n"
          "from repro_torch.core.index import flat_tile_pad\n"
          "def build(n):\n"
          "    flat_len = flat_tile_pad(n)\n"
          "    postings = torch.full((flat_len,), -1)\n")
    assert lint_source(ok, "repro_torch/indexing/x.py") == []


def test_lint_posting_gather_is_scoped():
    """A gather on posting data is flagged in a *_cuda wrapper and on the
    kernel backend's host path; the plain versions gather by design;
    gathers on metadata stay legal."""
    wrapper = "def join_cuda(postings, idx):\n    return postings[idx]\n"
    plain = "def join_torch(postings, idx):\n    return postings[idx]\n"
    meta = "def join_cuda(offsets, idx):\n    return offsets[idx]\n"
    engine = ("def _query_topk_kernel(index, idx):\n"
              "    return index.postings.gather(0, idx)\n")
    rel = "repro_torch/kernels/k.py"
    assert [f.rule for f in lint_source(wrapper, rel)] == ["posting-gather"]
    assert lint_source(plain, rel) == []
    assert lint_source(meta, rel) == []
    assert lint_source(wrapper, "repro_torch/core/k.py") == []
    assert [f.rule for f in lint_source(engine, "repro_torch/core/engine.py")] == [
        "posting-gather"]


def test_lint_cpu_fallback_allows_reraise_and_device_picks():
    reraise = ("def join(x):\n"
               "    try:\n"
               "        return join_cuda(x)\n"
               "    except RuntimeError as e:\n"
               "        raise ValueError('launch failed') from e\n")
    by_device = ("def join(x):\n"
                 "    fn = join_cuda if x.is_cuda else join_torch\n"
                 "    return fn(x)\n")
    rel = "repro_torch/kernels/k.py"
    assert lint_source(reraise, rel) == []
    assert lint_source(by_device, rel) == []


def test_lint_launch_counter_and_import_time_build_pass_when_kept():
    ok = ("def join_cuda(x):\n"
          "    from repro_torch.kernels import _build\n"
          "    launch = _build.kernel('driver_streamed')\n"
          "    join_cuda.launches += 1\n"
          "    return launch(x)\n")
    assert lint_source(ok, "repro_torch/kernels/k.py") == []


# ------------------------------------------------------------------ CLI --
def test_cli_check_lint_selftest_pass():
    assert analysis_main(["check"]) == 0
    assert analysis_main(["lint"]) == 0
    assert analysis_main(["selftest"]) == 0


def test_cli_check_fails_on_tiny_budget(capsys):
    assert analysis_main(["check", "topk_merge_rows", "--smem-budget", "0"]) == 1
    assert "launch-limits" in capsys.readouterr().err


def test_cli_check_kernel_subset(capsys):
    assert analysis_main(["check", "topk_merge_rows", "block_skip"]) == 0
    assert "2 launch contract(s)" in capsys.readouterr().out


# --------------------------------------------------- padding contract --
# ------------------------------------------------- memcheck's verdict --
_REFUSED = """========= COMPUTE-SANITIZER
========= Error: Device not supported. Please refer to the "Supported Devices" section of the sanitizer documentation
========= 
========= Program hit cudaErrorUnknown (error 999) due to "unknown error" on CUDA API call to cudaMalloc.
=========     Saved host backtrace up to driver entry point at error
=========         Host Frame: c10::cuda::CUDACachingAllocator::Native::NativeCachingAllocator::allocate(unsigned long) [0x449cb] in libc10_cuda.so
RuntimeError: CUDA error: unknown error
========= Error: process didn't terminate successfully
========= Target application returned an error
========= ERROR SUMMARY: 1 error
"""
_LAUNCHED = """========= COMPUTE-SANITIZER
[launch] driver_streamed tile edge: ok max_abs_err=0.0
[launch] flat_sort_i32 n 300: ok max_abs_err=0.0
launch: 2 instance(s), 0 mismatch(es)
"""
_INVALID = """========= Invalid __global__ read of size 16 bytes
=========     at driver_streamed_kernel(const int *, const int *, int)+0x1a0 in driver_streamed.cu:120
=========     by thread (3,0,0) in block (2,1,0)
=========     Address 0x7f00 is out of bounds
"""
MEMCHECK_CASES = {
    # id: (sanitizer output, the target's exit code, status, by kernel)
    "refused": (_REFUSED, 1, "not run", {}),
    "clean": (_LAUNCHED + "========= ERROR SUMMARY: 0 errors\n", 0, "clean", {}),
    "invalid-read": (_LAUNCHED + _INVALID + "========= ERROR SUMMARY: 1 error\n", 0,
                     "faults", {"driver_streamed_kernel": 1}),
    "fault-kills-target": (
        "========= COMPUTE-SANITIZER\n[launch] driver_streamed tile edge: ok max_abs_err=0.0\n"
        + _INVALID + "RuntimeError: CUDA error: an illegal memory access was encountered\n"
        "========= Error: process didn't terminate successfully\n"
        "========= ERROR SUMMARY: 3 errors\n", 1, "faults", {"driver_streamed_kernel": 1}),
    "mismatch-exit-1": (_LAUNCHED.replace("0 mismatch", "1 mismatch")
                        + "========= ERROR SUMMARY: 0 errors\n", 1, "faults", {}),
    "no-summary": (_LAUNCHED, 0, "faults", {}),
    "refusal-after-launches": (_REFUSED.replace("RuntimeError", _LAUNCHED + "RuntimeError"),
                               1, "faults", {}),
}


@pytest.mark.parametrize("case", list(MEMCHECK_CASES), ids=list(MEMCHECK_CASES))
def test_memcheck_verdict(case):
    """Only the sanitizer's own refusal, before any launch, reads as "not
    run"; a fault report, a non-zero exit, a missing summary or a
    mismatch fails the run."""
    from repro_torch.analysis.launch import memcheck_verdict

    text, rc, status, by_kernel = MEMCHECK_CASES[case]
    v = memcheck_verdict(text, rc)
    assert (v.status, v.by_kernel) == (status, by_kernel), v
    if status == "not run":
        assert v.errors is None and v.detail.startswith("Error: Device not supported")
    if status == "clean":
        assert v.errors == 0


def test_padding_contract_metadata():
    offsets = np.array([0, 256, 384], np.int64)
    lengths = np.array([150, 100, 90], np.int32)
    live = core_index.flat_live_extent(offsets, lengths)
    assert live == 512
    good = core_index.padding_contract(offsets, lengths, 2048)
    assert good.spare_tile_ok(core_index.TILE)
    bad = core_index.padding_contract(offsets, lengths, 1024)  # floor+1
    assert not bad.spare_tile_ok(core_index.TILE)
    assert core_index.flat_live_extent(np.array([]), np.array([])) == 0


# ------------------------------------------------- against the reference --
@pytest.mark.parametrize("lengths", [(150, 100, 90), (1024, 500, 512, 0, 1900),
                                     (1500, 700, 300, 2100, 0), (1,)])
def test_synthetic_flat_index_equals_the_reference(lengths):
    from repro.kernels import registry as ref_registry

    got, live = registry.synthetic_flat_index(lengths)
    want, want_live = ref_registry.synthetic_flat_index(lengths)
    assert live == want_live
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("n_terms,cap,fills", [(5, 256, (256, 0, 100, 255, 17)),
                                               (3, 128, (5, 128, 0))])
def test_synthetic_delta_arrays_equal_the_reference(n_terms, cap, fills):
    from repro.kernels import registry as ref_registry

    got = registry.synthetic_delta_arrays(n_terms, cap, fills)
    want = ref_registry.synthetic_delta_arrays(n_terms, cap, fills)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_both_checkers_pass_unpatched_and_fail_on_the_floor_pad(monkeypatch):
    from repro.analysis import check_all as ref_check_all
    from repro.core import index as ref_index

    ref_names = ["intersect_batched_driver_streamed"]
    assert ref_check_all(ref_names)[1] == []
    assert check_all(["driver_streamed"])[1] == []
    floor = lambda n: (n // core_index.TILE + 1) * core_index.TILE  # noqa: E731
    monkeypatch.setattr(ref_index, "flat_tile_pad", floor)
    monkeypatch.setattr(core_index, "flat_tile_pad", floor)
    ref_checks = {f.check for f in ref_check_all(ref_names)[1]}
    port_checks = {f.check for f in check_all(["driver_streamed"])[1]}
    assert "spare-tile" in ref_checks
    assert port_checks == {"spare"}
