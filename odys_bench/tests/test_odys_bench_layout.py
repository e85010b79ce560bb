"""BENCHMARK.json resolves to the benchmark's files, and no module of the
benchmark loads JAX or the JAX package."""
import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest
from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_cells_resolve_to_their_files():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("odys_bench/configs/")
        held = json.loads(path.read_text())
        assert held["name"] == c["name"] and held["source"] == c["source"]
        assert set(c["reduced"]) <= set(held["reduced"])
    for w in BENCH["workloads"]:
        assert w["config"] in configs
        traffic = json.loads(
            (ROOT / "odys_bench" / "traffic" / f"{w['traffic']}.json").read_text())
        assert (ROOT / "odys_bench" / "loops" / f"{traffic['loop']}.py").is_file()
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == set(configs)


def test_every_metric_has_its_reader_and_cells():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert (ROOT / "odys_bench" / "metrics" / f"{m['name']}.py").is_file(), m["name"]
        assert set(m["workloads"]) <= cells and m["moves"] in {
            e["name"] for e in BENCH["end_to_end"]}
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


def test_names_units_and_bounds_keep_the_contract():
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"]) and m["better"] in (
            "lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("where", ["top", "service", "writer", "traffic"])
def test_a_key_the_harness_does_not_read_is_refused(where):
    from conftest import small_cell

    from odys_bench import harness

    config, traffic = small_cell("mor-4x1M.paper-mix-ingest")
    harness.check_keys(config, traffic, harness.load_loop(traffic["loop"]))
    if where == "top":
        config["codec"] = "packed"
    elif where == "service":
        config["service"]["device"] = "cpu"
    elif where == "writer":
        config["writer"]["n_writers"] = 4
    else:
        traffic["arrivals_per_s"] = 100
    with pytest.raises(ValueError, match="does not read"):
        harness.check_keys(config, traffic, harness.load_loop(traffic["loop"]))


def _top_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted((ROOT / "odys_bench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_jax_or_the_jax_package(path):
    names = set(_top_imports(path))
    assert not names & {"jax", "jaxlib", "flax", "repro"}, names
    if path.name in ("reference.py", "work.py", "profile.py", "data.py"):
        assert "repro_torch" not in names, names


def test_run_refuses_without_a_card_or_without_the_port(tmp_path):
    cmd = [sys.executable, "odys_bench/run.py", "--workload", "static-4x1M.paper-mix",
           "--seed", "3000000000", "--seconds", "1", "--trace", "0"]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    got = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, env=env,
                         timeout=120)
    assert got.returncode != 0 and got.stdout == ""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "odys_bench", tmp_path / "odys_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    got = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert got.returncode != 0 and got.stdout == ""
