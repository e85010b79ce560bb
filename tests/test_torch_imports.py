"""The port imports neither jax nor the JAX package ``repro``, and
``chip_smoke.py`` refuses to run without a card.

A subprocess blocks ``jax`` and ``repro`` through ``sys.modules`` and
imports every module of ``repro_torch`` and ``chip_smoke``; an AST scan
finds no import of either name in the sources."""
import ast
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
BLOCKED = ("jax", "jaxlib", "repro")


def _modules():
    names = ["repro_torch"]
    for info in pkgutil.walk_packages([str(PKG)], prefix="repro_torch."):
        names.append(info.name)
    return names


def test_every_module_imports_with_jax_and_repro_blocked():
    mods = _modules()
    assert "repro_torch.kernels.posting_intersect" in mods
    assert "repro_torch.kernels.flash_attention" in mods
    assert "repro_torch.indexing.delta" in mods
    assert "repro_torch.models.moe" in mods
    assert "repro_torch.models.rglru" in mods
    assert "repro_torch.models.rwkv6" in mods
    assert "repro_torch.training.checkpoint" in mods
    assert "repro_torch.launch.train" in mods
    for m in ("repro_torch.kernels.registry", "repro_torch.kernels.work",
              "repro_torch.analysis",
              "repro_torch.analysis.__main__", "repro_torch.analysis.geometry",
              "repro_torch.analysis.contracts", "repro_torch.analysis.fixtures",
              "repro_torch.analysis.lint", "repro_torch.analysis.launch",
              "repro_torch.roofline", "repro_torch.roofline.analysis",
              "repro_torch.roofline.op_cost",
              "repro_torch.launch.mesh", "repro_torch.launch.spawn",
              "repro_torch.launch._parallel_selftest", "repro_torch.models.sharding",
              "repro_torch.launch.shardings", "repro_torch.launch.specs",
              "repro_torch.launch.dryrun", "repro_torch.launch._tp_selftest"):
        assert m in mods, m
    code = "\n".join([
        "import sys",
        *(f"sys.modules[{b!r}] = None" for b in BLOCKED),
        *(f"import {m}" for m in mods),
        "import importlib.util",
        f"spec = importlib.util.spec_from_file_location('chip_smoke', "
        f"{str(ROOT / 'chip_smoke.py')!r})",
        "importlib.util.module_from_spec(spec); "
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))",
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{BLOCKED!r} and sys.modules[m] is not None]",
        "assert not bad, bad",
        "print('OK', len([m for m in sys.modules if m.startswith('repro_torch')]))",
    ])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK")


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import_in_source(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in BLOCKED, (path, name)


def test_kernel_layer_does_not_import_the_roofline_or_the_checker():
    """The kernels state their launches and their work; the roofline prices
    the work and the checker reads the launches, not the other way round."""
    for path in sorted((PKG / "kernels").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert not name.startswith(("repro_torch.roofline", "repro_torch.analysis")), (
                    path, name)


def test_chip_smoke_without_card_fails_and_prints_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    # alone in a directory, without the package beside it, it fails too
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    out = subprocess.run([sys.executable, str(alone)], capture_output=True,
                         text=True, env=env, cwd=tmp_path, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
