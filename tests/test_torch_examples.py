"""The port's example twins run end to end on the CPU (``--device cpu``,
the plain versions), each in its own process, and exit 0."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("script,expect", [
    ("quickstart_torch.py", "143 ODYS sets = 43,472 nodes"),
    ("search_engine_demo_torch.py", "with set 1 failed on sets [0]"),
    ("serve_lm_torch.py", "served 8 requests OK"),
    ("train_lm_torch.py", "done"),
])
def test_example_runs_on_cpu(script, expect, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(ROOT / "examples" / script),
                          "--device", "cpu"], capture_output=True, text=True,
                         env=env, cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr
    assert expect in out.stdout
    assert "MISMATCH" not in out.stdout
