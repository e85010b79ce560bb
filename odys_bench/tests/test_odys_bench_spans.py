"""The readers of the port's host spans (``admit_us``, ``scheduler_ms``,
``batch_build_ms``, ``slave_launch_ms``) on a traced run of the static
cell, cut to the CPU."""
import math
import types

import pytest

from conftest import run_small
from odys_bench.harness import load_reader

SPAN_METRICS = ("admit_us", "scheduler_ms", "batch_build_ms", "slave_launch_ms")


def test_a_traced_run_reads_the_program_spans():
    res = run_small("static-4x1M.paper-mix", 2**31 + 13, seconds=2.5, trace=True)
    assert res["correct"]
    got = {k: v for k, (v, _) in res["metrics"].items()}
    for name in SPAN_METRICS:
        assert got[name] is not None and math.isfinite(got[name]) and got[name] >= 0, name
    assert got["batch_build_ms"] + got["slave_launch_ms"] <= got["dispatch_ms"]


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_reader_gives_nothing_without_its_phase(name):
    run = types.SimpleNamespace(phases=[{"slave_dispatch": 0.01, "finalize": 0.02}])
    assert load_reader(name)(run) is None
