"""Shared fixtures of the benchmark's tests: the checkout on the path,
the ``card`` marker, and the cells cut to a size the CPU runs in seconds."""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: Cells as BENCHMARK.json names them, cut to seconds on the CPU.
CELLS = {"static-4x1M.paper-mix": ("odys-static-4x1M", "paper-mix"),
         "mor-4x1M.paper-mix-ingest": ("odys-mor-4x1M", "paper-mix-ingest")}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def small_cell(cell: str) -> tuple[dict, dict]:
    """(configuration, traffic) of ``cell`` at 20,000 pages, window 2048,
    batch 64 and 256 clients; every other setting as committed."""
    config_name, traffic_name = CELLS[cell]
    config = json.loads((ROOT / "odys_bench" / "configs" / f"{config_name}.json").read_text())
    traffic = json.loads((ROOT / "odys_bench" / "traffic" / f"{traffic_name}.json").read_text())
    config.update(n_docs=20_000, vocab_size=2_000, n_sites=100)
    config["service"].update(window=2048, batch_size=64)
    traffic.update(clients=256, stream_queries=20_000, check_rate=1.0, check_sample=256,
                   trace_batches=4, read_back=128, ingest_period_s=0.25, ingest_ops_per_s=48)
    return config, traffic


def run_small(cell: str, seed: int, *, seconds: float = 2.5, trace: bool = False,
              faults=None, device="cpu") -> dict:
    import time

    from odys_bench.harness import run_cell

    config, traffic = small_cell(cell)
    # every reader, so that a cell kept for later is read as well
    per_layer = [{"name": p.stem, "unit": ""}
                 for p in sorted((ROOT / "odys_bench" / "metrics").glob("*.py"))] if trace else ()
    return run_cell(config, traffic, seed=seed, seconds=seconds, trace=trace,
                    device=device, t0=time.perf_counter(), per_layer=per_layer,
                    faults=faults)
