"""The control of the correctness check: the program with one guarantee
that the configuration states switched off, through a run's own check.

    python3 odys_bench/control.py --workload <cell> --seeds 11,12,13 [--seconds 10]

- static cells, :func:`halved_window`: every slave joins the first half of
  the driver's window (the tempting approximation), against the stated
  window;
- merge-on-read cells, :func:`stale_by_one_bulk`: every batch reads the
  snapshot published one bulk before the newest (the tempting later
  publish), against the snapshot its batch was due.

Each seed is one run of the cell (``harness.run_cell``) at the cell's own
size and load, with the control planted before the warm-up; the run's
check compares as it always does, and the control has failed as it must
when the run reads ``correct`` false.  The benchmark's own runs never
plant it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def halved_window(s) -> None:
    """The service joins half of each driver window."""
    s.svc.window //= 2


def stale_by_one_bulk(s) -> None:
    """Every batch reads the snapshot that the newest publish replaced."""
    writer = s.svc.writer
    publish = writer.device_delta
    held = {"new": publish(), "old": None}

    def device_delta():
        snap = publish()
        if snap is not held["new"]:
            held["old"], held["new"] = held["new"], snap
        return snap if held["old"] is None else held["old"]

    writer.device_delta = device_delta


def control_of(config: dict):
    """The control that a configuration's cells take."""
    return stale_by_one_bulk if config.get("writer") is not None else halved_window


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from odys_bench.harness import run_cell
    from odys_bench.run import load_cell

    _, config, traffic, _, _ = load_cell(args.workload)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    failed_all = True
    for seed in (int(x) for x in args.seeds.split(",")):
        res = run_cell(config, traffic, seed=seed, seconds=args.seconds, trace=False,
                       device=device, t0=time.perf_counter(), faults=control_of(config))
        failed_all &= not res["correct"]
        print(json.dumps({"control": args.workload, "seed": seed, "correct": res["correct"],
                          "answered": res["answered"], "checked": res["checked"],
                          "checks": {k: {"value": v, "limit": lim}
                                     for k, (v, lim) in res["compared"].items()}}),
              flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
