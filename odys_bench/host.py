"""How fast the host ran around a run, so that a slow run can be told from a
slow host: the process's share of a core over the window, and two fixed
probes, a pure-Python loop and a first touch of fresh memory.  Printed on
standard error beside a run's numbers, never among its metrics.

On the card's machines ``/proc/stat``, the load average and the page-fault
counters read zero, so the probes stand in for them."""
from __future__ import annotations

import resource
import time

import numpy as np

PROBE_LOOP = 2_000_000
PROBE_BYTES = 256 << 20


def cpu_seconds() -> float:
    """This process's user and system seconds so far."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def probes() -> dict:
    """Milliseconds of a fixed pure-Python loop and of a first touch of
    256 MiB of fresh memory."""
    t0 = time.perf_counter()
    acc = 0
    for i in range(PROBE_LOOP):
        acc += i & 7
    t1 = time.perf_counter()
    buf = np.ones(PROBE_BYTES // 8)
    t2 = time.perf_counter()
    del buf
    return {"loop_ms": 1e3 * (t1 - t0), "touch_ms": 1e3 * (t2 - t1)}


def line(what: str, values: dict) -> str:
    return f"odys_bench: host {what}: " + ", ".join(
        f"{k} {v:.4g}" for k, v in values.items())
