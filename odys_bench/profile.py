"""Reduce a ``torch.profiler`` trace of the traced window to device numbers.

The harness wraps the traced batches in one ``record_function`` span,
:data:`WINDOW`; everything here is read inside it:

- device operations: the trace's kernels, memcpys and memsets;
- busy time: the union of their intervals, so an overlap counts once;
- idle gaps: the stretches with no device operation, each named by the
  innermost host span (an aten op or one of the harness's spans around the
  port's layers) that covers the gap's middle.
"""
from __future__ import annotations

import bisect
import json
from pathlib import Path
from typing import NamedTuple

WINDOW = "bench.traced"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
NAME_CHARS = 120


def base_name(name: str) -> str:
    """``void ns::f<3>(int const*, int)`` -> ``f``."""
    head = name.split("(")[0].strip().split(" ")[-1]
    return head.split("::")[-1].split("<")[0]


class DeviceTrace(NamedTuple):
    window_s: float
    busy_s: float
    ops: list          # (name, start_us, dur_us), in the window, by start
    gaps: list         # (host span name, seconds), every idle gap

    def seconds_of(self, names) -> float:
        """Device seconds of the kernels whose function name (the trace's
        name before its argument list) is one of ``names``."""
        names = set(names)
        return sum(d for n, _, d in self.ops if base_name(n) in names) / 1e6

    def top_ops(self, n: int = 10) -> list:
        by: dict[str, float] = {}
        for name, _, dur in self.ops:
            key = name[:NAME_CHARS]
            by[key] = by.get(key, 0.0) + dur / 1e6
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]

    def top_gaps(self, n: int = 10) -> list:
        by: dict[str, float] = {}
        for name, sec in self.gaps:
            by[name] = by.get(name, 0.0) + sec
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]


def read_trace(path: Path) -> DeviceTrace | None:
    """The traced window's device numbers from a chrome trace; None when
    the trace holds no window span or no device operation in it."""
    doc = json.loads(Path(path).read_text())
    events = doc.get("traceEvents", []) if isinstance(doc, dict) else doc
    spans = [e for e in events if e.get("ph") == "X"]
    win = [e for e in spans if e.get("name") == WINDOW]
    if not win:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    ops = sorted((e["name"], float(e["ts"]), float(e["dur"])) for e in spans
                 if e.get("cat") in DEVICE_CATS and w0 <= float(e["ts"]) < w1)
    ops.sort(key=lambda o: o[1])
    if not ops:
        return None
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                   for e in spans if e.get("cat") in HOST_CATS
                   and e.get("name") != WINDOW and float(e["ts"]) < w1
                   and float(e["ts"]) + float(e["dur"]) > w0))
    starts = [h[0] for h in host]

    def host_at(t: float) -> str:
        i = bisect.bisect_right(starts, t)
        while i > 0:
            i -= 1
            if host[i][1] >= t:
                return host[i][2]
            if t - host[i][0] > 5e6:
                break
        return "host outside any span"

    busy = 0.0
    gaps = []
    cursor = w0
    for _, ts, dur in ops:
        end = min(ts + dur, w1)
        if ts > cursor:
            gaps.append((host_at((cursor + ts) / 2), (ts - cursor) / 1e6))
        if end > cursor:
            busy += end - max(ts, cursor)
            cursor = end
    if w1 > cursor:
        gaps.append((host_at((cursor + w1) / 2), (w1 - cursor) / 1e6))
    return DeviceTrace((w1 - w0) / 1e6, busy / 1e6, ops, gaps)
