"""Metric exposition: Prometheus text format 0.0.4 + a JSON dump.

Both render a :class:`~repro_torch.obs.registry.MetricsRegistry` snapshot:

- :func:`to_prometheus` — the scrapeable text format (``# HELP``/``# TYPE``
  headers, cumulative ``_bucket{le=...}`` histogram series, ``_sum`` and
  ``_count``);
- :func:`to_json` — the same data as one JSON document, with derived
  conveniences the text format leaves to the scraper: per-histogram mean
  and p50/p95/p99 (bucket-interpolated — see
  :meth:`~repro_torch.obs.registry.Histogram.quantile`).

``python -m repro_torch.obs demo`` writes both; ``python -m
repro_torch.obs check`` validates them.

A copy of the JAX package's ``repro.obs.exposition``: the same registry
contents render to the same text and the same JSON document.  The
document's ``"format"`` tag, ``repro.obs/v1``, names the format readers of
either package's JSON key on; it is not a module.
"""
from __future__ import annotations

import json
import math

from repro_torch.obs.registry import Counter, Gauge, Histogram, MetricsRegistry

__all__ = ["to_json", "to_prometheus"]

_QUANTILES = (0.5, 0.95, 0.99)


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape(str(v))}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _num(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def to_prometheus(reg: MetricsRegistry) -> str:
    lines: list[str] = []
    for name, kind, help, series in reg.collect():
        if help:
            lines.append(f"# HELP {name} {help}")
        lines.append(f"# TYPE {name} {kind}")
        for labels, inst in series:
            if isinstance(inst, Histogram):
                cum = 0
                for bound, c in zip(inst.bounds, inst.counts):
                    cum += c
                    le = _labels({**labels, "le": _num(bound)})
                    lines.append(f"{name}_bucket{le} {cum}")
                cum += inst.counts[-1]
                le = _labels({**labels, "le": "+Inf"})
                lines.append(f"{name}_bucket{le} {cum}")
                lines.append(f"{name}_sum{_labels(labels)} {_num(inst.sum)}")
                lines.append(
                    f"{name}_count{_labels(labels)} {inst.count}"
                )
            else:
                assert isinstance(inst, (Counter, Gauge))
                lines.append(f"{name}{_labels(labels)} {_num(inst.value)}")
    return "\n".join(lines) + "\n"


def _histogram_json(inst: Histogram) -> dict:
    return {
        "buckets": list(inst.bounds),
        "counts": list(inst.counts),
        "sum": inst.sum,
        "count": inst.count,
        "mean": None if inst.count == 0 else inst.mean(),
        "quantiles": {
            f"p{int(q * 100)}": (None if inst.count == 0 else inst.quantile(q))
            for q in _QUANTILES
        },
    }


def to_json(reg: MetricsRegistry) -> dict:
    metrics: dict[str, dict] = {}
    for name, kind, help, series in reg.collect():
        out_series = []
        for labels, inst in series:
            entry: dict = {"labels": labels}
            if isinstance(inst, Histogram):
                entry.update(_histogram_json(inst))
            else:
                entry["value"] = inst.value
            out_series.append(entry)
        metrics[name] = {"kind": kind, "help": help, "series": out_series}
    return {"format": "repro.obs/v1", "metrics": metrics}


def dump_json(reg: MetricsRegistry) -> str:
    return json.dumps(to_json(reg), indent=2, allow_nan=False) + "\n"
