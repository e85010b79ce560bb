"""Online model-residual monitor: live engine vs the fitted hybrid model.

The calibration loop (:mod:`repro_torch.core.calibrate`) fits the paper's
hybrid performance model (§4–§5) from the engine on its device, and an
offline replay validates it with Formula (18).  This monitor makes every
served query a validation sample instead: finished spans stream in (wire
:meth:`ModelResidualMonitor.sink` as the scheduler's ``span_sink``), and
:meth:`update` compares the measured mean response against the Formula
(17) projection from the fitted :class:`~repro_torch.core.calibrate.Calibration`
— exporting the Formula (18) estimation error as a scrapeable gauge.
Drift between the live engine and the model becomes a number on a
dashboard, not a bench-day discovery.

Exported gauges (all on the monitor's registry):

- ``odys_model_residual``                — Formula (18) error
  ``|projected − measured| / measured``;
- ``odys_model_measured_mean_seconds``   — windowed measured mean response;
- ``odys_model_projected_mean_seconds``  — Formula (17) + formation delay;
- ``odys_model_lambda_qps``              — the arrival-rate estimate fed
  to the projection.

The projection is :meth:`Calibration.projected_response` — the *same*
code path an offline replay reports, so the online gauge and the offline
number agree by construction (up to the arrival-rate estimate, which the
monitor derives from span submit times unless pinned with ``lam=``).

Cache hits are excluded: the hybrid model prices the full dispatch path,
and a hit's response is one cache probe.  Span times are consumed in the
scheduler's clock domain, so the monitor is coherent under virtual-time
replay too (that is how the tests pin it against the offline number).

A copy of the JAX package's ``repro.obs.residual`` on the port's
:class:`~repro_torch.obs.trace.QuerySpan` and registry.
"""
from __future__ import annotations

import math
from collections import deque

from repro_torch.core.perfmodel import estimation_error
from repro_torch.obs.registry import MetricsRegistry, get_registry
from repro_torch.obs.trace import QuerySpan

__all__ = ["ModelResidualMonitor"]


class ModelResidualMonitor:
    """Fold finished spans; export the Formula (18) residual as a gauge.

    Parameters
    ----------
    calibration:
        The fitted :class:`~repro_torch.core.calibrate.Calibration` (its
        ``projected_response`` supplies the Formula (17) projection).
    batch_size, max_wait:
        The serving scheduler's formation parameters — the projection adds
        the micro-batcher's expected formation delay exactly as the
        offline projection does.
    lam:
        Pin the arrival rate instead of estimating it from span submit
        times (``None`` = estimate over the retained window).
    window:
        Finished-span retention (a deque; old samples age out so the gauge
        tracks the current workload, not the process lifetime).
    """

    def __init__(
        self,
        calibration,
        *,
        batch_size: int,
        max_wait: float = 0.0,
        mix=None,
        lam: float | None = None,
        window: int = 512,
        registry: MetricsRegistry | None = None,
    ):
        reg = registry if registry is not None else get_registry()
        self.cal = calibration
        self.batch_size = batch_size
        self.max_wait = max_wait
        self.mix = mix
        self.lam = lam
        self._samples: deque[tuple[float, float]] = deque(maxlen=window)
        self._g_residual = reg.gauge(
            "odys_model_residual",
            help="Formula (18) error: |projected - measured| / measured",
        )
        self._g_measured = reg.gauge(
            "odys_model_measured_mean_seconds",
            help="measured mean response over the monitor window",
        )
        self._g_projected = reg.gauge(
            "odys_model_projected_mean_seconds",
            help="Formula (17) projection + formation delay",
        )
        self._g_lambda = reg.gauge(
            "odys_model_lambda_qps",
            help="arrival-rate estimate fed to the projection",
        )
        self._c_folded = reg.counter(
            "odys_model_spans_total", help="spans folded into the monitor"
        )
        self._c_skipped = reg.counter(
            "odys_model_spans_skipped_total",
            help="spans excluded from the residual (cache hits)",
        )

    def sink(self, span: QuerySpan) -> None:
        """Scheduler ``span_sink``-compatible entry point."""
        if span.from_cache:
            self._c_skipped.inc()
            return
        self._c_folded.inc()
        self._samples.append((span.submit_time, span.response_time))

    def _lambda_estimate(self) -> float | None:
        if self.lam is not None:
            return self.lam
        if len(self._samples) < 2:
            return None
        t0 = self._samples[0][0]
        t1 = self._samples[-1][0]
        if t1 <= t0:
            return None
        return (len(self._samples) - 1) / (t1 - t0)

    def update(self) -> dict:
        """Recompute and export the residual; returns the numbers used.

        Keys: ``measured``, ``projected``, ``lam``, ``error``, ``n`` —
        all ``nan`` (and the gauges untouched) until enough spans
        arrived to estimate an arrival rate.
        """
        n = len(self._samples)
        lam = self._lambda_estimate()
        measured = sum(r for _, r in self._samples) / n if n else 0.0
        if measured <= 0 or lam is None or lam <= 0:
            return {
                "measured": math.nan, "projected": math.nan,
                "lam": math.nan, "error": math.nan, "n": n,
            }
        kw = {} if self.mix is None else {"mix": self.mix}
        projected = self.cal.projected_response(
            lam, batch_size=self.batch_size, max_wait=self.max_wait, **kw
        )
        error = estimation_error(projected, measured)
        self._g_measured.set(measured)
        self._g_projected.set(projected)
        self._g_lambda.set(lam)
        self._g_residual.set(error)
        return {
            "measured": measured, "projected": projected,
            "lam": lam, "error": error, "n": n,
        }
