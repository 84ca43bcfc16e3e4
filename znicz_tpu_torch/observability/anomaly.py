"""Step anomaly flight recorder (port of
``znicz_tpu/observability/anomaly.py``).

:class:`StepAnomalyDetector` turns per-step ``(loss, grad_norm,
step_seconds)`` observations into typed verdicts: a non-finite loss or
gradient norm, a loss spike against a rolling baseline, a step-time
regression.  It keeps a bounded ring of the last steps for post-mortems and
exports the ``znicz_train_anomal*`` / ``znicz_train_last_*`` series.  The
workflow feeds it each train step's ``[loss, grad_norm]`` two steps late
(``workflow/workflow.py``), so the watch never waits on the card.

Pure stdlib: the detector consumes plain floats.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional

from znicz_tpu_torch.observability.registry import (
    MetricsRegistry,
    get_registry,
)

NON_FINITE_LOSS = "non_finite_loss"
NON_FINITE_GRAD = "non_finite_grad_norm"
LOSS_SPIKE = "loss_spike"
STEP_TIME_REGRESSION = "step_time_regression"

ANOMALY_TYPES = (
    NON_FINITE_LOSS,
    NON_FINITE_GRAD,
    LOSS_SPIKE,
    STEP_TIME_REGRESSION,
)

# consistency scale factor: MAD * 1.4826 estimates sigma for a normal
_MAD_SIGMA = 1.4826


def _robust_z(value: float, history: List[float], min_scale: float) -> float:
    """One-sided robust z of ``value`` against ``history`` (median/MAD)."""
    n = len(history)
    srt = sorted(history)
    mid = n // 2
    median = srt[mid] if n % 2 else 0.5 * (srt[mid - 1] + srt[mid])
    devs = sorted(abs(v - median) for v in history)
    mad = devs[mid] if n % 2 else 0.5 * (devs[mid - 1] + devs[mid])
    scale = max(_MAD_SIGMA * mad, min_scale, 1e-12)
    return (value - median) / scale


class StepAnomalyDetector:
    """Rolling per-step anomaly watch + bounded flight-recorder ring.

    Feed it once per training step via :meth:`observe_step`; read the
    JSON-able :meth:`report` (ring + counts + active flag) from status
    surfaces.  Thread-safe: the workflow feeds it from the training
    thread while status/HTTP readers snapshot it.
    """

    def __init__(
        self,
        *,
        window: int = 64,
        z_threshold: float = 8.0,
        min_history: int = 12,
        snapshot_last: int = 8,
        ring_size: int = 16,
        active_window: int = 32,
        # floor on the robust scale as a fraction of the median: with
        # the default z_threshold=8 a verdict needs a value > ~3x the
        # rolling median, not just an 8-MAD wobble — host-timer jitter
        # is heavy-tailed and a flat loss curve has near-zero MAD
        min_scale_frac: float = 0.25,
        # a step-time REGRESSION is sustained by definition: one slow
        # step is an OS/GC blip (measured firing z=9 on sub-ms CPU
        # steps), so the verdict needs this many consecutive
        # over-threshold steps.  Loss spikes stay single-step — they
        # are deterministic values, not wall-clock jitter
        time_consecutive: int = 3,
        registry: Optional[MetricsRegistry] = None,
    ):
        if window < 2 or min_history < 2:
            raise ValueError("want window >= 2 and min_history >= 2")
        self.window = int(window)
        self.z_threshold = float(z_threshold)
        self.min_history = int(min_history)
        self.snapshot_last = int(snapshot_last)
        self.active_window = int(active_window)
        self.min_scale_frac = float(min_scale_frac)
        self.time_consecutive = max(int(time_consecutive), 1)
        self._time_over = 0
        reg = registry if registry is not None else get_registry()
        self._m_total = reg.counter(
            "znicz_train_anomalies_total",
            "training anomalies by typed verdict",
            ("type",),
        )
        self._m_active = reg.gauge(
            "znicz_train_anomaly_active",
            "1 while an anomaly fired within the last active_window "
            "steps (znicz-doctor's exit-1 gate)",
        )
        self._m_loss = reg.gauge(
            "znicz_train_last_loss", "last observed per-step train loss"
        )
        self._m_grad = reg.gauge(
            "znicz_train_last_grad_norm",
            "last observed per-step gradient (or update) global norm",
        )
        self._lock = threading.Lock()
        self._loss_hist: Deque[float] = deque(maxlen=self.window)
        self._time_hist: Deque[float] = deque(maxlen=self.window)
        self._recent: Deque[dict] = deque(maxlen=max(snapshot_last, 1))
        self._ring: Deque[dict] = deque(maxlen=max(ring_size, 1))
        self._counts: Dict[str, int] = {}
        self._last_anomaly_step: Optional[int] = None
        self._last_step: Optional[int] = None

    # -- feeding -----------------------------------------------------------

    def observe_step(
        self,
        step: int,
        *,
        loss: float,
        grad_norm: Optional[float] = None,
        step_seconds: Optional[float] = None,
    ) -> List[dict]:
        """Record one step; returns the anomalies it raised (possibly
        empty).  ``grad_norm``/``step_seconds`` are optional — the
        scanned epoch path has no per-step wall, a workflow without the
        watch piggyback has no grad norm."""
        loss = float(loss)
        anomalies: List[dict] = []
        with self._lock:
            self._last_step = int(step)
            if not math.isfinite(loss):
                anomalies.append(
                    self._raise(NON_FINITE_LOSS, step, loss, None)
                )
            elif len(self._loss_hist) >= self.min_history:
                z = _robust_z(
                    loss,
                    list(self._loss_hist),
                    self.min_scale_frac
                    * abs(self._median(self._loss_hist)),
                )
                if z >= self.z_threshold:
                    anomalies.append(
                        self._raise(LOSS_SPIKE, step, loss, z)
                    )
            if grad_norm is not None and not math.isfinite(
                float(grad_norm)
            ):
                anomalies.append(
                    self._raise(
                        NON_FINITE_GRAD, step, float(grad_norm), None
                    )
                )
            if step_seconds is not None:
                t = float(step_seconds)
                if (
                    math.isfinite(t)
                    and len(self._time_hist) >= self.min_history
                ):
                    z = _robust_z(
                        t,
                        list(self._time_hist),
                        self.min_scale_frac
                        * abs(self._median(self._time_hist)),
                    )
                    if z >= self.z_threshold:
                        self._time_over += 1
                        if self._time_over >= self.time_consecutive:
                            anomalies.append(
                                self._raise(
                                    STEP_TIME_REGRESSION, step, t, z
                                )
                            )
                            self._time_over = 0
                    else:
                        self._time_over = 0
                if math.isfinite(t):
                    self._time_hist.append(t)
            # only finite values enter the baselines: a NaN-poisoned
            # window would make every later median NaN and mute the
            # detector exactly when it matters
            if math.isfinite(loss):
                self._loss_hist.append(loss)
            self._recent.append(
                {
                    "step": int(step),
                    "loss": loss if math.isfinite(loss) else None,
                    "grad_norm": (
                        float(grad_norm)
                        if grad_norm is not None
                        and math.isfinite(float(grad_norm))
                        else None
                    ),
                    "step_seconds": (
                        round(float(step_seconds), 6)
                        if step_seconds is not None
                        else None
                    ),
                }
            )
            active = self._active_locked()
        self._m_active.set(1.0 if active else 0.0)
        if math.isfinite(loss):
            self._m_loss.set(loss)
        if grad_norm is not None and math.isfinite(float(grad_norm)):
            self._m_grad.set(float(grad_norm))
        for a in anomalies:
            self._m_total.labels(type=a["type"]).inc()
        return anomalies

    @staticmethod
    def _median(values) -> float:
        srt = sorted(values)
        n = len(srt)
        if not n:
            return 0.0
        mid = n // 2
        return srt[mid] if n % 2 else 0.5 * (srt[mid - 1] + srt[mid])

    def _raise(
        self,
        kind: str,
        step: int,
        value: float,
        z: Optional[float],
    ) -> dict:
        entry = {
            "type": kind,
            "step": int(step),
            "value": value if math.isfinite(value) else repr(value),
            "zscore": round(z, 2) if z is not None else None,
            "z_threshold": self.z_threshold,
            "unix": time.time(),  # timestamp, not a duration
            # the flight-recorder readout: the last K steps leading in
            "snapshot": list(self._recent),
        }
        self._ring.append(entry)
        self._counts[kind] = self._counts.get(kind, 0) + 1
        self._last_anomaly_step = int(step)
        return entry

    def _active_locked(self) -> bool:
        return (
            self._last_anomaly_step is not None
            and self._last_step is not None
            and self._last_step - self._last_anomaly_step
            <= self.active_window
        )

    # -- reading -----------------------------------------------------------

    @property
    def active(self) -> bool:
        with self._lock:
            return self._active_locked()

    def report(self) -> dict:
        """JSON-able flight-recorder readout (embedded in
        ``status.json`` next to the metrics snapshot)."""
        with self._lock:
            return {
                "active": self._active_locked(),
                "counts": dict(sorted(self._counts.items())),
                "total": sum(self._counts.values()),
                "last_anomaly_step": self._last_anomaly_step,
                "last_step": self._last_step,
                "ring": [dict(e) for e in self._ring],
            }
