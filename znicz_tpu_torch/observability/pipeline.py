"""Input-pipeline bottleneck attribution: where does a train step's wall go?
(port of ``znicz_tpu/observability/pipeline.py``; every metric and stage
name is the JAX package's, byte for byte).

* **Stage taxonomy**: the producer (:mod:`znicz_tpu_torch.loader.prefetch`)
  observes ``znicz_pipeline_stage_seconds{stage}`` for ``fetch``
  (materializing one batch from the loader), ``host_transform`` (callables
  run on the producer thread) and ``enqueue`` (blocked handing the batch
  over: depth exhaustion); the workflow's staging observes ``h2d`` through
  :class:`H2DProbe` (bytes moved + wall -> the live
  ``znicz_h2d_bytes_per_second`` gauge).
* **:class:`PipelineAttribution`** decomposes the per-step wall
  (``znicz_train_step_wall_seconds``) into fractions (compute /
  prefetch-wait / h2d / other) that sum to 1, names the bottleneck with a
  confidence band and suggests the next move.  It reads a live registry, a
  JSON snapshot or a Prometheus exposition.

Attribution math: the consumer's step wall is sliced into *compute* (the
``dispatch/*`` phases of ``znicz_train_phase_seconds``), *prefetch-wait*
(``znicz_prefetch_wait_seconds``) and *other* (the untimed residual).  H2D
is carved out of the slice it ran in: with the prefetch thread on, the
producer's ``h2d`` share of its busy time prorates the wait slice; with
prefetching off the probe ran inline on the consumer, so its seconds come
out of the residual.  The four fractions are disjoint and sum to 1.

Pure stdlib.
"""

from __future__ import annotations

import contextlib
import math
import threading
import time
from collections import deque
from typing import Dict, Iterator, List, Optional, Tuple

from znicz_tpu_torch.observability.registry import (
    MetricsRegistry,
    get_registry,
    parse_prometheus_text,
)
from znicz_tpu_torch.utils import faults

# the producer/consumer stage taxonomy (docs/OBSERVABILITY.md
# "Training observability")
STAGE_FETCH = "fetch"
STAGE_TRANSFORM = "host_transform"
STAGE_H2D = "h2d"
STAGE_ENQUEUE = "enqueue"

STEP_WALL_METRIC = "znicz_train_step_wall_seconds"
WAIT_METRIC = "znicz_prefetch_wait_seconds"
PHASE_METRIC = "znicz_train_phase_seconds"
STAGE_METRIC = "znicz_pipeline_stage_seconds"
H2D_BPS_METRIC = "znicz_h2d_bytes_per_second"
H2D_BYTES_METRIC = "znicz_h2d_bytes_total"
QUEUE_FULL_METRIC = "znicz_prefetch_queue_full_total"

# anomaly surfaces the doctor reads from the same exposition
ANOMALY_ACTIVE_METRIC = "znicz_train_anomaly_active"
ANOMALY_TOTAL_METRIC = "znicz_train_anomalies_total"
LAST_LOSS_METRIC = "znicz_train_last_loss"
LAST_GRAD_METRIC = "znicz_train_last_grad_norm"

# self-healing surfaces (docs/TRAINING.md): the training tier's
# detect->recover loop.  Defined HERE (stdlib-pure) so both the
# producers (workflow/recovery.py, launcher.py, loader/base.py) and the
# doctor's readout speak one name per signal.
ROLLBACKS_METRIC = "znicz_train_rollbacks_total"
ROLLBACK_GIVE_UP_METRIC = "znicz_train_rollback_give_up"
RESTARTS_METRIC = "znicz_train_restarts_total"
RESTART_BUDGET_METRIC = "znicz_train_restart_budget"
LOADER_RETRIES_METRIC = "znicz_loader_retries_total"
LOADER_SKIPPED_METRIC = "znicz_loader_skipped_batches_total"
SNAPSHOT_FAILURES_METRIC = "znicz_train_snapshot_failures_total"

# the families a warm-up window reset clears (bench/tests exclude the
# first epoch's compile stall from the attribution they report)
WINDOW_METRICS = (
    STEP_WALL_METRIC,
    WAIT_METRIC,
    PHASE_METRIC,
    STAGE_METRIC,
    H2D_BYTES_METRIC,
    QUEUE_FULL_METRIC,
)


def stage_seconds(registry: Optional[MetricsRegistry] = None):
    """The shared per-stage histogram family (get-or-create)."""
    reg = registry if registry is not None else get_registry()
    return reg.histogram(
        STAGE_METRIC,
        "input-pipeline per-stage wall seconds "
        "(fetch / host_transform / h2d / enqueue)",
        ("stage",),
    )


def step_wall_seconds(registry: Optional[MetricsRegistry] = None):
    """Consumer-side per-train-step wall histogram (get-or-create)."""
    reg = registry if registry is not None else get_registry()
    return reg.histogram(
        STEP_WALL_METRIC,
        "wall seconds per training step as seen by the consumer loop "
        "(prefetch wait + dispatch + host bookkeeping)",
    )


def reset_window(registry: Optional[MetricsRegistry] = None) -> None:
    """Zero the attribution-relevant series (warm-up exclusion: call
    after the compile epoch so the reported window is steady-state).
    Families that don't exist yet are simply skipped."""
    reg = registry if registry is not None else get_registry()
    fams = reg.metrics()
    for name in WINDOW_METRICS:
        m = fams.get(name)
        if m is not None:
            m.reset()


class H2DProbe:
    """Host->device transfer probe: bytes moved + wall time.

    ``with probe.measure(nbytes):`` around the device placement calls
    observes the ``h2d`` stage histogram, counts
    ``znicz_h2d_bytes_total`` and keeps the live
    ``znicz_h2d_bytes_per_second`` gauge fresh from a rolling window of
    recent transfers.  The wall measured is the *initiation* wall — on
    an async transport this under-reports link occupancy and
    over-reports bandwidth, so the gauge is a best-effort live signal,
    while the byte counter and stage histogram stay exact.

    The ``loader.h2d`` fault point fires inside the measured region, so
    an injected delay reads as a slow link to the attribution — the
    CI fixture for the h2d-bound verdict.
    """

    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        *,
        window: int = 64,
    ):
        reg = registry if registry is not None else get_registry()
        self._hist = stage_seconds(reg)
        self._bytes = reg.counter(
            H2D_BYTES_METRIC,
            "bytes transferred host->device by the training loader path",
        )
        self._bps = reg.gauge(
            H2D_BPS_METRIC,
            "live host->device transfer rate over the last ~window of "
            "training batches",
        )
        self._recent: deque = deque(maxlen=max(int(window), 1))
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def measure(self, nbytes: int) -> Iterator[None]:
        faults.fire("loader.h2d")
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.observe(nbytes, dt)

    def observe(self, nbytes: int, seconds: float) -> None:
        self._hist.labels(stage=STAGE_H2D).observe(seconds)
        if nbytes > 0:
            self._bytes.inc(float(nbytes))
        with self._lock:
            self._recent.append((float(nbytes), float(seconds)))
            total_b = sum(b for b, _ in self._recent)
            total_s = sum(s for _, s in self._recent)
        if total_s > 0:
            self._bps.set(total_b / total_s)


# -- attribution ------------------------------------------------------------

_SUGGESTIONS = {
    "input": (
        "raise prefetch depth, shard loaders across processes, or move "
        "decode/augment on-device (the streaming-rebuild rung)"
    ),
    "h2d": (
        "overlap H2D with compute (double-buffered device prefetch), "
        "batch transfers, or ship compact dtypes (u8 + on-device "
        "normalize)"
    ),
    "compute": (
        "input pipeline keeps up — optimize the step itself or scale "
        "devices"
    ),
    "other": (
        "untimed host work dominates (python loop, stacking, metric "
        "sync) — record a tracer window to see where"
    ),
}

_VERDICTS = {
    "input": "input-bound",
    "h2d": "h2d-bound",
    "compute": "compute-bound",
    "other": "unattributed",
}


class PipelineAttribution:
    """Step-wall decomposition over one metrics capture.

    Construct from a live registry (:meth:`from_registry`), a registry
    JSON snapshot (:meth:`from_snapshot` — the ``status.json`` /
    bench-record shape, self-describing non-metric entries like
    ``{"type": "slo"}`` are skipped), or a Prometheus text exposition
    (:meth:`from_prometheus` — a ``metrics.prom`` file or an
    aggregator's merged ``/metrics``; pass ``instance=`` to scope a
    fleet exposition to one process).  :meth:`attribution` returns the
    self-describing ``{"type": "pipeline", ...}`` record the bench
    attaches and ``znicz-doctor`` prints.
    """

    def __init__(self, samples: List[Tuple[str, Dict[str, str], float]]):
        # prometheus-shaped flat samples: histograms appear as
        # <name>_sum / <name>_count / <name>_bucket rows
        self._samples = samples

    # -- constructors ------------------------------------------------------

    @classmethod
    def from_registry(
        cls, registry: Optional[MetricsRegistry] = None
    ) -> "PipelineAttribution":
        reg = registry if registry is not None else get_registry()
        return cls.from_snapshot(reg.snapshot())

    @classmethod
    def from_snapshot(cls, snap: dict) -> "PipelineAttribution":
        samples: List[Tuple[str, Dict[str, str], float]] = []
        for name, fam in snap.items():
            if not isinstance(fam, dict):
                continue
            kind = fam.get("type")
            series = fam.get("series")
            # self-describing riders ({"type": "slo"/"programs"/
            # "pipeline"}) are not metric families
            if kind not in ("counter", "gauge", "histogram") or not (
                isinstance(series, list)
            ):
                continue
            for s in series:
                labels = dict(s.get("labels") or {})
                if kind == "histogram":
                    samples.append(
                        (f"{name}_sum", labels, float(s.get("sum", 0.0)))
                    )
                    samples.append(
                        (
                            f"{name}_count",
                            labels,
                            float(s.get("count", 0.0)),
                        )
                    )
                else:
                    samples.append(
                        (name, labels, float(s.get("value", 0.0)))
                    )
        return cls(samples)

    @classmethod
    def from_prometheus(
        cls, text: str, *, instance: Optional[str] = None
    ) -> "PipelineAttribution":
        """Raises ``ValueError`` on a malformed exposition (the doctor
        maps it to the usage exit)."""
        parsed = parse_prometheus_text(text)
        samples = [
            (name, labels, value)
            for name, labels, value in parsed["samples"]
            if instance is None or labels.get("instance") == instance
        ]
        return cls(samples)

    # -- sample queries ----------------------------------------------------

    def _sum(self, name: str, **want: str) -> float:
        total = 0.0
        for sname, labels, value in self._samples:
            if sname != name:
                continue
            if any(labels.get(k) != v for k, v in want.items()):
                continue
            total += value
        return total

    def _sum_label_prefix(self, name: str, label: str, prefix: str) -> float:
        total = 0.0
        for sname, labels, value in self._samples:
            if sname == name and str(labels.get(label, "")).startswith(
                prefix
            ):
                total += value
        return total

    def _gauge_max(self, name: str) -> Optional[float]:
        vals = [
            value for sname, _, value in self._samples if sname == name
        ]
        return max(vals) if vals else None

    # -- the verdict -------------------------------------------------------

    def attribution(self) -> dict:
        wall = self._sum(f"{STEP_WALL_METRIC}_sum")
        steps = self._sum(f"{STEP_WALL_METRIC}_count")
        stages = {
            s: self._sum(f"{STAGE_METRIC}_sum", stage=s)
            for s in (
                STAGE_FETCH, STAGE_TRANSFORM, STAGE_H2D, STAGE_ENQUEUE
            )
        }
        out: dict = {
            "type": "pipeline",
            "steps": int(steps),
            "wall_seconds": round(wall, 6),
            "stages": {k: round(v, 6) for k, v in stages.items()},
            "queue_full_stalls": int(self._sum(QUEUE_FULL_METRIC)),
            "h2d_bytes_per_second": self._bandwidth(stages),
        }
        if steps <= 0 or wall <= 0:
            out.update(
                {
                    "fractions": {},
                    "bottleneck": None,
                    "verdict": "no-data",
                    "confidence": "none",
                    "margin": 0.0,
                    "input_bound_frac": 0.0,
                    "suggestion": (
                        "no znicz_train_step_wall_seconds samples in this "
                        "capture — run a stepwise training window first"
                    ),
                }
            )
            return out

        wait = min(self._sum(f"{WAIT_METRIC}_sum"), wall)
        wait_count = self._sum(f"{WAIT_METRIC}_count")
        compute = min(
            self._sum_label_prefix(f"{PHASE_METRIC}_sum", "phase", "dispatch/"),
            wall,
        )
        h2d_raw = stages[STAGE_H2D]
        if wait_count > 0:
            # prefetch thread on: while the consumer waits, the producer
            # is in one of its stages — prorate the wait slice by the
            # producer's h2d share of busy (non-enqueue) time
            busy = (
                stages[STAGE_FETCH] + stages[STAGE_TRANSFORM] + h2d_raw
            )
            h2d_frac = (
                (wait / wall) * (h2d_raw / busy) if busy > 0 else 0.0
            )
            wait_frac = max(wait / wall - h2d_frac, 0.0)
        else:
            # no prefetch thread: the probe ran inline on the consumer,
            # its wall sits in the residual outside the dispatch phases
            h2d_frac = min(h2d_raw, max(wall - compute, 0.0)) / wall
            wait_frac = 0.0
        compute_frac = compute / wall
        measured = compute_frac + wait_frac + h2d_frac
        if measured > 1.0:
            # phase/wait timers overlap the wall by jitter: renormalize
            # so the reported fractions stay a partition of 1
            compute_frac /= measured
            wait_frac /= measured
            h2d_frac /= measured
            measured = 1.0
        other_frac = max(1.0 - measured, 0.0)
        fractions = {
            "compute": round(compute_frac, 4),
            "prefetch_wait": round(wait_frac, 4),
            "h2d": round(h2d_frac, 4),
            "other": round(other_frac, 4),
        }
        by_bottleneck = {
            "compute": compute_frac,
            "input": wait_frac,
            "h2d": h2d_frac,
            "other": other_frac,
        }
        ranked = sorted(
            by_bottleneck.items(), key=lambda kv: -kv[1]
        )
        top, top_frac = ranked[0]
        margin = top_frac - ranked[1][1]
        band = min(0.5, 1.0 / math.sqrt(steps))
        if steps >= 20 and margin >= 2 * band:
            confidence = "high"
        elif steps >= 8 and margin >= band:
            confidence = "medium"
        else:
            confidence = "low"
        out.update(
            {
                "fractions": fractions,
                "fractions_sum": round(sum(fractions.values()), 4),
                "bottleneck": top,
                "verdict": _VERDICTS[top],
                "confidence": confidence,
                "margin": round(margin, 4),
                "confidence_band": [
                    round(max(top_frac - band, 0.0), 4),
                    round(min(top_frac + band, 1.0), 4),
                ],
                "input_bound_frac": round(wait_frac + h2d_frac, 4),
                "suggestion": _SUGGESTIONS[top],
            }
        )
        return out

    def _bandwidth(self, stages: Dict[str, float]) -> Optional[float]:
        """Window-consistent first: bytes / h2d-stage seconds — both
        zeroed together by :func:`reset_window`, so the headline never
        blends the compile epoch back in.  The live gauge (a rolling
        probe window reset_window cannot reach) is only the fallback
        for captures without the counter."""
        total = self._sum(H2D_BYTES_METRIC)
        if total > 0 and stages.get(STAGE_H2D, 0.0) > 0:
            return round(total / stages[STAGE_H2D], 1)
        live = self._gauge_max(H2D_BPS_METRIC)
        if live:
            return round(live, 1)
        return None

    def anomaly_summary(self) -> dict:
        """The anomaly view of the same capture: active flag, per-type
        counts and the last loss/grad-norm gauges — what the doctor's
        exit-1 gate reads (the full ring lives in ``status.json``)."""
        active = self._gauge_max(ANOMALY_ACTIVE_METRIC)
        counts: Dict[str, float] = {}
        for name, labels, value in self._samples:
            if name == ANOMALY_TOTAL_METRIC and value > 0:
                key = labels.get("type", "unknown")
                counts[key] = counts.get(key, 0.0) + value
        return {
            "active": bool(active),
            "counts": {k: int(v) for k, v in sorted(counts.items())},
            "total": int(sum(counts.values())),
            "last_loss": self._gauge_max(LAST_LOSS_METRIC),
            "last_grad_norm": self._gauge_max(LAST_GRAD_METRIC),
        }

    def recovery_summary(self) -> dict:
        """The self-healing view of the same capture: rollback /
        restart / loader-retry counters plus the give-up signals
        ``znicz-doctor`` gates on.  ``looping`` is True when the run
        has burned its whole restart budget (the supervisor is about
        to — or already did — give up) or a rollback gave up: both are
        "this run is not healing itself" incidents, the doctor's
        exit-1 condition."""
        rollbacks: Dict[str, int] = {}
        for name, labels, value in self._samples:
            if name == ROLLBACKS_METRIC and value > 0:
                key = labels.get("reason", "unknown")
                rollbacks[key] = rollbacks.get(key, 0) + int(value)
        restarts = int(self._sum(RESTARTS_METRIC))
        budget = self._gauge_max(RESTART_BUDGET_METRIC)
        give_up = bool(self._gauge_max(ROLLBACK_GIVE_UP_METRIC))
        looping = give_up or (
            budget is not None and budget > 0 and restarts >= budget
        )
        return {
            "rollbacks": dict(sorted(rollbacks.items())),
            "rollbacks_total": sum(rollbacks.values()),
            "rollback_give_up": give_up,
            "restarts": restarts,
            "restart_budget": int(budget) if budget is not None else None,
            "loader_retries": int(self._sum(LOADER_RETRIES_METRIC)),
            "loader_skipped_batches": int(
                self._sum(LOADER_SKIPPED_METRIC)
            ),
            "snapshot_failures": int(
                self._sum(SNAPSHOT_FAILURES_METRIC)
            ),
            "looping": looping,
        }
