"""Status service: live training state as JSON + HTML (port of
``znicz_tpu/services/web_status.py``).

The per-epoch state is written as ``status.json`` + a static
``status.html`` that auto-refreshes, servable by anything (``python -m
znicz_tpu_torch.services.serve``), with no long-running service process
coupled to training.  Point the plotters
(:mod:`znicz_tpu_torch.services.plotting`) at the same directory and the
page embeds every ``*.png`` it finds, cache-busted per refresh.

``status.json``'s keys and the page's structure are the JAX package's;
``devices`` lists the torch devices the process sees (``cuda:0 NVIDIA H100
80GB HBM3``), where the JAX package lists ``jax.devices()``.
"""

from __future__ import annotations

import html
import json
import logging
import os

from znicz_tpu_torch.observability import get_registry
from znicz_tpu_torch.utils.profiling import Stopwatch

logger = logging.getLogger(__name__)


def _atomic_write(path: str, text: str) -> None:
    """Write-then-rename so a concurrently-polling reader (the serve
    process, a dashboard scraper) can never observe a truncated file.
    The temp file lives in the same directory, so ``os.replace`` is an
    atomic same-filesystem rename."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


class StatusWriter:
    """Per-epoch status/metrics files, optionally also PUSHED to a
    fleet :class:`~znicz_tpu_torch.observability.aggregate.MetricsAggregator`
    (``aggregator_url``): the background pusher reports every
    ``push_interval_s`` and :meth:`on_epoch` flushes synchronously so
    the fleet view is epoch-fresh.  A dead aggregator costs log lines,
    never training time beyond the pusher's own bounded timeout."""

    def __init__(
        self,
        directory: str,
        *,
        refresh_seconds: int = 5,
        aggregator_url: str = None,
        instance: str = None,
        push_interval_s: float = 15.0,
    ):
        self.directory = directory
        self.refresh_seconds = refresh_seconds
        self._clock = Stopwatch()
        os.makedirs(directory, exist_ok=True)
        self._pusher = None
        if aggregator_url:
            from znicz_tpu_torch.observability.aggregate import MetricsPusher

            self._pusher = MetricsPusher(
                aggregator_url,
                instance=instance or f"train-{os.getpid()}",
                interval_s=push_interval_s,
            ).start()

    def close(self) -> None:
        """Stop the aggregator pusher (final flush included)."""
        if self._pusher is not None:
            self._pusher.stop()

    def on_epoch(self, workflow, verdict) -> None:
        dec = workflow.decision
        status = {
            "workflow": workflow.name,
            "epoch": dec.epoch - 1,
            "max_epochs": dec.max_epochs,
            "best_value": dec.best_value,
            "best_epoch": dec.best_epoch,
            "improved": bool(verdict["improved"]),
            "stopping": bool(verdict["stop"]),
            "elapsed_seconds": round(self._clock.elapsed(), 1),
            "devices": self._devices(),
            "summary": verdict["summary"],
            "history_len": len(dec.history),
            # per-phase wall-clock ledger (reference per-unit timing on the
            # status page, SURVEY.md 5.1) — a windowed view over the same
            # registry histogram the full snapshot below exports
            "timing": (
                workflow.timer.summary()
                if getattr(workflow, "timer", None)
                else {}
            ),
            # the whole process-wide metrics registry, embedded so one
            # status.json answers "what is this process doing right now"
            "metrics": get_registry().snapshot(),
            # flight-recorder readout: the anomaly ring + active flag
            # (typed verdicts with last-K-steps snapshots) and the
            # input-pipeline attribution verdict — the same records
            # znicz-doctor derives from /metrics, epoch-fresh here
            "anomalies": self._anomalies(workflow),
            "pipeline": self._attribution(),
            # self-healing readout: rollback events/budget + lr backoff
            # (docs/TRAINING.md; restart counters ride "metrics")
            "recovery": self._recovery(workflow),
        }
        _atomic_write(
            os.path.join(self.directory, "status.json"),
            json.dumps(status, indent=2),
        )
        # Prometheus text beside the JSON: the serve process's /metrics
        # endpoint prefers this file (textfile-collector pattern), so a
        # scraper sees the TRAINING process's registry, not the server's
        _atomic_write(
            os.path.join(self.directory, "metrics.prom"),
            get_registry().prometheus_text(),
        )
        self._write_html(status)
        if self._pusher is not None:
            # epoch-fresh fleet view; bounded by the pusher's timeout
            self._pusher.push_now()

    @staticmethod
    def _anomalies(workflow) -> dict:
        """The workflow's flight-recorder report (empty when the
        detector is off).  Status must never break training."""
        detector = getattr(workflow, "anomaly", None)
        if detector is None:
            return {"active": False, "total": 0, "ring": []}
        try:
            return detector.report()
        except Exception:
            logger.debug("anomaly report failed", exc_info=True)
            return {"active": False, "total": 0, "ring": []}

    @staticmethod
    def _recovery(workflow) -> dict:
        """The workflow's recovery-policy readout (empty when no policy
        is wired).  Status must never break training."""
        policy = getattr(workflow, "recovery", None)
        if policy is None:
            return {"rollbacks_used": 0, "gave_up": False, "events": []}
        try:
            return policy.report()
        except Exception:
            logger.debug("recovery report failed", exc_info=True)
            return {"rollbacks_used": 0, "gave_up": False, "events": []}

    @staticmethod
    def _attribution() -> dict:
        """Pipeline-attribution verdict over the live registry (the
        ``{"type": "pipeline"}`` self-describing record)."""
        try:
            from znicz_tpu_torch.observability.pipeline import (
                PipelineAttribution,
            )

            return PipelineAttribution.from_registry().attribution()
        except Exception:
            logger.debug("pipeline attribution failed", exc_info=True)
            return {"type": "pipeline", "verdict": "error"}

    @staticmethod
    def _devices():
        """The torch devices this process sees: each card as ``cuda:<i>
        <name>``, else ``cpu``."""
        try:
            import torch

            if torch.cuda.is_available():
                return [
                    f"cuda:{i} {torch.cuda.get_device_name(i)}"
                    for i in range(torch.cuda.device_count())
                ]
            return ["cpu"]
        except Exception:
            # status must never break training, but the degraded page
            # should be diagnosable
            logger.debug("device listing failed", exc_info=True)
            return []

    def _plot_images(self) -> list:
        """PNGs in the status directory (plotters writing alongside) with
        mtime cache-busters so the auto-refresh shows the newest frame."""
        out = []
        try:
            for name in sorted(os.listdir(self.directory)):
                if name.endswith(".png"):
                    mtime = int(
                        os.path.getmtime(os.path.join(self.directory, name))
                    )
                    out.append((name, mtime))
        except OSError:
            # a plotter writing concurrently can race the listing;
            # status must never break training, but leave a trace
            logger.debug(
                "plot image listing failed in %s",
                self.directory,
                exc_info=True,
            )
        return out

    @staticmethod
    def _doctor_html(status) -> str:
        """One-line doctor verdict + anomaly banner for the page."""
        lines = []
        pipe = status.get("pipeline") or {}
        if pipe.get("verdict") and pipe["verdict"] not in (
            "no-data", "error"
        ):
            fracs = pipe.get("fractions") or {}
            detail = ", ".join(
                f"{k} {v:.2f}" for k, v in fracs.items()
            )
            lines.append(
                f"<p>pipeline: <b>{html.escape(pipe['verdict'])}</b> "
                f"({html.escape(detail)})</p>"
            )
        anomalies = status.get("anomalies") or {}
        if anomalies.get("active"):
            counts = ", ".join(
                f"{k}={v}"
                for k, v in (anomalies.get("counts") or {}).items()
            )
            lines.append(
                '<p style="color:#b00"><b>anomaly active</b> '
                f"({html.escape(counts)})</p>"
            )
        return "\n".join(lines)

    def _write_html(self, status) -> None:
        rows = []
        for split, m in status["summary"].items():
            cells = "".join(
                f"<td>{html.escape(f'{v:.4f}' if isinstance(v, float) else str(v))}</td>"
                for v in (
                    m.get("n_samples", ""),
                    m.get("loss", ""),
                    m.get("err_pct", ""),
                )
            )
            rows.append(f"<tr><td>{html.escape(split)}</td>{cells}</tr>")
        doc = f"""<!DOCTYPE html>
<html><head><meta http-equiv="refresh" content="{self.refresh_seconds}">
<title>{html.escape(status['workflow'])}</title>
<style>body{{font-family:monospace;margin:2em}}table{{border-collapse:collapse}}
td,th{{border:1px solid #999;padding:4px 10px}}</style></head><body>
<h2>{html.escape(status['workflow'])}</h2>
<p>epoch {status['epoch']} / {status['max_epochs']} —
best {status['best_value']} @ {status['best_epoch']} —
{status['elapsed_seconds']}s elapsed</p>
<p>devices: {html.escape(', '.join(status['devices']))}</p>
{self._doctor_html(status)}
<table><tr><th>split</th><th>n</th><th>loss</th><th>err%</th></tr>
{''.join(rows)}</table>
{''.join(
    f'<p><img src="{html.escape(name)}?t={mtime}" '
    f'alt="{html.escape(name)}" style="max-width:45em"></p>'
    for name, mtime in self._plot_images()
)}
<details><summary>metrics registry snapshot</summary>
<pre>{html.escape(json.dumps(status.get("metrics", {}), indent=2))}</pre>
</details>
</body></html>"""
        _atomic_write(os.path.join(self.directory, "status.html"), doc)
