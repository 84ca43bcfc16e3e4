"""znicz-doctor: training triage over one metrics capture (port of
``znicz_tpu/observability/doctor.py``: the same verdicts, text, ``--json``
and exit codes, over the port's pipeline attribution).

Point it at a metrics source and it prints the pipeline-attribution verdict plus the
anomaly state, e.g. ::

    $ python -m znicz_tpu_torch.observability.doctor run/metrics.prom
    input-bound: 0.83 of step wall in prefetch-wait (compute 0.12,
      h2d 0.03, other 0.02); H2D ~12.0 MB/s; confidence high, 64 steps
    anomalies: none
    suggest: raise prefetch depth, shard loaders across processes, ...

Sources (same contract as :func:`~znicz_tpu_torch.observability.slo.main`): a local
``metrics.prom`` path, or an http(s) URL — a serving replica's or the
aggregator's ``/metrics`` (a bare ``http://host:port`` gets
``/metrics`` appended).  On a fleet exposition pass ``--instance`` to
scope the attribution to one process's series.

Exit codes: **0** healthy (including "no training data in this
capture" — absence of evidence is not an incident), **1** an anomaly
is ACTIVE (``znicz_train_anomaly_active`` > 0 — the flight recorder
fired within its active window; the ring itself lives in
``status.json``) OR the run is **restart-looping** (its supervised
restart budget is spent — ``znicz_train_restarts_total`` >=
``znicz_train_restart_budget`` — or a rollback gave up:
``znicz_train_rollback_give_up``), **2** usage / unreadable source /
malformed exposition.
The self-healing counters (rollbacks by reason, restarts, loader
retries/skips, snapshot write failures) print on their own line and
ride the ``--json`` output as ``"recovery"``.
"""

from __future__ import annotations

import json
import sys
from typing import List, Optional

from znicz_tpu_torch.observability.pipeline import PipelineAttribution
from znicz_tpu_torch.observability.slo import _read_source

USAGE = (
    "usage: znicz-doctor <metrics.prom | http://host:port[/metrics]> "
    "[--instance NAME] [--json]"
)


def _fmt_bandwidth(bps: Optional[float]) -> str:
    if bps is None:
        return "H2D n/a"
    return f"H2D ~{bps / 1e6:.1f} MB/s"


def _render_recovery(rec: dict) -> List[str]:
    """The self-healing line(s): silent when nothing ever fired."""
    lines: List[str] = []
    parts: List[str] = []
    if rec["rollbacks_total"]:
        by_reason = ", ".join(
            f"{k}={v}" for k, v in rec["rollbacks"].items()
        )
        parts.append(f"rollbacks {rec['rollbacks_total']} ({by_reason})")
    if rec["restarts"]:
        budget = (
            f"/{rec['restart_budget']}"
            if rec["restart_budget"] is not None
            else ""
        )
        parts.append(f"restarts {rec['restarts']}{budget}")
    if rec["loader_retries"]:
        parts.append(f"loader retries {rec['loader_retries']}")
    if rec["loader_skipped_batches"]:
        parts.append(
            f"skipped batches {rec['loader_skipped_batches']}"
        )
    if rec["snapshot_failures"]:
        parts.append(f"snapshot failures {rec['snapshot_failures']}")
    if parts:
        lines.append("self-healing: " + "; ".join(parts))
    if rec["looping"]:
        why = (
            "rollback gave up"
            if rec["rollback_give_up"]
            else "restart budget spent"
        )
        lines.append(
            f"self-healing: LOOPING ({why}) — this run is not healing "
            "itself; intervene"
        )
    return lines


def _render(att: dict, anomalies: dict, recovery: dict) -> str:
    lines: List[str] = []
    if att["verdict"] == "no-data":
        lines.append(
            "no-data: no training step-wall samples in this capture"
        )
    else:
        f = att["fractions"]
        others = ", ".join(
            f"{k} {f[k]:.2f}"
            for k in ("compute", "prefetch_wait", "h2d", "other")
            if k != _headline_key(att["bottleneck"])
        )
        lines.append(
            f"{att['verdict']}: {f[_headline_key(att['bottleneck'])]:.2f} "
            f"of step wall in {_headline_name(att['bottleneck'])} "
            f"({others}); {_fmt_bandwidth(att['h2d_bytes_per_second'])}; "
            f"confidence {att['confidence']}, {att['steps']} steps"
        )
        if att["queue_full_stalls"]:
            lines.append(
                f"prefetch depth exhausted {att['queue_full_stalls']} "
                "time(s): the producer outran the consumer — the "
                "input pipeline is keeping up"
            )
    if anomalies["active"]:
        counts = ", ".join(
            f"{k}={v}" for k, v in anomalies["counts"].items()
        )
        lines.append(
            f"anomalies: ACTIVE ({counts or 'unknown'}; "
            f"{anomalies['total']} total) — see status.json for the "
            "flight-recorder ring"
        )
    elif anomalies["total"]:
        counts = ", ".join(
            f"{k}={v}" for k, v in anomalies["counts"].items()
        )
        lines.append(
            f"anomalies: none active ({counts}; past incidents only)"
        )
    else:
        lines.append("anomalies: none")
    lines.extend(_render_recovery(recovery))
    if att.get("suggestion"):
        lines.append(f"suggest: {att['suggestion']}")
    return "\n".join(lines)


def _headline_key(bottleneck: str) -> str:
    return {"input": "prefetch_wait"}.get(bottleneck, bottleneck)


def _headline_name(bottleneck: str) -> str:
    return {
        "input": "prefetch-wait",
        "h2d": "host->device transfer",
        "compute": "device compute/dispatch",
        "other": "untimed host work",
    }[bottleneck]


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    as_json = "--json" in args
    if as_json:
        args.remove("--json")
    instance = None
    if "--instance" in args:
        i = args.index("--instance")
        if i + 1 >= len(args):
            print("--instance needs a value", file=sys.stderr)
            return 2
        instance = args[i + 1]
        del args[i:i + 2]
    if len(args) != 1 or args[0].startswith("--"):
        print(USAGE, file=sys.stderr)
        return 2
    try:
        text = _read_source(args[0])
        att_src = PipelineAttribution.from_prometheus(
            text, instance=instance
        )
        att = att_src.attribution()
        anomalies = att_src.anomaly_summary()
        recovery = att_src.recovery_summary()
    except (OSError, ValueError) as exc:
        print(f"znicz-doctor: {exc}", file=sys.stderr)
        return 2
    if as_json:
        print(
            json.dumps(
                {
                    "source": args[0],
                    "instance": instance,
                    **att,
                    "anomalies": anomalies,
                    "recovery": recovery,
                }
            )
        )
    else:
        print(_render(att, anomalies, recovery))
    return 1 if anomalies["active"] or recovery["looping"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
