"""SLO evaluation: rolling percentiles and multi-window burn rates (port
of ``znicz_tpu/observability/slo.py``, the same names, outputs and text).

The front door produces TTFT and request-latency histograms and typed
error/shed counters; this module is the judgment on top: "over the last
minute / five minutes / hour, what were p50/p95/p99, what fraction of
requests blew the target, and how fast is the error budget burning?"
Host-side and registry-fed:

* :class:`SLOTarget` — one declared objective: "``objective`` of
  requests must finish the ``metric`` histogram under ``threshold_s``"
  (e.g. 99% of TTFTs under 1 s).
* :class:`SLOMonitor` — keeps a bounded ring of timestamped registry
  captures; :meth:`snapshot` evaluates each target over each rolling
  window from CUMULATIVE-BUCKET DELTAS (the same interpolation rule the
  registry's own quantiles use), plus request/error/shed rates from
  counter deltas.  ``burn_rate = bad_fraction / (1 - objective)`` —
  1.0 means the error budget spends exactly as fast as it accrues; a
  target is **breached** when every window with data burns at or above
  ``breach_burn_rate`` (the classic multi-window AND: a transient spike
  trips only the short window, a recovered incident clears it, a real
  sustained burn trips both).
* :func:`evaluate_exposition` / :func:`lifetime_snapshot` — the
  windowless twins over a single Prometheus exposition or live
  registry (process-lifetime deltas from zero), and :func:`main`, the
  command line that gates on them
  (``python -m znicz_tpu_torch.observability.slo``).

Exposed at ``GET /slo`` (:mod:`znicz_tpu_torch.services.serve`) and as
:meth:`~znicz_tpu_torch.services.frontdoor.ServingFrontDoor.slo_snapshot`.
Pure stdlib.
"""

from __future__ import annotations

import dataclasses
import json
import math
import sys
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from znicz_tpu_torch.observability.registry import (
    MetricsRegistry,
    fraction_le,
    get_registry,
    parse_prometheus_text,
    quantile_from_cumulative,
)


@dataclasses.dataclass(frozen=True)
class SLOTarget:
    """One latency objective over a registry histogram."""

    name: str  # e.g. "ttft"
    metric: str  # histogram family, e.g. znicz_serve_ttft_seconds
    threshold_s: float  # a request is "good" when under this
    objective: float = 0.99  # fraction of requests that must be good

    def __post_init__(self):
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"{self.name}: want 0 < objective < 1; got "
                f"{self.objective}"
            )
        if self.threshold_s <= 0:
            raise ValueError(
                f"{self.name}: want threshold_s > 0; got "
                f"{self.threshold_s}"
            )


DEFAULT_TARGETS: Tuple[SLOTarget, ...] = (
    SLOTarget("ttft", "znicz_serve_ttft_seconds", 1.0, 0.99),
    SLOTarget(
        "latency", "znicz_serve_request_latency_seconds", 5.0, 0.99
    ),
)

# the front door's CLIENT-clock twins (submit -> first token /
# completion delivery, front-door queueing and tick cadence included).
# The engine-clock defaults above start at ENGINE submit and cannot see
# a deep pending queue — a replica gate should judge these instead
# (znicz-slo --frontdoor; ServingFrontDoor.slo_snapshot() already does).
FRONTDOOR_TARGETS: Tuple[SLOTarget, ...] = (
    SLOTarget("ttft", "znicz_serve_frontdoor_ttft_seconds", 1.0, 0.99),
    SLOTarget(
        "latency", "znicz_serve_frontdoor_latency_seconds", 5.0, 0.99
    ),
)

DEFAULT_WINDOWS_S: Tuple[float, ...] = (60.0, 300.0, 3600.0)

# counters the rates view reads (label-summed deltas per window)
_RATE_COUNTERS = {
    "requests": "znicz_serve_requests_submitted_total",
    "errors": ("znicz_serve_requests_retired_total", ("error",)),
    "sheds": "znicz_serve_rejected_total",
    "deadlines": "znicz_serve_deadline_exceeded_total",
    "cancels": "znicz_serve_cancelled_total",
}


def _capture(
    registry: MetricsRegistry, metrics: Sequence[str]
) -> dict:
    """One point-in-time state: per-histogram cumulative pairs summed
    across label-sets, and the watched counters (``reason``-filtered
    where declared)."""
    fams = registry.metrics()
    hists: Dict[str, dict] = {}
    for name in metrics:
        m = fams.get(name)
        if m is None or m.kind != "histogram":
            continue
        merged: Dict[float, float] = {}
        count, total = 0.0, 0.0
        for child in m.children().values():
            for upper, acc in child.cumulative():
                merged[upper] = merged.get(upper, 0.0) + acc
            count += child.count
            total += child.sum
        hists[name] = {
            "cum": sorted(merged.items()), "count": count, "sum": total
        }
    counters: Dict[str, float] = {}
    for key, spec in _RATE_COUNTERS.items():
        name, reasons = (
            spec if isinstance(spec, tuple) else (spec, None)
        )
        m = fams.get(name)
        if m is None or m.kind != "counter":
            counters[key] = 0.0
            continue
        v = 0.0
        for labels, child in m.children().items():
            if reasons is not None and not any(
                lv in reasons for lv in labels
            ):
                continue
            v += child.value
        counters[key] = v
    return {"hists": hists, "counters": counters}


def _delta_cum(cur: dict, base: Optional[dict]) -> List[Tuple[float, float]]:
    """current-minus-baseline cumulative pairs (baseline None = zero).
    Registries share one process-fixed ladder, so the edges line up;
    a mid-flight ladder change just clamps negatives to zero."""
    if base is None:
        return list(cur["cum"])
    base_map = dict(base["cum"])
    return [
        (upper, max(acc - base_map.get(upper, 0.0), 0.0))
        for upper, acc in cur["cum"]
    ]


def _eval_target(
    target: SLOTarget,
    cum: List[Tuple[float, float]],
    *,
    span_s: Optional[float],
) -> dict:
    n = cum[-1][1] if cum else 0.0
    good = fraction_le(cum, target.threshold_s) if n else 1.0
    bad = max(1.0 - good, 0.0)
    burn = bad / max(1.0 - target.objective, 1e-9)
    out = {
        "n": n,
        "p50_s": quantile_from_cumulative(cum, 0.5),
        "p95_s": quantile_from_cumulative(cum, 0.95),
        "p99_s": quantile_from_cumulative(cum, 0.99),
        "bad_frac": round(bad, 6),
        "burn_rate": round(burn, 4),
    }
    if span_s is not None:
        out["span_s"] = round(span_s, 3)
    return out


def _window_key(w: float) -> str:
    return str(int(w)) if float(w).is_integer() else str(w)


class SLOMonitor:
    """Rolling-window SLO evaluation over one registry.

    :meth:`sample` appends a timestamped capture to a bounded ring
    (call it on a cadence — the front door's engine thread does, every
    ``min_sample_gap_s``); :meth:`snapshot` takes a fresh capture and
    evaluates every target over every window against the ring.  A
    window with no baseline old enough uses the OLDEST capture and
    reports its true ``span_s`` — short uptimes degrade honestly
    instead of inventing history."""

    def __init__(
        self,
        *,
        targets: Sequence[SLOTarget] = DEFAULT_TARGETS,
        windows_s: Sequence[float] = DEFAULT_WINDOWS_S,
        registry: Optional[MetricsRegistry] = None,
        min_sample_gap_s: float = 5.0,
        breach_burn_rate: float = 1.0,
        max_samples: int = 4096,
    ):
        if not targets:
            raise ValueError("want at least one SLOTarget")
        if not windows_s or any(w <= 0 for w in windows_s):
            raise ValueError(f"want positive windows; got {windows_s}")
        self.targets = tuple(targets)
        self.windows_s = tuple(sorted(float(w) for w in windows_s))
        self.breach_burn_rate = float(breach_burn_rate)
        self.min_sample_gap_s = float(min_sample_gap_s)
        self._registry = registry if registry is not None else get_registry()
        self._metrics = tuple(
            dict.fromkeys(t.metric for t in self.targets)
        )
        self._ring: Deque[Tuple[float, dict]] = deque(maxlen=max_samples)
        self._last_sample = -math.inf
        # construction instant: the honest span for a snapshot taken
        # before any sample() landed (an empty ring must not report
        # lifetime counter totals as if they spanned exactly one window)
        self._t0 = time.monotonic()
        # sample() runs on the engine thread, snapshot() on HTTP worker
        # threads — the ring needs one lock or iteration can see a
        # mid-append deque ("deque mutated during iteration")
        self._ring_lock = threading.Lock()

    def sample(self, now: Optional[float] = None) -> None:
        """Record one capture (and prune the ring past the longest
        window — plus slack so the oldest baseline stays available)."""
        t = time.monotonic() if now is None else now
        state = _capture(self._registry, self._metrics)
        with self._ring_lock:
            self._record(t, state)

    def _record(self, t: float, state: dict) -> None:
        self._ring.append((t, state))
        self._last_sample = t
        horizon = t - 1.25 * self.windows_s[-1]
        while len(self._ring) > 2 and self._ring[1][0] <= horizon:
            self._ring.popleft()

    def maybe_sample(self, now: Optional[float] = None) -> bool:
        """Tick-rate-friendly :meth:`sample`: records only when
        ``min_sample_gap_s`` has passed since the last one."""
        t = time.monotonic() if now is None else now
        with self._ring_lock:
            if t - self._last_sample < self.min_sample_gap_s:
                return False
        # capture outside the lock (it walks the whole registry), then
        # re-check: a concurrent sampler winning the race just means
        # one redundant-but-valid capture lands in the ring
        state = _capture(self._registry, self._metrics)
        with self._ring_lock:
            if t - self._last_sample < self.min_sample_gap_s:
                return False
            self._record(t, state)
        return True

    def latest_burn(self) -> float:
        """Max burn rate across targets and windows WITH data,
        evaluated from the ring's newest capture — no fresh registry
        walk, no rates/percentile computation.  The cheap per-tick
        reduction behind the ``znicz_serve_slo_burn_rate`` gauge (the
        front door calls this right after :meth:`maybe_sample`
        recorded, so the newest capture is current); :meth:`snapshot`
        stays the full judgment."""
        with self._ring_lock:
            ring = list(self._ring)
        if not ring:
            return 0.0
        t_new, current = ring[-1]
        burn = 0.0
        for target in self.targets:
            cur_h = current["hists"].get(target.metric)
            if cur_h is None:
                continue
            for w in self.windows_s:
                _, base = self._baseline(ring, t_new - w)
                cum = _delta_cum(
                    cur_h,
                    base["hists"].get(target.metric)
                    if base is not None
                    else None,
                )
                ev = _eval_target(target, cum, span_s=None)
                if ev["n"] > 0:
                    burn = max(burn, ev["burn_rate"])
        return round(burn, 4)

    @staticmethod
    def _baseline(
        ring: Sequence[Tuple[float, dict]], t_want: float
    ) -> Tuple[float, Optional[dict]]:
        """Newest capture at or before ``t_want``; oldest available
        when the ring does not reach back that far; (t_want, None)
        when the ring is empty (zero baseline)."""
        chosen: Optional[Tuple[float, dict]] = None
        for t, state in ring:
            if t <= t_want:
                chosen = (t, state)
            else:
                break
        if chosen is None:
            chosen = ring[0] if ring else None
        if chosen is None:
            return t_want, None
        return chosen

    def snapshot(self, now: Optional[float] = None) -> dict:
        """Evaluate every target over every rolling window.  JSON-able;
        the ``/slo`` endpoint body.  Safe against a concurrent
        :meth:`sample`: evaluates one consistent copy of the ring."""
        t = time.monotonic() if now is None else now
        with self._ring_lock:
            ring = list(self._ring)
        current = _capture(self._registry, self._metrics)
        targets_out: dict = {}
        any_breach = False
        for target in self.targets:
            windows: dict = {}
            burns: List[float] = []
            for w in self.windows_s:
                bt, base = self._baseline(ring, t - w)
                span = (
                    t - bt if base is not None
                    else max(t - self._t0, 1e-9)
                )
                cur_h = current["hists"].get(target.metric)
                cum = (
                    _delta_cum(
                        cur_h,
                        base["hists"].get(target.metric)
                        if base is not None
                        else None,
                    )
                    if cur_h is not None
                    else []
                )
                ev = _eval_target(target, cum, span_s=span)
                windows[_window_key(w)] = ev
                if ev["n"] > 0:
                    burns.append(ev["burn_rate"])
            breached = bool(burns) and all(
                b >= self.breach_burn_rate for b in burns
            )
            any_breach = any_breach or breached
            targets_out[target.name] = {
                "metric": target.metric,
                "threshold_s": target.threshold_s,
                "objective": target.objective,
                "windows": windows,
                "breached": breached,
            }
        rates: dict = {}
        for w in self.windows_s:
            bt, base = self._baseline(ring, t - w)
            span = max(
                t - bt if base is not None else t - self._t0, 1e-9
            )
            row: dict = {"span_s": round(span, 3)}
            for key in _RATE_COUNTERS:
                cur_v = current["counters"].get(key, 0.0)
                base_v = (
                    base["counters"].get(key, 0.0)
                    if base is not None
                    else 0.0
                )
                row[key] = max(cur_v - base_v, 0.0)
            # "requests" counts ENGINE submits, but errors/deadlines
            # also claim requests that died in the front-door pending
            # queue before ever reaching engine submit (a wedged tick
            # holds them exactly there) — floor the denominator at the
            # fatality count so the rate saturates at 1.0 instead of
            # reporting a nonsensical >100% mid-incident
            fatal = row["errors"] + row["deadlines"]
            denom = max(row["requests"] + row["sheds"], fatal, 1.0)
            row["requests_per_s"] = round(row["requests"] / span, 4)
            row["error_rate"] = round(fatal / denom, 6)
            row["shed_rate"] = round(row["sheds"] / denom, 6)
            rates[_window_key(w)] = row
        return {
            "generated_unix": time.time(),  # timestamp, not a duration
            "breach_burn_rate": self.breach_burn_rate,
            "targets": targets_out,
            "rates": rates,
            "breached": any_breach,
        }


# -- windowless evaluation (prom files, aggregator scrapes, bench) ----------


def _eval_state(
    state: dict,
    targets: Sequence[SLOTarget],
    *,
    breach_burn_rate: float = 1.0,
) -> dict:
    targets_out: dict = {}
    any_breach = False
    for target in targets:
        h = state["hists"].get(target.metric)
        cum = list(h["cum"]) if h is not None else []
        ev = _eval_target(target, cum, span_s=None)
        breached = ev["n"] > 0 and ev["burn_rate"] >= breach_burn_rate
        any_breach = any_breach or breached
        targets_out[target.name] = {
            "metric": target.metric,
            "threshold_s": target.threshold_s,
            "objective": target.objective,
            "windows": {"lifetime": ev},
            "breached": breached,
        }
    counters = state["counters"]
    # same pending-queue-fatality floor as SLOMonitor.snapshot(): the
    # rate must stay a fraction even when deaths outnumber engine
    # submits
    fatal = counters["errors"] + counters["deadlines"]
    denom = max(counters["requests"] + counters["sheds"], fatal, 1.0)
    rates = {
        "lifetime": {
            **{k: counters.get(k, 0.0) for k in _RATE_COUNTERS},
            "error_rate": round(fatal / denom, 6),
            "shed_rate": round(counters["sheds"] / denom, 6),
        }
    }
    return {
        "type": "slo",  # self-describing inside a metrics_snapshot
        "generated_unix": time.time(),
        "breach_burn_rate": breach_burn_rate,
        "targets": targets_out,
        "rates": rates,
        "breached": any_breach,
    }


def lifetime_snapshot(
    registry: Optional[MetricsRegistry] = None,
    targets: Sequence[SLOTarget] = DEFAULT_TARGETS,
    *,
    breach_burn_rate: float = 1.0,
) -> dict:
    """Process-lifetime SLO view of a live registry (deltas from zero).
    What the bench attaches to every ``metrics_snapshot``."""
    reg = registry if registry is not None else get_registry()
    metrics = tuple(dict.fromkeys(t.metric for t in targets))
    return _eval_state(
        _capture(reg, metrics), targets,
        breach_burn_rate=breach_burn_rate,
    )


def evaluate_exposition(
    text: str,
    targets: Sequence[SLOTarget] = DEFAULT_TARGETS,
    *,
    breach_burn_rate: float = 1.0,
) -> dict:
    """SLO view of one Prometheus text exposition — a ``metrics.prom``
    file or an aggregator's merged ``/metrics`` body.  Raises
    ``ValueError`` on a malformed exposition."""
    parsed = parse_prometheus_text(text)
    wanted = {t.metric for t in targets}
    hists: Dict[str, dict] = {}
    by_series: Dict[str, Dict[float, float]] = {}
    counts: Dict[str, float] = {}
    sums: Dict[str, float] = {}
    for name, labels, value in parsed["samples"]:
        for metric in wanted:
            if name == f"{metric}_bucket" and "le" in labels:
                acc = by_series.setdefault(metric, {})
                le = float(labels["le"])
                acc[le] = acc.get(le, 0.0) + value
            elif name == f"{metric}_count":
                counts[metric] = counts.get(metric, 0.0) + value
            elif name == f"{metric}_sum":
                sums[metric] = sums.get(metric, 0.0) + value
    for metric, acc in by_series.items():
        hists[metric] = {
            "cum": sorted(acc.items()),
            "count": counts.get(metric, 0.0),
            "sum": sums.get(metric, 0.0),
        }
    counters: Dict[str, float] = {}
    for key, spec in _RATE_COUNTERS.items():
        cname, reasons = (
            spec if isinstance(spec, tuple) else (spec, None)
        )
        v = 0.0
        for name, labels, value in parsed["samples"]:
            if name != cname:
                continue
            if reasons is not None and not any(
                lv in reasons for lv in labels.values()
            ):
                continue
            v += value
        counters[key] = v
    return _eval_state(
        {"hists": hists, "counters": counters}, targets,
        breach_burn_rate=breach_burn_rate,
    )


# -- the znicz-slo CLI ------------------------------------------------------


def _fmt_ms(v: Optional[float]) -> str:
    return "-" if v is None else f"{1000.0 * v:.1f}"


def _render_table(snap: dict) -> str:
    rows = [
        (
            "target", "window", "n", "p50 ms", "p95 ms", "p99 ms",
            "bad %", "burn", "status",
        )
    ]
    for name, t in snap["targets"].items():
        for wname, ev in t["windows"].items():
            rows.append(
                (
                    f"{name}<{t['threshold_s']}s@{t['objective']:.0%}",
                    wname,
                    str(int(ev["n"])),
                    _fmt_ms(ev["p50_s"]),
                    _fmt_ms(ev["p95_s"]),
                    _fmt_ms(ev["p99_s"]),
                    f"{100.0 * ev['bad_frac']:.2f}",
                    f"{ev['burn_rate']:.2f}",
                    "BREACH" if t["breached"] else "ok",
                )
            )
    widths = [
        max(len(r[i]) for r in rows) for i in range(len(rows[0]))
    ]
    lines = [
        "  ".join(cell.ljust(w) for cell, w in zip(row, widths)).rstrip()
        for row in rows
    ]
    for wname, r in snap["rates"].items():
        lines.append(
            f"[{wname}] requests={int(r['requests'])} "
            f"errors={int(r['errors'])} sheds={int(r['sheds'])} "
            f"deadlines={int(r['deadlines'])} "
            f"error_rate={r['error_rate']:.4f} "
            f"shed_rate={r['shed_rate']:.4f}"
        )
    return "\n".join(lines)


def _read_source(src: str, timeout_s: float = 10.0) -> str:
    """A metrics source: a local ``metrics.prom`` path, or an http URL
    (an aggregator or serve endpoint; a bare ``http://host:port`` gets
    ``/metrics`` appended)."""
    if src.startswith("http://") or src.startswith("https://"):
        import urllib.parse
        import urllib.request

        parsed = urllib.parse.urlsplit(src)
        if parsed.path in ("", "/"):
            src = src.rstrip("/") + "/metrics"
        with urllib.request.urlopen(src, timeout=timeout_s) as resp:
            return resp.read().decode("utf-8")
    with open(src) as f:
        return f.read()


def main(argv=None) -> int:
    """``znicz-slo <metrics.prom|url> [--frontdoor] [--ttft S]
    [--latency S] [--objective F] [--burn-threshold F] [--json]`` —
    print the SLO table for one exposition; exit 1 when any target's
    burn rate breaches (the CI/bench gate), 2 on usage/read errors.
    ``--frontdoor`` judges the client-clock
    ``znicz_serve_frontdoor_*`` histograms (what ``/slo`` on a serving
    replica judges — a deep pending queue is invisible to the
    engine-clock defaults)."""
    args = list(sys.argv[1:] if argv is None else argv)
    opts = {
        "--ttft": 1.0, "--latency": 5.0, "--objective": 0.99,
        "--burn-threshold": 1.0,
    }
    as_json = "--json" in args
    if as_json:
        args.remove("--json")
    frontdoor = "--frontdoor" in args
    if frontdoor:
        args.remove("--frontdoor")
    positional: List[str] = []
    i = 0
    while i < len(args):
        if args[i] in opts:
            if i + 1 >= len(args):
                print(f"{args[i]} needs a value", file=sys.stderr)
                return 2
            try:
                opts[args[i]] = float(args[i + 1])
            except ValueError:
                print(
                    f"{args[i]}: not a number: {args[i + 1]!r}",
                    file=sys.stderr,
                )
                return 2
            i += 2
        else:
            positional.append(args[i])
            i += 1
    if len(positional) != 1:
        print(
            "usage: znicz-slo <metrics.prom | http://host:port[/metrics]>"
            " [--frontdoor] [--ttft S] [--latency S] [--objective F]"
            " [--burn-threshold F] [--json]",
            file=sys.stderr,
        )
        return 2
    metrics = FRONTDOOR_TARGETS if frontdoor else DEFAULT_TARGETS
    try:
        # inside the try: an out-of-range --objective/--ttft must be
        # the usage exit (2), never a traceback or a fake breach (1)
        targets = (
            SLOTarget(
                "ttft", metrics[0].metric,
                opts["--ttft"], opts["--objective"],
            ),
            SLOTarget(
                "latency", metrics[1].metric,
                opts["--latency"], opts["--objective"],
            ),
        )
        text = _read_source(positional[0])
        snap = evaluate_exposition(
            text, targets, breach_burn_rate=opts["--burn-threshold"]
        )
    except (OSError, ValueError) as exc:
        print(f"znicz-slo: {exc}", file=sys.stderr)
        return 2
    print(json.dumps(snap, indent=2) if as_json else _render_table(snap))
    return 1 if snap["breached"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
