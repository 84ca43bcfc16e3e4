"""Fleet metrics aggregation: slaves push, the master merges (port of
``znicz_tpu/observability/aggregate.py``: the same names, wire format and
merged text, so the JAX package's pushers and this one feed either
aggregator).

The registry is process-wide; a fleet is many processes — a training
job plus N serving replicas — and a router schedules against the FLEET
view, not any one process's.  This module is that view, reviving the paper's master–slave
lineage (SURVEY §3.4, ``apply_data_from_slave``) as an observability
control plane in the shape Prometheus pushgateway / OpenTelemetry
collectors standardized:

* :class:`MetricsAggregator` — holds the latest registry snapshot per
  ``instance`` (each push carries its own TTL; instances that stop
  pushing expire out of the merged view), and merges live instances
  into ONE fleet-wide snapshot: counters and gauges SUM per label-set
  (right for this repo's additive-occupancy gauges — pending, inflight,
  pool blocks; age/ratio-shaped gauges do not belong in a summed fleet
  view), histograms merge BUCKET-WISE on
  the shared ladder (cumulative counts add per ``le`` edge, so the
  merged exposition keeps the histogram invariants and quantiles stay
  computable).
* :func:`build_aggregator_server` — the HTTP surface: ``POST /push``
  (JSON registry snapshot, or Prometheus text with an instance tag),
  ``GET /metrics`` / ``/metrics.json`` (the merged fleet view, same two
  formats every other surface in this repo speaks), ``GET /instances``
  (who is pushing, how stale), ``GET /healthz``.
* :class:`MetricsPusher` — the slave side: a bounded background thread
  POSTing the local registry's snapshot every ``interval_s``, every
  network call timeout-bounded, failures counted and logged but NEVER
  raised into the host process (a dead aggregator must not hurt
  serving).  Fault-injectable at ``pusher.push``
  (:mod:`znicz_tpu_torch.utils.faults`).  Wired into
  :class:`~znicz_tpu_torch.services.frontdoor.ServingFrontDoor`, so N
  serving replicas land in one scrape.

Pure stdlib, like the rest of :mod:`znicz_tpu_torch.observability` (the
aggregator typically runs on a host with no accelerator stack at all).
"""

from __future__ import annotations

import http.client
import http.server
import json
import logging
import os
import socket
import threading
import time
import urllib.parse
from typing import Dict, List, Optional, Tuple

from znicz_tpu_torch.observability.registry import (
    MetricsRegistry,
    _fmt_value,
    _sample,
    get_registry,
    parse_prometheus_text,
    quantile_from_cumulative,
)
from znicz_tpu_torch.utils import faults

logger = logging.getLogger(__name__)

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# kinds the merge understands; "untyped" degrades to gauge, "summary"
# families are skipped (this repo never emits them)
_MERGEABLE = ("counter", "gauge", "histogram")

# the aggregator's OWN health families, appended fresh to every merged
# view.  A pushed snapshot that carries them (an aggregator's merged
# /metrics federated into a higher tier) would otherwise be summed in
# and then silently overwritten by the local values — drop them at
# canon time instead, so only this aggregator ever speaks these names
_SELF_FAMILIES = (
    "znicz_aggregator_instances",
    "znicz_aggregator_pushes_total",
    "znicz_aggregator_merge_conflicts",
)


def _norm_le(key) -> str:
    """Canonical bucket-edge key: ``"1.0"`` and ``"1"`` (and the float
    1.0) all merge into one edge, ``"+Inf"`` stays ``"+Inf"``."""
    return _fmt_value(float(key))


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _canon_snapshot(snapshot: dict) -> dict:
    """Registry-``snapshot()``-shaped dict -> the aggregator's canonical
    per-instance form: ``{name: {"type", "help", "series":
    {label_key: series_dict}}}`` with normalized bucket keys.  Raises
    ``ValueError`` on a malformed push — the HTTP layer answers 400, a
    broken pusher must not poison the fleet view."""
    out: dict = {}
    if not isinstance(snapshot, dict):
        raise ValueError("snapshot must be a dict of metric families")
    for name, fam in snapshot.items():
        if name in _SELF_FAMILIES:
            continue  # another aggregator's self-series: never merged
        if not isinstance(fam, dict):
            raise ValueError(f"family {name!r}: want a dict with 'series'")
        kind = fam.get("type", "gauge")
        if kind == "untyped":
            kind = "gauge"
        if kind not in _MERGEABLE:
            # summaries and self-describing side entries (bench's
            # {"type": "slo", ...} rides next to the metric families):
            # not mergeable — skip them, don't 400 the whole push
            continue
        if "series" not in fam:
            raise ValueError(f"family {name!r}: want a dict with 'series'")
        series: dict = {}
        for s in fam["series"]:
            if not isinstance(s, dict):
                raise ValueError(
                    f"family {name!r}: series entries must be objects"
                )
            labels = dict(s.get("labels") or {})
            key = _label_key(labels)
            if kind == "histogram":
                try:
                    buckets = {
                        _norm_le(le): float(c)
                        for le, c in dict(s["buckets"]).items()
                    }
                    series[key] = {
                        "labels": labels,
                        "count": float(s["count"]),
                        "sum": float(s["sum"]),
                        "buckets": buckets,
                    }
                except (KeyError, TypeError, ValueError) as exc:
                    raise ValueError(
                        f"family {name!r}: malformed histogram series: "
                        f"{exc}"
                    ) from exc
            else:
                try:
                    series[key] = {
                        "labels": labels, "value": float(s["value"])
                    }
                except (KeyError, TypeError, ValueError) as exc:
                    raise ValueError(
                        f"family {name!r}: malformed series: {exc}"
                    ) from exc
        out[name] = {
            "type": kind, "help": str(fam.get("help", "")),
            "series": series,
        }
    return out


def _canon_prom_text(text: str) -> dict:
    """Prometheus text exposition -> the same canonical form (so a
    pusher may POST either its JSON snapshot or its ``/metrics`` body).
    Histogram families are reassembled from their ``_bucket`` /
    ``_sum`` / ``_count`` samples."""
    parsed = parse_prometheus_text(text)  # raises ValueError when bad
    types, helps = parsed["types"], parsed["helps"]
    hist = {n for n, k in types.items() if k == "histogram"}
    out: dict = {}

    def fam_for(base: str) -> dict:
        kind = types.get(base, "gauge")
        if kind == "untyped":
            kind = "gauge"
        return out.setdefault(
            base,
            {"type": kind, "help": helps.get(base, ""), "series": {}},
        )

    for name, labels, value in parsed["samples"]:
        base, role = name, None
        for h in hist:
            if name == f"{h}_bucket":
                base, role = h, "bucket"
            elif name == f"{h}_sum":
                base, role = h, "sum"
            elif name == f"{h}_count":
                base, role = h, "count"
            else:
                continue
            break
        kind = types.get(base, "gauge")
        if kind not in _MERGEABLE and kind != "untyped":
            continue
        if base in _SELF_FAMILIES:
            continue  # another aggregator's self-series: never merged
        fam = fam_for(base)
        if role is not None:
            key = _label_key(
                {k: v for k, v in labels.items() if k != "le"}
            )
            ser = fam["series"].setdefault(
                key,
                {
                    "labels": {
                        k: v for k, v in labels.items() if k != "le"
                    },
                    "count": 0.0, "sum": 0.0, "buckets": {},
                },
            )
            if role == "bucket":
                ser["buckets"][_norm_le(labels["le"])] = float(value)
            else:
                ser[role] = float(value)
        else:
            fam["series"][_label_key(labels)] = {
                "labels": dict(labels), "value": float(value)
            }
    return out


def series_value(
    families: Optional[dict],
    name: str,
    labels: Optional[Dict[str, str]] = None,
) -> Optional[float]:
    """Counter/gauge series value out of a canonicalized families dict
    (as returned by :meth:`MetricsAggregator.instance_families`); None
    when the family/series is absent or is a histogram."""
    if families is None:
        return None
    fam = families.get(name)
    if fam is None or fam.get("type") == "histogram":
        return None
    ser = fam["series"].get(_label_key(dict(labels or {})))
    if ser is None:
        return None
    return float(ser["value"])


def _cumulative_pairs(buckets: Dict[str, float]) -> List[Tuple[float, float]]:
    return sorted(
        ((float(le), float(c)) for le, c in buckets.items()),
        key=lambda p: p[0],
    )


class _Instance:
    __slots__ = ("families", "pushed_at", "ttl_s", "pushes")

    def __init__(self, families: dict, ttl_s: float, now: float):
        self.families = families
        self.pushed_at = now
        self.ttl_s = ttl_s
        self.pushes = 1


class MetricsAggregator:
    """Thread-safe last-push-wins store of per-instance registry
    snapshots with a merged fleet view.

    Each push REPLACES that instance's snapshot (the registries are
    cumulative — the latest snapshot is the whole story), carries its
    own TTL (default ``default_ttl_s``), and an instance whose TTL
    lapses silently leaves the merged view — a crashed replica stops
    counting without ever unwinding anything."""

    def __init__(self, *, default_ttl_s: float = 60.0):
        if default_ttl_s <= 0:
            raise ValueError(
                f"want default_ttl_s > 0; got {default_ttl_s}"
            )
        self.default_ttl_s = float(default_ttl_s)
        self._lock = threading.Lock()
        self._instances: Dict[str, _Instance] = {}
        self._n_pushes = 0

    # -- intake ------------------------------------------------------------

    def push(
        self,
        instance: str,
        snapshot: Optional[dict] = None,
        *,
        text: Optional[str] = None,
        ttl_s: Optional[float] = None,
        now: Optional[float] = None,
    ) -> None:
        """Record one push for ``instance`` — exactly one of
        ``snapshot`` (registry ``snapshot()`` dict) or ``text``
        (Prometheus exposition).  Raises ``ValueError`` on malformed
        input; never partially applies."""
        if not instance:
            raise ValueError("push needs a non-empty instance name")
        if (snapshot is None) == (text is None):
            raise ValueError("push wants exactly one of snapshot= or text=")
        families = (
            _canon_snapshot(snapshot)
            if snapshot is not None
            else _canon_prom_text(text)
        )
        ttl = float(ttl_s) if ttl_s is not None else self.default_ttl_s
        if ttl <= 0:
            raise ValueError(f"want ttl_s > 0; got {ttl}")
        t = time.monotonic() if now is None else now
        with self._lock:
            prev = self._instances.get(str(instance))
            inst = _Instance(families, ttl, t)
            if prev is not None:
                inst.pushes = prev.pushes + 1
            self._instances[str(instance)] = inst
            self._n_pushes += 1

    def forget(self, instance: str) -> bool:
        """Drop ``instance`` immediately (an orderly replica shutdown
        need not wait for its TTL)."""
        with self._lock:
            return self._instances.pop(str(instance), None) is not None

    # -- views -------------------------------------------------------------

    def _live(self, now: Optional[float]) -> Dict[str, _Instance]:
        t = time.monotonic() if now is None else now
        with self._lock:
            stale = [
                name for name, inst in self._instances.items()
                if t - inst.pushed_at > inst.ttl_s
            ]
            for name in stale:
                del self._instances[name]
            return dict(self._instances)

    def instances(self, now: Optional[float] = None) -> List[dict]:
        """Live pushers: name, seconds since last push, TTL, push count."""
        t = time.monotonic() if now is None else now
        return [
            {
                "instance": name,
                "age_s": round(t - inst.pushed_at, 3),
                "ttl_s": inst.ttl_s,
                "pushes": inst.pushes,
            }
            for name, inst in sorted(self._live(now).items())
        ]

    def instance_families(
        self, instance: str, now: Optional[float] = None
    ) -> Optional[dict]:
        """ONE live instance's canonicalized families dict (None when
        unknown/stale).  Treat as read-only; extract series with
        :func:`series_value`.  One staleness sweep + lock acquisition
        buys every per-instance read a caller needs — the cluster
        router reads five load series per replica per routing
        decision through this."""
        inst = self._live(now).get(str(instance))
        return None if inst is None else inst.families

    def instance_value(
        self,
        instance: str,
        name: str,
        labels: Optional[Dict[str, str]] = None,
        now: Optional[float] = None,
    ) -> Optional[float]:
        """ONE instance's latest counter/gauge series value, or None
        when the instance is unknown/stale, the family absent, or the
        series is a histogram.  The merged view sums across instances,
        which is exactly the wrong shape for picking between them."""
        return series_value(
            self.instance_families(instance, now), name, labels
        )

    def merged_snapshot(self, now: Optional[float] = None) -> dict:
        """The fleet view in registry-``snapshot()`` shape: counters and
        gauges summed per label-set across live instances, histograms
        merged bucket-wise (same ladder; a series whose ladder disagrees
        with the already-merged one is SKIPPED and tallied as a
        conflict, never silently mis-summed), with p50/p95/p99
        re-interpolated from the merged cumulative buckets."""
        live = self._live(now)
        merged: dict = {}
        conflicts = 0
        for inst_name in sorted(live):
            for name, fam in live[inst_name].families.items():
                m = merged.get(name)
                if m is None:
                    m = merged[name] = {
                        "type": fam["type"], "help": fam["help"],
                        "series": {},
                    }
                elif m["type"] != fam["type"]:
                    conflicts += 1
                    logger.warning(
                        "aggregator: %s is %s on %s but %s in the "
                        "merged view; skipping that instance's family",
                        name, fam["type"], inst_name, m["type"],
                    )
                    continue
                for key, ser in fam["series"].items():
                    cur = m["series"].get(key)
                    if m["type"] == "histogram":
                        if cur is None:
                            m["series"][key] = {
                                "labels": dict(ser["labels"]),
                                "count": ser["count"],
                                "sum": ser["sum"],
                                "buckets": dict(ser["buckets"]),
                            }
                        elif set(cur["buckets"]) != set(ser["buckets"]):
                            conflicts += 1
                            logger.warning(
                                "aggregator: %s bucket ladder from %s "
                                "does not match the merged ladder; "
                                "skipping that series", name, inst_name,
                            )
                        else:
                            cur["count"] += ser["count"]
                            cur["sum"] += ser["sum"]
                            for le in cur["buckets"]:
                                cur["buckets"][le] += ser["buckets"][le]
                    else:
                        if cur is None:
                            m["series"][key] = {
                                "labels": dict(ser["labels"]),
                                "value": ser["value"],
                            }
                        else:
                            cur["value"] += ser["value"]
        with self._lock:
            n_pushes = self._n_pushes
        out: dict = {}
        for name in sorted(merged):
            fam = merged[name]
            series = []
            for key in sorted(fam["series"]):
                ser = fam["series"][key]
                if fam["type"] == "histogram":
                    cum = _cumulative_pairs(ser["buckets"])
                    series.append(
                        {
                            "labels": ser["labels"],
                            "count": ser["count"],
                            "sum": ser["sum"],
                            "buckets": {
                                _fmt_value(u): c for u, c in cum
                            },
                            "p50": quantile_from_cumulative(cum, 0.5),
                            "p95": quantile_from_cumulative(cum, 0.95),
                            "p99": quantile_from_cumulative(cum, 0.99),
                        }
                    )
                else:
                    series.append(
                        {"labels": ser["labels"], "value": ser["value"]}
                    )
            out[name] = {
                "type": fam["type"], "help": fam["help"],
                "series": series,
            }
        # the aggregator's own health, visible in the same scrape
        out["znicz_aggregator_instances"] = {
            "type": "gauge",
            "help": "live (unexpired) instances in the fleet view",
            "series": [{"labels": {}, "value": float(len(live))}],
        }
        out["znicz_aggregator_pushes_total"] = {
            "type": "counter",
            "help": "snapshot pushes accepted since aggregator start",
            "series": [{"labels": {}, "value": float(n_pushes)}],
        }
        # a GAUGE of the current view, not a counter: the conflict set
        # is recomputed per merge from the live instances, and reads
        # must not mutate state (a counter here would scale with
        # scrape frequency, not with pushes)
        out["znicz_aggregator_merge_conflicts"] = {
            "type": "gauge",
            "help": (
                "series skipped in this merged view "
                "(kind or ladder mismatch)"
            ),
            "series": [{"labels": {}, "value": float(conflicts)}],
        }
        return out

    def prometheus_text(self, now: Optional[float] = None) -> str:
        """The merged fleet view as a parse-clean text exposition
        (format 0.0.4) — what a real Prometheus scrapes off this
        service, and what :func:`parse_prometheus_text` round-trips in
        the tier-1 acceptance test."""
        lines: List[str] = []
        for name, fam in self.merged_snapshot(now).items():
            if fam["help"]:
                lines.append(f"# HELP {name} {fam['help']}")
            lines.append(f"# TYPE {name} {fam['type']}")
            for ser in fam["series"]:
                base = sorted(ser["labels"].items())
                if fam["type"] == "histogram":
                    for upper, acc in _cumulative_pairs(ser["buckets"]):
                        lines.append(
                            _sample(
                                f"{name}_bucket",
                                base + [("le", _fmt_value(upper))],
                                acc,
                            )
                        )
                    lines.append(_sample(f"{name}_sum", base, ser["sum"]))
                    lines.append(
                        _sample(f"{name}_count", base, ser["count"])
                    )
                else:
                    lines.append(_sample(name, base, ser["value"]))
        return "\n".join(lines) + "\n"


# -- the HTTP surface -------------------------------------------------------


class AggregatorRequestHandler(http.server.BaseHTTPRequestHandler):
    """``POST /push`` + the merged read endpoints.  Every response
    carries an explicit Content-Length (no streaming here)."""

    protocol_version = "HTTP/1.1"
    aggregator: MetricsAggregator  # set by build_aggregator_server

    def log_message(self, fmt, *args):  # noqa: A003 — http.server API
        logger.debug("aggregator http: " + fmt, *args)

    def do_GET(self):  # noqa: N802 — http.server API
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            self._send(
                self.aggregator.prometheus_text().encode(),
                PROM_CONTENT_TYPE,
            )
        elif path == "/metrics.json":
            self._send_json(self.aggregator.merged_snapshot())
        elif path == "/instances":
            inst = self.aggregator.instances()
            self._send_json({"instances": inst, "live": len(inst)})
        elif path == "/healthz":
            self._send(b"ok\n", "text/plain")
        else:
            self._send_json({"error": "unknown endpoint"}, status=404)

    def do_POST(self):  # noqa: N802 — http.server API
        path, _, query = self.path.partition("?")
        if path != "/push":
            self._send_json({"error": "unknown endpoint"}, status=404)
            return
        qs = urllib.parse.parse_qs(query)
        try:
            n = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(n)
            ctype = (self.headers.get("Content-Type") or "").split(";")[0]
            ttl_raw = (
                qs.get("ttl_s", [None])[0]
                or self.headers.get("X-Znicz-Ttl")
            )
            ttl_s = float(ttl_raw) if ttl_raw is not None else None
            if ctype == "application/json":
                payload = json.loads(body or b"{}")
                if not isinstance(payload, dict):
                    raise ValueError("JSON push body must be an object")
                instance = payload.get("instance")
                if not instance:
                    raise ValueError("JSON push needs an 'instance' key")
                if payload.get("ttl_s") is not None:
                    ttl_s = float(payload["ttl_s"])
                self.aggregator.push(
                    instance, payload.get("snapshot"), ttl_s=ttl_s
                )
            else:  # Prometheus text: instance rides query/header
                instance = (
                    qs.get("instance", [None])[0]
                    or self.headers.get("X-Znicz-Instance")
                )
                if not instance:
                    raise ValueError(
                        "text push needs ?instance= or X-Znicz-Instance"
                    )
                self.aggregator.push(
                    instance, text=body.decode("utf-8"), ttl_s=ttl_s
                )
        except (ValueError, TypeError, UnicodeDecodeError) as exc:
            self._send_json(
                {"error": "bad_push", "detail": str(exc)}, status=400
            )
            return
        self._send_json(
            {"ok": True, "live": len(self.aggregator.instances())}
        )

    def _send_json(self, obj: dict, status: int = 200) -> None:
        self._send(
            (json.dumps(obj) + "\n").encode(), "application/json",
            status=status,
        )

    def _send(self, body: bytes, content_type: str, status: int = 200):
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def build_aggregator_server(
    aggregator: Optional[MetricsAggregator] = None,
    port: int = 9109,
    host: str = "127.0.0.1",
) -> http.server.ThreadingHTTPServer:
    """A ready-to-serve aggregator; ``port=0`` binds ephemeral (read it
    back from ``server.server_address``).  The aggregator instance is
    reachable as ``server.aggregator``."""
    agg = aggregator if aggregator is not None else MetricsAggregator()
    handler = type(
        "BoundAggregatorHandler",
        (AggregatorRequestHandler,),
        {"aggregator": agg},
    )
    server = http.server.ThreadingHTTPServer((host, port), handler)
    server.aggregator = agg
    return server


def main(argv=None) -> int:
    """``python -m znicz_tpu_torch.observability.aggregate [port] [host]`` —
    run a standalone fleet aggregator (loopback by default)."""
    import sys

    args = list(sys.argv[1:] if argv is None else argv)
    port = int(args[0]) if args else 9109
    host = args[1] if len(args) > 1 else "127.0.0.1"
    server = build_aggregator_server(port=port, host=host)
    host, port = server.server_address[:2]
    print(
        f"znicz metrics aggregator on http://{host}:{port} "
        "(push to /push, scrape /metrics, roster at /instances)"
    )
    server.serve_forever()
    return 0


# -- the slave side ---------------------------------------------------------


class MetricsPusher:
    """Background registry pusher: POST the local registry snapshot to
    an aggregator every ``interval_s``, each attempt bounded by
    ``timeout_s`` and advertised with ``ttl_s = ttl_factor *
    interval_s`` (miss a few pushes and the fleet view forgets you).

    Failures never propagate: a dead aggregator costs one log line and
    a counter tick, not a serving thread.  ``push_now()`` is the
    synchronous hook (StatusWriter calls it per epoch so the view is
    epoch-fresh; tests drive it directly).  The ``pusher.push`` fault
    point makes the failure path deterministic in CI."""

    def __init__(
        self,
        url: str,
        *,
        instance: Optional[str] = None,
        interval_s: float = 15.0,
        registry: Optional[MetricsRegistry] = None,
        timeout_s: float = 5.0,
        ttl_factor: float = 3.0,
    ):
        if interval_s <= 0:
            raise ValueError(f"want interval_s > 0; got {interval_s}")
        parsed = urllib.parse.urlsplit(url)
        if parsed.scheme != "http" or not parsed.hostname:
            raise ValueError(
                f"want an http://host:port aggregator url; got {url!r}"
            )
        self.host = parsed.hostname
        self.port = parsed.port or 80
        base = parsed.path.rstrip("/")
        self.path = base + "/push" if not base.endswith("/push") else base
        self.instance = (
            instance
            if instance
            else f"{socket.gethostname()}-{os.getpid()}"
        )
        self.interval_s = float(interval_s)
        self.timeout_s = float(timeout_s)
        self.ttl_s = float(ttl_factor) * self.interval_s
        self._registry = registry if registry is not None else get_registry()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.pushes_ok = 0
        self.pushes_failed = 0
        self._m_pushes = self._registry.counter(
            "znicz_pusher_pushes_total",
            "aggregator pushes attempted by this process, by outcome",
            ("status",),
        )
        # push lag: seconds since the last SUCCESSFUL push, stamped at
        # each attempt BEFORE the snapshot is taken — so the pushed
        # snapshot itself carries how stale the previous one was, and a
        # silently wedged/failing pusher is visible from the fleet view
        # the moment any push lands again (a fully dead pusher shows as
        # /instances age_s instead)
        self._m_lag = self._registry.gauge(
            "znicz_pusher_lag_seconds",
            "seconds since this process's last successful aggregator "
            "push, as of its most recent attempt",
        )
        self._last_ok: Optional[float] = None

    def start(self) -> "MetricsPusher":
        """Start the background push loop (idempotent)."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        # _loop only calls push_now, whose contract is "never raises"
        # (every failure is caught, counted and logged inside it)
        self._thread = threading.Thread(  # znicz-check: disable=ZNC013
            target=self._loop,
            name=f"znicz-pusher-{self.instance}",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self, timeout: Optional[float] = None) -> None:
        """Stop the loop; the thread makes one final flush push (so the
        last snapshot before shutdown lands) before exiting.  Bounded:
        the flush itself is timeout-bounded, and the join waits at most
        ``timeout`` (default: push timeout + 2 intervals)."""
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(
                timeout=(
                    timeout
                    if timeout is not None
                    else self.timeout_s + 2 * self.interval_s
                )
            )

    def __enter__(self) -> "MetricsPusher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _loop(self) -> None:
        while not self._stop.wait(timeout=self.interval_s):
            self.push_now()
        self.push_now()  # final flush: the shutdown-instant snapshot

    def push_now(self) -> bool:
        """One synchronous, bounded push; True on 2xx.  Never raises."""
        now = time.monotonic()
        self._m_lag.set(
            round(now - self._last_ok, 3)
            if self._last_ok is not None
            else 0.0
        )
        try:
            faults.fire("pusher.push")
            body = json.dumps(
                {
                    "instance": self.instance,
                    "ttl_s": self.ttl_s,
                    "snapshot": self._registry.snapshot(),
                }
            ).encode()
            conn = http.client.HTTPConnection(
                self.host, self.port, timeout=self.timeout_s
            )
            try:
                conn.request(
                    "POST", self.path, body=body,
                    headers={"Content-Type": "application/json"},
                )
                resp = conn.getresponse()
                resp.read()
                ok = 200 <= resp.status < 300
            finally:
                conn.close()
        except Exception as exc:
            self.pushes_failed += 1
            self._m_pushes.labels(status="error").inc()
            logger.debug(
                "metrics push to %s:%s failed: %s",
                self.host, self.port, exc,
            )
            return False
        if ok:
            self.pushes_ok += 1
            self._last_ok = time.monotonic()
            self._m_pushes.labels(status="ok").inc()
        else:
            self.pushes_failed += 1
            self._m_pushes.labels(status="error").inc()
            logger.debug(
                "metrics push to %s:%s rejected: HTTP %s",
                self.host, self.port, resp.status,
            )
        return ok


if __name__ == "__main__":
    raise SystemExit(main())
