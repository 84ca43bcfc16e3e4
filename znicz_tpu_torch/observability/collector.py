"""Fleet trace collection: spans push, the master merges the timeline
(port of ``znicz_tpu/observability/collector.py``, the same names and
wire format).

:mod:`aggregate` gives the fleet ONE metrics view; traces stay
per-process — the router, each replica and the engine each stream their
own Chrome-trace file with no shared clock, so following one request
across a failover meant eyeballing three files.  This module is the
tracing twin of the aggregator, same master–slave shape (SURVEY §3.4):

* :class:`TracePusher` — the slave side: drains a BOUNDED sink off the
  process tracer and POSTs span batches to a collector every
  ``interval_s``; every call timeout-bounded, failures counted and
  logged but NEVER raised (a dead collector must not hurt serving),
  final flush on :meth:`TracePusher.stop`.  Fault-injectable at
  ``trace_pusher.push``.
* :class:`TraceCollector` — holds the latest span window per instance
  (bounded per-instance ring; each push carries its own TTL, stale
  instances expire out of the merged view) and merges live instances
  into ONE Perfetto-loadable Chrome trace: ``GET /trace`` returns
  ``{"traceEvents": [...]}`` with **pid = instance** (a
  ``process_name`` metadata event per instance) and every instance's
  timestamps REBASED onto a shared wall-clock epoch — so a single
  trace-id filter shows a request's full life across the router hop,
  replica queue/prefill/decode, failover re-routes and preemptions.
* :func:`build_collector_server` — the HTTP surface: ``POST /push``,
  ``GET /trace`` (``?trace_id=`` filters server-side), ``GET
  /instances`` (who is pushing, how stale), ``GET /healthz``.

Instance attribution is per-EVENT first: an event whose ``args``
carry an ``instance`` tag (the engine/front door/router stamp their
spans; :meth:`~znicz_tpu_torch.observability.tracing.Tracer.set_instance`
sets a process default) groups under that tag; untagged events fall
back to the push envelope's instance.  One process hosting several
logical instances (an in-process test fleet, a router beside a
replica) therefore still splits into per-instance tracks.

Pure stdlib, like the rest of :mod:`znicz_tpu_torch.observability`.
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
from collections import deque
from typing import Dict, List, Optional

from znicz_tpu_torch.observability.registry import get_registry
from znicz_tpu_torch.observability.tracing import Tracer, get_tracer
from znicz_tpu_torch.utils import faults

logger = logging.getLogger(__name__)

# per-instance span window: big enough for minutes of serving traffic,
# small enough that a runaway pusher cannot OOM the collector
DEFAULT_MAX_EVENTS_PER_INSTANCE = 200_000


class _TraceInstance:
    __slots__ = (
        "events", "pushed_at", "ttl_s", "pushes", "epoch_us", "dropped"
    )

    def __init__(self, maxlen: int, ttl_s: float, now: float):
        self.events: deque = deque(maxlen=maxlen)
        self.pushed_at = now
        self.ttl_s = ttl_s
        self.pushes = 0
        self.epoch_us: Optional[float] = None
        self.dropped = 0


def _id_matches(value, trace_id: str) -> bool:
    """Exact id match, plus the front door's live-collision spelling:
    a duplicate inbound id is adopted as ``<id>-r<digits>``
    (``ServingFrontDoor._mint_id``), and the filter must keep that
    request's lifecycle visible under the client's original id.  The
    suffix must be all digits — a DIFFERENT client-chosen id that
    merely starts with ``<id>-r`` (``batch`` vs ``batch-run2``) must
    not pollute the filtered timeline."""
    if value == trace_id:
        return True
    if not isinstance(value, str) or not value.startswith(
        trace_id + "-r"
    ):
        return False
    suffix = value[len(trace_id) + 2:]
    return bool(suffix) and suffix.isdigit()


def _event_matches(ev: dict, trace_id: str) -> bool:
    """One trace-id filter over the span-arg conventions the repo
    emits: engine spans carry ``trace``, front-door instants ``id``,
    batched decode chunks a comma-joined ``traces`` list."""
    args = ev.get("args") or {}
    if _id_matches(args.get("trace"), trace_id) or _id_matches(
        args.get("id"), trace_id
    ):
        return True
    traces = args.get("traces")
    return isinstance(traces, str) and any(
        _id_matches(tok, trace_id) for tok in traces.split(",")
    )


class TraceCollector:
    """Thread-safe per-instance span store with a merged fleet trace.

    Each push APPENDS to that instance's bounded event window (spans
    are deltas, unlike registry snapshots — the latest push is NOT the
    whole story) and refreshes its TTL; an instance whose TTL lapses
    silently leaves the merged view.  ``epoch_us`` (wall-clock of the
    pushing tracer's ``ts=0``) rides the envelope so instances land on
    one shared timeline."""

    def __init__(
        self,
        *,
        default_ttl_s: float = 60.0,
        max_events_per_instance: int = DEFAULT_MAX_EVENTS_PER_INSTANCE,
    ):
        if default_ttl_s <= 0:
            raise ValueError(
                f"want default_ttl_s > 0; got {default_ttl_s}"
            )
        if max_events_per_instance < 1:
            raise ValueError(
                "want max_events_per_instance >= 1; got "
                f"{max_events_per_instance}"
            )
        self.default_ttl_s = float(default_ttl_s)
        self.max_events_per_instance = int(max_events_per_instance)
        self._lock = threading.Lock()
        self._instances: Dict[str, _TraceInstance] = {}
        self._n_pushes = 0
        reg = get_registry()
        self._m_pushes = reg.counter(
            "znicz_trace_collector_pushes_total",
            "span-batch pushes accepted by this collector",
        )
        self._m_events = reg.counter(
            "znicz_trace_collector_events_total",
            "span events accepted by this collector",
        )

    # -- intake ------------------------------------------------------------

    def push(
        self,
        instance: str,
        events: List[dict],
        *,
        ttl_s: Optional[float] = None,
        epoch_us: Optional[float] = None,
        now: Optional[float] = None,
    ) -> int:
        """Record one span batch for ``instance``; returns the events
        accepted.  Raises ``ValueError`` on malformed input (the HTTP
        layer answers 400 — a broken pusher must not poison the merged
        trace)."""
        if not instance:
            raise ValueError("push needs a non-empty instance name")
        if not isinstance(events, list) or any(
            not isinstance(ev, dict) for ev in events
        ):
            raise ValueError("events must be a list of trace-event dicts")
        ttl = float(ttl_s) if ttl_s is not None else self.default_ttl_s
        if ttl <= 0:
            raise ValueError(f"want ttl_s > 0; got {ttl}")
        if epoch_us is not None:
            epoch_us = float(epoch_us)
        t = time.monotonic() if now is None else now
        with self._lock:
            inst = self._instances.get(str(instance))
            if inst is None:
                inst = self._instances[str(instance)] = _TraceInstance(
                    self.max_events_per_instance, ttl, t
                )
            before = len(inst.events)
            inst.events.extend(events)
            overflow = before + len(events) - len(inst.events)
            if overflow > 0:
                inst.dropped += overflow
            inst.pushed_at = t
            inst.ttl_s = ttl
            inst.pushes += 1
            if epoch_us is not None:
                inst.epoch_us = epoch_us
            self._n_pushes += 1
        self._m_pushes.inc()
        self._m_events.inc(len(events))
        return len(events)

    def forget(self, instance: str) -> bool:
        """Drop ``instance`` immediately (orderly shutdown need not
        wait for its TTL)."""
        with self._lock:
            return self._instances.pop(str(instance), None) is not None

    # -- views -------------------------------------------------------------

    def _live(self, now: Optional[float]) -> Dict[str, _TraceInstance]:
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
        """Live pushers: name, seconds since last push, TTL, push and
        event counts, window drops."""
        t = time.monotonic() if now is None else now
        return [
            {
                "instance": name,
                "age_s": round(t - inst.pushed_at, 3),
                "ttl_s": inst.ttl_s,
                "pushes": inst.pushes,
                "events": len(inst.events),
                "dropped": inst.dropped,
            }
            for name, inst in sorted(self._live(now).items())
        ]

    def merged_trace(
        self,
        trace_id: Optional[str] = None,
        now: Optional[float] = None,
    ) -> dict:
        """ONE Chrome-trace JSON object over every live instance —
        load it straight into Perfetto.  ``pid`` is a stable small int
        per instance tag (``process_name`` metadata names it), ``ts``
        is rebased per instance onto the earliest live epoch so the
        timeline is shared, and ``trace_id`` (when given) filters to
        the spans of one request before the events leave the
        collector."""
        live = self._live(now)
        # copy each window UNDER the lock: a concurrent push()'s
        # extend (which also pops left past maxlen) would otherwise
        # blow up this iteration exactly when the fleet is busiest
        with self._lock:
            windows = {
                name: list(inst.events) for name, inst in live.items()
            }
        epochs = [
            inst.epoch_us for inst in live.values()
            if inst.epoch_us is not None
        ]
        base = min(epochs) if epochs else 0.0
        # pass 1: gather (tag, rebased event) so pid assignment is
        # deterministic (sorted tags), whatever the push order was
        tagged: List = []
        tags = set()
        for name in sorted(live):
            inst = live[name]
            offset = (
                inst.epoch_us - base if inst.epoch_us is not None else 0.0
            )
            for ev in windows[name]:
                if trace_id is not None and not _event_matches(
                    ev, trace_id
                ):
                    continue
                tag = (ev.get("args") or {}).get("instance") or name
                tags.add(tag)
                out = dict(ev)
                if "ts" in out:
                    out["ts"] = round(float(out["ts"]) + offset, 3)
                tagged.append((tag, out))
        pid_of = {tag: i + 1 for i, tag in enumerate(sorted(tags))}
        events = [
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "args": {"name": tag},
            }
            for tag, pid in sorted(pid_of.items())
        ]
        for tag, ev in tagged:
            ev["pid"] = pid_of[tag]
            events.append(ev)
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "instances": sorted(pid_of),
        }


# -- the HTTP surface -------------------------------------------------------


class CollectorRequestHandler(http.server.BaseHTTPRequestHandler):
    """``POST /push`` + the merged trace endpoints; explicit
    Content-Length on every response (no streaming here)."""

    protocol_version = "HTTP/1.1"
    collector: TraceCollector  # set by build_collector_server

    def log_message(self, fmt, *args):  # noqa: A003 — http.server API
        logger.debug("collector http: " + fmt, *args)

    def do_GET(self):  # noqa: N802 — http.server API
        path, _, query = self.path.partition("?")
        if path == "/trace":
            qs = urllib.parse.parse_qs(query)
            trace_id = qs.get("trace_id", [None])[0]
            self._send_json(self.collector.merged_trace(trace_id))
        elif path == "/instances":
            inst = self.collector.instances()
            self._send_json({"instances": inst, "live": len(inst)})
        elif path == "/healthz":
            self._send(b"ok\n", "text/plain")
        else:
            self._send_json({"error": "unknown endpoint"}, status=404)

    def do_POST(self):  # noqa: N802 — http.server API
        path = self.path.split("?", 1)[0]
        if path != "/push":
            self._send_json({"error": "unknown endpoint"}, status=404)
            return
        try:
            n = int(self.headers.get("Content-Length") or 0)
            payload = json.loads(self.rfile.read(n) or b"{}")
            if not isinstance(payload, dict):
                raise ValueError("push body must be a JSON object")
            instance = payload.get("instance")
            if not instance:
                raise ValueError("push needs an 'instance' key")
            accepted = self.collector.push(
                instance,
                payload.get("events") or [],
                ttl_s=payload.get("ttl_s"),
                epoch_us=payload.get("epoch_us"),
            )
        except (ValueError, TypeError, UnicodeDecodeError) as exc:
            self._send_json(
                {"error": "bad_push", "detail": str(exc)}, status=400
            )
            return
        self._send_json({"ok": True, "accepted": accepted})

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


def build_collector_server(
    collector: Optional[TraceCollector] = None,
    port: int = 9110,
    host: str = "127.0.0.1",
) -> http.server.ThreadingHTTPServer:
    """A ready-to-serve trace collector; ``port=0`` binds ephemeral
    (read it back from ``server.server_address``).  The collector is
    reachable as ``server.collector``."""
    col = collector if collector is not None else TraceCollector()
    handler = type(
        "BoundCollectorHandler",
        (CollectorRequestHandler,),
        {"collector": col},
    )
    server = http.server.ThreadingHTTPServer((host, port), handler)
    server.collector = col
    return server


def main(argv=None) -> int:
    """``python -m znicz_tpu_torch.observability.collector [port] [host]`` —
    run a standalone fleet trace collector (loopback by default)."""
    import sys

    args = list(sys.argv[1:] if argv is None else argv)
    port = int(args[0]) if args else 9110
    host = args[1] if len(args) > 1 else "127.0.0.1"
    server = build_collector_server(port=port, host=host)
    host, port = server.server_address[:2]
    print(
        f"znicz trace collector on http://{host}:{port} "
        "(push to /push, merged Perfetto trace at /trace)"
    )
    server.serve_forever()
    return 0


# -- the slave side ---------------------------------------------------------


class TracePusher:
    """Background span pusher: drain a bounded sink off ``tracer`` and
    POST span batches to a collector every ``interval_s``, each attempt
    bounded by ``timeout_s`` and advertised with ``ttl_s = ttl_factor *
    interval_s``.  An empty batch still pushes (a keep-alive, so an
    idle instance stays in the merged view).

    Failures never propagate: a dead collector costs one log line and a
    counter tick, not a serving thread; the failed batch is DROPPED
    (spans are diagnostics — redelivery would reorder the timeline).
    :meth:`push_now` is the synchronous hook tests drive; the
    ``trace_pusher.push`` fault point makes the failure path
    deterministic in CI."""

    def __init__(
        self,
        url: str,
        *,
        instance: Optional[str] = None,
        interval_s: float = 2.0,
        tracer: Optional[Tracer] = None,
        timeout_s: float = 5.0,
        ttl_factor: float = 5.0,
        max_batch: int = 5000,
        queue_len: int = 65536,
    ):
        if interval_s <= 0:
            raise ValueError(f"want interval_s > 0; got {interval_s}")
        parsed = urllib.parse.urlsplit(url)
        if parsed.scheme != "http" or not parsed.hostname:
            raise ValueError(
                f"want an http://host:port collector url; got {url!r}"
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
        self.ttl_factor = float(ttl_factor)
        self.ttl_s = self.ttl_factor * self.interval_s
        self.max_batch = int(max_batch)
        self._tracer = tracer if tracer is not None else get_tracer()
        self._queue = self._tracer.add_sink(maxlen=queue_len)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.pushes_ok = 0
        self.pushes_failed = 0
        self._m_pushes = get_registry().counter(
            "znicz_trace_pusher_pushes_total",
            "collector pushes attempted by this process, by outcome",
            ("status",),
        )
        self._m_dropped = get_registry().counter(
            "znicz_trace_pusher_events_dropped_total",
            "span events dropped on failed collector pushes",
        )

    def start(self) -> "TracePusher":
        """Start the background push loop (idempotent)."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        # _loop only calls push_now, whose contract is "never raises"
        # (every failure is caught, counted and logged inside it)
        self._thread = threading.Thread(  # znicz-check: disable=ZNC013
            target=self._loop,
            name=f"znicz-trace-pusher-{self.instance}",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self, timeout: Optional[float] = None) -> None:
        """Stop the loop; the thread drains the remaining sink in a
        bounded number of final flush pushes, then the sink detaches
        from the tracer.  The join waits at most ``timeout`` (default:
        push timeout + 2 intervals)."""
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
        self._tracer.remove_sink(self._queue)

    def __enter__(self) -> "TracePusher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _loop(self) -> None:
        while not self._stop.wait(timeout=self.interval_s):
            self.push_now()
        # final flush: bounded batches, so a huge backlog cannot wedge
        # shutdown — and one keep-alive push even when already empty
        for _ in range(10):
            self.push_now()
            if not self._queue:
                break

    def push_now(self) -> bool:
        """One synchronous, bounded push of up to ``max_batch`` queued
        events; True on 2xx.  Never raises."""
        batch: List[dict] = []
        while self._queue and len(batch) < self.max_batch:
            try:
                batch.append(self._queue.popleft())
            except IndexError:  # znicz-check: disable=ZNC008
                # benign race: the deque drained between the loop's
                # emptiness check and the pop — nothing was lost
                break
        try:
            faults.fire("trace_pusher.push")
            body = json.dumps(
                {
                    "instance": self.instance,
                    "ttl_s": self.ttl_s,
                    "epoch_us": self._tracer.epoch_us,
                    "events": batch,
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
            if batch:
                self._m_dropped.inc(len(batch))
            logger.debug(
                "trace push to %s:%s failed: %s",
                self.host, self.port, exc,
            )
            return False
        if ok:
            self.pushes_ok += 1
            self._m_pushes.labels(status="ok").inc()
        else:
            self.pushes_failed += 1
            self._m_pushes.labels(status="error").inc()
            if batch:
                self._m_dropped.inc(len(batch))
            logger.debug(
                "trace push to %s:%s rejected: HTTP %s",
                self.host, self.port, resp.status,
            )
        return ok


# -- process-shared pushers -------------------------------------------------

_SHARED_LOCK = threading.Lock()
_SHARED: Dict[tuple, TracePusher] = {}


def attach_pusher(
    url: str,
    *,
    instance: Optional[str] = None,
    tracer: Optional[Tracer] = None,
    interval_s: float = 2.0,
) -> TracePusher:
    """ONE running pusher per (collector url, tracer) per process,
    however many components attach.  Every sink sees every tracer
    event, so a second :class:`TracePusher` on the same tracer would
    push each span TWICE into the merged view — an in-process fleet
    (two front doors beside a router) must share one pusher, with
    per-event ``instance`` tags keeping the attribution.  The first
    attachment's ``instance`` names the push envelope (the fallback
    tag for untagged events); a later attachment asking for a FASTER
    cadence tightens the shared interval (and its advertised TTL) —
    the pusher runs at the fastest cadence anyone attached with; the
    pusher stops when the LAST attachment calls
    :func:`detach_pusher`."""
    t = tracer if tracer is not None else get_tracer()
    key = (str(url), id(t))
    with _SHARED_LOCK:
        pusher = _SHARED.get(key)
        if pusher is None:
            pusher = TracePusher(
                url, instance=instance, tracer=t, interval_s=interval_s
            )
            pusher._shared_key = key
            pusher._shared_refs = 1
            _SHARED[key] = pusher
            pusher.start()
        else:
            pusher._shared_refs += 1
            if float(interval_s) < pusher.interval_s:
                # applied on the loop's next wait; TTL scales with it
                pusher.interval_s = float(interval_s)
                pusher.ttl_s = pusher.ttl_factor * pusher.interval_s
                logger.debug(
                    "shared trace pusher %s tightened to %.2fs by a "
                    "later attachment", key[0], pusher.interval_s,
                )
        return pusher


def detach_pusher(pusher: TracePusher) -> None:
    """Release one :func:`attach_pusher` attachment; the last one
    stops the pusher (final flush included).  A pusher built directly
    (no shared key) just stops."""
    key = getattr(pusher, "_shared_key", None)
    if key is None:
        pusher.stop()
        return
    with _SHARED_LOCK:
        pusher._shared_refs -= 1
        last = pusher._shared_refs <= 0
        if last:
            _SHARED.pop(key, None)
    if last:
        pusher.stop()


if __name__ == "__main__":
    raise SystemExit(main())
