"""``python -m znicz_tpu_torch.services.serve <dir> [port] [host]`` — serve a
status directory over HTTP, with a Prometheus ``/metrics`` endpoint, and
(with :func:`build_server`'s ``frontdoor=``) LM serving through a
:class:`~znicz_tpu_torch.services.frontdoor.ServingFrontDoor` (port of
``znicz_tpu/services/serve.py``: the same endpoints, status codes, headers
and NDJSON records).

Serving is decoupled from training: a training process writes
``status.json``/``metrics.prom`` files and this command — or any web
server — exposes them.  Any number of viewers, zero training-side state.

Endpoints beyond the static files:

* ``/metrics`` — Prometheus text exposition.  Prefers the
  ``metrics.prom`` the training process drops into the status directory
  (textfile-collector pattern: the scrape reflects the TRAINING
  process's registry); falls back to this server process's own registry
  when the file is absent (e.g. an in-process DecodeEngine server).
* ``/metrics.json`` — the same data as a JSON snapshot, with the same
  file-first preference (the ``"metrics"`` snapshot StatusWriter embeds
  in ``status.json``), so the two endpoints never contradict each
  other.
* ``/healthz`` — liveness.  Plain 200 for a static status server; when
  a :class:`~znicz_tpu_torch.services.frontdoor.ServingFrontDoor` is attached
  (:func:`build_server`), 200 only while its watchdog reports
  ``running`` — a stalled tick, a failed engine rebuild, or a closed
  door answer 503, so a load balancer stops routing here before
  clients hang.
* ``POST /generate`` — LM serving through the front door: a JSON body
  ``{"prompt": [ids], "max_new_tokens": N, "deadline_s": S?}`` streams
  back newline-delimited JSON (chunked transfer): one ``{"token": t}``
  line per generated token and a final ``{"done": true, ...}`` record
  carrying the typed ``finish_reason``, the client-visible trace id
  (also in the ``X-Znicz-Trace-Id`` response header) and latency.
  Load shedding answers 503 + ``Retry-After``; an impossible request
  400.  A client that disconnects mid-stream gets its request
  CANCELLED — crashed callers cannot pin KV blocks.

Graceful shutdown: :func:`run_server` installs SIGTERM/SIGINT handlers
that drain the front door up to a grace period, shed the rest with
typed rejections, stop the listener, and exit 0.
"""

from __future__ import annotations

import functools
import http.server
import json
import logging
import os
import signal
import sys
import threading
import urllib.parse

from znicz_tpu_torch.observability import get_registry, parse_prometheus_text
from znicz_tpu_torch.services.errors import (
    EngineClosedError,
    RejectedError,
    RequestTooLargeError,
    retry_after_header,
)

logger = logging.getLogger(__name__)

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
NDJSON_CONTENT_TYPE = "application/x-ndjson"

_SLO_FALLBACK = None
_SLO_FALLBACK_LOCK = threading.Lock()


def _fallback_slo():
    """Lazy process-local SLO monitor for frontdoor-less servers (the
    static status-dir case): /slo still answers, evaluated over this
    process's registry.  Locked: concurrent first polls on a
    ThreadingHTTPServer must share ONE monitor (and one sample ring)."""
    global _SLO_FALLBACK
    with _SLO_FALLBACK_LOCK:
        if _SLO_FALLBACK is None:
            from znicz_tpu_torch.observability.slo import SLOMonitor

            _SLO_FALLBACK = SLOMonitor()
        return _SLO_FALLBACK


def _snapshot_from_prom(text: str) -> dict:
    """Sample-level JSON view of a Prometheus exposition: ``{sample_name:
    {"type"?: ..., "series": [{"labels": ..., "value": ...}]}}``.
    Histogram families appear as their raw ``_bucket``/``_sum``/
    ``_count`` sample names — a faithful rendering of the file, used
    when ``status.json`` carries no embedded snapshot."""
    parsed = parse_prometheus_text(text)
    out: dict = {}
    for name, labels, value in parsed["samples"]:
        fam = out.setdefault(name, {"series": []})
        fam["series"].append({"labels": labels, "value": value})
    for name, kind in parsed["types"].items():
        if name in out:
            out[name]["type"] = kind
    return out


class HttpJsonMixin:
    """Shared response writers for the repo's HTTP/1.1 surfaces (this
    status/front-door server and the cluster router proxy): explicit
    Content-Length on every non-streaming response, and the chunked
    NDJSON frame writer for token streams.  ONE owner, so the framing
    can never diverge between a replica and the router fronting it."""

    def _chunk(self, obj: dict) -> None:
        data = (json.dumps(obj) + "\n").encode()
        self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
        self.wfile.flush()

    def _send_json(self, obj: dict, status: int = 200, headers=None):
        self._send(
            (json.dumps(obj) + "\n").encode(),
            "application/json",
            status=status,
            headers=headers,
        )

    def _send(
        self,
        body: bytes,
        content_type: str,
        status: int = 200,
        headers=None,
    ) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for key, value in (headers or {}).items():
            self.send_header(key, value)
        self.end_headers()
        self.wfile.write(body)


class StatusRequestHandler(
    HttpJsonMixin, http.server.SimpleHTTPRequestHandler
):
    """Static status files + registry export + the serving front door.

    HTTP/1.1 so ``POST /generate`` can stream chunked responses; every
    non-streaming response therefore carries an explicit
    Content-Length (:class:`HttpJsonMixin`)."""

    protocol_version = "HTTP/1.1"

    def __init__(self, *args, frontdoor=None, **kwargs):
        # set BEFORE super().__init__: BaseHTTPRequestHandler handles
        # the request inside its constructor
        self.frontdoor = frontdoor
        super().__init__(*args, **kwargs)

    def do_GET(self):  # noqa: N802 — http.server API
        path = self.path.split("?", 1)[0]
        if path == "/healthz":
            self._do_healthz()
        elif path == "/slo":
            # the front door's rolling judgment when one is attached;
            # a plain status server still answers from a process-local
            # monitor over the live registry
            fd = self.frontdoor
            if fd is not None:
                snap = fd.slo_snapshot()
            else:
                # nothing else samples this monitor, so each poll does:
                # consecutive polls build real rolling windows instead
                # of judging lifetime totals as if they were 60 s old
                mon = _fallback_slo()
                mon.maybe_sample()
                snap = mon.snapshot()
            self._send_json(snap)
        elif path == "/debug/requests":
            fd = self.frontdoor
            if fd is None:
                self._send_json(
                    {"error": "no_engine",
                     "detail": "no serving front door attached"},
                    status=404,
                )
            else:
                self._send_json({"requests": fd.recent_requests()})
        elif path == "/debug/programs":
            # the device/compile ledger: every true first compile with
            # its wall time, cost analysis and memory analysis — the
            # count matches the engine ledger and
            # znicz_serve_compiles_total by construction
            from znicz_tpu_torch.observability import device

            self._send_json(device.ledger_snapshot())
        elif path == "/metrics":
            prom = os.path.join(self.directory, "metrics.prom")
            if os.path.exists(prom):
                with open(prom, "rb") as f:
                    body = f.read()
            else:
                body = get_registry().prometheus_text().encode()
            self._send(body, PROM_CONTENT_TYPE)
        elif path == "/metrics.json":
            snap = self._training_snapshot()
            if snap is None:
                snap = get_registry().snapshot()
            body = json.dumps(snap, indent=2).encode()
            self._send(body, "application/json")
        else:
            super().do_GET()

    def _training_snapshot(self):
        """The training process's snapshot, or None: the ``"metrics"``
        dict embedded in ``status.json`` when present, else a sample-
        level view derived from ``metrics.prom`` — so /metrics.json can
        never describe a different world than /metrics does (both are
        training-file-first, live-registry-last)."""
        status_path = os.path.join(self.directory, "status.json")
        if os.path.exists(status_path):
            try:
                with open(status_path) as f:
                    snap = json.load(f).get("metrics")
                if snap is not None:
                    return snap
            except (OSError, ValueError):
                # a half-written legacy file must not 500 the endpoint
                logger.warning("unreadable %s; trying metrics.prom",
                               status_path)
        prom_path = os.path.join(self.directory, "metrics.prom")
        if os.path.exists(prom_path):
            try:
                with open(prom_path) as f:
                    return _snapshot_from_prom(f.read())
            except (OSError, ValueError):
                logger.warning("unreadable %s; serving live registry",
                               prom_path)
        return None

    def _do_healthz(self) -> None:
        fd = self.frontdoor
        if fd is None:
            self._send(b"ok\n", "text/plain")
            return
        state = fd.watchdog_state()
        body = (json.dumps(state) + "\n").encode()
        self._send(
            body,
            "application/json",
            status=200 if state["state"] == "running" else 503,
        )

    # -- the serving front door -------------------------------------------

    def do_POST(self):  # noqa: N802 — http.server API
        path, _, query = self.path.partition("?")
        if path == "/prefix_probe":
            self._do_prefix_probe()
            return
        if path == "/debug/profile":
            self._do_profile(query)
            return
        if path != "/generate":
            self.send_error(404, "unknown endpoint")
            return
        fd = self.frontdoor
        if fd is None:
            self._send_json(
                {"error": "no_engine",
                 "detail": "this server has no serving front door attached"},
                status=503,
            )
            return
        try:
            n = int(self.headers.get("Content-Length") or 0)
            body = json.loads(self.rfile.read(n) or b"{}")
            prompt = body["prompt"]
            max_new = int(body.get("max_new_tokens", 16))
            deadline_s = body.get("deadline_s")
            if deadline_s is not None:
                deadline_s = float(deadline_s)
        except (KeyError, TypeError, ValueError) as exc:
            self._send_json(
                {"error": "bad_request", "detail": str(exc)}, status=400
            )
            return
        # trace-context propagation: an inbound X-Znicz-Trace-Id (the
        # cluster router mints one per client request) becomes THIS
        # request's trace id, so the router's route/retry spans and
        # every replica's engine spans share one filterable id —
        # instead of each process minting its own
        inbound_trace = self.headers.get("X-Znicz-Trace-Id")
        if inbound_trace:
            inbound_trace = inbound_trace.strip()[:128] or None
        try:
            handle = fd.submit(
                prompt, max_new, deadline_s=deadline_s,
                trace_id=inbound_trace,
            )
        except RejectedError as exc:
            self._send_json(
                {"error": "rejected", "reason": exc.reason,
                 "detail": str(exc)},
                status=503,
                headers={"Retry-After": retry_after_header(exc)},
            )
            return
        except EngineClosedError as exc:
            self._send_json(
                {"error": "engine_closed", "detail": str(exc)},
                status=503,
                headers={"Retry-After": retry_after_header(exc)},
            )
            return
        except RequestTooLargeError as exc:
            self._send_json(
                {"error": "request_too_large", "detail": str(exc)},
                status=400,
            )
            return
        except (TypeError, ValueError) as exc:
            # malformed prompt (None, ragged/nested lists, non-ints)
            # surfaces from submit()'s array coercion — a client error,
            # never a dropped connection
            self._send_json(
                {"error": "bad_request", "detail": str(exc)}, status=400
            )
            return
        self._stream_generation(fd, handle)

    def _do_profile(self, query: str) -> None:
        """``POST /debug/profile?seconds=N`` — one on-demand
        ``torch.profiler`` capture, host-span aligned, written as a Chrome
        trace into the answered directory
        (:func:`znicz_tpu_torch.observability.device.capture_profile`).
        Answers the capture directory; 409 while another capture runs,
        400 on a malformed duration."""
        from znicz_tpu_torch.observability import device

        # drain any request body first: HTTP/1.1 keep-alive reuses the
        # socket, and unread body bytes would be parsed as the NEXT
        # request's start line (every other POST handler reads it)
        try:
            n = int(self.headers.get("Content-Length") or 0)
            if n:
                self.rfile.read(n)
        except (TypeError, ValueError):  # znicz-check: disable=ZNC008
            # a garbage Content-Length only matters for keep-alive
            # reuse; the capture itself proceeds either way
            logger.debug("unparseable Content-Length on /debug/profile")
        try:
            qs = urllib.parse.parse_qs(query)
            seconds = float(qs.get("seconds", ["1.0"])[0])
        except (TypeError, ValueError) as exc:
            self._send_json(
                {"error": "bad_request", "detail": str(exc)}, status=400
            )
            return
        try:
            # with a door, the capture starts and stops on its engine
            # thread between two ticks (see ServingFrontDoor.between_ticks)
            fd = self.frontdoor
            result = device.capture_profile(
                seconds, call=fd.between_ticks if fd is not None else None
            )
        except ValueError as exc:
            # non-finite duration ("nan"/"inf" parse as floats but
            # cannot time a capture): a client error, answered 400
            self._send_json(
                {"error": "bad_request", "detail": str(exc)}, status=400
            )
            return
        except RuntimeError as exc:
            busy = "already running" in str(exc)
            self._send_json(
                {
                    "error": "profile_busy" if busy
                    else "profiler_unavailable",
                    "detail": str(exc),
                },
                status=409 if busy else 503,
            )
            return
        self._send_json({"ok": True, **result})

    def _do_prefix_probe(self) -> None:
        """``POST /prefix_probe`` ``{"prompt": [ids]}`` — the front
        door's public prefix-cache probe over HTTP: the prompt's
        chained block keys plus this replica's cached-block count.  A
        debugging surface for prefix-affinity routing (compare the
        router's learned index against the replica's actual cache) —
        the router itself never calls it; its index tracks, never
        trusts, replica state."""
        fd = self.frontdoor
        if fd is None:
            self._send_json(
                {"error": "no_engine",
                 "detail": "this server has no serving front door attached"},
                status=503,
            )
            return
        try:
            n = int(self.headers.get("Content-Length") or 0)
            body = json.loads(self.rfile.read(n) or b"{}")
            probe = fd.prefix_probe(body["prompt"])
        except EngineClosedError as exc:
            self._send_json(
                {"error": "engine_closed", "detail": str(exc)}, status=503
            )
            return
        except (KeyError, TypeError, ValueError) as exc:
            self._send_json(
                {"error": "bad_request", "detail": str(exc)}, status=400
            )
            return
        self._send_json(probe)

    def _stream_generation(self, fd, handle) -> None:
        """Chunked NDJSON token stream; a broken pipe mid-stream
        cancels the request so abandoned work frees its KV blocks."""
        self.send_response(200)
        self.send_header("Content-Type", NDJSON_CONTENT_TYPE)
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header("X-Znicz-Trace-Id", handle.id)
        self.end_headers()
        try:
            for tok in handle.tokens():
                self._chunk({"token": int(tok)})
            comp = handle.result(timeout=30.0)
            self._chunk(
                {
                    "done": True,
                    "trace_id": handle.id,
                    "finish_reason": comp.finish_reason,
                    "n_new": comp.n_new,
                    "latency_ms": round(1000.0 * comp.latency_s, 1),
                    "ttft_ms": (
                        round(1000.0 * comp.ttft_s, 1)
                        if comp.ttft_s is not None
                        else None
                    ),
                    # the per-request lifecycle breakdown: queue_s /
                    # prefill_s / decode_s / preemptions / cached_tokens
                    "timings": comp.timings,
                    **(
                        {"error": comp.error}
                        if comp.error is not None
                        else {}
                    ),
                }
            )
            self.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError, TimeoutError):
            logger.warning(
                "client gone mid-stream; cancelling %s", handle.id
            )
            fd.cancel(handle.id)

def build_server(
    directory: str = ".",
    port: int = 8080,
    host: str = "127.0.0.1",
    frontdoor=None,
) -> http.server.ThreadingHTTPServer:
    """A ready-to-serve HTTP server; ``port=0`` binds an ephemeral
    port (read it back from ``server.server_address``).  Pass a
    :class:`~znicz_tpu_torch.services.frontdoor.ServingFrontDoor` to enable
    ``POST /generate`` and watchdog-backed ``/healthz``."""
    handler = functools.partial(
        StatusRequestHandler, directory=directory, frontdoor=frontdoor
    )
    return http.server.ThreadingHTTPServer((host, port), handler)


def shutdown_gracefully(server, frontdoor=None, grace_s: float = 5.0):
    """Drain-then-stop, callable from any thread: the front door stops
    intake, drains in-flight requests up to ``grace_s``, sheds the
    remainder with typed rejections, then the listener stops.  Running
    response threads are daemonic (``ThreadingHTTPServer``), and every
    front-door stream has already been resolved by ``close()`` — so
    shutdown cannot hang on a slow client."""
    try:
        if frontdoor is not None:
            frontdoor.close(drain=True, grace_s=grace_s)
        # a recording tracer is flushed and closed AFTER the drain, so
        # the spans of the final requests land in the JSONL file before
        # exit — a SIGTERM rollout must not truncate the trace
        from znicz_tpu_torch.observability import get_tracer

        tracer = get_tracer()
        if tracer.recording:
            tracer.stop()
    except Exception:
        # ZNC013: this runs on the signal handler's shutdown thread —
        # a failed drain must still reach server.shutdown(), or SIGTERM
        # leaves the listener serving forever
        logger.exception("graceful drain failed; stopping the listener")
    try:
        server.shutdown()
    except Exception:
        logger.exception("listener shutdown failed")


def run_server(server, frontdoor=None, grace_s: float = 5.0) -> int:
    """Serve until SIGTERM/SIGINT, then shut down gracefully and
    return 0 (the exit code a process supervisor reads as a clean
    rollout, not a crash)."""

    def _on_signal(signum, frame):
        logger.info(
            "signal %s: graceful shutdown (grace %.1fs)", signum, grace_s
        )
        # serve_forever() must keep running while we drain — shutdown()
        # blocks until the serve loop exits, so do it off-thread
        threading.Thread(
            target=shutdown_gracefully,
            args=(server, frontdoor, grace_s),
            name="graceful-shutdown",
            daemon=True,
        ).start()

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, _on_signal)
    server.serve_forever()
    server.server_close()
    return 0


def main(argv=None) -> int:
    """Usage: serve <dir> [port] [host].  Binds loopback by default —
    serving all interfaces (host 0.0.0.0) is an explicit choice."""
    args = list(sys.argv[1:] if argv is None else argv)
    directory = args[0] if args else "."
    port = int(args[1]) if len(args) > 1 else 8080
    host = args[2] if len(args) > 2 else "127.0.0.1"
    server = build_server(directory, port, host)
    print(
        f"serving {directory} at http://{host}:{port}/status.html "
        f"(metrics at /metrics, liveness at /healthz)"
    )
    return run_server(server)


if __name__ == "__main__":
    raise SystemExit(main())
