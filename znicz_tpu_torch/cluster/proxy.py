"""HTTP surface of the serving router: the one address clients dial (port
of ``znicz_tpu/cluster/proxy.py``, the same endpoints, status codes and
headers).

``python -m znicz_tpu_torch.cluster.proxy http://host:port [...] [--port N]``
fronts N replica base URLs with a :class:`~znicz_tpu_torch.cluster.router
.ServingRouter`.  The client contract is EXACTLY the single-replica
surface (docs/SERVING.md "The front door" HTTP table) — a client
cannot tell a router from a replica:

* ``POST /generate`` — same JSON body; the chunked NDJSON token
  stream is proxied end-to-end from the chosen replica.
  ``X-Znicz-Trace-Id`` carries the replica-issued trace id (preserved
  across a mid-stream failover; the FIRST upstream's id is the one a
  support ticket quotes), ``X-Znicz-Replica`` names the first choice,
  and the final done record gains a ``"router"`` sub-object
  (``replica`` actually finishing, ``retries``, ``affinity_blocks``).
  503 + ``Retry-After`` ONLY when no live replica could take the
  request (every one shed, or none reachable); 400 for malformed
  bodies — the router validates before routing, a bad request never
  burns a replica connection.  A client that disconnects mid-stream
  tears down the upstream connection, which cancels the request on
  the replica — abandoned work frees its KV blocks fleet-wide.
* ``GET /healthz`` — 200 while ANY replica is routable (the router is
  a control plane: it is healthy while the fleet can serve), 503
  otherwise; the body carries the per-replica states.
* ``GET /replicas`` — the registry roster + affinity index stats
  (the ``/debug``-grade view of the placement state).
* ``GET /metrics`` / ``/metrics.json`` — this router process's live
  registry (the ``znicz_router_*`` families; docs/OBSERVABILITY.md).

Graceful shutdown mirrors :func:`znicz_tpu_torch.services.serve.run_server`:
SIGTERM/SIGINT stop the listener and the heartbeat thread, exit 0.
"""

from __future__ import annotations

import functools
import http.server
import json
import logging
import signal
import sys
import threading

from znicz_tpu_torch.observability import get_registry
from znicz_tpu_torch.cluster.router import ServingRouter
from znicz_tpu_torch.services.errors import RejectedError, retry_after_header
from znicz_tpu_torch.services.serve import (
    NDJSON_CONTENT_TYPE,
    PROM_CONTENT_TYPE,
    HttpJsonMixin,
)

logger = logging.getLogger(__name__)


class RouterRequestHandler(
    HttpJsonMixin, http.server.BaseHTTPRequestHandler
):
    """The router's HTTP face; ``router`` is injected per-server.
    Response framing (Content-Length bodies, chunked NDJSON frames)
    comes from the shared :class:`~znicz_tpu_torch.services.serve
    .HttpJsonMixin`, so router and replica surfaces cannot drift."""

    protocol_version = "HTTP/1.1"

    def __init__(self, *args, router: ServingRouter, **kwargs):
        self.router = router
        super().__init__(*args, **kwargs)

    def log_message(self, fmt, *args):  # noqa: A003 — http.server API
        logger.debug("router http: " + fmt, *args)

    def do_GET(self):  # noqa: N802 — http.server API
        path = self.path.split("?", 1)[0]
        if path == "/healthz":
            states = {
                r["instance"]: r["state"]
                for r in self.router.registry.snapshot()
            }
            ok = self.router.healthy()
            self._send_json(
                {"state": "routing" if ok else "no_replicas",
                 "replicas": states},
                status=200 if ok else 503,
            )
        elif path == "/replicas":
            self._send_json(self.router.stats())
        elif path == "/metrics":
            self._send(
                get_registry().prometheus_text().encode(),
                PROM_CONTENT_TYPE,
            )
        elif path == "/metrics.json":
            body = json.dumps(get_registry().snapshot(), indent=2)
            self._send(body.encode(), "application/json")
        else:
            self.send_error(404, "unknown endpoint")

    def do_POST(self):  # noqa: N802 — http.server API
        path = self.path.split("?", 1)[0]
        if path != "/generate":
            self.send_error(404, "unknown endpoint")
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
        try:
            rs = self.router.open_stream(
                prompt, max_new, deadline_s=deadline_s
            )
        except RejectedError as exc:
            self._send_json(
                {"error": "rejected", "reason": exc.reason,
                 "detail": str(exc)},
                status=503,
                headers={"Retry-After": retry_after_header(exc)},
            )
            return
        except (TypeError, ValueError) as exc:
            self._send_json(
                {"error": "bad_request", "detail": str(exc)}, status=400
            )
            return
        self.send_response(200)
        self.send_header("Content-Type", NDJSON_CONTENT_TYPE)
        self.send_header("Transfer-Encoding", "chunked")
        if rs.trace_id:
            self.send_header("X-Znicz-Trace-Id", rs.trace_id)
        if rs.replica:
            self.send_header("X-Znicz-Replica", rs.replica)
        self.end_headers()
        try:
            for rec in rs.records():
                self._chunk(rec)
            self.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError, TimeoutError):
            logger.warning(
                "client gone mid-stream; dropping upstream for %s",
                rs.trace_id,
            )
            rs.close()  # the replica sees the drop and cancels


def build_router_server(
    router: ServingRouter,
    port: int = 8080,
    host: str = "127.0.0.1",
) -> http.server.ThreadingHTTPServer:
    """A ready-to-serve router front; ``port=0`` binds ephemeral (read
    it back from ``server.server_address``).  The router is reachable
    as ``server.router``."""
    handler = functools.partial(RouterRequestHandler, router=router)
    server = http.server.ThreadingHTTPServer((host, port), handler)
    server.router = router
    return server


def run_router_server(server, router: ServingRouter) -> int:
    """Serve until SIGTERM/SIGINT, then stop the listener and the
    heartbeat thread and return 0 (a clean rollout to a supervisor)."""

    def _on_signal(signum, frame):
        logger.info("signal %s: stopping router", signum)
        threading.Thread(
            target=server.shutdown, name="router-shutdown", daemon=True
        ).start()

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, _on_signal)
    server.serve_forever()
    server.server_close()
    router.close()
    return 0


def main(argv=None) -> int:
    """Usage: ``proxy URL [URL ...] [--port N] [--host H]
    [--block-size B] [--policy P] [--collector URL]`` — replica
    instance names default to ``replica-<i>``; ``--collector`` pushes
    the router's route/retry spans to a fleet
    :mod:`~znicz_tpu_torch.observability.collector` so the merged timeline
    includes the router hop."""
    args = list(sys.argv[1:] if argv is None else argv)
    port, host, block_size = 8080, "127.0.0.1", 16
    policy = "prefix_affinity"
    collector_url = None
    urls = []
    i = 0
    while i < len(args):
        if args[i] == "--port":
            port, i = int(args[i + 1]), i + 2
        elif args[i] == "--host":
            host, i = args[i + 1], i + 2
        elif args[i] == "--block-size":
            block_size, i = int(args[i + 1]), i + 2
        elif args[i] == "--policy":
            policy, i = args[i + 1], i + 2
        elif args[i] == "--collector":
            collector_url, i = args[i + 1], i + 2
        else:
            urls.append(args[i])
            i += 1
    if not urls:
        print(
            "usage: python -m znicz_tpu_torch.cluster.proxy URL [URL ...] "
            "[--port N] [--host H] [--block-size B] [--policy P] "
            "[--collector URL]",
            file=sys.stderr,
        )
        return 2
    router = ServingRouter(
        block_size=block_size, policy=policy,
        collector_url=collector_url,
    )
    for j, url in enumerate(urls):
        router.register(f"replica-{j}", url)
    server = build_router_server(router, port=port, host=host)
    host, port = server.server_address[:2]
    print(
        f"znicz serving router on http://{host}:{port} fronting "
        f"{len(urls)} replicas (POST /generate, roster at /replicas)"
    )
    return run_router_server(server, router)


if __name__ == "__main__":
    raise SystemExit(main())
