"""The prefix-affinity serving router: one front for N replicas (port of
``znicz_tpu/cluster/router.py``: the same policies, placement order,
failover rules, metric families and fault points).

The multi-replica control plane (the paper's master–slave coordinator
lineage — SURVEY §3.4 ``apply_data_from_slave`` — revived as a SERVING
concern): a :class:`ServingRouter` owns a
:class:`~znicz_tpu_torch.cluster.registry.ReplicaRegistry` (who is alive)
and a :class:`~znicz_tpu_torch.cluster.affinity.PrefixAffinityIndex` (who
is warm), and places each request by:

1. **longest cached prefix first** — the prompt's chained block keys
   (:func:`~znicz_tpu_torch.services.engine.prefix_block_keys`, the
   prefix cache's keying) are ranked against the affinity index; the replica
   with the deepest learned prefix wins (SGLang cache-aware placement);
2. **load tiebreak** — equal overlap falls through to the lightest
   replica: heartbeat-reported ``pending + inflight`` depth, then the
   largest KV-pool allocatable fraction.  When a
   :class:`~znicz_tpu_torch.observability.MetricsAggregator` is attached
   (replicas push their registries to the control plane), the per-
   instance gauge reads override the heartbeat numbers — fresher than
   the last probe;
3. **least-loaded fallback** — no affinity signal at all (short or
   never-seen prompt) routes purely by load.

Failover is the router's reason to exist: a chosen replica that
refuses the connection, sheds (503), dies mid-stream, or returns a
typed ``error`` completion is retried on the NEXT-best replica
(bounded by ``max_retries``, always excluding already-tried replicas),
with the already-forwarded token prefix SKIPPED on the resumed stream
— greedy decode recomputes the same tokens, so a single replica
watchdog event is invisible to the client.  Only when every live
replica shed does the router itself shed (a typed
:class:`~znicz_tpu_torch.services.errors.RejectedError` → 503 + Retry-After
at the HTTP layer).  Failure paths are deterministic under the
``router.connect`` / ``router.stream`` / ``router.heartbeat`` fault
points.

The HTTP surface lives in :mod:`znicz_tpu_torch.cluster.proxy`; this module
is the policy + proxy-stream core, fully drivable without a socket in
tests via :meth:`ServingRouter.open_stream`.
"""

from __future__ import annotations

import http.client
import itertools
import json
import logging
import os
import socket
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from znicz_tpu_torch import observability
from znicz_tpu_torch.observability.aggregate import series_value
from znicz_tpu_torch.cluster.affinity import PrefixAffinityIndex
from znicz_tpu_torch.cluster.registry import (
    STATE_DEAD,
    STATE_HEALTHY,
    Replica,
    ReplicaRegistry,
)
from znicz_tpu_torch.services.engine import prefix_block_keys
from znicz_tpu_torch.services.errors import RejectedError
from znicz_tpu_torch.utils import faults

logger = logging.getLogger(__name__)

POLICY_PREFIX_AFFINITY = "prefix_affinity"
POLICY_ROUND_ROBIN = "round_robin"
POLICY_LEAST_LOADED = "least_loaded"
_POLICIES = (
    POLICY_PREFIX_AFFINITY, POLICY_ROUND_ROBIN, POLICY_LEAST_LOADED
)


class _UpstreamFailure(Exception):
    """One replica attempt failed retryably; ``reason`` feeds the
    retry counter and ``retry_after_s`` is set for sheds."""

    def __init__(self, reason: str, detail: str,
                 retry_after_s: Optional[float] = None):
        super().__init__(detail)
        self.reason = reason
        self.retry_after_s = retry_after_s


class RoutedStream:
    """One client request in flight through the router: an iterator of
    NDJSON-shaped records (``{"token": t}`` lines then one ``{"done":
    ...}`` record) plus the routing metadata the HTTP layer puts in
    response headers.  Construction (via
    :meth:`ServingRouter.open_stream`) has already CONNECTED to a
    replica and holds a live 200 response — submit-time failures
    (fleet saturated, no replicas, bad request) raise there, before
    any response bytes are committed.  Mid-stream replica failures
    re-route INSIDE :meth:`records`, transparently to the consumer.

    Always close (or exhaust) the stream: :meth:`close` releases the
    upstream connection, which is what propagates a client disconnect
    into a replica-side cancel."""

    def __init__(self, router: "ServingRouter", payload: Dict,
                 keys: List[str]):
        self._router = router
        self._payload = payload
        self._keys = keys
        self._t0 = time.monotonic()
        self._conn: Optional[http.client.HTTPConnection] = None
        self._resp = None
        self.replica: Optional[str] = None  # current upstream instance
        # ROUTER-minted trace id (set by open_stream, forwarded inbound
        # to every replica attempt); stays one id across failovers
        self.trace_id: Optional[str] = None
        self.overlap = 0  # affinity depth of the current choice
        self.retries = 0  # reported failovers, sheds included
        # the RETRY BUDGET counts only the expensive attempts (connect
        # timeouts and mid-stream recomputes); a shed is answered
        # instantly and must not eat the budget a later genuine crash
        # needs
        self._budget_used = 0
        # replicas excluded from further attempts: transport-failed,
        # misbehaving, or already streamed to.  Shed replicas are NOT
        # here — they may have capacity again by the time a mid-stream
        # re-route needs them
        self.tried: Set[str] = set()
        self._sent = 0  # token records forwarded to the consumer
        # tokens of the CURRENT upstream to swallow before forwarding:
        # a resumed stream recomputes from scratch, and the client
        # already holds the first ``_sent`` tokens
        self._to_skip = 0
        self._outcome: Optional[str] = None

    # -- consumer surface --------------------------------------------------

    def records(self) -> Iterator[Dict]:
        """Yield token records then exactly one done record.  Never
        hangs: upstream reads are socket-timeout bounded, and every
        exit path (including re-route exhaustion) ends in a done
        record."""
        try:
            while True:
                try:
                    for rec in self._read_upstream():
                        if "token" in rec:
                            if self._to_skip > 0:
                                # the already-delivered prefix of a
                                # resumed stream (greedy recompute
                                # reproduces it token for token)
                                self._to_skip -= 1
                                continue
                            if self._sent == 0:
                                self._router._m_ttft.observe(
                                    time.monotonic() - self._t0
                                )
                            self._sent += 1
                            yield rec
                        elif rec.get("done"):
                            retryable = rec.get("finish_reason") in (
                                "error", "shed"
                            )
                            if retryable and self._can_retry():
                                raise _UpstreamFailure(
                                    "upstream_" + rec["finish_reason"],
                                    str(rec.get("error") or
                                        rec["finish_reason"]),
                                )
                            # a terminal error/shed completion (out of
                            # retries) is a FAILED request to the
                            # router's own metrics, even though the
                            # client gets the replica's typed record
                            yield self._finish(
                                rec,
                                outcome=(
                                    "failed" if retryable else None
                                ),
                            )
                            return
                    # upstream EOF without a done record: replica died
                    raise _UpstreamFailure(
                        "mid_stream", "upstream closed without done"
                    )
                except _UpstreamFailure as exc:
                    if not self._reroute(exc):
                        yield self._finish(
                            {
                                "done": True,
                                "trace_id": self.trace_id,
                                "finish_reason": "error",
                                "n_new": self._sent,
                                "error": (
                                    f"no replica could finish the "
                                    f"request: {exc}"
                                ),
                            },
                            outcome="failed",
                        )
                        return
        finally:
            self.close()

    def close(self) -> None:
        """Release the upstream connection (idempotent).  Closing with
        the stream unfinished is the client-disconnect path: the
        replica's handler sees the drop and cancels the request, so an
        abandoned stream cannot pin replica KV blocks."""
        self._close_upstream_only()
        if self._outcome is None:
            self._outcome = "client_gone"
            self._router._m_requests.labels(outcome="client_gone").inc()

    # -- routing internals (driven by the router) --------------------------

    def _can_retry(self) -> bool:
        return self._budget_used < self._router.max_retries

    def payload_now(self) -> Dict:
        """The request body for the NEXT upstream attempt: a client
        deadline is the client's total budget, so a re-routed attempt
        carries only the REMAINING budget — otherwise each failover
        would grant the replica a fresh full deadline and a 10 s
        request could run 30 s of wall clock.  An exhausted budget is
        floored just above zero: the replica then expires it
        immediately with its own typed ``deadline_exceeded``
        completion, which forwards to the client as the truthful
        outcome."""
        payload = dict(self._payload)
        d = payload.get("deadline_s")
        if d is not None:
            payload["deadline_s"] = max(
                float(d) - (time.monotonic() - self._t0), 0.001
            )
        return payload

    def _read_upstream(self) -> Iterator[Dict]:
        """Parse NDJSON records off the live upstream response.  Raises
        :class:`_UpstreamFailure` on any transport error, tagged
        ``connect`` only by the caller (we are already connected)."""
        try:
            while True:
                faults.fire("router.stream")  # injectable stream death
                line = self._resp.readline()
                if not line:
                    return
                line = line.strip()
                if not line:
                    continue
                yield json.loads(line)
        except (OSError, socket.timeout, http.client.HTTPException,
                ValueError, faults.FaultInjected) as exc:
            raise _UpstreamFailure("mid_stream", f"{type(exc).__name__}: "
                                   f"{exc}") from exc

    def _reroute(self, exc: _UpstreamFailure) -> bool:
        """One bounded failover: report the failure, pick the next-best
        untried replica, reconnect with the forwarded-token prefix
        skipped.  False when retries or replicas are exhausted."""
        self._close_upstream_only()
        router = self._router
        if self.replica is not None and exc.reason == "mid_stream":
            # transport-level death counts toward ejection; a shed or
            # typed-error completion means the replica is ALIVE.
            # (Connect failures never reach here — _attempt's are
            # handled inside _connect's walk.)
            router.registry.note_failure(self.replica)
        if not self._can_retry():
            logger.warning(
                "request out of retries after %s on %s",
                exc.reason, self.replica,
            )
            return False
        # counted only past the gate: the family reports FAILOVERS,
        # and a budget-exhausted request attempts none
        router._m_retries.labels(reason=exc.reason).inc()
        self.retries += 1
        self._budget_used += 1  # a mid-stream re-route recomputes
        observability.instant(
            "router/retry", reason=exc.reason, gone=self.replica,
            sent=self._sent, trace=self.trace_id,
            instance=self._router.name,
        )
        try:
            router._connect(self, skip=self._sent)
        except (RejectedError, ValueError) as final:
            # ValueError here is a replica 4xx-ing a request it (or a
            # twin) previously ACCEPTED — config drift; headers are
            # already committed, so it ends in a typed error done
            # record like any other exhaustion
            logger.warning("re-route failed: %s", final)
            return False
        return True

    def _close_upstream_only(self) -> None:
        conn, self._conn, self._resp = self._conn, None, None
        if conn is not None:
            try:
                conn.close()
            except Exception:
                logger.debug("upstream close failed", exc_info=True)

    def _finish(self, rec: Dict, outcome: Optional[str] = None) -> Dict:
        """Augment the final done record with the router's view and
        settle the outcome metrics exactly once."""
        rec = dict(rec)
        rec["router"] = {
            "replica": self.replica,
            "retries": self.retries,
            "affinity_blocks": self.overlap,
        }
        if "n_new" in rec:
            # the done record must agree with the STREAM the client
            # actually saw: a request that terminates (e.g. deadline
            # expiry) on the failover replica while the skipped prefix
            # is still recomputing reports fewer tokens than the first
            # replica already delivered — reconcile upward, exactly
            # like the exhaustion-path record reports self._sent
            rec["n_new"] = max(int(rec.get("n_new") or 0), self._sent)
        if self._outcome is None:
            self._outcome = outcome or "ok"
            self._router._m_requests.labels(outcome=self._outcome).inc()
            # failed requests are not latency measurements: a replica
            # crash-loop ending requests in fast terminal errors must
            # not dilute the client-clock distribution mid-incident
            # (the front door's convention; deadline expiries ride
            # through as ok-outcome records — they ARE slow requests)
            if self._outcome == "ok":
                self._router._m_latency.observe(
                    time.monotonic() - self._t0
                )
        observability.instant(
            "router/done", replica=self.replica, retries=self.retries,
            reason=rec.get("finish_reason"), trace=self.trace_id,
            instance=self._router.name,
        )
        return rec


class ServingRouter:
    """Prefix-affinity router over a fleet of serving replicas.

    Usage::

        router = ServingRouter(block_size=16)
        router.register("replica-0", "http://127.0.0.1:8081")
        router.register("replica-1", "http://127.0.0.1:8082")
        rs = router.open_stream(prompt, max_new_tokens=64)
        for rec in rs.records():
            ...                      # {"token": t}... {"done": ...}
        router.close()

    ``block_size`` must match the replicas' paged engines — the chain
    keys are block-aligned content hashes, so a mismatched size indexes
    nothing (requests still route, by load).  ``policy`` selects the
    placement rule (``prefix_affinity`` default; ``round_robin`` and
    ``least_loaded`` exist for baselines/benches).  ``aggregator`` is
    an optional :class:`~znicz_tpu_torch.observability.MetricsAggregator`
    the replicas push to — per-instance gauge reads then override the
    heartbeat's load numbers."""

    def __init__(
        self,
        registry: Optional[ReplicaRegistry] = None,
        *,
        block_size: int = 16,
        policy: str = POLICY_PREFIX_AFFINITY,
        affinity: Optional[PrefixAffinityIndex] = None,
        aggregator=None,
        max_retries: int = 2,
        connect_timeout_s: float = 5.0,
        stream_gap_s: float = 60.0,
        retry_after_s: float = 1.0,
        heartbeat_interval_s: float = 2.0,
        name: str = "znicz-router",
        slo_burn_threshold: float = 1.0,
        collector_url: Optional[str] = None,
    ):
        if policy not in _POLICIES:
            raise ValueError(
                f"unknown policy {policy!r}; want one of {_POLICIES}"
            )
        if block_size < 1:
            raise ValueError(f"want block_size >= 1; got {block_size}")
        self.block_size = int(block_size)
        self.policy = policy
        self.max_retries = int(max_retries)
        self.connect_timeout_s = float(connect_timeout_s)
        self.stream_gap_s = float(stream_gap_s)
        self.retry_after_s = float(retry_after_s)
        self.name = name
        self.slo_burn_threshold = float(slo_burn_threshold)
        # router-minted trace ids: ONE id per client request, forwarded
        # to every replica attempt via X-Znicz-Trace-Id so the whole
        # failover chain shares a single filterable id (the replica
        # adopts it)
        self._ids = itertools.count()
        self._suffix = os.urandom(3).hex()
        self._trace_pusher = None
        if collector_url:
            # attached, not constructed: a router colocated with its
            # replicas shares the process pusher (collector.py)
            from znicz_tpu_torch.observability.collector import attach_pusher

            observability.get_tracer().ensure_recording()
            self._trace_pusher = attach_pusher(
                collector_url, instance=name
            )
        self.affinity = (
            affinity if affinity is not None else PrefixAffinityIndex()
        )
        self._aggregator = aggregator
        self._owns_registry = registry is None
        self.registry = (
            registry
            if registry is not None
            else ReplicaRegistry(
                probe_interval_s=heartbeat_interval_s,
                on_eject=self._on_eject,
                on_sweep=self.affinity.prune,
            )
        )
        if registry is not None:
            if registry.on_eject is None:
                registry.on_eject = self._on_eject
            if registry.on_sweep is None:
                registry.on_sweep = self.affinity.prune
        self._rr = 0  # round-robin cursor
        self._rr_lock = threading.Lock()
        self._n_requests = 0
        self._m_requests = observability.counter(
            "znicz_router_requests_total",
            "requests through the router by outcome",
            ("outcome",),
        )
        self._m_retries = observability.counter(
            "znicz_router_retries_total",
            "replica failovers by failure reason",
            ("reason",),
        )
        self._m_affinity = observability.counter(
            "znicz_router_affinity_total",
            "routing decisions by signal (hit: prefix overlap chose the "
            "replica; miss: pure load fallback)",
            ("signal",),
        )
        self._m_ttft = observability.histogram(
            "znicz_router_ttft_seconds",
            "router accept -> first proxied token (client clock)",
        )
        self._m_latency = observability.histogram(
            "znicz_router_request_seconds",
            "router accept -> final done record (client clock)",
        )

    # -- roster passthrough ------------------------------------------------

    def register(self, instance: str, base_url: str, *,
                 probe: bool = True) -> Replica:
        return self.registry.register(instance, base_url, probe=probe)

    def _on_eject(self, rep: Replica) -> None:
        """A dead replica's cache is gone (or will be, by the time it
        answers again): flush its affinity entries so nothing routes
        toward a pool that no longer exists."""
        dropped = self.affinity.drop(rep.instance)
        if dropped:
            logger.info(
                "flushed %d affinity keys for ejected replica %s",
                dropped, rep.instance,
            )

    def close(self) -> None:
        if self._trace_pusher is not None:
            from znicz_tpu_torch.observability.collector import detach_pusher

            detach_pusher(self._trace_pusher)
            self._trace_pusher = None
        if self._owns_registry:
            self.registry.close()

    def __enter__(self) -> "ServingRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- placement ---------------------------------------------------------

    def _load(self, rep: Replica) -> Tuple[float, float, float]:
        """Load score (smaller is lighter): SLO burn band first (a
        replica burning its error budget at or past
        ``slo_burn_threshold`` ranks behind every non-burning peer, read
        per-instance off ``znicz_serve_slo_burn_rate``), then queued
        depth, then pool headroom.  :meth:`rank` lifts the burn band
        ABOVE affinity overlap (like the health band: a warm cache on
        a breached replica is still a breached replica), so the
        guarantee holds even for shared-prefix traffic.  Heartbeat
        numbers by default; per-instance aggregator gauges override
        when pushed (fresher, and pushed on the replica's own cadence
        rather than the probe's)."""
        health = rep.health or {}
        pending = float(health.get("pending", 0) or 0)
        inflight = float(health.get("inflight", 0) or 0)
        frac = health.get("pool_free_frac")
        frac = 1.0 if frac is None else float(frac)
        burn = None
        agg = self._aggregator
        if agg is not None:
            # ONE locked aggregator read per replica; the six series
            # come out of the same snapshot
            fams = agg.instance_families(rep.instance)
            v = series_value(fams, "znicz_serve_frontdoor_pending")
            if v is not None:
                pending = v
            v = series_value(fams, "znicz_serve_frontdoor_inflight")
            if v is not None:
                inflight = v
            burn = series_value(fams, "znicz_serve_slo_burn_rate")
            free = series_value(
                fams, "znicz_serve_kv_pool_blocks", {"state": "free"}
            )
            cached = series_value(
                fams, "znicz_serve_kv_pool_blocks", {"state": "cached"}
            )
            used = series_value(
                fams, "znicz_serve_kv_pool_blocks", {"state": "used"}
            )
            if free is not None:
                total = free + (cached or 0.0) + (used or 0.0)
                if total > 0:
                    frac = (free + (cached or 0.0)) / total
        burning = (
            1.0
            if burn is not None and burn >= self.slo_burn_threshold
            else 0.0
        )
        return (burning, pending + inflight, -frac)

    def rank(
        self, keys: Sequence[str], exclude: Optional[Set[str]] = None
    ) -> List[Tuple[Replica, int]]:
        """Live replicas in placement order with their affinity
        overlap.  Healthy replicas always rank ahead of degraded ones
        (whatever their overlap — a warm cache on a stalled engine is
        still a stalled engine); within a state band: longest cached
        prefix first, load-tiebroken, least-loaded fallback when
        nothing overlaps (or per ``policy``).  Degraded replicas stay
        IN the list as the failover tail, so a transport blip on every
        healthy replica degrades to an alive-but-limping one instead
        of a 503.  Dead replicas never appear."""
        exclude = exclude or set()
        reps = [
            r for r in self.registry.replicas()
            if r.state != STATE_DEAD and r.instance not in exclude
        ]
        if not reps:
            return []

        def band(r: Replica) -> int:
            return 0 if r.state == STATE_HEALTHY else 1

        if self.policy == POLICY_ROUND_ROBIN:
            with self._rr_lock:
                start = self._rr
                self._rr += 1
            reps = sorted(reps, key=lambda r: (band(r), r.instance))
            healthy = [r for r in reps if band(r) == 0] or reps
            k = start % len(healthy)
            order = healthy[k:] + healthy[:k] + [
                r for r in reps if r not in healthy
            ]
            return [(r, 0) for r in order]
        overlaps = (
            self.affinity.rank(keys, [r.instance for r in reps])
            if self.policy == POLICY_PREFIX_AFFINITY
            else {r.instance: 0 for r in reps}
        )
        # full ties (equal band, overlap AND load — e.g. an idle fleet
        # between heartbeats) rotate instead of always picking the
        # alphabetically-first replica: load signals only refresh per
        # probe/push, and piling every tie on one replica would WRITE
        # the affinity entries that then keep gravity there
        reps = sorted(reps, key=lambda r: r.instance)
        with self._rr_lock:
            start = self._rr
            self._rr += 1
        rotation = {
            r.instance: (i - start) % len(reps)
            for i, r in enumerate(reps)
        }
        # ONE load read per replica; the burn band sorts ABOVE the
        # affinity overlap (a burning replica must drain, and affinity
        # concentrates exactly the traffic that would keep it breached)
        loads = {r.instance: self._load(r) for r in reps}
        return sorted(
            ((r, overlaps[r.instance]) for r in reps),
            key=lambda pair: (band(pair[0]),
                              loads[pair[0].instance][0],  # burn band
                              -pair[1],
                              loads[pair[0].instance][1:],
                              rotation[pair[0].instance]),
        )

    # -- the proxy ---------------------------------------------------------

    def open_stream(
        self,
        prompt,
        max_new_tokens: int,
        *,
        deadline_s: Optional[float] = None,
    ) -> RoutedStream:
        """Route one request and connect to its replica; returns the
        live :class:`RoutedStream`.  Raises ``ValueError`` on malformed
        input and :class:`~znicz_tpu_torch.services.errors.RejectedError`
        when no replica can take it — reason ``fleet_saturated`` when
        every live replica shed, ``no_replicas`` when the roster has no
        live entry, ``no_upstream`` when the live ones failed at
        transport level."""
        try:
            if isinstance(prompt, (str, bytes, dict)):
                # iterating "123" (chars) or a dict (keys) would
                # silently reinterpret it as token ids — the replica
                # rejects both shapes, so must the proxy
                raise ValueError(
                    "prompt must be a sequence of token ids"
                )
            try:
                prompt = [int(t) for t in prompt]
            except (TypeError, ValueError) as exc:
                raise ValueError(f"malformed prompt: {exc}") from exc
            if not prompt:
                raise ValueError("empty prompt")
            if int(max_new_tokens) < 1:
                raise ValueError(
                    f"want max_new_tokens >= 1; got {max_new_tokens}"
                )
        except (TypeError, ValueError):
            # the router's OWN validation rejections count in the same
            # outcome series as replica-side 400s: a bad-request storm
            # must be visible on the request-by-outcome dashboard
            self._m_requests.labels(outcome="bad_request").inc()
            raise
        payload = {
            "prompt": prompt,
            "max_new_tokens": int(max_new_tokens),
        }
        if deadline_s is not None:
            payload["deadline_s"] = float(deadline_s)
        keys = prefix_block_keys(prompt, self.block_size)
        with self._rr_lock:  # shared state lock: rotation + tallies
            self._n_requests += 1
        rs = RoutedStream(self, payload, keys)
        # mint the trace id HERE: every replica attempt (first choice
        # and failovers alike) carries it inbound, so one filter shows
        # the request's whole cross-process life
        rs.trace_id = f"{self.name}-{self._suffix}-{next(self._ids):06d}"
        try:
            self._connect(rs, skip=0)
        except RejectedError as exc:
            # "shed" is a CAPACITY signal (every live replica said
            # retry later); a fleet that is down or unreachable is an
            # OUTAGE and must not masquerade as load shedding
            outcome = (
                "shed" if exc.reason == "fleet_saturated" else "failed"
            )
            rs._outcome = outcome
            self._m_requests.labels(outcome=outcome).inc()
            raise
        except ValueError:
            rs._outcome = "bad_request"
            self._m_requests.labels(outcome="bad_request").inc()
            raise
        return rs

    def _connect(self, rs: RoutedStream, *, skip: int) -> None:
        """Walk the placement order until one replica streams.  Fills
        ``rs`` with the live connection; raises
        :class:`~znicz_tpu_torch.services.errors.RejectedError` when nobody
        could take the request."""
        sheds: List[float] = []
        failures = 0
        candidates = self.rank(rs._keys, exclude=rs.tried)
        if not candidates and not rs.tried:
            raise RejectedError(
                "no live replicas registered with the router",
                reason="no_replicas",
                retry_after_s=self.retry_after_s,
            )
        for rep, overlap in candidates:
            try:
                conn, resp, trace = self._attempt(
                    rep, rs.payload_now(), trace_id=rs.trace_id
                )
            except _UpstreamFailure as exc:
                if exc.reason == "upstream_4xx":
                    # the REPLICA rejected the request as a client
                    # error (e.g. too large for its KV capacity after
                    # the router's shallower validation passed): the
                    # request is bad, the replica is fine — no failure
                    # note, no retry on its neighbours, a 400 to the
                    # client (never a retryable 503)
                    raise ValueError(
                        f"replica rejected the request: {exc}"
                    ) from exc
                rs.retries += 1  # one failed attempt == one failover
                if exc.reason == "shed":
                    # a shed is answered instantly and costs neither
                    # the retry budget nor a `tried` exclusion (the
                    # replica may have capacity again by the next
                    # re-route) — walking through every shedding
                    # replica is what makes fleet_saturated honest
                    sheds.append(
                        exc.retry_after_s
                        if exc.retry_after_s is not None
                        else self.retry_after_s
                    )
                    self._m_retries.labels(reason="shed").inc()
                    continue
                rs.tried.add(rep.instance)
                failures += 1
                self._m_retries.labels(reason=exc.reason).inc()
                self.registry.note_failure(rep.instance)
                if exc.reason == "connect":
                    rs._budget_used += 1
                    if rs._budget_used > self.max_retries:
                        # transport failures each burn a connect
                        # timeout: bound the walk so a partitioned
                        # 10-replica fleet answers 503 after
                        # max_retries+1 timeouts, not ten.  A replica
                        # that ANSWERED with a wrong status
                        # (upstream_status) cost nothing and only
                        # excludes itself
                        break
                continue
            rs.tried.add(rep.instance)  # streamed-to: excluded later
            # a streaming 200 is a liveness observation as good as a
            # heartbeat: heal a transport-blip demotion immediately
            self.registry.note_success(rep.instance)
            rs._conn, rs._resp = conn, resp
            rs.replica = rep.instance
            rs.overlap = overlap
            rs._to_skip = skip
            if rs.trace_id is None:
                rs.trace_id = trace
            if self.policy == POLICY_PREFIX_AFFINITY:
                self._m_affinity.labels(
                    signal="hit" if overlap > 0 else "miss"
                ).inc()
                # learn NOW: a concurrent burst sharing this prefix
                # must co-locate immediately, not after retirement
                self.affinity.learn(rep.instance, rs._keys)
            observability.instant(
                "router/route", replica=rep.instance, overlap=overlap,
                skip=skip, trace=rs.trace_id or trace,
                instance=self.name,
            )
            return
        if sheds and failures == 0:
            raise RejectedError(
                f"all {len(sheds)} live replicas shed; retry later",
                reason="fleet_saturated",
                retry_after_s=max(sheds),
            )
        raise RejectedError(
            f"no upstream replica could take the request "
            f"({len(sheds)} shed, {failures} unreachable)",
            reason="no_upstream",
            retry_after_s=max(sheds, default=self.retry_after_s),
        )

    def _attempt(
        self, rep: Replica, payload: Dict,
        trace_id: Optional[str] = None,
    ):
        """One replica connection: POST /generate (forwarding the
        router-minted trace id via ``X-Znicz-Trace-Id``, which the
        replica adopts as the request's own), demand a streaming 200.
        Returns ``(conn, resp, trace_id)``; raises
        :class:`_UpstreamFailure` (reason ``shed`` for 503 — carrying
        its Retry-After — ``upstream_4xx`` for a 400 client-level
        reject, ``upstream_status`` for any other wrong status — a
        misconfigured instance — and ``connect`` for transport
        errors)."""
        conn = http.client.HTTPConnection(
            rep.host, rep.port, timeout=self.connect_timeout_s
        )
        try:
            faults.fire("router.connect")  # injectable connect refusal
            headers = {"Content-Type": "application/json"}
            if trace_id:
                headers["X-Znicz-Trace-Id"] = trace_id
            conn.request(
                "POST", "/generate", body=json.dumps(payload),
                headers=headers,
            )
            resp = conn.getresponse()
            if conn.sock is not None:
                # connected and headers in: reads now wait on TOKENS,
                # whose gaps are bounded by the engine's tick cadence,
                # not the transport's
                conn.sock.settimeout(self.stream_gap_s)
            if resp.status == 503:
                body = resp.read()
                retry_after = None
                header = resp.getheader("Retry-After")
                if header is not None:
                    try:
                        retry_after = float(header)
                    except ValueError:
                        retry_after = None
                raise _UpstreamFailure(
                    "shed", f"{rep.instance} shed: {body[:200]!r}",
                    retry_after_s=retry_after,
                )
            if resp.status == 400:
                # the replica judged the REQUEST invalid (all replicas
                # would): terminal client error, no failover
                body = resp.read()
                raise _UpstreamFailure(
                    "upstream_4xx",
                    f"{rep.instance} answered {resp.status}: "
                    f"{body[:200]!r}",
                )
            if resp.status != 200:
                # 404/405/500/...: this INSTANCE is misbehaving (a
                # wrong base URL, a non-replica service) — fail over
                # and let the failure note demote it
                body = resp.read()
                raise _UpstreamFailure(
                    "upstream_status",
                    f"{rep.instance} answered {resp.status}: "
                    f"{body[:200]!r}",
                )
            return conn, resp, resp.getheader("X-Znicz-Trace-Id")
        except _UpstreamFailure:
            conn.close()
            raise
        except (OSError, socket.timeout, http.client.HTTPException,
                faults.FaultInjected) as exc:
            conn.close()
            raise _UpstreamFailure(
                "connect", f"{rep.instance} unreachable: "
                f"{type(exc).__name__}: {exc}"
            ) from exc

    # -- introspection -----------------------------------------------------

    def stats(self) -> Dict:
        return {
            "name": self.name,
            "policy": self.policy,
            "block_size": self.block_size,
            "requests": self._n_requests,
            "max_retries": self.max_retries,
            "replicas": self.registry.snapshot(),
            "affinity": self.affinity.stats(),
        }

    def healthy(self) -> bool:
        """The router is healthy while ANYONE can take traffic."""
        return bool(self.registry.routable())
