"""Replica registry: registration, heartbeat liveness, ejection (port of
``znicz_tpu/cluster/registry.py``, the same states, metric families and
fault point).

The control plane's ground truth about WHO can serve.  Each replica is
a :class:`~znicz_tpu_torch.services.frontdoor.ServingFrontDoor` behind the
serving HTTP surface (:mod:`znicz_tpu_torch.services.serve`); its
``/healthz`` already answers liveness (watchdog state) AND load (pending
/ inflight / pool_free_frac) in one probe, so one heartbeat feeds both
the routing eligibility ladder and the load-tiebreak score.  States:

* ``healthy`` — last probe answered 200 with watchdog ``running``:
  first-class routing target.
* ``degraded`` — the replica ANSWERS but reports trouble (503, or a
  watchdog state other than running: stalled tick, failed rebuild,
  closing).  Routed to only when no healthy replica exists — alive
  beats nothing, but a stalled engine must not take traffic a healthy
  one could.
* ``dead`` — ``dead_after`` CONSECUTIVE probe failures (connect
  refused, timeout — the process is gone or unreachable).  Ejected
  from routing entirely; the ``on_eject`` hook fires once per
  transition so the router can flush its affinity entries.  A dead
  replica keeps being probed: the first successful probe RE-ADMITS it
  (``on_readmit``), because a restarted replica announces itself by
  answering, not by re-registering.

Probing is available both as a background thread (``start=True``,
production) and as explicit :meth:`probe_all` calls (tests, and the
bench — every transition above is then deterministic).  Every blocking
primitive is timeout-bounded (ZNC010 applies to ``cluster/`` too).
The ``router.heartbeat`` fault point makes probe failure injectable
without killing a real server.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import logging
import threading
import time
import urllib.parse
from typing import Callable, Dict, List, Optional

from znicz_tpu_torch import observability
from znicz_tpu_torch.utils import faults

logger = logging.getLogger(__name__)

STATE_HEALTHY = "healthy"
STATE_DEGRADED = "degraded"
STATE_DEAD = "dead"


@dataclasses.dataclass
class Replica:
    """One registered serving replica and what the heartbeat knows."""

    instance: str
    base_url: str
    host: str
    port: int
    state: str = STATE_DEGRADED  # first probe decides; never assumed
    failures: int = 0  # CONSECUTIVE probe failures
    # CONSECUTIVE proxied-traffic failures (note_failure), reset only
    # by real served traffic (note_success) — NOT by an answered
    # probe.  A misconfigured endpoint whose /healthz happens to
    # answer 200 (a non-replica service on the registered port) would
    # otherwise flip back to healthy every probe interval and attract
    # traffic forever; once this streak reaches dead_after the entry
    # is QUARANTINED to degraded even while its probes pass
    traffic_failures: int = 0
    # True only when the degradation came from TRANSPORT failures (a
    # missed beat / connect refusal) rather than the replica itself
    # reporting trouble — only a transport demotion may be healed by
    # an out-of-band streaming success (note_success)
    degraded_by_transport: bool = False
    probes: int = 0
    ejections: int = 0
    readmissions: int = 0
    # the parsed /healthz body of the last ANSWERED probe — the load
    # signal (pending / inflight / pool_free_frac) the router tiebreaks
    # on; {} until a probe lands
    health: Dict = dataclasses.field(default_factory=dict)
    _last_probe_at: Optional[float] = None

    def snapshot(self) -> Dict:
        """JSON view for ``/replicas`` and ``stats()``."""
        return {
            "instance": self.instance,
            "base_url": self.base_url,
            "state": self.state,
            "failures": self.failures,
            "traffic_failures": self.traffic_failures,
            "probes": self.probes,
            "ejections": self.ejections,
            "readmissions": self.readmissions,
            "last_probe_age_s": (
                round(time.monotonic() - self._last_probe_at, 3)
                if self._last_probe_at is not None
                else None
            ),
            "health": dict(self.health),
        }


class ReplicaRegistry:
    """Thread-safe replica roster with heartbeat-driven states."""

    def __init__(
        self,
        *,
        probe_interval_s: float = 2.0,
        probe_timeout_s: float = 1.0,
        dead_after: int = 3,
        start: bool = True,
        on_eject: Optional[Callable[[Replica], None]] = None,
        on_readmit: Optional[Callable[[Replica], None]] = None,
        on_sweep: Optional[Callable[[], None]] = None,
    ):
        if probe_interval_s <= 0:
            raise ValueError(
                f"want probe_interval_s > 0; got {probe_interval_s}"
            )
        if dead_after < 1:
            raise ValueError(f"want dead_after >= 1; got {dead_after}")
        self.probe_interval_s = float(probe_interval_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.dead_after = int(dead_after)
        self.on_eject = on_eject
        self.on_readmit = on_readmit
        # ran after every background probe sweep — the router hangs
        # its affinity-index TTL prune here so an IDLE fleet's index
        # still decays on the heartbeat cadence
        self.on_sweep = on_sweep
        self._lock = threading.Lock()
        self._replicas: Dict[str, Replica] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._m_replicas = observability.gauge(
            "znicz_router_replicas",
            "registered serving replicas by heartbeat state",
            ("state",),
        )
        self._m_heartbeats = observability.counter(
            "znicz_router_heartbeats_total",
            "replica healthz probes by outcome",
            ("outcome",),
        )
        self._m_ejections = observability.counter(
            "znicz_router_ejections_total",
            "replicas declared dead after consecutive heartbeat failures",
        )
        self._m_readmissions = observability.counter(
            "znicz_router_readmissions_total",
            "dead replicas re-admitted by a successful heartbeat",
        )
        if start:
            self.start()

    # -- roster ------------------------------------------------------------

    def register(
        self, instance: str, base_url: str, *, probe: bool = True
    ) -> Replica:
        """Add (or re-point) a replica; ``base_url`` is the replica's
        serving HTTP root (``http://host:port``).  ``probe=True`` runs
        one synchronous heartbeat so the replica enters the roster with
        a MEASURED state, not an assumed one."""
        parsed = urllib.parse.urlsplit(base_url)
        if parsed.scheme != "http" or not parsed.hostname:
            raise ValueError(
                f"want an http://host:port base_url; got {base_url!r}"
            )
        rep = Replica(
            instance=str(instance),
            base_url=base_url.rstrip("/"),
            host=parsed.hostname,
            port=parsed.port or 80,
        )
        with self._lock:
            self._replicas[rep.instance] = rep
            self._update_gauges()
        if probe:
            self.probe(rep.instance)
        return rep

    def deregister(self, instance: str) -> bool:
        with self._lock:
            gone = self._replicas.pop(str(instance), None)
            self._update_gauges()
        return gone is not None

    def get(self, instance: str) -> Optional[Replica]:
        with self._lock:
            return self._replicas.get(str(instance))

    def replicas(self) -> List[Replica]:
        with self._lock:
            return list(self._replicas.values())

    def routable(self) -> List[Replica]:
        """Replicas eligible for traffic: every healthy one; when none
        is healthy, the degraded ones (alive beats nothing — a shedding
        or stalled replica may still answer).  Dead replicas never."""
        with self._lock:
            reps = list(self._replicas.values())
        healthy = [r for r in reps if r.state == STATE_HEALTHY]
        if healthy:
            return healthy
        return [r for r in reps if r.state == STATE_DEGRADED]

    def snapshot(self) -> List[Dict]:
        return [
            r.snapshot()
            for r in sorted(self.replicas(), key=lambda r: r.instance)
        ]

    # -- heartbeats --------------------------------------------------------

    def probe(self, instance: str) -> Optional[str]:
        """One heartbeat for ``instance``; returns its new state (None
        when unknown).  Callable from any thread — tests and the bench
        drive transitions deterministically through here."""
        rep = self.get(instance)
        if rep is None:
            return None
        outcome, health = self._probe_http(rep)
        return self._apply(rep, outcome, health)

    def probe_all(self) -> Dict[str, str]:
        """Heartbeat every registered replica; instance -> new state.
        Probes run CONCURRENTLY (one short-lived thread each, join
        bounded by the probe timeout), so K unreachable replicas cost
        ONE probe timeout per sweep, not K stacked ones — the
        ``dead_after x probe_interval_s`` detection-latency story
        survives a partition of most of the fleet."""
        reps = self.replicas()
        results: Dict[str, str] = {}
        if len(reps) <= 1:
            for rep in reps:
                results[rep.instance] = self._apply(
                    rep, *self._probe_http(rep)
                )
            return results
        lock = threading.Lock()

        def one(rep: Replica) -> None:
            try:
                state = self._apply(rep, *self._probe_http(rep))
            except Exception:  # ZNC013: a probe-thread death must log
                logger.warning(
                    "probe of %s failed unexpectedly", rep.instance,
                    exc_info=True,
                )
                return  # the sweep's join is bounded; the entry keeps
                # its previous state until the next probe lands
            with lock:
                results[rep.instance] = state

        threads = [
            threading.Thread(
                target=one, args=(rep,),
                name=f"znicz-probe-{rep.instance}", daemon=True,
            )
            for rep in reps
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=self.probe_timeout_s + 1.0)
        with lock:
            return dict(results)

    def note_failure(self, instance: str) -> Optional[str]:
        """An OUT-OF-BAND failure observation (the router's proxy hit a
        connect refusal / mid-stream death) — counts against the same
        consecutive-failure budget as a failed heartbeat, so a replica
        that is dead to traffic gets ejected without waiting
        ``dead_after`` probe intervals."""
        rep = self.get(instance)
        if rep is None:
            return None
        return self._apply(rep, "failed", None, count_probe=False)

    def note_success(self, instance: str) -> Optional[str]:
        """The out-of-band GOOD observation: a proxied request got a
        streaming 200 from this replica.  Clears the consecutive-
        failure streak, and heals a transport-blip demotion (degraded
        WITH failures) back to healthy — a degradation reported by the
        replica itself (503 heartbeat, zero failures) waits for the
        next probe instead, because serving one stream does not refute
        'my watchdog says stalled'."""
        rep = self.get(instance)
        if rep is None:
            return None
        with self._lock:
            if (
                rep.state == STATE_DEGRADED
                and rep.degraded_by_transport
            ):
                rep.state = STATE_HEALTHY
                rep.degraded_by_transport = False
            rep.failures = 0
            rep.traffic_failures = 0  # real traffic served: unquarantine
            self._update_gauges()
            return rep.state

    def _probe_http(self, rep: Replica):
        """GET ``/healthz``, timeout-bounded.  Returns ``(outcome,
        health_body)`` with outcome ``ok`` (200), ``degraded``
        (answered, not 200) or ``failed`` (unreachable)."""
        conn = None
        try:
            faults.fire("router.heartbeat")  # injectable probe failure
            conn = http.client.HTTPConnection(
                rep.host, rep.port, timeout=self.probe_timeout_s
            )
            conn.request("GET", "/healthz")
            resp = conn.getresponse()
            body = resp.read()
            try:
                health = json.loads(body)
                if not isinstance(health, dict):
                    health = {}
            except ValueError:
                health = {}  # a plain static server answers "ok\n"
            if resp.status == 200 and health.get("state", "running") == (
                "running"
            ):
                return "ok", health
            return "degraded", health
        except (OSError, http.client.HTTPException) as exc:
            # HTTPException covers a port reclaimed by a non-HTTP
            # process or a half-dead server truncating its response
            # (BadStatusLine/IncompleteRead): exactly as dead-to-
            # traffic as a refused connect, and it must count toward
            # ejection, not abort the sweep
            logger.debug(
                "heartbeat to %s (%s) failed: %s",
                rep.instance, rep.base_url, exc,
            )
            return "failed", None
        except faults.FaultInjected:
            return "failed", None
        finally:
            if conn is not None:
                conn.close()

    def _apply(
        self,
        rep: Replica,
        outcome: str,
        health: Optional[Dict],
        *,
        count_probe: bool = True,
    ) -> str:
        """Fold one probe outcome into the replica's state machine."""
        ejected = readmitted = False
        with self._lock:
            if count_probe:
                rep.probes += 1
                rep._last_probe_at = time.monotonic()
                self._m_heartbeats.labels(outcome=outcome).inc()
            else:
                rep.traffic_failures += 1
            if outcome == "failed":
                rep.failures += 1
                if rep.failures >= self.dead_after:
                    if rep.state != STATE_DEAD:
                        rep.state = STATE_DEAD
                        rep.ejections += 1
                        ejected = True
                elif rep.state == STATE_HEALTHY:
                    # one missed beat demotes, it does not eject: the
                    # replica stops being first-choice but stays a
                    # fallback until the failure streak proves it dead
                    rep.state = STATE_DEGRADED
                    rep.degraded_by_transport = True
            else:
                was_dead = rep.state == STATE_DEAD
                rep.failures = 0
                if health is not None:
                    rep.health = health
                rep.state = (
                    STATE_HEALTHY if outcome == "ok" else STATE_DEGRADED
                )
                # an ANSWERED probe is replica truth: a remaining
                # degradation is self-reported, not a transport blip
                rep.degraded_by_transport = False
                if rep.traffic_failures >= self.dead_after:
                    # quarantine: it answers probes but keeps failing
                    # real traffic (a non-replica on the registered
                    # port) — last-resort fallback, never first choice,
                    # until a real stream succeeds (note_success)
                    rep.state = STATE_DEGRADED
                if was_dead:
                    rep.readmissions += 1
                    readmitted = True
            self._update_gauges()
        # hooks OUTSIDE the lock: they call back into router state
        if ejected:
            self._m_ejections.inc()
            logger.warning(
                "replica %s ejected after %d consecutive failures",
                rep.instance, rep.failures,
            )
            if self.on_eject is not None:
                self.on_eject(rep)
        if readmitted:
            self._m_readmissions.inc()
            logger.info("replica %s re-admitted (%s)", rep.instance,
                        rep.state)
            if self.on_readmit is not None:
                self.on_readmit(rep)
        return rep.state

    def _update_gauges(self) -> None:
        """Per-state roster sizes (lock held by the caller)."""
        counts = {STATE_HEALTHY: 0, STATE_DEGRADED: 0, STATE_DEAD: 0}
        for r in self._replicas.values():
            counts[r.state] = counts.get(r.state, 0) + 1
        for state, n in counts.items():
            self._m_replicas.labels(state=state).set(n)

    # -- the heartbeat thread ----------------------------------------------

    def start(self) -> "ReplicaRegistry":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="znicz-heartbeat", daemon=True
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(timeout=self.probe_interval_s):
            try:
                self.probe_all()
                if self.on_sweep is not None:
                    self.on_sweep()
            except Exception:
                logger.warning("heartbeat sweep failed", exc_info=True)

    def close(self) -> None:
        """Stop the heartbeat thread (bounded join).  Idempotent."""
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=self.probe_timeout_s + self.probe_interval_s)

    def __enter__(self) -> "ReplicaRegistry":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
