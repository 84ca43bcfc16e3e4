"""The serving front door: async submit/stream/cancel over the engine (port
of ``znicz_tpu/services/frontdoor.py``: the same surface, completions,
metric series and fault points, over the port's engines).

:class:`DecodeEngine`/:class:`PagedDecodeEngine` are synchronous-tick
LIBRARIES — ``run()`` drains a queue and returns.  Real traffic needs a
SERVICE: callers on many threads submitting concurrently, reading
tokens as they are produced, abandoning requests (crashed client,
user hit stop), and bounded by explicit deadlines and admission
control rather than by hope.  :class:`ServingFrontDoor` is that layer:

* **one engine thread** owns the engine and drives it tick by tick
  (admit → prefill chunk → decode chunk — the same programs ``run()``
  uses; the front door adds ZERO programs).  All engine state, and every
  device call a request makes, stays on this thread: on the card each
  program's first call (its CUDA-graph capture) happens here, while HTTP
  handler threads, the pushers and profiler captures only read host
  state.  Speculative decoding rides this unchanged: a paged engine
  factory built with ``spec_k > 0`` drafts/verifies inside the same tick
  (a watchdog restart rebuilds from the factory, so the spec config
  survives a crash), every completion's ``timings`` carries
  ``spec_drafted``/``spec_accepted``, and the dense backend's factory
  fails construction with the typed
  :class:`~znicz_tpu_torch.services.errors.SpeculationUnsupportedError`
  before the door ever starts.
* **submit() → handle**: validation runs single-flight BEFORE enqueue
  (:class:`RequestTooLargeError` — a request that can never fit is
  refused at the door, not after queueing).  The handle streams tokens
  incrementally (:meth:`RequestHandle.tokens`) and resolves to a typed
  :class:`~znicz_tpu_torch.services.engine.Completion`
  (:meth:`RequestHandle.result`).
* **admission control / backpressure**: the pending queue is BOUNDED
  (``max_pending``); beyond it — or when the paged KV pool's free
  fraction drops under ``shed_pool_frac`` while a backlog exists —
  submission sheds with a typed :class:`RejectedError` carrying
  ``retry_after_s`` (the HTTP surface maps it to 503 + Retry-After).
  The pool's free fraction is read on the engine thread between ticks.
* **per-request deadlines**: ``deadline_s`` (relative to submit) is
  checked every tick; an expired request is retired MID-FLIGHT with a
  ``deadline_exceeded`` completion and, on the paged backend, its
  blocks released immediately (the engine's preemption machinery makes
  reclaim cheap).  Queued requests expire without ever touching the
  engine.
* **cancellation**: ``cancel(id)`` (or ``handle.cancel()``) works
  before admission (dropped from the queue), during decode (typed
  ``cancelled`` completion, blocks reclaimed), and after completion
  (no-op, returns False).  The HTTP layer cancels on client
  disconnect, so a crashed caller cannot pin KV blocks.
* **engine watchdog**: every tick timestamps itself; a tick running
  longer than ``stall_after_s`` flips :meth:`watchdog_state` to
  ``"stalled"`` (``/healthz`` → 503).  An engine-thread EXCEPTION
  fails only the slot-resident requests — each gets a typed ``error``
  completion naming the exception — then the door drops the dead engine
  and rebuilds one from the factory (``znicz_serve_watchdog_restarts_total``;
  on the card the new engine captures its own graphs at its first
  calls), engine-queued requests are re-admitted, and the pending queue
  proceeds.  A factory that fails leaves the door failed-closed.  Every
  path ends in a completion + stream sentinel: no hung clients, ever.
* **graceful shutdown**: :meth:`close` stops intake
  (:class:`EngineClosedError`), drains in-flight work up to a grace
  period, then sheds the remainder with typed ``shed`` completions.

Every failure path above is deterministically testable via
:mod:`znicz_tpu_torch.utils.faults` (``frontdoor.slow_tick``,
``engine.decode_step``, ``pool.alloc``, ``pool.pressure``).
"""

from __future__ import annotations

import dataclasses
import gc
import itertools
import logging
import os
import queue
import threading
import time
import traceback
from collections import deque
from typing import Callable, Dict, Iterator, List, Optional, Set

import numpy as np

from znicz_tpu_torch import observability
from znicz_tpu_torch.observability.aggregate import MetricsPusher
from znicz_tpu_torch.observability.collector import (
    TracePusher,
    attach_pusher,
    detach_pusher,
)
from znicz_tpu_torch.observability.slo import FRONTDOOR_TARGETS, SLOMonitor
from znicz_tpu_torch.services.engine import (
    Completion,
    DecodeEngine,
    RequestTimings,
)
from znicz_tpu_torch.services.errors import (
    EngineClosedError,
    RejectedError,
    RequestTooLargeError,  # noqa: F401  — re-export beside the raiser
)
from znicz_tpu_torch.utils import faults, profiling

logger = logging.getLogger(__name__)

# finish_reason values a front-door completion can carry, beyond the
# engine's own "eos"/"budget" (the failure taxonomy)
REASON_CANCELLED = "cancelled"
REASON_DEADLINE = "deadline_exceeded"
REASON_ERROR = "error"
REASON_SHED = "shed"

# stream-queue sentinel: completion follows, no more tokens
_DONE = object()
# bounded-wait quantum for "wait forever" paths (ZNC010: every blocking
# primitive in services/ carries a timeout)
_IDLE_GAP_S = 60.0


class RequestHandle:
    """Client-side view of one submitted request.  Thread-safe: any
    thread may stream, wait, or cancel; the engine thread feeds it."""

    def __init__(self, door: "ServingFrontDoor", trace_id: str):
        self._door = door
        self.id = trace_id  # client-visible trace id
        self._q: "queue.Queue" = queue.Queue()
        self._done = threading.Event()
        self._completion: Optional[Completion] = None

    @property
    def done(self) -> bool:
        return self._done.is_set()

    @property
    def completion(self) -> Optional[Completion]:
        """The typed completion once :attr:`done`, else None."""
        return self._completion

    def cancel(self) -> bool:
        """Request cancellation; False when already completed."""
        return self._door.cancel(self.id)

    def tokens(self, timeout: Optional[float] = None) -> Iterator[int]:
        """Yield generated tokens as the engine produces them,
        terminating when the request completes (for ANY reason — check
        :meth:`result` for the typed outcome).  ``timeout`` bounds the
        SILENCE between consecutive tokens; None waits indefinitely
        (safe: every termination path enqueues the sentinel)."""
        while True:
            try:
                item = self._q.get(
                    timeout=timeout if timeout is not None else _IDLE_GAP_S
                )
            except queue.Empty:
                if timeout is not None:
                    raise TimeoutError(
                        f"request {self.id}: no token within {timeout}s"
                    ) from None
                if self._done.is_set() and self._q.empty():
                    return  # belt-and-braces: never hang past completion
                continue
            if item is _DONE:
                return
            yield item

    def result(self, timeout: Optional[float] = None) -> Completion:
        """Block until the request completes; returns the typed
        :class:`Completion`.  Raises ``TimeoutError`` when ``timeout``
        (seconds) elapses first."""
        if timeout is not None:
            if not self._done.wait(timeout=timeout):
                raise TimeoutError(
                    f"request {self.id} still running after {timeout}s"
                )
        else:
            while not self._done.wait(timeout=_IDLE_GAP_S):
                pass
        assert self._completion is not None
        return self._completion


@dataclasses.dataclass(eq=False)
class _FrontRequest:
    """Front-door bookkeeping for one accepted request."""

    trace_id: str
    prompt: np.ndarray  # 1-D int32
    max_new_tokens: int
    deadline_s: Optional[float]  # relative to submit
    handle: RequestHandle
    watch: profiling.Stopwatch  # started at front-door submit
    engine_id: Optional[int] = None  # set once handed to the engine
    streamed: int = 0  # emitted tokens already pushed to the handle
    tokens: List[int] = dataclasses.field(default_factory=list)
    ttft_s: Optional[float] = None  # first token seen (front-door clock)
    # time spent in the FRONT DOOR's pending queue before the engine
    # took it — added to the completion's queue_s (the engine's own
    # queue accounting starts at engine submit)
    pending_wait_s: float = 0.0


class ServingFrontDoor:
    """Thread-safe serving facade owning a decode engine on a
    dedicated engine thread.

    Usage::

        door = ServingFrontDoor(
            lambda: PagedDecodeEngine(params, n_heads=8, eos_id=0),
            max_pending=64,
        )
        h = door.submit(prompt, max_new_tokens=64, deadline_s=30.0)
        for tok in h.tokens():
            ...                      # stream
        comp = h.result()            # typed Completion
        door.close()                 # drain + shed + stop the thread

    ``engine_factory`` must build a FRESH engine with the same config —
    it runs once at construction and again on every watchdog restart
    (restarts ride the process-wide jit caches, so they recompile
    nothing).  ``engine_queue_limit`` caps how many requests sit in the
    ENGINE's internal queue (default: its batch size); the rest wait in
    the front door's pending queue where deadlines and cancellation are
    applied without touching engine state, and where a watchdog restart
    can re-admit them losslessly."""

    def __init__(
        self,
        engine_factory: Callable[[], DecodeEngine],
        *,
        max_pending: int = 64,
        default_deadline_s: Optional[float] = None,
        shed_pool_frac: float = 0.05,
        stall_after_s: float = 10.0,
        idle_tick_s: float = 0.05,
        engine_queue_limit: Optional[int] = None,
        retry_after_s: float = 1.0,
        name: str = "znicz",
        debug_requests: int = 64,
        slo_targets=None,
        slo_windows_s=None,
        slo_sample_gap_s: float = 5.0,
        aggregator_url: Optional[str] = None,
        instance: Optional[str] = None,
        push_interval_s: float = 15.0,
        collector_url: Optional[str] = None,
        trace_push_interval_s: float = 2.0,
    ):
        if max_pending < 1:
            raise ValueError(f"want max_pending >= 1; got {max_pending}")
        self._factory = engine_factory
        self.max_pending = int(max_pending)
        self.default_deadline_s = default_deadline_s
        self.shed_pool_frac = float(shed_pool_frac)
        self.stall_after_s = float(stall_after_s)
        self.idle_tick_s = float(idle_tick_s)
        self.retry_after_s = float(retry_after_s)
        self.name = name
        self._engine: Optional[DecodeEngine] = engine_factory()
        self.engine_queue_limit = int(
            engine_queue_limit
            if engine_queue_limit is not None
            else self._engine.batch_size
        )
        self._lock = threading.Lock()
        # a watchdog restart drops the dead engine before building the
        # next: submit() waits on this (bounded) instead of refusing
        # while ``_restarting`` holds
        self._rebuilt = threading.Condition(self._lock)
        self._restarting = False
        # (fn, result box, done event) to run on the engine thread at the
        # top of its next tick (between_ticks)
        self._between: List[tuple] = []
        self._pending: "deque[_FrontRequest]" = deque()
        self._inflight: Dict[int, _FrontRequest] = {}  # engine id -> fr
        self._by_id: Dict[str, _FrontRequest] = {}
        self._cancels: Set[str] = set()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._closing = False
        self._closed = False
        self._failed = False
        self._shed_requested = False
        self._pool_free_frac = 1.0
        self._tick_started: Optional[float] = None
        self._last_tick = time.monotonic()
        # per-request ids: a per-door random suffix keeps trace ids
        # unique across restarts of the whole process
        self._ids = itertools.count()
        self._suffix = os.urandom(3).hex()
        # the serving instance name: the metrics-push tag, AND the
        # ``instance`` arg every span this door (and its engine) emits
        # carries — the trace collector's per-instance track key
        self.instance = instance or f"{name}-{self._suffix}"
        self._engine.trace_instance = self.instance
        # /debug/requests ring: the last K request summaries (newest
        # last), appended by the engine thread, read under the lock
        self._recent: "deque" = deque(maxlen=max(int(debug_requests), 1))
        # SLO judgment over the process registry: the engine thread
        # samples it on a bounded cadence so /slo always has rolling
        # windows to evaluate
        slo_kw = {
            "min_sample_gap_s": float(slo_sample_gap_s),
            # default: the client-clock front-door histograms (what
            # znicz-slo --frontdoor gates on), not the engine's own —
            # those start at ENGINE submit and cannot see a deep
            # pending queue or a wedged tick
            "targets": (
                slo_targets
                if slo_targets is not None
                else FRONTDOOR_TARGETS
            ),
        }
        if slo_windows_s is not None:
            slo_kw["windows_s"] = slo_windows_s
        self._slo = SLOMonitor(**slo_kw)
        # pristine baseline at door creation: the very first request's
        # observations must be visible as a DELTA against something
        # (the per-tick sample lands only at the end of a tick)
        self._slo.sample()
        # fleet aggregation: push this process's registry to a
        # MetricsAggregator so N replicas land in one /metrics
        # pusher wiring is all-or-nothing: a bad URL must fail the
        # constructor WITHOUT leaking an already-started background
        # pusher thread (the half-built door is discarded and close()
        # never runs on it)
        self._pusher: Optional[MetricsPusher] = None
        self._trace_pusher: Optional[TracePusher] = None
        try:
            # fleet tracing: push this process's spans to a
            # TraceCollector so N replicas land in one merged Perfetto
            # timeline.  The tracer must be recording for spans to
            # exist at all — start a buffer-only window if the
            # operator has not.  Attached (not constructed):
            # in-process colocations sharing one tracer must share ONE
            # pusher or every span pushes N times
            if collector_url:
                observability.get_tracer().ensure_recording()
                self._trace_pusher = attach_pusher(
                    collector_url,
                    instance=self.instance,
                    interval_s=trace_push_interval_s,
                )
            if aggregator_url:
                self._pusher = MetricsPusher(
                    aggregator_url,
                    instance=self.instance,
                    interval_s=push_interval_s,
                ).start()
        except Exception:
            if self._trace_pusher is not None:
                detach_pusher(self._trace_pusher)
                self._trace_pusher = None
            if self._pusher is not None:
                self._pusher.stop(timeout=0.1)
                self._pusher = None
            raise
        # per-instance tallies (the registry counters are process-wide)
        self._n_submitted = 0
        self._n_completed = 0
        self._n_cancelled = 0
        self._n_deadline = 0
        self._n_shed = 0
        self._n_restarts = 0
        self._n_rejected: Dict[str, int] = {}
        self._m_rejected = observability.counter(
            "znicz_serve_rejected_total",
            "submissions shed at the front door by reason",
            ("reason",),
        )
        self._m_deadline = observability.counter(
            "znicz_serve_deadline_exceeded_total",
            "requests retired because their deadline expired",
        )
        self._m_cancelled = observability.counter(
            "znicz_serve_cancelled_total",
            "requests retired by client cancellation",
        )
        self._m_restarts = observability.counter(
            "znicz_serve_watchdog_restarts_total",
            "engine rebuilds after an engine-thread exception",
        )
        # same family the engine retires into (get-or-create): the
        # front door is the ONLY writer of reason="error" — crash/
        # submit-failed requests bypass the engine's _retire, and
        # /slo's error_rate reads exactly this series; without it a
        # crash incident would be invisible to the SLO gate
        self._m_retired = observability.counter(
            "znicz_serve_requests_retired_total",
            "completed requests by finish reason",
            ("reason",),
        )
        self._m_pending = observability.gauge(
            "znicz_serve_frontdoor_pending",
            "requests waiting in the front-door queue",
        )
        self._m_oldest = observability.gauge(
            "znicz_serve_frontdoor_queue_age_seconds",
            "age of the oldest front-door-queued request",
        )
        self._m_inflight = observability.gauge(
            "znicz_serve_frontdoor_inflight",
            "requests handed to the engine and not yet completed",
        )
        # CLIENT-clock histograms: submit -> first streamed token /
        # completion, front-door queueing and tick cadence included —
        # what the SLO targets judge (the engine's own ttft/latency
        # series start at ENGINE submit and miss both)
        self._m_fd_ttft = observability.histogram(
            "znicz_serve_frontdoor_ttft_seconds",
            "front-door submit -> first streamed token (client clock)",
        )
        self._m_fd_latency = observability.histogram(
            "znicz_serve_frontdoor_latency_seconds",
            "front-door submit -> completion delivery (client clock)",
        )
        # the SLO judgment as ONE routable number: the max burn rate
        # across targets/windows with data, refreshed on the SLO
        # sample cadence.  A per-instance read through the aggregator
        # lets the cluster router steer traffic away from a replica
        # that is burning its error budget
        self._m_burn = observability.gauge(
            "znicz_serve_slo_burn_rate",
            "max SLO burn rate across targets and windows with data "
            "(the router load tiebreak's per-instance input)",
        )
        self._thread = threading.Thread(
            target=self._serve_loop, name=f"{name}-frontdoor", daemon=True
        )
        self._thread.start()

    # -- client surface ---------------------------------------------------

    @property
    def engine(self) -> Optional[DecodeEngine]:
        """The CURRENT engine (replaced on watchdog restart)."""
        return self._engine

    def submit(
        self,
        prompt,
        max_new_tokens: int,
        *,
        deadline_s: Optional[float] = None,
        trace_id: Optional[str] = None,
    ) -> RequestHandle:
        """Accept one request; returns its :class:`RequestHandle`.
        Single-flight validation happens HERE (before enqueue):
        malformed input raises ``ValueError``, an impossible request
        :class:`RequestTooLargeError`, a closed door
        :class:`EngineClosedError`, and load shedding
        :class:`RejectedError` — nothing invalid ever occupies a queue
        slot.  ``trace_id`` adopts an INBOUND id (the HTTP surface
        passes ``X-Znicz-Trace-Id`` through; the cluster router mints
        one per client request) so one id threads router → replica →
        engine spans instead of each process minting its own; omitted,
        the door mints as before."""
        try:
            p = np.asarray(prompt, np.int32).reshape(-1)
        except (TypeError, ValueError) as exc:
            raise ValueError(f"malformed prompt: {exc}") from exc
        if p.size == 0:
            raise ValueError("empty prompt")
        n_new = int(max_new_tokens)
        if n_new < 1:
            raise ValueError(f"want max_new_tokens >= 1; got {n_new}")
        if deadline_s is not None:
            # coerce HERE, single-flight: a non-numeric deadline must
            # fail the caller, not poison every engine-thread tick
            try:
                deadline_s = float(deadline_s)
            except (TypeError, ValueError) as exc:
                raise ValueError(
                    f"malformed deadline_s: {exc}"
                ) from exc
            if deadline_s < 0.0:
                raise ValueError(
                    f"want deadline_s >= 0; got {deadline_s}"
                )
        with self._lock:
            if self._closing or self._closed:
                self._reject("closed")
                raise EngineClosedError(
                    "front door is closed to new submissions"
                )
            if self._engine is None and self._restarting:
                self._rebuilt.wait_for(
                    lambda: not self._restarting, timeout=_IDLE_GAP_S
                )
            eng = self._engine
            if eng is None:
                self._reject("engine_down")
                raise EngineClosedError(
                    "engine is down and could not be restarted"
                )
            eng._validate_request(p, n_new)  # RequestTooLargeError
            if len(self._pending) >= self.max_pending:
                self._reject("queue_full")
                raise RejectedError(
                    f"pending queue full ({self.max_pending} requests); "
                    "retry later",
                    reason="queue_full",
                    retry_after_s=self.retry_after_s,
                )
            if (
                self.shed_pool_frac > 0.0
                and self._pending
                and self._pool_free_frac < self.shed_pool_frac
            ):
                self._reject("pool_pressure")
                raise RejectedError(
                    f"KV pool under pressure "
                    f"({self._pool_free_frac:.0%} allocatable < "
                    f"{self.shed_pool_frac:.0%} watermark) with a "
                    "backlog; retry later",
                    reason="pool_pressure",
                    retry_after_s=self.retry_after_s,
                )
            tid = self._mint_id(trace_id)
            handle = RequestHandle(self, tid)
            fr = _FrontRequest(
                trace_id=tid,
                prompt=p,
                max_new_tokens=n_new,
                deadline_s=(
                    deadline_s
                    if deadline_s is not None
                    else self.default_deadline_s
                ),
                handle=handle,
                watch=profiling.Stopwatch(),
            )
            self._pending.append(fr)
            self._by_id[tid] = fr
            self._n_submitted += 1
            self._m_pending.set(len(self._pending))
        observability.instant(
            "frontdoor/submit", id=tid, instance=self.instance
        )
        self._wake.set()
        return handle

    def _mint_id(self, trace_id: Optional[str]) -> str:
        """The request's trace id (lock held by the caller): the
        inbound id verbatim when given and not currently live; a live
        collision keeps the inbound id as a PREFIX (``-r<n>`` suffix)
        so a Perfetto substring filter still finds it; else a minted
        ``<name>-<suffix>-<n>`` id."""
        if trace_id:
            tid = str(trace_id).strip()[:128]
            if tid and tid not in self._by_id:
                return tid
            if tid:
                return f"{tid}-r{next(self._ids):04d}"
        return f"{self.name}-{self._suffix}-{next(self._ids):06d}"

    def cancel(self, trace_id: str) -> bool:
        """Request cancellation of ``trace_id`` — valid before
        admission, during decode, or after completion (then a no-op
        returning False).  Applied by the engine thread at the next
        tick; the handle resolves with a ``cancelled`` completion."""
        with self._lock:
            if trace_id not in self._by_id:
                return False
            self._cancels.add(trace_id)
        self._wake.set()
        return True

    def close(self, *, drain: bool = True, grace_s: float = 5.0) -> None:
        """Graceful shutdown: stop intake immediately (submit raises
        :class:`EngineClosedError`), give in-flight work ``grace_s``
        seconds to drain, then shed whatever remains with typed
        ``shed`` completions and stop the engine thread.  Idempotent."""
        with self._lock:
            already = self._closed
            self._closing = True
        self._wake.set()
        if already and not self._thread.is_alive():
            return
        if drain:
            deadline = time.monotonic() + grace_s
            while time.monotonic() < deadline and self.has_work():
                time.sleep(0.01)
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=grace_s + 30.0)
        if self._thread.is_alive():
            logger.error(
                "front door engine thread failed to stop (stalled tick?)"
            )
        with self._lock:  # submit() reads _closed under the lock
            self._closed = True
        if self._pusher is not None:
            # final flush AFTER the drain: the aggregator's last view of
            # this instance includes the shutdown-path counters
            self._pusher.stop()
        if self._trace_pusher is not None:
            # same contract for spans: the final requests' lifecycle
            # events land in the collector before the door goes away
            # (shared pusher: the LAST detaching component flushes)
            detach_pusher(self._trace_pusher)
            self._trace_pusher = None

    def between_ticks(self, fn: Callable[[], object], timeout: float = 300.0):
        """Run ``fn`` on the engine thread at the top of its next tick,
        while no device work of the door's is in flight, and return its
        result (or raise what it raised).  ``/debug/profile`` starts its
        profiler capture here: a process's first ``torch.profiler`` start
        (CUPTI's initialization) hangs if another thread launches CUDA
        graphs meanwhile.  Raises ``RuntimeError`` when the engine thread
        has stopped, ``TimeoutError`` after ``timeout`` seconds."""
        if threading.current_thread() is self._thread:
            return fn()
        box: Dict = {}
        done = threading.Event()
        with self._lock:
            self._between.append((fn, box, done))
        self._wake.set()
        deadline = time.monotonic() + timeout
        while not done.wait(timeout=0.1):
            if not self._thread.is_alive():
                raise RuntimeError("front door engine thread is not running")
            if time.monotonic() > deadline:
                raise TimeoutError(f"engine thread ran no tick within {timeout}s")
        if "exc" in box:
            raise box["exc"]
        return box.get("value")

    def _run_between(self) -> None:
        with self._lock:
            calls, self._between = self._between, []
        for fn, box, done in calls:
            try:
                box["value"] = fn()
            except Exception as exc:  # handed to the caller, not the watchdog
                box["exc"] = exc
            finally:
                done.set()

    def __enter__(self) -> "ServingFrontDoor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- health / introspection -------------------------------------------

    def has_work(self) -> bool:
        if self._inflight:
            return True
        with self._lock:
            if self._pending or self._cancels:
                return True
        eng = self._engine
        return eng is not None and eng._has_work()

    def watchdog_state(self) -> Dict:
        """Liveness as observed from OUTSIDE the engine thread — the
        ``/healthz`` truth.  ``stalled`` means the current tick has run
        longer than ``stall_after_s`` (a wedged device call, an
        injected slow tick); ``failed`` means the engine could not be
        rebuilt after a crash."""
        now = time.monotonic()
        started = self._tick_started
        if self._closed:
            state = "closed"
        elif self._failed:
            state = "failed"
        elif started is not None and now - started > self.stall_after_s:
            state = "stalled"
        else:
            state = "running"
        return {
            "state": state,
            "last_tick_age_s": round(now - self._last_tick, 3),
            "tick_in_flight_s": (
                round(now - started, 3) if started is not None else 0.0
            ),
            "restarts": self._n_restarts,
            "pending": len(self._pending),
            "inflight": len(self._inflight),
            # the per-replica load signal a cluster router tiebreaks on
            # (rides /healthz, so one heartbeat carries liveness AND
            # load; 1.0 on the dense backend — no pool to run dry)
            "pool_free_frac": round(self._pool_free_frac, 4),
        }

    def prefix_probe(self, prompt) -> Dict:
        """Delegate to the CURRENT engine's public
        :meth:`~znicz_tpu_torch.services.engine.DecodeEngine.prefix_probe`:
        the prompt's chained block keys plus the cached-block count —
        what a prefix-affinity router (or a test) reads instead of
        engine privates.  Advisory snapshot (the engine thread mutates
        the cache between ticks); raises :class:`EngineClosedError`
        when the engine is down."""
        eng = self._engine
        if eng is None:
            raise EngineClosedError(
                "engine is down; nothing to probe"
            )
        return eng.prefix_probe(prompt)

    def healthy(self) -> bool:
        return self.watchdog_state()["state"] == "running"

    def slo_snapshot(self) -> Dict:
        """Rolling SLO judgment (``GET /slo`` body, and the input the
        SLO-aware-scheduling rung consumes): per-target p50/p95/p99 and
        multi-window burn rates over the TTFT/latency histograms, plus
        request/error/shed rates.  Thread-safe — evaluation reads the
        registry and the monitor's sample ring, never engine state."""
        return self._slo.snapshot()

    def recent_requests(self) -> List[Dict]:
        """The ``/debug/requests`` ring: the last K completed request
        summaries, NEWEST FIRST — trace id, finish reason, latency,
        TTFT and the queue/prefill/decode timings breakdown.  Live
        debugging surface; bounded, so safe to poll."""
        with self._lock:
            return list(reversed(self._recent))

    def stats(self) -> Dict:
        """Front-door report: the admission/termination tallies plus
        the live engine's own :meth:`~DecodeEngine.stats`."""
        eng = self._engine
        with self._lock:  # _reject mutates the dict under the lock
            rejected = dict(self._n_rejected)
        return {
            "submitted": self._n_submitted,
            "completed": self._n_completed,
            "rejected": rejected,
            "cancelled": self._n_cancelled,
            "deadline_exceeded": self._n_deadline,
            "shed": self._n_shed,
            "watchdog_restarts": self._n_restarts,
            "watchdog": self.watchdog_state(),
            "engine": eng.stats() if eng is not None else {},
        }

    # -- the engine thread ------------------------------------------------

    def _serve_loop(self) -> None:
        # the WHOLE body runs under the failure handler (ZNC013): a
        # crash anywhere on this thread — has_work touching a dying
        # engine included, not just the tick itself — must become the
        # watchdog's typed restart path, never a silent thread death
        while True:
            try:
                if not self.has_work():
                    self._wake.wait(timeout=self.idle_tick_s)
                self._wake.clear()
                stopping = self._stop.is_set()
                if stopping:
                    self._shed_requested = True
                self._tick()
                if stopping and not self.has_work():
                    break
            except Exception as exc:  # engine-thread failure
                self._engine_failure(exc)
        with self._lock:
            self._closed = True

    def _tick(self) -> None:
        self._tick_started = time.monotonic()
        try:
            faults.fire("frontdoor.slow_tick")
            self._run_between()
            self._apply_control()
            if self._shed_requested:
                self._shed_all()
            self._pump_pending()
            eng = self._engine
            if eng is not None:
                # one occupancy-instrumented engine tick (admit +
                # prefill + decode/verify chunk); no-op without work
                eng.tick()
            self._stream_and_collect()
            self._publish_gauges()
            if self._slo.maybe_sample():
                # the sample cadence is also the burn-gauge cadence:
                # the router's load tiebreak reads this per-instance
                # through the aggregator
                self._publish_burn()
        finally:
            self._last_tick = time.monotonic()
            self._tick_started = None

    def _apply_control(self) -> None:
        """Cancellations and deadline expiry, applied between engine
        ticks (so engine state is only ever touched from this thread)."""
        with self._lock:
            cancels, self._cancels = self._cancels, set()
            # snapshot under the lock: submit() appends concurrently,
            # and iterating a deque mid-append raises (ZNC012)
            pending = list(self._pending)
        eng = self._engine
        for tid in cancels:
            fr = self._by_id.get(tid)
            if fr is None:
                continue  # completed before the cancel landed
            self._terminate(fr, REASON_CANCELLED, eng)
        for fr in [f for f in pending if self._expired(f)]:
            self._terminate(fr, REASON_DEADLINE, eng)
        for fr in [
            f for f in list(self._inflight.values()) if self._expired(f)
        ]:
            self._terminate(fr, REASON_DEADLINE, eng)

    @staticmethod
    def _expired(fr: _FrontRequest) -> bool:
        return (
            fr.deadline_s is not None
            and fr.watch.elapsed() > fr.deadline_s
        )

    def _terminate(
        self,
        fr: _FrontRequest,
        reason: str,
        eng: Optional[DecodeEngine],
    ) -> None:
        """Retire ``fr`` with a typed completion wherever it lives."""
        if fr.engine_id is not None and fr.engine_id in self._inflight:
            comp = (
                eng.abort(fr.engine_id, reason) if eng is not None else None
            )
            if comp is None:
                return  # already completed: the normal path wins
            self._inflight.pop(fr.engine_id, None)
            if eng is not None:
                eng.reap(fr.engine_id)
            self._finish(fr, comp)
        else:
            with self._lock:
                try:
                    self._pending.remove(fr)
                except ValueError:
                    # already terminated this tick (e.g. cancel + expiry
                    # landing together): first writer won
                    logger.debug(
                        "%s already terminated; dropping %s",
                        fr.trace_id, reason,
                    )
                    return
            self._finish(fr, self._local_completion(fr, reason))

    def _pump_pending(self) -> None:
        """Move pending work into the engine, keeping its internal
        queue shallow (``engine_queue_limit``) so most waiting happens
        HERE — where deadlines, cancellation and restart re-admission
        are cheap."""
        eng = self._engine
        if eng is None:
            return
        while True:
            with self._lock:
                if not self._pending or eng.pending >= self.engine_queue_limit:
                    break
                fr = self._pending.popleft()
            fr.pending_wait_s = fr.watch.elapsed()
            try:
                rid = eng.submit(
                    fr.prompt, fr.max_new_tokens, trace_id=fr.trace_id
                )
            except Exception as exc:
                # pre-validated, so only config drift after a restart
                # can land here; typed error, never a hung handle
                self._finish(
                    fr,
                    self._local_completion(
                        fr,
                        REASON_ERROR,
                        error=f"{type(exc).__name__}: {exc}",
                    ),
                )
                continue
            fr.engine_id = rid
            self._inflight[rid] = fr

    def _stream_and_collect(self) -> None:
        """Push newly emitted tokens to each handle's stream and reap
        completions.  A preempted row restarts decode on re-admission
        and streaming resumes past the delivered prefix — exact under
        greedy recompute; with ``temperature > 0`` the resumed suffix
        may diverge (fresh sampling draws)."""
        eng = self._engine
        if eng is None:
            return
        for st in eng._slots:
            if st is None:
                continue
            fr = self._inflight.get(st["req"].id)
            if fr is None:
                continue
            emitted = st.get("emitted") or []
            if fr.streamed < len(emitted):
                if fr.streamed == 0:
                    fr.ttft_s = fr.watch.elapsed()
                for t in emitted[fr.streamed:]:
                    fr.tokens.append(int(t))
                    fr.handle._q.put(int(t))
                fr.streamed = len(emitted)
        done = [r for r in self._inflight if r in eng.completions]
        for rid in done:
            fr = self._inflight.pop(rid)
            comp = eng.completions[rid]
            eng.reap(rid)
            self._finish(fr, comp)

    def _finish(self, fr: _FrontRequest, comp: Completion) -> None:
        """The ONE termination path: every accepted request — whatever
        its fate — flows through here exactly once, so every handle
        resolves and every stream ends."""
        comp.trace_id = fr.trace_id
        if len(comp.tokens) < fr.prompt.size + fr.streamed:
            # an abort caught the request REQUEUED after a preemption:
            # the engine's emitted list was dropped at eviction, but the
            # client already received fr.streamed tokens — the typed
            # completion must agree with the stream, not undercount it
            comp.tokens = np.concatenate(
                [fr.prompt, np.asarray(fr.tokens, np.int32)]
            )
            comp.n_new = len(fr.tokens)
            comp.tokens_per_sec = comp.n_new / max(comp.latency_s, 1e-9)
        # tokens that retired inside the final tick (or arrived with an
        # out-of-band abort) and were never streamed
        tail = comp.tokens[fr.prompt.size + fr.streamed:]
        if len(tail) and fr.streamed == 0 and fr.ttft_s is None:
            fr.ttft_s = fr.watch.elapsed()
        for t in tail:
            fr.handle._q.put(int(t))
        if comp.ttft_s is None:
            comp.ttft_s = fr.ttft_s
        # client-clock series (the SLO inputs): only the front-door
        # first-token instant — never the engine's admission-time ttft,
        # which a request aborted after a preemption (tokens reconciled
        # away, nothing ever streamed) would otherwise leak here,
        # recording a tiny engine-clock ttft for a request that sat in
        # the pending queue the whole time.  Client cancels, shutdown
        # sheds and engine-crash errors are not latency measurements —
        # a flood of fast cancels (or a burst of requests error-failed
        # 0.2s in by a crash) mid-incident must not dilute bad_frac
        # below a real breach (those fates are judged via the
        # cancelled/rejected/error rate counters instead; deadline
        # expiries DO count — they are genuinely slow requests)
        if comp.finish_reason not in (
            REASON_CANCELLED, REASON_SHED, REASON_ERROR
        ):
            self._m_fd_latency.observe(fr.watch.elapsed())
        if fr.ttft_s is not None:
            self._m_fd_ttft.observe(fr.ttft_s)
        # every completion carries the lifecycle breakdown: the engine's
        # own accounting plus the FRONT-DOOR pending wait (a request that
        # never reached the engine is pure queue time)
        if comp.timings is None:
            comp.timings = RequestTimings(
                queue_s=fr.watch.elapsed()
            ).as_dict()
        else:
            comp.timings = dict(comp.timings)
            comp.timings["queue_s"] = round(
                comp.timings.get("queue_s", 0.0) + fr.pending_wait_s, 6
            )
        fr.handle._completion = comp
        fr.handle._done.set()
        fr.handle._q.put(_DONE)
        with self._lock:
            self._by_id.pop(fr.trace_id, None)
            self._recent.append(
                {
                    "trace_id": fr.trace_id,
                    "finish_reason": comp.finish_reason,
                    "prompt_len": int(fr.prompt.size),
                    "n_new": comp.n_new,
                    "latency_ms": round(1000.0 * fr.watch.elapsed(), 1),
                    "ttft_ms": (
                        round(1000.0 * comp.ttft_s, 1)
                        if comp.ttft_s is not None
                        else None
                    ),
                    "timings": comp.timings,
                    "error": comp.error,
                    "done_unix": time.time(),  # timestamp, not a delta
                }
            )
        self._n_completed += 1
        if comp.finish_reason == REASON_DEADLINE:
            self._n_deadline += 1
            self._m_deadline.inc()
        elif comp.finish_reason == REASON_CANCELLED:
            self._n_cancelled += 1
            self._m_cancelled.inc()
        elif comp.finish_reason == REASON_SHED:
            self._n_shed += 1
            self._m_rejected.labels(reason="shutdown").inc()
        elif comp.finish_reason == REASON_ERROR:
            self._m_retired.labels(reason="error").inc()
        observability.instant(
            "frontdoor/done",
            id=fr.trace_id,
            reason=comp.finish_reason,
            latency_ms=round(1000.0 * fr.watch.elapsed(), 1),
            instance=self.instance,
        )

    def _local_completion(
        self,
        fr: _FrontRequest,
        reason: str,
        error: Optional[str] = None,
        timings: Optional[RequestTimings] = None,
    ) -> Completion:
        """A typed completion for a request the ENGINE cannot speak for
        (never admitted, or the engine just died).  ``timings`` carries
        the dead engine's real per-request accounting when the request
        HAD been admitted — without it, :meth:`_finish` would fabricate
        a 100%%-queue-wait breakdown for a request that was mid-decode
        when the engine crashed."""
        dt = fr.watch.elapsed()
        return Completion(
            id=fr.engine_id if fr.engine_id is not None else -1,
            tokens=np.concatenate(
                [fr.prompt, np.asarray(fr.tokens, np.int32)]
            ),
            n_new=len(fr.tokens),
            finish_reason=reason,
            latency_s=dt,
            tokens_per_sec=len(fr.tokens) / max(dt, 1e-9),
            bucket=0,
            ttft_s=fr.ttft_s,
            error=error,
            timings=timings.as_dict() if timings is not None else None,
        )

    def _engine_failure(self, exc: Exception) -> None:
        """The watchdog's crash path: collect what completed, fail the
        slot-resident requests with typed error completions, drop the
        dead engine, rebuild one, re-admit engine-queued work.  The
        program ledger is process-wide, so a restart ledgers no new
        program; the new engine captures its own graphs on the card."""
        logger.error(
            "engine thread failed; restarting engine", exc_info=exc
        )
        msg = f"{type(exc).__name__}: {exc}"
        eng = self._engine
        try:
            # completions that beat the crash are real — deliver them
            self._stream_and_collect()
        except Exception:
            logger.warning(
                "post-failure completion sweep failed", exc_info=True
            )
        queued_ids: Set[int] = set()
        engine_timings: Dict[int, RequestTimings] = {}
        if eng is not None:
            try:
                queued_ids = {r.id for r in eng._queue}
                # salvage the dead engine's per-request accounting so
                # crash-failed completions report their REAL breakdown
                for r in eng._queue:
                    engine_timings[r.id] = r.timings
                for st in eng._slots:
                    if st is not None:
                        engine_timings[st["req"].id] = st["req"].timings
            except Exception:
                logger.warning(
                    "could not read the failed engine's queue; failing "
                    "all in-flight requests", exc_info=True
                )
        requeue: List[_FrontRequest] = []
        for rid, fr in list(self._inflight.items()):
            if rid in queued_ids and not fr.tokens:
                fr.engine_id = None  # never admitted: recompute losslessly
                requeue.append(fr)
            else:
                self._finish(
                    fr,
                    self._local_completion(
                        fr, REASON_ERROR, error=msg,
                        timings=engine_timings.get(rid),
                    ),
                )
        self._inflight.clear()
        with self._lock:
            for fr in reversed(requeue):
                self._pending.appendleft(fr)
        self._n_restarts += 1
        self._m_restarts.inc()
        # drop the dead engine BEFORE building its successor: its slot
        # requests are failed and its queue taken, and on the card it
        # holds a whole KV pool and its CUDA graphs, which must not live
        # on beside the new engine.  The crashed tick's frames (kept by the
        # exception's traceback, and by any log handler that stored the
        # record) hold the engine too: clear their locals.  The engine and
        # its programs form a cycle, which the collector frees now
        with self._lock:
            self._engine = None
            self._restarting = True
        del eng
        traceback.clear_frames(exc.__traceback__)
        gc.collect()
        try:
            new_engine = self._factory()
        except Exception:
            logger.error(
                "engine factory failed after a crash; front door is "
                "failed-closed", exc_info=True
            )
            with self._lock:
                self._engine = None
                self._closing = True
                self._restarting = False
                self._rebuilt.notify_all()
            self._failed = True
            self._shed_requested = True  # next tick sheds the queue
            return
        new_engine.trace_instance = self.instance
        with self._lock:
            self._engine = new_engine
            self._restarting = False
            self._rebuilt.notify_all()
        self._wake.set()

    def _shed_all(self) -> None:
        """Shutdown shedding: typed ``shed`` completions for everything
        still queued or in flight — the queue never strands a client."""
        eng = self._engine
        with self._lock:
            pending, self._pending = list(self._pending), deque()
        for fr in pending:
            self._finish(fr, self._local_completion(fr, REASON_SHED))
        for rid, fr in list(self._inflight.items()):
            comp = eng.abort(rid, REASON_SHED) if eng is not None else None
            if comp is None:
                comp = self._local_completion(fr, REASON_SHED)
            elif eng is not None:
                eng.reap(rid)
            self._inflight.pop(rid, None)
            self._finish(fr, comp)

    def _publish_gauges(self) -> None:
        eng = self._engine
        with self._lock:
            n = len(self._pending)
            oldest = max(
                (f.watch.elapsed() for f in self._pending), default=0.0
            )
        self._m_pending.set(n)
        self._m_oldest.set(round(oldest, 4))
        self._m_inflight.set(len(self._inflight))
        frac = getattr(eng, "pool_free_frac", None)
        if frac is not None:
            with self._lock:  # submit()'s shed check reads it locked
                self._pool_free_frac = frac

    def _publish_burn(self) -> None:
        """Fold the rolling SLO judgment into the burn-rate gauge
        (engine thread, SLO sample cadence).  ``latest_burn`` reduces
        the capture :meth:`SLOMonitor.maybe_sample` just recorded —
        no second registry walk, no rates/percentiles computed only
        to be thrown away."""
        self._m_burn.set(self._slo.latest_burn())

    def _reject(self, reason: str) -> None:
        """Tally one shed submission (lock held by the caller)."""
        self._n_rejected[reason] = self._n_rejected.get(reason, 0) + 1
        self._m_rejected.labels(reason=reason).inc()
