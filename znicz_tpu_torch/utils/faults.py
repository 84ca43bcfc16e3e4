"""Fault injection: named failure points, toggled per test or per
environment (port of ``znicz_tpu/utils/faults.py``, the same point names
and arming API).

Points fired by the port's host loop, its serving engines, the front door,
the fleet telemetry's pushers and the cluster router:

========================  ==================================================
point                     effect when armed
========================  ==================================================
``engine.decode_step``    raises before a decode (or spec-verify) chunk's
                          program runs (``services/engine.py``)
``engine.prefill``        raises before a paged prefill chunk runs
``pool.alloc``            raises inside the paged engine's block allocator
``pool.pressure``         behavioral (``flag=True``): the allocator reports
                          the pool dry (free list and cache), driving the
                          eviction and preemption ladder without filling
                          the pool
``frontdoor.slow_tick``   sleeps at the top of the engine-thread tick (a
                          stalled tick: the watchdog-detection path;
                          also how SLO-breach latency is injected)
``pusher.push``           raises/sleeps inside a MetricsPusher push (a
                          dead or slow aggregator: the push failure
                          path — counted, logged, never propagated)
``trace_pusher.push``     raises/sleeps inside a TracePusher push (a dead
                          or slow trace collector: the batch is dropped,
                          counted and logged, never propagated)
``router.connect``        raises as the cluster router opens a replica
                          connection (replica connect refused: the
                          route-to-next-best failover path)
``router.stream``         raises as the router reads one record of a
                          replica's token stream (mid-stream replica
                          death: the skip-prefix re-route path; arm
                          with ``after=k`` to let k records through
                          first)
``router.heartbeat``      raises inside a registry heartbeat probe
                          (heartbeat timeout: the ejection /
                          re-admission ladder without killing a real
                          server)
``loader.fetch``          fires inside the prefetch producer's timed fetch
                          of one batch (arm with ``delay=`` for a
                          deterministic slow producer: the input-bound
                          attribution fixture)
``loader.fetch_flaky``    fires before each ``Loader.fill`` attempt, behind
                          the retry ladder (arm with ``times=k`` for k
                          transient failures; unlimited exhausts the budget:
                          ``LoaderFetchError``, or a skipped batch)
``loader.h2d``            fires inside the H2D probe's measured region (arm
                          with ``delay=`` for a slow host->device link)
``snapshot.write``        raises inside the snapshot file write, before the
                          atomic replace (``maybe_save`` counts it and
                          continues; the previous snapshot stays intact)
``snapshot.load``         raises at the top of ``load_snapshot`` (an
                          unreadable checkpoint: ``find_latest_valid``
                          skips it)
``train.crash``           raises at the top of ``Workflow.run_epoch`` (arm
                          with ``after=k`` to crash entering epoch k)
``train.step_nan``        behavioral (``flag=True``): the anomaly watch reads
                          the step's loss as NaN without poisoning the state
                          (the rollback path's fixture; ``after=k`` picks the
                          (k+1)-th watched step)
========================  ==================================================

Arming::

    with faults.injected("loader.fetch", delay=0.02):
        ...          # every fetch sleeps 20 ms, disarmed on exit

    faults.inject("snapshot.write", times=1)   # one write fails

or from the environment (process-wide)::

    ZNICZ_FAULTS="snapshot.write:times=1,loader.fetch:delay=0.2"

Each spec is ``point[:field]...`` with fields ``times=<int>`` (default
unlimited), ``after=<int>`` (the first ``after`` fires pass through),
``delay=<seconds>`` and ``flag`` (behavioral: fire just returns True); a
point with none of ``exc``/``delay``/``flag`` raises
:class:`FaultInjected` when fired.  An unarmed registry costs one
truthiness check on an empty dict.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Iterator, Optional

__all__ = [
    "FaultInjected",
    "inject",
    "clear",
    "fire",
    "armed",
    "injected",
]


class FaultInjected(RuntimeError):
    """The default exception an armed raise-point throws."""


class _Fault:
    __slots__ = ("name", "exc", "delay", "remaining", "after")

    def __init__(self, name: str, exc: Optional[BaseException],
                 delay: float, times: Optional[int], after: int):
        self.name = name
        self.exc = exc
        self.delay = float(delay)
        self.remaining = times  # None = until cleared
        self.after = int(after)  # fires to let through before acting


# module-level registry: empty in production, so fire() is one dict
# truthiness check on the hot path
_ARMED: Dict[str, _Fault] = {}
_LOCK = threading.Lock()


def inject(
    name: str,
    *,
    exc: Optional[BaseException] = None,
    delay: float = 0.0,
    times: Optional[int] = None,
    flag: bool = False,
    after: int = 0,
) -> None:
    """Arm ``name``.  ``exc`` raises at the point; ``delay`` sleeps
    there; ``flag`` arms a BEHAVIORAL point (``fire`` just returns
    True — e.g. ``pool.pressure`` reports the pool dry).  With none of
    the three, firing raises :class:`FaultInjected`.  ``times`` bounds
    how many fires before auto-disarm (None = until :func:`clear`);
    ``after`` lets the first N fires pass through untouched first —
    "the third stream read dies", not the first."""
    if exc is None and delay == 0.0 and not flag:
        exc = FaultInjected(f"injected fault at {name!r}")
    with _LOCK:
        _ARMED[name] = _Fault(name, exc, delay, times, after)


def clear(name: Optional[str] = None) -> None:
    """Disarm ``name`` (or every point when None).  Idempotent."""
    with _LOCK:
        if name is None:
            _ARMED.clear()
        else:
            _ARMED.pop(name, None)


def armed(name: str) -> bool:
    if not _ARMED:
        return False
    with _LOCK:
        return name in _ARMED


def fire(name: str) -> bool:
    """The injection point: no-op False when ``name`` is unarmed; when
    armed, sleeps ``delay`` and/or raises ``exc``, decrementing the
    remaining-fires budget, and returns True (behavioral points branch
    on it).  Thread-safe; auto-disarms once ``times`` is spent."""
    if not _ARMED:  # production fast path: one dict truthiness check
        return False
    with _LOCK:
        fault = _ARMED.get(name)
        if fault is None:
            return False
        if fault.after > 0:
            fault.after -= 1
            return False  # pass-through fire: not yet our turn
        if fault.remaining is not None:
            fault.remaining -= 1
            if fault.remaining <= 0:
                del _ARMED[name]
    if fault.delay:
        time.sleep(fault.delay)
    if fault.exc is not None:
        raise fault.exc
    return True


@contextlib.contextmanager
def injected(
    name: str,
    *,
    exc: Optional[BaseException] = None,
    delay: float = 0.0,
    times: Optional[int] = None,
    flag: bool = False,
    after: int = 0,
) -> Iterator[None]:
    """Scoped :func:`inject` — the point is disarmed on exit even if
    the body (or the fault itself) raised."""
    inject(name, exc=exc, delay=delay, times=times, flag=flag, after=after)
    try:
        yield
    finally:
        clear(name)


def _parse_env(spec: str) -> None:
    """``ZNICZ_FAULTS="a.b:times=1,c.d:delay=0.5"`` — malformed specs
    raise at import so a typo'd chaos config can't silently arm
    nothing."""
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        kwargs: Dict = {}
        for field in fields[1:]:
            key, _, value = field.partition("=")
            if key == "times":
                kwargs["times"] = int(value)
            elif key == "after":
                kwargs["after"] = int(value)
            elif key == "delay":
                kwargs["delay"] = float(value)
            elif key == "flag" and not value:
                kwargs["flag"] = True
            else:
                raise ValueError(
                    f"ZNICZ_FAULTS: unknown field {key!r} in {part!r} "
                    "(want times=<int>, after=<int>, delay=<seconds>, "
                    "or flag)"
                )
        inject(fields[0], **kwargs)


_ENV = os.environ.get("ZNICZ_FAULTS", "")
if _ENV:
    _parse_env(_ENV)
