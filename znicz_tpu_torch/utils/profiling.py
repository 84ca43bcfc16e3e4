"""Tracing / profiling (port of ``znicz_tpu/utils/profiling.py``).

:func:`trace` captures the device with ``torch.profiler`` and writes a
Chrome trace; :class:`Stopwatch`, :class:`LatencyStats` and
:class:`StepTimer` are the light host-side timing helpers, as in the JAX
package.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Iterator, List, Optional


@contextlib.contextmanager
def trace(log_dir: str, *, cuda: Optional[bool] = None) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the block and write it as a
    Chrome trace (``<log_dir>/trace.json``, open in Perfetto).  The card's
    kernels are recorded when ``cuda`` (default: when a card is present).

    Usage::

        with profiling.trace("build/trace"):
            workflow.run_epoch()
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Stopwatch:
    """Wall-clock elapsed-seconds tracker.

    The one shared implementation of the run-lifetime bookkeeping that
    the status page, the run report and the training loop all need —
    monotonic (immune to NTP clock steps mid-run), resettable, and
    loggable without each consumer keeping its own ``t0`` arithmetic.
    """

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._t0 = time.monotonic()

    def elapsed(self) -> float:
        """Seconds since construction (or the last :meth:`reset`)."""
        return time.monotonic() - self._t0


class LatencyStats:
    """Order-statistics aggregate for per-request latencies.

    The serving engine (services/engine.py) records one sample per
    retired request; the summary is what the serve bench and status
    surfaces report.  Plain Python like the rest of this module — no
    numpy dependency for a handful of floats.

    Memory is BOUNDED: a ring buffer keeps the most recent
    ``max_samples`` observations (a long-lived engine must not grow a
    list forever), so percentiles/mean describe that sliding window
    while ``count`` stays the lifetime total.  ``observe`` (when given)
    is called once per recorded sample — the hook the engine uses to
    feed the shared metrics-registry histogram without keeping a second
    ledger beside it."""

    def __init__(
        self,
        max_samples: int = 4096,
        observe: Optional[Callable[[float], None]] = None,
    ):
        if max_samples < 1:
            raise ValueError(f"want max_samples >= 1; got {max_samples}")
        self._cap = int(max_samples)
        self._observe = observe
        self._samples: List[float] = []
        self._next = 0  # ring write cursor once the buffer is full
        self._count = 0

    def record(self, seconds: float) -> None:
        v = float(seconds)
        if self._observe is not None:
            self._observe(v)
        if len(self._samples) < self._cap:
            self._samples.append(v)
        else:
            self._samples[self._next] = v
            self._next = (self._next + 1) % self._cap
        self._count += 1

    def __len__(self) -> int:
        """Lifetime sample count (not the retained-window size)."""
        return self._count

    def summary(self) -> Dict[str, float]:
        if not self._samples:
            return {"count": 0}
        s = sorted(self._samples)

        def pct(p: float) -> float:
            return s[min(len(s) - 1, int(round(p * (len(s) - 1))))]

        return {
            "count": self._count,
            "mean_ms": 1000.0 * sum(s) / len(s),
            "p50_ms": 1000.0 * pct(0.5),
            "p95_ms": 1000.0 * pct(0.95),
            "p99_ms": 1000.0 * pct(0.99),
            "max_ms": 1000.0 * s[-1],
        }

    def reset(self) -> None:
        self._samples.clear()
        self._next = 0
        self._count = 0


class StepTimer:
    """Accumulate per-phase wall-clock times (the reference's per-unit timing
    ledger, SURVEY.md 5.1) without forcing device syncs: timings are host
    dispatch+block times and are meaningful at epoch granularity."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": total,
                "count": self.counts[name],
                "mean_ms": 1000.0 * total / max(self.counts[name], 1),
            }
            for name, total in sorted(
                self.totals.items(), key=lambda kv: -kv[1]
            )
        }

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()
