"""Per-phase timing that feeds the registry and the span tracer (port of
``znicz_tpu/observability/phases.py``).

:class:`PhaseTimer` keeps ``utils.profiling.StepTimer``'s ``with
timer.phase(name):`` call sites, and every phase (1) emits a tracer span
(inside a recording window also a ``torch.profiler.record_function`` range,
so a concurrent device capture carries the same names) and (2) observes into
one shared registry histogram labeled by phase.

``summary()`` stays StepTimer-shaped (``{phase: {total_s, count,
mean_ms}}``) but is a delta against a baseline captured at construction (or
the last ``reset()``): the registry series live as long as the process,
while a workflow only reports its own window.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, Optional, Sequence, Tuple

from znicz_tpu_torch.observability.registry import (
    DEFAULT_TIME_BUCKETS,
    MetricsRegistry,
    get_registry,
)
from znicz_tpu_torch.observability.tracing import Tracer, get_tracer


class PhaseTimer:
    """StepTimer-compatible phase ledger backed by a registry histogram."""

    def __init__(
        self,
        metric: str = "znicz_phase_seconds",
        *,
        help: str = "per-phase wall-clock seconds",
        span_prefix: str = "",
        registry: Optional[MetricsRegistry] = None,
        tracer: Optional[Tracer] = None,
        buckets: Sequence[float] = DEFAULT_TIME_BUCKETS,
    ):
        self._registry = registry if registry is not None else get_registry()
        self._hist = self._registry.histogram(
            metric, help, ("phase",), buckets=buckets
        )
        self._tracer = tracer if tracer is not None else get_tracer()
        self._prefix = span_prefix
        self._base: Dict[str, Tuple[int, float]] = {}
        self.reset()

    @contextlib.contextmanager
    def phase(self, name: str, **span_args) -> Iterator[None]:
        """Time one phase: span ``<prefix><name>`` + histogram observe.
        ``span_args`` ride into the trace event (request ids, buckets)."""
        with self._tracer.span(self._prefix + name, **span_args):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self._hist.labels(phase=name).observe(
                    time.perf_counter() - t0
                )

    def _totals(self) -> Dict[str, Tuple[int, float]]:
        return {
            key[0]: (child.count, child.sum)
            for key, child in self._hist.children().items()
        }

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-phase ``{total_s, count, mean_ms}`` since construction or
        the last :meth:`reset` — StepTimer-shaped, registry-sourced."""
        out = {}
        for name, (count, total) in self._totals().items():
            base_count, base_total = self._base.get(name, (0, 0.0))
            if count < base_count:
                # the family was reset() behind our back (e.g. a
                # warm-up pipeline.reset_window()): the captured base
                # is stale — fall back to the fresh series as-is
                # instead of reporting empty/negative windows forever
                base_count, base_total = 0, 0.0
                self._base[name] = (0, 0.0)
            n, s = count - base_count, total - base_total
            if n > 0:
                out[name] = {
                    "total_s": s,
                    "count": n,
                    "mean_ms": 1000.0 * s / n,
                }
        return dict(
            sorted(out.items(), key=lambda kv: -kv[1]["total_s"])
        )

    def reset(self) -> None:
        """Re-baseline this instance's window (the registry keeps the
        process-lifetime series untouched)."""
        self._base = self._totals()
