"""Telemetry substrate of the host loop (port of ``znicz_tpu/observability``).

* **Registry** (:mod:`registry`): labeled counters, gauges and histograms
  with a fixed bucket ladder; Prometheus text and JSON snapshots.
* **Tracer** (:mod:`tracing`): nested host spans as Chrome trace-event
  JSONL, each inside a recording window also a
  ``torch.profiler.record_function`` range.
* **PhaseTimer** (:mod:`phases`): StepTimer-compatible phase timing that
  feeds both.
* **Pipeline attribution** (:mod:`pipeline`): per-stage input-pipeline
  timings, the H2D probe and the step-wall decomposition that the JAX
  package's ``tools/znicz-doctor`` reads.
* **Step anomaly flight recorder** (:mod:`anomaly`).
* **Fleet aggregation** (:mod:`aggregate`): a MetricsAggregator that
  replicas push registry snapshots to, and the MetricsPusher thread.
* **Fleet tracing** (:mod:`collector`): a TraceCollector that spans push to
  (TracePusher), merged into one Perfetto-loadable timeline.
* **Device telemetry** (:mod:`device`): the program ledger behind
  ``/debug/programs``, the live device memory and on-demand
  ``torch.profiler`` captures.
* **SLO monitoring** (:mod:`slo`): rolling-window percentiles and
  multi-window burn rates over declared targets (``/slo``).

The same public names as the JAX package's.  Pure stdlib at import.
"""

from znicz_tpu_torch.observability.aggregate import (  # noqa: F401
    MetricsAggregator,
    MetricsPusher,
    build_aggregator_server,
)
from znicz_tpu_torch.observability.collector import (  # noqa: F401
    TraceCollector,
    TracePusher,
    build_collector_server,
)
from znicz_tpu_torch.observability import device  # noqa: F401

from znicz_tpu_torch.observability.anomaly import (  # noqa: F401
    StepAnomalyDetector,
)
from znicz_tpu_torch.observability.phases import PhaseTimer  # noqa: F401
from znicz_tpu_torch.observability.pipeline import (  # noqa: F401
    H2DProbe,
    PipelineAttribution,
)
from znicz_tpu_torch.observability.registry import (  # noqa: F401
    DEFAULT_FRACTION_BUCKETS,
    DEFAULT_TIME_BUCKETS,
    Metric,
    MetricsRegistry,
    fraction_le,
    get_registry,
    parse_prometheus_text,
    quantile_from_cumulative,
)
from znicz_tpu_torch.observability.slo import (  # noqa: F401
    DEFAULT_TARGETS,
    SLOMonitor,
    SLOTarget,
)
from znicz_tpu_torch.observability.tracing import (  # noqa: F401
    Tracer,
    get_tracer,
    instant,
    span,
)


def counter(name: str, help: str = "", labelnames=()) -> Metric:
    """Get-or-create a counter on the default registry."""
    return get_registry().counter(name, help, labelnames)


def gauge(name: str, help: str = "", labelnames=()) -> Metric:
    """Get-or-create a gauge on the default registry."""
    return get_registry().gauge(name, help, labelnames)


def histogram(
    name: str, help: str = "", labelnames=(), buckets=DEFAULT_TIME_BUCKETS
) -> Metric:
    """Get-or-create a histogram on the default registry."""
    return get_registry().histogram(name, help, labelnames, buckets)


def prometheus_text() -> str:
    """Prometheus text exposition of the default registry."""
    return get_registry().prometheus_text()


def snapshot() -> dict:
    """JSON-able snapshot of the default registry."""
    return get_registry().snapshot()
