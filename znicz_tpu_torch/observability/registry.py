"""Process-wide metrics registry: labeled counters, gauges, histograms
(port of ``znicz_tpu/observability/registry.py``).

A thread-safe registry of named metrics with fixed-ladder histogram
buckets, exported as Prometheus text (:meth:`MetricsRegistry.prometheus_text`,
byte-identical to the JAX package's for the same observations, so its
``tools/znicz-doctor`` reads a port run's ``metrics.prom``) and as a
JSON-able snapshot (:meth:`MetricsRegistry.snapshot`).  Pure stdlib.
Metric creation is get-or-create: two subsystems asking for the same name
share the series; a conflicting kind or label set is an error.
"""

from __future__ import annotations

import json
import math
import re
import threading
from bisect import bisect_left
from typing import Dict, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# One shared seconds ladder (~100 us .. 60 s) for every latency-shaped
# histogram: fixed buckets keep series comparable across subsystems and
# exposition size bounded regardless of traffic.
DEFAULT_TIME_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

# The fraction ladder (0..1) for occupancy/utilization-shaped
# histograms — per-tick phase occupancy, attribution fractions.  Dense
# near the edges where "idle" vs "saturated" verdicts live.
DEFAULT_FRACTION_BUCKETS = (
    0.01, 0.025, 0.05, 0.1, 0.2, 0.3, 0.4, 0.5,
    0.6, 0.7, 0.8, 0.9, 0.95, 0.99, 1.0,
)


def quantile_from_cumulative(
    cum: Sequence[Tuple[float, float]], q: float
) -> Optional[float]:
    """Bucket-interpolated quantile from ``[(upper_bound,
    cumulative_count), ...]`` (last pair is the +Inf bucket).  None when
    empty.  Shared by the live histogram children, the fleet aggregator's
    merged series, and the SLO monitor's windowed deltas — one
    interpolation rule everywhere."""
    if not cum:
        return None
    total = cum[-1][1]
    if total <= 0:
        return None
    target = q * total
    lo = 0.0
    prev = 0.0
    for upper, acc in cum:
        if acc >= target:
            if upper == math.inf:
                return lo  # best finite estimate: last finite edge
            span = acc - prev
            frac = (target - prev) / span if span else 1.0
            return lo + (upper - lo) * frac
        lo = upper if upper != math.inf else lo
        prev = acc
    return lo


def fraction_le(
    cum: Sequence[Tuple[float, float]], threshold: float
) -> float:
    """Interpolated fraction of observations <= ``threshold`` from the
    same cumulative-bucket shape.  1.0 when the series is empty (no
    evidence of a violation).  The SLO monitor's "good fraction"."""
    if not cum:
        return 1.0
    total = cum[-1][1]
    if total <= 0:
        return 1.0
    lo = 0.0
    prev = 0.0
    for upper, acc in cum:
        if upper >= threshold:
            if upper == math.inf:
                # samples past the last finite edge sit above any finite
                # threshold: count only what is provably below
                return prev / total
            span = upper - lo
            frac = (threshold - lo) / span if span else 1.0
            return (prev + frac * (acc - prev)) / total
        lo = upper
        prev = acc
    return 1.0


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if v != v:
        return "NaN"
    f = float(v)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class _CounterChild:
    """One labeled counter series (monotone non-decreasing)."""

    __slots__ = ("_lock", "_value")

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counters only go up; got inc({amount})")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class _GaugeChild:
    """One labeled gauge series (settable level)."""

    __slots__ = ("_lock", "_value")

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class _HistogramChild:
    """One labeled histogram series over a fixed bucket ladder."""

    __slots__ = ("_lock", "_uppers", "_counts", "_sum", "_count")

    def __init__(self, lock: threading.RLock, uppers: Tuple[float, ...]):
        self._lock = lock
        self._uppers = uppers  # strictly increasing, last is +inf
        self._counts = [0] * len(uppers)
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            # le semantics: the first upper bound >= v owns the sample
            self._counts[bisect_left(self._uppers, v)] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def cumulative(self) -> List[Tuple[float, int]]:
        """[(upper_bound, cumulative_count)] including the +Inf bucket."""
        with self._lock:
            out, acc = [], 0
            for upper, n in zip(self._uppers, self._counts):
                acc += n
                out.append((upper, acc))
            return out

    def quantile(self, q: float) -> Optional[float]:
        """Bucket-interpolated quantile estimate (None when empty)."""
        return quantile_from_cumulative(self.cumulative(), q)


class Metric:
    """A named metric family: one child series per label-value tuple."""

    def __init__(
        self,
        registry: "MetricsRegistry",
        name: str,
        help: str,
        kind: str,
        labelnames: Tuple[str, ...],
        buckets: Optional[Tuple[float, ...]] = None,
    ):
        self.name = name
        self.help = help
        self.kind = kind
        self.labelnames = labelnames
        self.buckets = buckets
        self._registry = registry
        self._lock = registry._lock
        self._children: Dict[Tuple[str, ...], object] = {}
        if not labelnames:
            self._children[()] = self._make_child()

    def _make_child(self):
        if self.kind == "counter":
            return _CounterChild(self._lock)
        if self.kind == "gauge":
            return _GaugeChild(self._lock)
        return _HistogramChild(self._lock, self.buckets)

    def labels(self, *values, **kv):
        """The child series for one label-value set (created on demand,
        capped at the registry's cardinality limit)."""
        if kv:
            if values:
                raise ValueError("pass labels positionally OR by name")
            try:
                values = tuple(str(kv[n]) for n in self.labelnames)
            except KeyError as e:
                raise ValueError(
                    f"{self.name}: missing label {e}; wants "
                    f"{self.labelnames}"
                ) from e
            if len(kv) != len(self.labelnames):
                extra = set(kv) - set(self.labelnames)
                raise ValueError(f"{self.name}: unknown label(s) {extra}")
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name} wants labels {self.labelnames}; got "
                f"{values!r}"
            )
        with self._lock:
            child = self._children.get(values)
            if child is None:
                if len(self._children) >= self._registry.max_series:
                    raise ValueError(
                        f"{self.name}: label cardinality exceeds "
                        f"{self._registry.max_series} series — a label "
                        "value is probably unbounded (request id, path)"
                    )
                child = self._children[values] = self._make_child()
            return child

    def children(self) -> Dict[Tuple[str, ...], object]:
        with self._lock:
            return dict(self._children)

    def reset(self) -> None:
        """Drop every child series (tests / explicit counter resets)."""
        with self._lock:
            self._children.clear()
            if not self.labelnames:
                self._children[()] = self._make_child()

    # unlabeled convenience: the metric IS its single series
    def _default(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} is labeled {self.labelnames}; use .labels()"
            )
        return self._children[()]

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default().dec(amount)

    def set(self, value: float) -> None:
        self._default().set(value)

    def observe(self, value: float) -> None:
        self._default().observe(value)

    @property
    def value(self) -> float:
        return self._default().value


class MetricsRegistry:
    """Thread-safe get-or-create registry of named metric families."""

    def __init__(self, *, max_series_per_metric: int = 1000):
        self._lock = threading.RLock()
        self._metrics: Dict[str, Metric] = {}
        self.max_series = max_series_per_metric

    def _get_or_create(
        self, name, help, kind, labelnames, buckets=None
    ) -> Metric:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        labelnames = tuple(labelnames)
        for ln in labelnames:
            if not _LABEL_RE.match(ln) or ln == "le":
                raise ValueError(f"invalid label name {ln!r} on {name}")
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if (
                    existing.kind != kind
                    or existing.labelnames != labelnames
                    or (buckets is not None and existing.buckets != buckets)
                ):
                    raise ValueError(
                        f"metric {name} already registered as "
                        f"{existing.kind}{existing.labelnames}; cannot "
                        f"re-register as {kind}{labelnames}"
                    )
                return existing
            m = Metric(self, name, help, kind, labelnames, buckets)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "", labelnames=()) -> Metric:
        return self._get_or_create(name, help, "counter", labelnames)

    def gauge(self, name: str, help: str = "", labelnames=()) -> Metric:
        return self._get_or_create(name, help, "gauge", labelnames)

    def histogram(
        self,
        name: str,
        help: str = "",
        labelnames=(),
        buckets: Sequence[float] = DEFAULT_TIME_BUCKETS,
    ) -> Metric:
        finite = sorted({float(b) for b in buckets if b != math.inf})
        if not finite:
            raise ValueError(f"{name}: want at least one finite bucket")
        uppers = tuple(finite) + (math.inf,)
        return self._get_or_create(
            name, help, "histogram", labelnames, uppers
        )

    def metrics(self) -> Dict[str, Metric]:
        with self._lock:
            return dict(self._metrics)

    def reset(self) -> None:
        """Zero every series (test isolation; keeps registrations)."""
        for m in self.metrics().values():
            m.reset()

    # -- exports -----------------------------------------------------------

    def snapshot(self) -> Dict[str, dict]:
        """JSON-able dict of every series; histograms carry count/sum,
        bucket counts and interpolated p50/p95/p99 estimates."""
        out: Dict[str, dict] = {}
        for name, m in sorted(self.metrics().items()):
            series = []
            for values, child in sorted(m.children().items()):
                labels = dict(zip(m.labelnames, values))
                if m.kind == "histogram":
                    series.append(
                        {
                            "labels": labels,
                            "count": child.count,
                            "sum": child.sum,
                            "buckets": {
                                _fmt_value(u): c
                                for u, c in child.cumulative()
                            },
                            "p50": child.quantile(0.5),
                            "p95": child.quantile(0.95),
                            "p99": child.quantile(0.99),
                        }
                    )
                else:
                    series.append({"labels": labels, "value": child.value})
            out[name] = {"type": m.kind, "help": m.help, "series": series}
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition (format 0.0.4)."""
        lines: List[str] = []
        for name, m in sorted(self.metrics().items()):
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            for values, child in sorted(m.children().items()):
                base = list(zip(m.labelnames, values))
                if m.kind == "histogram":
                    for upper, acc in child.cumulative():
                        lines.append(
                            _sample(
                                f"{name}_bucket",
                                base + [("le", _fmt_value(upper))],
                                acc,
                            )
                        )
                    lines.append(_sample(f"{name}_sum", base, child.sum))
                    lines.append(_sample(f"{name}_count", base, child.count))
                else:
                    lines.append(_sample(name, base, child.value))
        return "\n".join(lines) + "\n"


def _sample(name: str, labels, value) -> str:
    if labels:
        inner = ",".join(
            f'{k}="{_escape_label(str(v))}"' for k, v in labels
        )
        return f"{name}{{{inner}}} {_fmt_value(value)}"
    return f"{name} {_fmt_value(value)}"


# -- exposition parsing ----------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{((?:[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\]|\\.)*\",?\s*)*)\})?"
    r"\s+(\S+)(?:\s+\d+)?$"
)
_LABEL_PAIR_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prometheus_text(text: str) -> dict:
    """Strict-enough parser for the 0.0.4 text exposition.

    Returns ``{"types": {...}, "helps": {...}, "samples":
    [(name, labels_dict, value), ...]}`` and raises ``ValueError`` on
    any malformed line — the tier-1 acceptance check that ``/metrics``
    stays machine-readable, with no external scrape stack needed.
    """
    types: Dict[str, str] = {}
    helps: Dict[str, str] = {}
    samples: List[Tuple[str, Dict[str, str], float]] = []
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            parts = line.split(" ", 3)
            if len(parts) < 3:
                raise ValueError(f"line {lineno}: malformed HELP: {line!r}")
            helps[parts[2]] = parts[3] if len(parts) > 3 else ""
            continue
        if line.startswith("# TYPE "):
            parts = line.split(" ")
            if len(parts) != 4 or parts[3] not in (
                "counter", "gauge", "histogram", "summary", "untyped"
            ):
                raise ValueError(f"line {lineno}: malformed TYPE: {line!r}")
            types[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            continue  # plain comment
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {lineno}: malformed sample: {line!r}")
        name, labelsrc, valuesrc = m.group(1), m.group(2), m.group(3)
        try:
            value = float(valuesrc)  # accepts +Inf/-Inf/NaN
        except ValueError as e:
            raise ValueError(
                f"line {lineno}: bad sample value {valuesrc!r}"
            ) from e
        labels = {}
        if labelsrc:
            for lm in _LABEL_PAIR_RE.finditer(labelsrc):
                labels[lm.group(1)] = (
                    lm.group(2)
                    .replace("\\n", "\n")
                    .replace('\\"', '"')
                    .replace("\\\\", "\\")
                )
        samples.append((name, labels, value))
    # histogram invariants: cumulative buckets and le=+Inf == _count
    for name, kind in types.items():
        if kind != "histogram":
            continue
        by_series: Dict[Tuple, List[Tuple[float, float]]] = {}
        counts: Dict[Tuple, float] = {}
        for sname, labels, value in samples:
            key = tuple(
                sorted((k, v) for k, v in labels.items() if k != "le")
            )
            if sname == f"{name}_bucket":
                le = labels.get("le")
                if le is None:
                    raise ValueError(
                        f"{name}_bucket sample missing 'le' label"
                    )
                by_series.setdefault(key, []).append((float(le), value))
            elif sname == f"{name}_count":
                counts[key] = value
        for key, edges in by_series.items():
            edges.sort()
            cum = [c for _, c in edges]
            if cum != sorted(cum):
                raise ValueError(f"{name}: non-cumulative buckets at {key}")
            if edges[-1][0] != math.inf:
                raise ValueError(f"{name}: missing le=+Inf bucket at {key}")
            if key in counts and counts[key] != edges[-1][1]:
                raise ValueError(
                    f"{name}: le=+Inf != _count at {key}"
                )
    return {"types": types, "helps": helps, "samples": samples}


# -- default (process-wide) registry ---------------------------------------

_DEFAULT = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry every subsystem feeds."""
    return _DEFAULT


def snapshot_json(indent: Optional[int] = None) -> str:
    return json.dumps(_DEFAULT.snapshot(), indent=indent)
