"""The program ledger: every program the serving path makes, once (the
ledger half of ``znicz_tpu/observability/device.py``).

In the port a "program" is what ``workflow.generate.generate_serve`` keeps
per cache key: on the card a captured CUDA graph of the decode step, on the
CPU the same step run eagerly.  Each true first make records one entry:
its wall time (the capture, or the set-up on the CPU), the optional cost
and memory figures, and its kind.  The metric names are the JAX package's,
byte for byte: ``znicz_compile_seconds{kind}`` (histogram),
``znicz_program_cost_flops_total{kind}``,
``znicz_program_cost_bytes_total{kind}`` and
``znicz_device_memory_bytes{kind,device}``.

The live device-memory gauges (``device_memory``) and the on-demand
profiler capture (``capture_profile``) are ROADMAP.md A11; so
:func:`ledger_snapshot` has no ``device_memory`` entry.  Pure stdlib.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional

from znicz_tpu_torch.observability.registry import get_registry

_LOCK = threading.Lock()
# ledger key -> entry dict, insertion (= make) order
_PROGRAMS: "OrderedDict[str, dict]" = OrderedDict()


def _m_compile_seconds():
    return get_registry().histogram(
        "znicz_compile_seconds",
        "wall time of true first compiles by program kind",
        ("kind",),
    )


def _m_cost_flops():
    return get_registry().counter(
        "znicz_program_cost_flops_total",
        "cost-analysis FLOPs of compiled programs, summed per kind",
        ("kind",),
    )


def _m_cost_bytes():
    return get_registry().counter(
        "znicz_program_cost_bytes_total",
        "cost-analysis bytes accessed of compiled programs, per kind",
        ("kind",),
    )


def _m_device_memory():
    return get_registry().gauge(
        "znicz_device_memory_bytes",
        "device memory by kind: executable sizes (summed over compiled "
        "programs) and live memory_stats where the backend reports them",
        ("kind", "device"),
    )


def record_program(
    key,
    compile_s: float,
    *,
    kind: Optional[str] = None,
    source: str = "engine",
    cost: Optional[dict] = None,
    memory: Optional[dict] = None,
    dedup=None,
) -> dict:
    """Ledger one program.  ``key`` is the display key; ``dedup`` (default:
    the key itself) is the uniqueness key.  ``kind`` defaults to the key's
    first element.  Call only on a true first make; the caller owns that
    dedup."""
    kind = kind if kind is not None else (
        key[0] if isinstance(key, tuple) and key else str(key)
    )
    entry = {
        "key": str(key),
        "kind": str(kind),
        "source": source,
        "compile_s": round(float(compile_s), 6),
        "flops": (cost or {}).get("flops"),
        "bytes_accessed": (cost or {}).get("bytes_accessed"),
        "memory": memory,
        "recorded_unix": time.time(),  # timestamp, not a delta
    }
    ledger_key = f"{source}:{dedup if dedup is not None else key}"
    with _LOCK:
        _PROGRAMS[ledger_key] = entry
    _m_compile_seconds().labels(kind=entry["kind"]).observe(float(compile_s))
    if entry["flops"]:
        _m_cost_flops().labels(kind=entry["kind"]).inc(entry["flops"])
    if entry["bytes_accessed"]:
        _m_cost_bytes().labels(kind=entry["kind"]).inc(entry["bytes_accessed"])
    if memory and memory.get("generated_code_size_in_bytes"):
        with _LOCK:
            total = sum(
                (e.get("memory") or {}).get("generated_code_size_in_bytes", 0)
                for e in _PROGRAMS.values()
            )
        _m_device_memory().labels(kind="executable", device="all").set(float(total))
    return entry


def programs(source: Optional[str] = None) -> List[dict]:
    """The ledger entries in make order (copies; filter by ``source``)."""
    with _LOCK:
        return [
            dict(e) for e in _PROGRAMS.values()
            if source is None or e["source"] == source
        ]


def program_count(source: Optional[str] = None) -> int:
    with _LOCK:
        return sum(
            1 for e in _PROGRAMS.values() if source is None or e["source"] == source
        )


def compile_seconds_total() -> float:
    with _LOCK:
        return round(sum(e["compile_s"] for e in _PROGRAMS.values()), 6)


def ledger_snapshot() -> dict:
    """The full entry list and the headline counts (the JAX package's
    ``/debug/programs`` body, without its ``device_memory``)."""
    progs = programs()
    by_kind: Dict[str, int] = {}
    for e in progs:
        by_kind[e["kind"]] = by_kind.get(e["kind"], 0) + 1
    return {
        "programs": progs,
        "count": len(progs),
        "engine_count": sum(1 for e in progs if e["source"] == "engine"),
        "by_kind": by_kind,
        "compile_seconds_total": round(sum(e["compile_s"] for e in progs), 6),
    }
