"""Device & compile telemetry: the program ledger behind /debug/programs,
the live device memory and on-demand profiler captures (port of
``znicz_tpu/observability/device.py``).

In the port a "program" is what ``workflow.generate.generate_serve`` and
the serving engines keep per key: on the card a captured CUDA graph, on the
CPU the same step run eagerly.  Each true first make records one entry:
its wall time (the capture, or the set-up on the CPU), the optional cost
and memory figures, and its kind.  The metric names are the JAX package's,
byte for byte: ``znicz_compile_seconds{kind}`` (histogram),
``znicz_program_cost_flops_total{kind}``,
``znicz_program_cost_bytes_total{kind}`` and
``znicz_device_memory_bytes{kind,device}``.

* :func:`device_memory` — one entry a visible CUDA device (``cuda:<i>``)
  with ``bytes_in_use`` / ``peak_bytes_in_use`` (the caching allocator's
  ``allocated_bytes.all.current`` / ``.peak``) and ``bytes_limit`` (the
  card's total memory), which also feed ``znicz_device_memory_bytes
  {kind=in_use|peak|limit}``; without a card ``{"device": "cpu:0",
  "stats": null}``, as the JAX package's CPU device answers.
* :func:`capture_profile` — one bounded ``torch.profiler`` capture (CPU
  activity, and CUDA activity where a card is present) inside a
  ``debug/profile`` span, written as a Chrome trace (``trace.json``) into
  the returned directory, where the JAX package writes a
  ``jax.profiler`` log directory (``POST /debug/profile``).  On the card
  a process's first capture spends seconds starting CUPTI before its
  window opens, and in a process that has captured CUDA graphs torch
  keeps CUPTI subscribed after the capture (it cannot tear it down safely
  there): every later graph launch issues slower.

The cost figures come from the program's own first run, never from an
extra one (a decode or engine step updates its caches and row state in
place, so a second run would change the tokens):

* :func:`lowered_cost` runs a program's first eager call (the run before
  a capture; on the CPU, its first call) under
  ``torch.utils.flop_counter.FlopCounterMode`` and returns its result
  and :func:`stage_cost` of the counter.  ``flops`` counts what the
  counter sees: matmuls, convolutions and attention, where XLA's cost
  analysis also counts elementwise and transcendental work.  A hand
  kernel launched through ctypes is invisible to it.  ``bytes_accessed``
  is None: torch has no counterpart to XLA's post-fusion byte estimate.
  The counted run is the program's own, so its seconds (the counter's
  dispatch cost included) stay in the span that times the first make:
  an engine program's ``compile_s``, ``generate_serve``'s compile and
  first request.  A process's first count also pays the counter's
  one-time set-up (it imports torch's distributed-tensor modules).
* :func:`compiled_memory` of a captured CUDA graph is the bytes its
  private memory pool holds, under the JAX package's field
  ``temp_size_in_bytes``; None on the CPU (no graph).  There is no
  executable, so no ``generated_code_size_in_bytes``.

Pure stdlib at import; torch is imported by the functions that need it
when they run.
"""

from __future__ import annotations

import logging
import os
import tempfile
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional

from znicz_tpu_torch.observability.registry import get_registry
from znicz_tpu_torch.observability.tracing import span

logger = logging.getLogger(__name__)

_LOCK = threading.Lock()
# ledger key -> entry dict, insertion (= make) order
_PROGRAMS: "OrderedDict[str, dict]" = OrderedDict()

# torch.profiler captures are process-global: one at a time
_PROFILE_LOCK = threading.Lock()
PROFILE_MAX_SECONDS = 30.0
# the Chrome trace capture_profile writes into its directory
PROFILE_TRACE = "trace.json"


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


# -- cost / memory figures (never raise) -------------------------------------


def stage_cost(counter) -> Optional[dict]:
    """Normalized cost of a stage a ``FlopCounterMode`` watched:
    ``{"flops": float, "bytes_accessed": None}``; None without a counter
    (or when it cannot answer)."""
    if counter is None:
        return None
    try:
        flops = float(counter.get_total_flops())
    except Exception:
        logger.debug("flop count unavailable", exc_info=True)
        return None
    return {"flops": flops, "bytes_accessed": None}


def lowered_cost(fn, args=(), kwargs=None):
    """Run ``fn(*args, **kwargs)`` ONCE, as the program's own call, under
    a ``FlopCounterMode``; returns ``(result, cost)``, ``cost`` None where
    the counter is unavailable (the call then runs uncounted).  The
    counter passes every op through unchanged."""
    try:
        from torch.utils.flop_counter import FlopCounterMode

        counter = FlopCounterMode(display=False)
    except Exception:
        logger.debug("FlopCounterMode unavailable", exc_info=True)
        return fn(*args, **(kwargs or {})), None
    with counter:
        out = fn(*args, **(kwargs or {}))
    return out, stage_cost(counter)


def compiled_memory(graph) -> Optional[dict]:
    """``{"temp_size_in_bytes": n}``: the bytes the captured CUDA graph's
    private memory pool holds (the caching allocator's segments of that
    pool).  None without a graph, or when the allocator cannot say."""
    if graph is None:
        return None
    try:
        import torch

        pool = tuple(graph.pool())
        held = sum(
            int(seg["total_size"]) for seg in torch.cuda.memory_snapshot()
            if tuple(seg.get("segment_pool_id", ())) == pool
        )
    except Exception:
        logger.debug("graph pool size unavailable", exc_info=True)
        return None
    return {"temp_size_in_bytes": held}


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
    """The ``/debug/programs`` body: the full entry list, the headline
    counts and the live :func:`device_memory`."""
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
        "device_memory": device_memory(),
    }


# -- live device memory -----------------------------------------------------


def device_memory() -> List[dict]:
    """One entry a visible CUDA device, ``{"device": "cuda:<i>", "stats":
    {...}}``, from the caching allocator's counters and the card's total
    memory; also refreshes the ``znicz_device_memory_bytes`` gauges.
    Without a card the list holds ``{"device": "cpu:0", "stats": None}``.
    Reads host-side counters and one CUDA memory query a device (no stream
    work), so any thread may call it.  Never raises."""
    try:
        import torch

        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    except Exception:
        logger.debug("torch.cuda unavailable", exc_info=True)
        return [{"device": "cpu:0", "stats": None}]
    if n == 0:
        return [{"device": "cpu:0", "stats": None}]
    out = []
    gauge = _m_device_memory()
    for i in range(n):
        name = f"cuda:{i}"
        try:
            ms = torch.cuda.memory_stats(i)
            stats = {
                "bytes_in_use": int(ms.get("allocated_bytes.all.current", 0)),
                "peak_bytes_in_use": int(ms.get("allocated_bytes.all.peak", 0)),
                "bytes_limit": int(torch.cuda.mem_get_info(i)[1]),
            }
        except Exception:
            logger.debug("memory stats of %s unavailable", name, exc_info=True)
            stats = None
        out.append({"device": name, "stats": stats})
        if stats:
            for stat_key, gauge_kind in (
                ("bytes_in_use", "in_use"),
                ("peak_bytes_in_use", "peak"),
                ("bytes_limit", "limit"),
            ):
                gauge.labels(kind=gauge_kind, device=name).set(float(stats[stat_key]))
    return out


# -- on-demand profiler capture ---------------------------------------------


def capture_profile(seconds: float, log_dir: Optional[str] = None, *,
                    call: Optional[Callable[[Callable[[], object]], object]] = None) -> dict:
    """One bounded ``torch.profiler`` capture (``POST
    /debug/profile?seconds=N``): start it (CPU activity, plus CUDA activity
    where a card is present), sleep ``seconds`` (clamped to
    ``PROFILE_MAX_SECONDS``), stop, write the Chrome trace
    (:data:`PROFILE_TRACE`) into the capture directory and return it.  The
    capture runs inside a ``debug/profile`` host span; the kernels other
    threads launch meanwhile (the serving engine's) land in the trace.
    ``call(fn)``, where given, runs the profiler's start and stop where no
    other thread launches device work (the front door's
    :meth:`~znicz_tpu_torch.services.frontdoor.ServingFrontDoor.between_ticks`):
    a process's first start initializes CUPTI for seconds, and hangs if
    another thread launches CUDA graphs meanwhile.

    Raises ``ValueError`` on a non-finite duration (the HTTP layer answers
    400), ``RuntimeError`` when a capture is already running (409) or the
    profiler is unavailable (503)."""
    s = float(seconds)
    if s != s or s in (float("inf"), float("-inf")):
        # NaN slides through min/max clamps (every comparison False)
        # and time.sleep(nan) raises — reject it at the door
        raise ValueError(f"want a finite duration; got {seconds!r}")
    s = min(max(s, 0.01), PROFILE_MAX_SECONDS)
    if not _PROFILE_LOCK.acquire(blocking=False):
        raise RuntimeError("a device profile capture is already running")
    try:
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile
        except Exception as exc:
            raise RuntimeError(f"torch profiler unavailable: {exc}") from exc
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        out_dir = log_dir or tempfile.mkdtemp(prefix="znicz-profile-")
        with span("debug/profile", seconds=s, log_dir=out_dir):
            prof = profile(activities=activities)
            try:
                if call is None:
                    prof.start()
                else:
                    call(prof.start)
            except Exception as exc:
                raise RuntimeError(f"torch profiler unavailable: {exc}") from exc
            try:
                time.sleep(s)
            finally:
                # stopped on the thread that started it: a capture stopped on
                # another thread crashes the process
                if call is None:
                    prof.stop()
                else:
                    call(prof.stop)
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir, PROFILE_TRACE))
        return {"log_dir": out_dir, "seconds": s}
    finally:
        _PROFILE_LOCK.release()
