"""Background-thread minibatch prefetching (port of
``znicz_tpu/loader/prefetch.py``).

``prefetch`` runs the loader's generator in a worker thread with a small
bounded queue: the same yield order and PRNG draw sequence as the serial
loop, overlapped with the step.  The producer is stage-instrumented: each
item's **fetch** (materializing one batch), optional **host transform** (a
``transform`` callable run on the producer thread: the workflow's pinned
host-to-device staging) and **enqueue** (blocked handing the batch over)
observe into ``znicz_pipeline_stage_seconds{stage}`` and emit tracer spans,
so a slow producer (long fetch or transform) and a starved one (long
enqueue: the consumer is behind and the queue stayed full, counted by
``znicz_prefetch_queue_full_total``) are told apart in one capture.  The
``loader.fetch`` fault point fires inside the timed fetch.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterable, Iterator, Optional, TypeVar

from znicz_tpu_torch import observability
from znicz_tpu_torch.observability import pipeline as _pipeline
from znicz_tpu_torch.utils import faults

T = TypeVar("T")

_SENTINEL = object()
# how long closing the generator waits for the producer to finish its item
JOIN_TIMEOUT_S = 60.0


class PrefetchProducerError(RuntimeError):
    """The prefetch producer thread died without delivering its
    end-of-epoch sentinel (or the error that killed it) — the typed,
    consumer-visible form of a dead producer.  Ordinary producer
    exceptions re-raise AS THEMSELVES at the consumer's next pull; this
    only fires when the thread is gone and nothing explains why (e.g.
    it never started), turning what used to be an unbounded ``q.get()``
    hang into a diagnosis (the ZNC013 "a thread death must be a typed
    event" contract)."""


def prefetch(
    iterable: Iterable[T],
    depth: int = 2,
    *,
    transform: Optional[Callable[[T], T]] = None,
    transform_stage: Optional[str] = _pipeline.STAGE_TRANSFORM,
) -> Iterator[T]:
    """Yield from ``iterable``, produced ``depth`` items ahead in a thread.

    ``transform`` (optional) is applied to each item ON the producer
    thread — host decode/augment work, or the workflow's device-placement
    closure — timed as the ``transform_stage`` pipeline stage (pass
    ``transform_stage=None`` when the callable owns its own
    instrumentation, e.g. an :class:`~znicz_tpu_torch.observability.H2DProbe`).

    Exceptions in the producer (fetch or transform) re-raise at the
    consumer's next pull.  If the consumer abandons the iterator
    (exception mid-epoch, interrupt), closing the generator signals the
    worker to stop and joins it (at most ``JOIN_TIMEOUT_S``, then
    :class:`PrefetchProducerError`): no thread or queued batches leak, and
    nothing draws from the loader's streams after ``close()`` returns.
    """
    q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
    stop = threading.Event()
    error: list = []

    # per-stage producer telemetry: each span is on the LOADER's own
    # thread track in Perfetto, so producer stalls line up against the
    # consumer's znicz_prefetch_wait_seconds histogram and the
    # train/serve spans they starve.  No-op span cost when the tracer
    # is idle; one histogram observe per stage per item otherwise.
    stage_hist = _pipeline.stage_seconds()
    queue_full = observability.counter(
        _pipeline.QUEUE_FULL_METRIC,
        "items whose producer-side enqueue found the prefetch queue "
        "full at least once (depth exhaustion: the consumer, not the "
        "producer, is behind)",
    )

    def worker():
        tracer = observability.get_tracer()
        try:
            it = iter(iterable)
            while True:
                t0 = time.perf_counter()
                with tracer.span("loader/fetch"):
                    # the fault fires INSIDE the timed window, so an
                    # injected delay reads as a slow producer to the
                    # attribution (the input-bound CI fixture)
                    faults.fire("loader.fetch")
                    item = next(it, _SENTINEL)
                stage_hist.labels(stage=_pipeline.STAGE_FETCH).observe(
                    time.perf_counter() - t0
                )
                if item is _SENTINEL:
                    break
                if transform is not None:
                    if transform_stage is None:
                        item = transform(item)
                    else:
                        t0 = time.perf_counter()
                        with tracer.span(f"loader/{transform_stage}"):
                            item = transform(item)
                        stage_hist.labels(stage=transform_stage).observe(
                            time.perf_counter() - t0
                        )
                # bounded put that gives up when the consumer went away
                t0 = time.perf_counter()
                try:
                    # non-blocking first attempt: ANY fullness counts as
                    # a depth-exhaustion stall, even one shorter than
                    # the polling timeout below
                    q.put_nowait(item)
                except queue.Full:  # znicz-check: disable=ZNC008
                    queue_full.inc()
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.1)
                            break
                        # polling control flow, not a swallowed failure
                        except queue.Full:  # znicz-check: disable=ZNC008
                            continue
                stage_hist.labels(stage=_pipeline.STAGE_ENQUEUE).observe(
                    time.perf_counter() - t0
                )
                if stop.is_set():
                    return
        except BaseException as e:  # noqa: BLE001 — must cross threads
            error.append(e)
        finally:
            # deliver the sentinel with the same give-up-on-stop loop as
            # items: a fixed timeout would lose it when the consumer stalls
            # longer (e.g. first-step XLA compile) and deadlock the epoch
            while not stop.is_set():
                try:
                    q.put(_SENTINEL, timeout=0.1)
                    break
                # polling control flow, not a swallowed failure
                except queue.Full:  # znicz-check: disable=ZNC008
                    continue

    # how long the training loop blocked waiting on the loader: the
    # "is the input pipeline the bottleneck" histogram — near-zero waits
    # mean the device is the limit; long waits mean the loader is
    wait = observability.histogram(
        "znicz_prefetch_wait_seconds",
        "seconds the consumer blocked waiting for the next minibatch",
    )
    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            t0 = time.perf_counter()
            # bounded get with a liveness check: a producer thread that
            # died without its sentinel (hard kill, never started) must
            # become a typed error, not an unbounded q.get() hang
            while True:
                try:
                    item = q.get(timeout=0.5)
                    break
                except queue.Empty:  # znicz-check: disable=ZNC008
                    if not t.is_alive() and q.empty():
                        if error:
                            raise error[0]
                        raise PrefetchProducerError(
                            "prefetch producer thread died without "
                            "delivering a sentinel or an error"
                        )
            wait.observe(time.perf_counter() - t0)
            if item is _SENTINEL:
                if error:
                    raise error[0]
                return
            yield item
    finally:
        # runs on normal exhaustion AND on generator close/abandonment
        stop.set()
        while True:  # unblock a worker stuck in put()
            try:
                q.get_nowait()
            # drain-until-empty control flow, not a swallowed failure
            except queue.Empty:  # znicz-check: disable=ZNC008
                break
        # a worker inside next(it) finishes that one item (a fill, a
        # reshuffle), sees the stop and returns: joined here, so a caller
        # that restores the loader or the streams after closing this
        # generator never races it
        if t.is_alive():
            t.join(JOIN_TIMEOUT_S)
        if t.is_alive():
            raise PrefetchProducerError(
                f"prefetch producer thread did not stop within {JOIN_TIMEOUT_S} s"
            )
