"""The prefetch thread of the port's host loop, on the CPU.

It yields the serial loop's batches in the serial order, bitwise, and the
workflow trained through it equals the serial workflow bitwise; a producer
exception re-raises at the consumer as itself, a producer that dies
silently as ``PrefetchProducerError``; an abandoned iterator leaves no live
thread; the ``loader.fetch`` fault point reads as input-bound.  Every wait
on a thread here is bounded.
"""

import threading
import time

import numpy as np
import pytest
import torch

from znicz_tpu_torch import observability
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.loader import prefetch as prefetch_mod
from znicz_tpu_torch.loader.fullbatch import FullBatchLoader
from znicz_tpu_torch.loader.prefetch import PrefetchProducerError, prefetch
from znicz_tpu_torch.observability import pipeline
from znicz_tpu_torch.utils import faults
from znicz_tpu_torch.workflow import model as model_lib
from znicz_tpu_torch.workflow.standard import StandardWorkflow

LAYERS = [
    {"type": "conv_relu", "->": {"n_kernels": 3, "kx": 3, "ky": 3}},
    {"type": "dropout", "->": {"dropout_ratio": 0.25}},
    {"type": "all2all_tanh", "->": {"output_sample_shape": 6}},
    {"type": "softmax", "->": {"output_sample_shape": 4}},
]


def _loader(seed=3, u8=False):
    prng.reset()
    prng.seed_all(seed)
    rng = np.random.default_rng(1)
    dt = np.uint8 if u8 else np.float32
    make = (lambda n: rng.integers(0, 256, (n, 6, 6, 1)).astype(dt)) if u8 else (
        lambda n: rng.random((n, 6, 6, 1), dt))
    return FullBatchLoader(
        {"train": make(45), "valid": make(11), "test": make(9)},
        {"train": rng.integers(0, 4, 45), "valid": rng.integers(0, 4, 11),
         "test": rng.integers(0, 4, 9)},
        minibatch_size=8, normalization="range" if u8 else "none", device_convert=u8,
    )


def _wait_gone(threads, timeout=10.0):
    deadline = time.monotonic() + timeout
    while any(t.is_alive() for t in threads) and time.monotonic() < deadline:
        time.sleep(0.01)
    return [t for t in threads if t.is_alive()]


@pytest.mark.parametrize("depth", [1, 2, 5])
def test_the_serial_batches_in_the_serial_order(depth):
    loader = _loader()
    serial = [(s, mb) for _ in range(2) for s, mb in loader.epoch()]
    loader = _loader()
    threaded = [(s, mb) for _ in range(2) for s, mb in prefetch(loader.epoch(), depth)]
    assert [s for s, _ in threaded] == [s for s, _ in serial]
    for (_, a), (_, b) in zip(threaded, serial):
        for field in ("data", "labels", "mask", "indices"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    assert loader.epoch_number == 2


@pytest.mark.parametrize("u8", [False, True], ids=["f32", "u8"])
def test_workflow_through_the_thread_equals_the_serial_one(u8):
    runs = {}
    for depth in (0, 2):
        wf = StandardWorkflow(_loader(u8=u8), LAYERS, device="cpu", prefetch_batches=depth,
                              decision_config={"max_epochs": 9})
        wf.initialize()
        seen = []
        step = wf.train_step

        def spy(x, y, mask, *args, _step=step, _seen=seen):
            _seen.append(x.clone())
            return _step(x, y, mask, *args)

        wf.train_step = spy
        history = [wf.run_epoch()["summary"] for _ in range(3)]
        runs[depth] = (history, model_lib.params_to_numpy(wf.state.params), seen)
    (h0, p0, s0), (h2, p2, s2) = runs[0], runs[2]
    assert h2 == h0
    assert len(s2) == len(s0) == 18
    for a, b in zip(s2, s0):
        assert a.dtype == b.dtype and bool((a == b).all())
    for la, lb in zip(p2, p0):
        for k in la:
            np.testing.assert_array_equal(la[k], lb[k])


@pytest.mark.cuda
def test_the_card_run_through_pinned_memory_equals_the_serial_one():
    """On the card the producer stages pinned copies and the consumer issues
    them on the step's stream: every batch the step receives equals the
    serial loop's (pageable copies), and so do the losses.  The runs are
    deterministic; the model has no dropout."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    runs = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for depth in (0, 2):
            wf = StandardWorkflow(_loader(u8=True), LAYERS[:1] + LAYERS[2:], device="cuda",
                                  prefetch_batches=depth, decision_config={"max_epochs": 9})
            wf.initialize()
            seen = []
            step = wf.train_step

            def spy(x, y, mask, *args, _step=step, _seen=seen):
                _seen.append((x.cpu(), y.cpu(), mask.cpu()))
                return _step(x, y, mask, *args)

            wf.train_step = spy
            runs[depth] = ([wf.run_epoch()["summary"] for _ in range(3)], seen)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (h0, s0), (h2, s2) = runs[0], runs[2]
    assert h2 == h0
    assert len(s2) == len(s0) == 18
    for a, b in zip(s2, s0):
        for u, v in zip(a, b):
            assert u.dtype == v.dtype and bool((u == v).all())


class Boom(RuntimeError):
    pass


def _failing(n_ok):
    for i in range(n_ok):
        yield i
    raise Boom("producer failed")


def test_a_producer_exception_reraises_at_the_consumer():
    got = []
    with pytest.raises(Boom, match="producer failed"):
        for item in prefetch(_failing(3), 2):
            got.append(item)
    assert got == [0, 1, 2]

    def bad_transform(item):
        if item == 1:
            raise KeyError("transform")
        return item

    with pytest.raises(KeyError, match="transform"):
        list(prefetch(iter(range(4)), 2, transform=bad_transform))


def test_a_silently_dead_producer_is_a_typed_error(monkeypatch):
    class NeverStarts(threading.Thread):
        def start(self):
            pass  # the worker never runs: no sentinel, no error

        def is_alive(self):
            return False

    monkeypatch.setattr(prefetch_mod.threading, "Thread", NeverStarts)
    t0 = time.monotonic()
    with pytest.raises(PrefetchProducerError):
        next(prefetch(iter(range(3)), 2))
    assert time.monotonic() - t0 < 5.0


def test_an_abandoned_iterator_leaves_no_live_thread():
    before = set(threading.enumerate())
    it = prefetch(iter(range(1000)), 2)
    assert next(it) == 0
    started = [t for t in threading.enumerate() if t not in before]
    assert len(started) == 1 and started[0].daemon
    it.close()
    assert _wait_gone(started) == []
    # and one abandoned by an exception in the consumer's loop body
    before = set(threading.enumerate())
    with pytest.raises(ZeroDivisionError):
        for i in prefetch(iter(range(1000)), 3):
            if i == 5:
                1 / 0
    assert _wait_gone([t for t in threading.enumerate() if t not in before]) == []


def test_stage_metrics_and_the_queue_full_counter():
    observability.get_registry().reset()
    stages = pipeline.stage_seconds()
    full = observability.counter(pipeline.QUEUE_FULL_METRIC)
    items = []
    for item in prefetch(iter(range(12)), 1, transform=lambda v: v * 2):
        time.sleep(0.002)  # a slow consumer: the depth-1 queue fills
        items.append(item)
    assert items == [2 * i for i in range(12)]
    assert stages.labels(stage=pipeline.STAGE_FETCH).count == 13  # the end too
    assert stages.labels(stage=pipeline.STAGE_TRANSFORM).count == 12
    assert stages.labels(stage=pipeline.STAGE_ENQUEUE).count == 12
    assert full.value >= 1
    assert observability.histogram(pipeline.WAIT_METRIC).children()[()].count == 13


def test_the_loader_fetch_fault_reads_as_input_bound():
    """A 0.2 s fetch beside a sub-millisecond step: the step runs on one
    intra-op thread, so that parallel test workers do not stretch it."""
    wf = StandardWorkflow(_loader(), LAYERS[:1] + LAYERS[2:], device="cpu",
                          decision_config={"max_epochs": 9})
    wf.initialize()
    wf.run_epoch()  # warm-up, outside the window
    pipeline.reset_window()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with faults.injected("loader.fetch", delay=0.2):
            wf.run_epoch()
    finally:
        torch.set_num_threads(threads)
    att = pipeline.PipelineAttribution.from_registry().attribution()
    assert att["verdict"] == "input-bound", att
    assert att["steps"] == 6 + 2 + 2
    assert att["fractions"]["prefetch_wait"] > 0.5
    assert att["fractions"]["prefetch_wait"] > att["fractions"]["h2d"]
    assert abs(att["fractions_sum"] - 1.0) < 0.05
    assert att["h2d_bytes_per_second"] is not None


def test_close_joins_a_producer_inside_its_fetch():
    """Closing the generator waits for the producer to finish the item it is
    fetching: nothing is drawn from the source after ``close()`` returns, so
    a caller may restore the loader's streams right away."""
    drawn = []

    def slow_source():
        for i in range(100):
            time.sleep(0.02)
            drawn.append(i)
            yield i

    before = set(threading.enumerate())
    it = prefetch(slow_source(), 2)
    assert next(it) == 0
    it.close()
    n = len(drawn)
    assert not [t for t in threading.enumerate() if t not in before and t.is_alive()]
    time.sleep(0.1)
    assert len(drawn) == n
