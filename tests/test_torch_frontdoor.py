"""The port's serving front door against the JAX package's, on the CPU.

``services/frontdoor.py``'s :class:`ServingFrontDoor` over the port's paged
and dense engines, at the JAX front-door tests' size (vocab 17, d_model 32,
2 layers, 4 heads, max_seq 64, block 8, EOS 14, ``prng.seed_all(27)``; the
JAX LM's params carried across with ``params_from_jax``).  The same stream
through JAX's door and the port's gives the same tokens, finish reasons,
``timings`` keys and stream tails, and the same ``znicz_serve_*`` metric
families (names, kinds, help, label sets, buckets, and the counter deltas
of one scenario).  Every failure path of ``tests/test_frontdoor.py`` is
forced through the port's ``faults`` and ends in a typed completion, with
the pool swept (free == pool) after it: cancel before admission, during
decode and after completion; deadlines queued, mid-decode and by default;
an engine crash with re-admission (the dead engine dropped before the
factory runs); an allocator failure; pool exhaustion; a stall flipping
``/healthz`` to 503; close draining then shedding; the spec engine's
timings and a restart keeping its config.  Every wait has its own timeout.
"""

import http.client
import json
import threading
import time
import weakref

import jax
import numpy as np
import pytest
import torch

from znicz_tpu import observability as jobs
from znicz_tpu.core import prng as jprng
from znicz_tpu.services import engine as JE
from znicz_tpu.services import frontdoor as JF
from znicz_tpu.utils import faults as jfaults
from znicz_tpu.workflow.transformer import init_lm_params as jinit
from znicz_tpu_torch import observability as tobs
from znicz_tpu_torch.services import (
    DecodeEngine,
    EngineClosedError,
    PagedDecodeEngine,
    RejectedError,
    RequestTooLargeError,
    ServingFrontDoor,
    SpeculationUnsupportedError,
)
from znicz_tpu_torch.services import engine as TE
from znicz_tpu_torch.services import frontdoor as TF
from znicz_tpu_torch.services import serve as tserve
from znicz_tpu_torch.utils import faults
from znicz_tpu_torch.workflow import generate as G, model as model_lib

torch.set_float32_matmul_precision("highest")

EOS = 14
HEADS = 4
T_MAX = 64
BS = 8
TIMING_KEYS = {
    "queue_s", "prefill_s", "decode_s", "preemptions", "cached_tokens",
    "spec_drafted", "spec_accepted",
}


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


@pytest.fixture(scope="module")
def both_params():
    jprng.seed_all(27)
    jp = jinit(17, 32, 2, HEADS, max_seq=T_MAX)
    return jp, model_lib.params_from_jax(jax.device_get(jp), "cpu")


@pytest.fixture(scope="module")
def params(both_params):
    return both_params[1]


def _kw(**kw):
    return {**dict(n_heads=HEADS, eos_id=EOS, batch_size=2, block_size=BS, max_seq=T_MAX,
                   admit_every=4), **kw}


def _factory(params, **kw):
    def factory():
        return PagedDecodeEngine(params, **_kw(**kw))
    return factory


def _reference(params, prompt, budget):
    out = G.generate(params, torch.as_tensor(prompt)[None], n_heads=HEADS,
                     max_new_tokens=budget, eos_id=EOS)[0].numpy()
    new = out[len(prompt):]
    hit = np.where(new == EOS)[0]
    if len(hit):
        new = new[: hit[0] + 1]
    return np.concatenate([prompt, new])


def _prompts(n, seed=7):
    gen = np.random.default_rng(seed)
    return [gen.integers(0, 17, (k,)).astype(np.int32) for k in (5, 12, 3, 9, 17)[:n]]


def _long_prompt(params, budget=40, seed=21):
    """A prompt whose greedy generation does not hit EOS within ``budget``."""
    gen = np.random.default_rng(seed)
    for _ in range(200):
        p = gen.integers(0, 17, (6,)).astype(np.int32)
        ref = _reference(params, p, budget)
        if len(ref) - len(p) == budget and ref[-1] != EOS:
            return p
    raise AssertionError("no EOS-free prompt found in 200 draws")


def _pool_swept(door):
    st = door.engine.stats()
    return st["pool_blocks_free"] == st["pool_blocks"]


def _wait_until(cond, timeout=10.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.005)
    raise AssertionError(f"timed out waiting for {what}")


def _retired_errors():
    m = tobs.get_registry().metrics().get("znicz_serve_requests_retired_total")
    if m is None:
        return 0.0
    return sum(c.value for key, c in m.children().items() if key and key[0] == "error")


def _hist_count(name):
    m = tobs.get_registry().metrics().get(name)
    return 0 if m is None else sum(c.count for c in m.children().values())


def _paged_compiles_total():
    m = tobs.get_registry().metrics().get("znicz_serve_compiles_total")
    if m is None:
        return 0.0
    return sum(c.value for key, c in m.children().items()
               if key[0] in ("prefill", "paged_chunk", "cow"))


# -- the same stream through both doors ---------------------------------------


def _serve(door_cls, factory, prompts, budgets, **door_kw):
    with door_cls(factory, **door_kw) as door:
        handles = [door.submit(p, b) for p, b in zip(prompts, budgets)]
        streamed = [list(h.tokens(timeout=60.0)) for h in handles]
        comps = [h.result(timeout=60.0) for h in handles]
        stats = door.stats()
        swept = "pool_blocks" not in stats["engine"] or _pool_swept(door)
        recent = door.recent_requests()
    return comps, streamed, stats, swept, recent


@pytest.mark.parametrize("backend", ["paged", "dense", "spec"])
def test_stream_equals_jax(both_params, backend):
    jp, tp = both_params
    prompts, budgets = _prompts(5), [6, 4, 8, 12, 5]
    kw = _kw() if backend != "dense" else {
        k: v for k, v in _kw().items() if k != "block_size"}
    if backend == "spec":
        kw["spec_k"] = 7
    cls = (JE.PagedDecodeEngine, TE.PagedDecodeEngine) if backend != "dense" else (
        JE.DecodeEngine, TE.DecodeEngine)
    jc, js, jst, jswept, jrecent = _serve(JF.ServingFrontDoor, lambda: cls[0](jp, **kw),
                                          prompts, budgets)
    tc, ts, tst, tswept, trecent = _serve(TF.ServingFrontDoor, lambda: cls[1](tp, **kw),
                                          prompts, budgets)
    for j, t, jstream, tstream, p, b in zip(jc, tc, js, ts, prompts, budgets):
        assert t.tokens.tolist() == j.tokens.tolist()
        assert t.tokens.tolist() == _reference(tp, p, b).tolist()
        assert t.finish_reason == j.finish_reason and t.finish_reason in ("eos", "budget")
        assert t.n_new == j.n_new
        assert tstream == jstream == t.tokens[len(p):].tolist()
        assert set(t.timings) == set(j.timings) == TIMING_KEYS
        for k in ("preemptions", "cached_tokens", "spec_drafted", "spec_accepted"):
            assert t.timings[k] == j.timings[k]
        assert t.trace_id is not None
    assert jswept and tswept
    for key in ("submitted", "completed", "rejected", "cancelled", "deadline_exceeded", "shed",
                "watchdog_restarts"):
        assert tst[key] == jst[key]
    assert set(tst) == set(jst)
    assert set(tst["watchdog"]) == set(jst["watchdog"])
    assert [set(r) for r in trecent] == [set(r) for r in jrecent]
    assert [r["finish_reason"] for r in trecent] == [r["finish_reason"] for r in jrecent]
    if backend == "spec":
        assert tst["engine"]["spec"] == jst["engine"]["spec"]


FRONTDOOR_FAMILIES = (
    "znicz_serve_rejected_total", "znicz_serve_deadline_exceeded_total",
    "znicz_serve_cancelled_total", "znicz_serve_watchdog_restarts_total",
    "znicz_serve_requests_retired_total", "znicz_serve_frontdoor_pending",
    "znicz_serve_frontdoor_queue_age_seconds", "znicz_serve_frontdoor_inflight",
    "znicz_serve_frontdoor_ttft_seconds", "znicz_serve_frontdoor_latency_seconds",
    "znicz_serve_slo_burn_rate",
)


def _families(obs):
    out = {}
    for name in FRONTDOOR_FAMILIES:
        m = obs.get_registry().metrics()[name]
        out[name] = (m.kind, m.help, tuple(m.labelnames), tuple(getattr(m, "buckets", ()) or ()))
    return out


def _counts(obs):
    out = {}
    for name in FRONTDOOR_FAMILIES:
        m = obs.get_registry().metrics()[name]
        for labels, c in m.children().items():
            if m.kind == "counter":
                out[(name, labels)] = c.value
            elif m.kind == "histogram":
                out[(name, labels)] = c.count
    return out


def _scenario(door_cls, factory, prompts):
    """A queue-full shed, a cancel before admission, a queued deadline and
    a normal request, on a door that pumps nothing until the last one."""
    with door_cls(factory, max_pending=3, engine_queue_limit=0) as door:
        h1 = door.submit(prompts[0], 4)
        h2 = door.submit(prompts[1], 4, deadline_s=0.0)
        h3 = door.submit(prompts[2], 4)
        with pytest.raises(Exception) as exc:
            door.submit(prompts[0], 4)
        assert type(exc.value).__name__ == "RejectedError"
        h1.cancel()
        results = [h.result(timeout=30.0).finish_reason for h in (h1, h2)]
        door.engine_queue_limit = 2
        door._wake.set()
        results.append(h3.result(timeout=30.0).finish_reason)
    return results


def test_metric_families_and_deltas_equal_jax(both_params):
    jp, tp = both_params
    prompts = _prompts(3)
    jb, tb = _counts_or_empty(jobs), _counts_or_empty(tobs)
    jr = _scenario(JF.ServingFrontDoor, lambda: JE.PagedDecodeEngine(jp, **_kw()), prompts)
    tr = _scenario(TF.ServingFrontDoor, lambda: TE.PagedDecodeEngine(tp, **_kw()), prompts)
    assert tr == jr == ["cancelled", "deadline_exceeded", "budget"]
    assert _families(tobs) == _families(jobs)
    jd = {k: v - jb.get(k, 0) for k, v in _counts(jobs).items() if v != jb.get(k, 0)}
    td = {k: v - tb.get(k, 0) for k, v in _counts(tobs).items() if v != tb.get(k, 0)}
    assert td == jd
    assert td[("znicz_serve_rejected_total", ("queue_full",))] == 1
    # the exposition's HELP and TYPE lines of these families, byte for byte
    def meta(obs):
        return sorted(line for line in obs.get_registry().prometheus_text().splitlines()
                      if line.startswith(("# HELP", "# TYPE"))
                      and line.split()[2] in FRONTDOOR_FAMILIES)
    assert meta(tobs) == meta(jobs)


def _counts_or_empty(obs):
    names = obs.get_registry().metrics()
    return _counts(obs) if all(n in names for n in FRONTDOOR_FAMILIES) else {}


def test_public_surface_equals_jax():
    for name in ("REASON_CANCELLED", "REASON_DEADLINE", "REASON_ERROR", "REASON_SHED"):
        assert getattr(TF, name) == getattr(JF, name)
    import inspect
    jsig = inspect.signature(JF.ServingFrontDoor.__init__)
    tsig = inspect.signature(TF.ServingFrontDoor.__init__)
    assert [(p.name, p.default) for p in tsig.parameters.values()] == [
        (p.name, p.default) for p in jsig.parameters.values()]
    for meth in ("submit", "cancel", "close", "has_work", "watchdog_state", "prefix_probe",
                 "healthy", "slo_snapshot", "recent_requests", "stats"):
        assert list(inspect.signature(getattr(TF.ServingFrontDoor, meth)).parameters) == list(
            inspect.signature(getattr(JF.ServingFrontDoor, meth)).parameters)


# -- admission ------------------------------------------------------------------


def test_validation_rejects_before_enqueue_with_jax_messages(both_params):
    jp, tp = both_params
    cases = [([], 4, None), ([1, 2, 3], 10_000, None), (None, 4, None), ([[1, 2], [3]], 4, None),
             ([1, 2], 4, "soon"), ([1, 2], 4, -1.0), ([1, 2], 0, None)]
    with JF.ServingFrontDoor(lambda: JE.PagedDecodeEngine(jp, **_kw())) as jdoor, \
            TF.ServingFrontDoor(_factory(tp)) as tdoor:
        for prompt, n, deadline in cases:
            errs = []
            for door in (jdoor, tdoor):
                with pytest.raises(ValueError) as exc:
                    door.submit(prompt, n, deadline_s=deadline)
                errs.append((type(exc.value).__name__, str(exc.value)))
            assert errs[1] == errs[0]
        assert tdoor.stats()["submitted"] == 0
    assert issubclass(RequestTooLargeError, ValueError)


def test_queue_full_sheds_with_retry_after(params):
    with ServingFrontDoor(_factory(params), max_pending=2, engine_queue_limit=0) as door:
        p = _prompts(1)[0]
        door.submit(p, 4)
        door.submit(p, 4)
        with pytest.raises(RejectedError) as exc:
            door.submit(p, 4)
        assert exc.value.reason == "queue_full"
        assert exc.value.retry_after_s > 0
        assert door.stats()["rejected"] == {"queue_full": 1}


def test_pool_pressure_watermark_sheds(params):
    with ServingFrontDoor(_factory(params), engine_queue_limit=0, shed_pool_frac=2.0) as door:
        p = _prompts(1)[0]
        door.submit(p, 4)  # no backlog yet: accepted
        with pytest.raises(RejectedError) as exc:
            door.submit(p, 4)
        assert exc.value.reason == "pool_pressure"


# -- cancellation ---------------------------------------------------------------


def test_cancel_before_admission(params):
    with ServingFrontDoor(_factory(params), engine_queue_limit=0) as door:
        h = door.submit(_prompts(1)[0], 8)
        time.sleep(0.02)
        assert h.cancel() is True
        comp = h.result(timeout=10.0)
        assert comp.finish_reason == "cancelled" and comp.n_new == 0
        assert comp.timings["queue_s"] >= 0.02
        assert comp.timings["prefill_s"] == 0.0 and comp.timings["decode_s"] == 0.0
        assert list(h.tokens(timeout=5.0)) == []
        assert _pool_swept(door)


def test_cancel_during_decode_reclaims_blocks(params):
    pa = _long_prompt(params)
    pb = _prompts(2)[1]
    faults.inject("frontdoor.slow_tick", delay=0.05)
    with ServingFrontDoor(_factory(params)) as door:
        ha = door.submit(pa, 40)
        hb = door.submit(pb, 5)
        next(ha.tokens(timeout=30.0))
        assert ha.cancel() is True
        comp = ha.result(timeout=30.0)
        faults.clear()
        assert comp.finish_reason == "cancelled"
        assert 1 <= comp.n_new < 40
        np.testing.assert_array_equal(hb.result(timeout=30.0).tokens, _reference(params, pb, 5))
        _wait_until(lambda: _pool_swept(door), what="block reclamation")
        assert door.stats()["cancelled"] == 1


def test_cancel_after_completion_is_noop(params):
    with ServingFrontDoor(_factory(params)) as door:
        h = door.submit(_prompts(1)[0], 3)
        h.result(timeout=30.0)
        assert h.cancel() is False
        assert door.stats()["cancelled"] == 0
        assert _pool_swept(door)


# -- deadlines ------------------------------------------------------------------


def test_deadline_expires_while_queued(params):
    with ServingFrontDoor(_factory(params), engine_queue_limit=0) as door:
        comp = door.submit(_prompts(1)[0], 8, deadline_s=0.01).result(timeout=10.0)
        assert comp.finish_reason == "deadline_exceeded" and comp.n_new == 0
        assert _pool_swept(door)


def test_deadline_expires_mid_decode(params):
    p = _long_prompt(params)
    faults.inject("frontdoor.slow_tick", delay=0.05)
    with ServingFrontDoor(_factory(params)) as door:
        comp = door.submit(p, 40, deadline_s=0.25).result(timeout=30.0)
        faults.clear()
        assert comp.finish_reason == "deadline_exceeded"
        assert 1 <= comp.n_new < 40
        _wait_until(lambda: _pool_swept(door), what="block reclamation")
        assert door.stats()["deadline_exceeded"] == 1


def test_default_deadline_applies(params):
    with ServingFrontDoor(_factory(params), engine_queue_limit=0,
                          default_deadline_s=0.01) as door:
        comp = door.submit(_prompts(1)[0], 8).result(timeout=10.0)
        assert comp.finish_reason == "deadline_exceeded"
        assert _pool_swept(door)


# -- the watchdog ---------------------------------------------------------------


class _CountingFactory:
    """An engine factory that records, at each call, whether the door
    still held an engine (the dead one must be dropped first)."""

    def __init__(self, params, **kw):
        self.make = _factory(params, **kw)
        self.door = None
        self.dead = None  # a weak reference to the engine about to crash
        self.held = []

    def __call__(self):
        if self.door is not None:
            self.held.append((self.door._engine is not None, self.dead() is not None))
        return self.make()


def test_engine_crash_fails_inflight_readmits_queued(params):
    pa = _long_prompt(params, budget=30)
    pb, pc = _prompts(3)[1:]
    factory = _CountingFactory(params, batch_size=1, admit_every=2)
    warm = factory()
    warm.submit(pa, 30)
    warm.run()
    faults.inject("frontdoor.slow_tick", delay=0.05)
    with ServingFrontDoor(factory, engine_queue_limit=1) as door:
        factory.door = door
        ha = door.submit(pa, 30)
        next(ha.tokens(timeout=30.0))
        hb = door.submit(pb, 5)
        hc = door.submit(pc, 5)
        _wait_until(lambda: door.watchdog_state()["inflight"] == 2,
                    what="B pumped into the engine queue")
        factory.dead = weakref.ref(door.engine)
        compiles_before = _paged_compiles_total()
        lat_before = _hist_count("znicz_serve_frontdoor_latency_seconds")
        err_before = _retired_errors()
        faults.inject("engine.decode_step", exc=RuntimeError("boom"), times=1)
        ca = ha.result(timeout=30.0)
        faults.clear("frontdoor.slow_tick")
        assert ca.finish_reason == "error" and "boom" in ca.error
        assert ca.timings["decode_s"] > 0 and ca.timings["prefill_s"] > 0
        for h, p in ((hb, pb), (hc, pc)):
            comp = h.result(timeout=60.0)
            assert comp.finish_reason in ("eos", "budget")
            np.testing.assert_array_equal(comp.tokens, _reference(params, p, 5))
        st = door.stats()
        assert st["watchdog_restarts"] == 1
        # the factory ran with the dead engine dropped and freed
        assert factory.held == [(False, False)]
        assert door.engine is not None and factory.dead() is None
        assert _hist_count("znicz_serve_frontdoor_latency_seconds") - lat_before == 2
        assert _retired_errors() - err_before == 1.0
        # the ledger is process-wide: a restart ledgers no new program
        assert _paged_compiles_total() == compiles_before
        assert _pool_swept(door)


def test_submit_during_the_rebuild_waits_for_the_new_engine(params):
    """While the factory runs the door holds no engine; a submission then
    waits for the rebuilt one instead of being refused."""
    gate = threading.Event()
    released = threading.Event()
    make = _factory(params)
    calls = []

    def factory():
        calls.append(1)
        if len(calls) == 2:
            gate.set()
            released.wait(timeout=30.0)
        return make()

    with ServingFrontDoor(factory) as door:
        faults.inject("engine.decode_step", exc=RuntimeError("boom"), times=1)
        first = door.submit(_long_prompt(params), 20)
        assert gate.wait(timeout=30.0)
        assert door.engine is None
        out = {}
        t = threading.Thread(target=lambda: out.update(h=door.submit(_prompts(1)[0], 4)))
        t.start()
        time.sleep(0.05)
        assert "h" not in out  # waiting on the rebuild
        released.set()
        t.join(timeout=30.0)
        assert first.result(timeout=30.0).finish_reason == "error"
        comp = out["h"].result(timeout=30.0)
        np.testing.assert_array_equal(comp.tokens, _reference(params, _prompts(1)[0], 4))
        assert door.stats()["rejected"] == {}
        assert _pool_swept(door)


def test_factory_failure_after_a_crash_fails_closed(params):
    make = _factory(params)
    calls = []

    def factory():
        calls.append(1)
        if len(calls) > 1:
            raise RuntimeError("no card left")
        return make()

    door = ServingFrontDoor(factory, engine_queue_limit=1)
    try:
        faults.inject("engine.decode_step", exc=RuntimeError("boom"), times=1)
        h = door.submit(_long_prompt(params), 20)
        assert h.result(timeout=30.0).finish_reason == "error"
        _wait_until(lambda: door.watchdog_state()["state"] == "failed", what="failed state")
        with pytest.raises(EngineClosedError):
            door.submit(_prompts(1)[0], 4)
        assert door.engine is None
    finally:
        door.close(grace_s=1.0)


def test_allocator_failure_is_survivable(params):
    with ServingFrontDoor(_factory(params)) as door:
        faults.inject("pool.alloc", exc=RuntimeError("alloc boom"), times=1)
        comp = door.submit(_prompts(1)[0], 4).result(timeout=30.0)
        assert comp.finish_reason == "error" and "alloc boom" in comp.error
        assert door.stats()["watchdog_restarts"] == 1
        p = _prompts(2)[1]
        np.testing.assert_array_equal(door.submit(p, 5).result(timeout=30.0).tokens,
                                      _reference(params, p, 5))
        assert _pool_swept(door)


def test_pool_exhaustion_expires_typed_then_recovers(params):
    with ServingFrontDoor(_factory(params)) as door:
        faults.inject("pool.pressure", flag=True)
        comp = door.submit(_prompts(1)[0], 4, deadline_s=0.3).result(timeout=30.0)
        assert comp.finish_reason == "deadline_exceeded"
        faults.clear()
        p = _prompts(2)[1]
        np.testing.assert_array_equal(door.submit(p, 5).result(timeout=30.0).tokens,
                                      _reference(params, p, 5))
        assert _pool_swept(door)
        assert door.stats()["watchdog_restarts"] == 0


def _healthz(port):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_stall_flips_healthz_to_503_and_back(params):
    with ServingFrontDoor(_factory(params), stall_after_s=0.1) as door:
        srv = tserve.build_server(port=0, frontdoor=door)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        port = srv.server_address[1]
        try:
            assert door.healthy() and _healthz(port)[0] == 200
            faults.inject("frontdoor.slow_tick", delay=0.6, times=1)
            _wait_until(lambda: door.watchdog_state()["state"] == "stalled", timeout=5.0,
                        what="stall detection")
            status, body = _healthz(port)
            assert status == 503 and body["state"] == "stalled"
            _wait_until(lambda: door.watchdog_state()["state"] == "running", timeout=5.0,
                        what="stall recovery")
            assert _healthz(port)[0] == 200
            assert _pool_swept(door)
        finally:
            srv.shutdown()
            srv.server_close()


# -- shutdown -------------------------------------------------------------------


def test_close_drains_then_sheds_with_typed_completions(params):
    door = ServingFrontDoor(_factory(params), engine_queue_limit=0)
    h1 = door.submit(_prompts(1)[0], 4)
    h2 = door.submit(_prompts(1)[0], 4)
    door.close(grace_s=0.1)
    for h in (h1, h2):
        assert h.result(timeout=5.0).finish_reason == "shed"
        assert list(h.tokens(timeout=2.0)) == []
    assert door.stats()["shed"] == 2
    with pytest.raises(EngineClosedError):
        door.submit(_prompts(1)[0], 4)
    assert door.watchdog_state()["state"] == "closed"
    assert _pool_swept(door)


def test_close_is_idempotent_and_drains_live_work(params):
    door = ServingFrontDoor(_factory(params))
    p = _prompts(1)[0]
    h = door.submit(p, 5)
    door.close(grace_s=30.0)
    np.testing.assert_array_equal(h.result(timeout=5.0).tokens, _reference(params, p, 5))
    door.close()
    assert _pool_swept(door)


# -- speculation ----------------------------------------------------------------


def test_watchdog_restart_preserves_spec_config(params):
    with ServingFrontDoor(_factory(params, spec_k=7), max_pending=8) as door:
        p = _long_prompt(params)
        with faults.injected("engine.decode_step", exc=RuntimeError("fell over"), times=1):
            comp = door.submit(p, 40).result(timeout=30.0)
        assert comp.finish_reason == "error"
        _wait_until(lambda: door.engine is not None and door.engine.spec_k == 7,
                    what="rebuilt spec engine")
        comp = door.submit(p, 12).result(timeout=30.0)
        np.testing.assert_array_equal(comp.tokens, _reference(params, p, 12))
        assert {"spec_drafted", "spec_accepted"} <= set(comp.timings)
        assert door.stats()["watchdog_restarts"] == 1
        assert _pool_swept(door)


def test_dense_factory_with_spec_fails_construction(params):
    with pytest.raises(SpeculationUnsupportedError):
        ServingFrontDoor(lambda: DecodeEngine(params, n_heads=HEADS, eos_id=EOS, spec_k=4),
                         max_pending=4)


def test_trace_id_reaches_engine_spans(params):
    tracer = tobs.get_tracer()
    tracer.start()
    try:
        with ServingFrontDoor(_factory(params)) as door:
            h = door.submit(_prompts(1)[0], 4, trace_id="client-7")
            h.result(timeout=30.0)
    finally:
        events = tracer.stop()
    assert h.id == "client-7"
    lifecycle = {e["name"] for e in events if e.get("args", {}).get("trace") == "client-7"}
    assert {"serve/admit", "serve/queued", "serve/retired"} <= lifecycle
    assert any(e["name"] == "frontdoor/done" and e["args"]["id"] == "client-7" for e in events)


def test_between_ticks_runs_on_the_engine_thread(params):
    door = ServingFrontDoor(_factory(params))
    try:
        assert door.between_ticks(threading.current_thread) is door._thread
        with pytest.raises(KeyError, match="boom"):
            door.between_ticks(lambda: {}["boom"])
        h = door.submit(_prompts(1)[0], 5)
        assert door.between_ticks(lambda: 7) == 7
        np.testing.assert_array_equal(h.result(timeout=30.0).tokens,
                                      _reference(params, _prompts(1)[0], 5))
        assert door.stats()["watchdog_restarts"] == 0
    finally:
        door.close(grace_s=10.0)
    with pytest.raises(RuntimeError, match="not running"):
        door.between_ticks(lambda: 1, timeout=5.0)
