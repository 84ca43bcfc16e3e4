"""The port's dense continuous-batching engine against the JAX package's, on
the CPU.

``services/engine.py``'s :class:`DecodeEngine` at the JAX engine tests'
size (vocab 17, d_model 32, 2 layers, 4 heads, max_seq 64): the JAX LM's
params are carried across with ``params_from_jax`` and both engines take
the same submissions.  Every request's tokens (exact), ``n_new``,
``finish_reason``, ``bucket`` and timing counts, ``compile_stats()
["programs"]``, the ``znicz_serve_*`` registry series (counter and histogram
deltas, gauge values), the device ledger's new keys and the host row state
after every tick are equal; greedy, sampled with JAX's draws handed in
(``rng(path, shape, kind)`` returns ``jax.random.gumbel(fold_in(key,
*path), shape)``) and the MoE LM in both dispatches.  Also: a second engine
of one geometry makes no ledger entry, ``abort``/``reap``, instant
retirement at admission, typed errors with JAX's messages, the
``engine.decode_step`` fault point, and each completion equals the port's
own ``generate()`` trimmed at EOS.
"""

import jax
import numpy as np
import pytest
import torch

from znicz_tpu import observability as jobs
from znicz_tpu.core import prng as jprng
from znicz_tpu.observability import device as jdevice
from znicz_tpu.services import engine as JE
from znicz_tpu.utils import faults as jfaults
from znicz_tpu.workflow.transformer import init_lm_params as jinit
from znicz_tpu_torch import observability as tobs
from znicz_tpu_torch.observability import device as tdevice
from znicz_tpu_torch.services import engine as TE
from znicz_tpu_torch.services.errors import (
    RequestTooLargeError,
    SpeculationUnsupportedError,
)
from znicz_tpu_torch.utils import faults as tfaults
from znicz_tpu_torch.workflow import generate as G, model as model_lib

torch.set_float32_matmul_precision("highest")

EOS = 14
HEADS = 4
T_MAX = 64
GREEDY = (True, 0, False)


@pytest.fixture(autouse=True)
def _fresh_program_ledgers():
    """Each test starts with empty first-make ledgers on both sides, so the
    compile counters count the same makes whatever ran earlier in the
    process; the JAX package's set is restored to what it holds plus what
    the test compiled."""
    saved = set(JE._COMPILED_KEYS)
    JE._COMPILED_KEYS.clear()
    TE._COMPILED_KEYS.clear()
    yield
    JE._COMPILED_KEYS.update(saved)
    jfaults.clear()
    tfaults.clear()


def _setup(moe_experts=0, seed=27):
    jprng.seed_all(seed)
    jp = jinit(17, 32, 2, HEADS, max_seq=T_MAX, moe_experts=moe_experts)
    return jp, model_lib.params_from_jax(jax.device_get(jp), "cpu")


def _jax_rng(key):
    """JAX's draws for the port: the fold-in path's Gumbel or uniform
    noise."""
    def rng(path, shape, kind):
        k = key
        for p in path:
            k = jax.random.fold_in(k, p)
        draw = jax.random.gumbel if kind == "gumbel" else jax.random.uniform
        return np.asarray(draw(k, shape))
    return rng


def _engines(jp, tp, *, sampling=None, **kw):
    kw = {**dict(n_heads=HEADS, eos_id=EOS, batch_size=2, admit_every=4), **kw}
    jkw, tkw = dict(kw), dict(kw)
    if sampling:
        key = jax.random.key(sampling.pop("seed", 3))
        jkw.update(sampling, rng=key)
        tkw.update(sampling, rng=_jax_rng(key))
    return JE.DecodeEngine(jp, **jkw), TE.DecodeEngine(tp, **tkw)


# the gauges a dense engine sets (the pool gauges belong to the paged engines
# of other tests in the process)
DENSE_GAUGES = ("znicz_serve_queue_depth", "znicz_serve_active_slots")


def _series(obs):
    out = {}
    for name, m in obs.get_registry().metrics().items():
        if not name.startswith("znicz_serve_") or name.startswith("znicz_serve_cache"):
            continue
        if m.kind == "gauge" and name not in DENSE_GAUGES:
            continue
        for labels, child in m.children().items():
            if m.kind == "histogram":
                out[(name, labels, "count")] = child.count
                if name == "znicz_serve_spec_accept_length":
                    out[(name, labels, "sum")] = child.sum
            else:
                out[(name, labels, m.kind)] = child.value
    return out


def _delta(before, after):
    return {k: v if k[-1] == "gauge" else v - before.get(k, 0) for k, v in after.items()
            if k[-1] == "gauge" or v != before.get(k, 0)}


class _Watch:
    """Registry series and device-ledger keys of both sides around a
    stream."""

    def __init__(self):
        self.series = (_series(jobs), _series(tobs))
        self.ledgers = ({e["key"] for e in jdevice.programs("engine")},
                        {e["key"] for e in tdevice.programs("engine")})

    def check(self):
        jd = _delta(self.series[0], _series(jobs))
        td = _delta(self.series[1], _series(tobs))
        assert td == jd
        jnew = {e["key"] for e in jdevice.programs("engine")} - self.ledgers[0]
        tnew = {e["key"] for e in tdevice.programs("engine")} - self.ledgers[1]
        # a key another test already ledgered overwrites its entry
        assert tnew <= {e["key"] for e in jdevice.programs("engine")}
        assert jnew <= {e["key"] for e in tdevice.programs("engine")}
        return td


COUNTED = ("preemptions", "cached_tokens", "spec_drafted", "spec_accepted")


def _assert_same(je, te):
    assert sorted(je.completions) == sorted(te.completions)
    for rid, jc in je.completions.items():
        tc = te.completions[rid]
        np.testing.assert_array_equal(tc.tokens, jc.tokens, err_msg=f"request {rid}")
        assert (tc.n_new, tc.finish_reason, tc.bucket) == (jc.n_new, jc.finish_reason, jc.bucket)
        assert {k: tc.timings[k] for k in COUNTED} == {k: jc.timings[k] for k in COUNTED}
        assert (tc.ttft_s is None) == (jc.ttft_s is None)
    assert [c.id for c in te._order] == [c.id for c in je._order]
    js, ts = je.stats(), te.stats()
    for k in ("kv_backend", "completed", "generated_tokens", "peak_active", "programs",
              "n_programs", "program_hits", "spec"):
        assert ts[k] == js[k], k
    assert ts["tick_occupancy"]["ticks"] == js["tick_occupancy"]["ticks"]
    assert set(ts["phases"]) == set(js["phases"])


def _drive(engines, reqs):
    for eng in engines:
        for prompt, budget in reqs:
            eng.submit(prompt, budget)
    return [eng.run() for eng in engines]


def _reference(tp, prompt, budget, **moe):
    """The port's single-request ``generate()`` trimmed at EOS."""
    out = G.generate(tp, prompt[None], n_heads=HEADS, max_new_tokens=budget, eos_id=EOS,
                     **moe).numpy()[0]
    new = out[len(prompt):]
    hit = np.where(new == EOS)[0]
    return np.concatenate([prompt, new[: hit[0] + 1] if len(hit) else new])


def _prompts(seed, lengths, lo=0):
    gen = np.random.default_rng(seed)
    return [gen.integers(lo, 17, (n,)).astype(np.int32) for n in lengths]


def test_mixed_stream_with_slot_reuse_equals_jax_and_generate():
    jp, tp = _setup()
    reqs = list(zip(_prompts(7, (5, 12, 3, 20, 9, 30)), (6, 5, 9, 7, 8, 4)))
    watch = _Watch()
    je, te = _engines(jp, tp)
    _drive((je, te), reqs)
    _assert_same(je, te)
    delta = watch.check()
    assert te.compile_stats()["programs"] == {
        ("admit", 16, GREEDY): 1, ("admit", 32, GREEDY): 1, ("chunk", 4, 2, GREEDY): 1,
    }
    assert delta[("znicz_serve_compiles_total", ("admit", "16"), "counter")] == 1
    retired = ("znicz_serve_requests_retired_total", ("eos",), "counter")
    assert delta.get(retired, 0) + delta.get(retired[:1] + (("budget",), "counter"), 0) == len(reqs)
    # a CPU engine runs its programs eagerly: no graphs, one timed first call a key
    st = te.compile_stats()
    assert st["admit_graph_entries"] == st["chunk_graph_entries"] == 0
    assert set(te.capture_s) == set(st["programs"])
    for rid, (prompt, budget) in enumerate(reqs):
        np.testing.assert_array_equal(te.completions[rid].tokens, _reference(tp, prompt, budget))
    assert te.pending == 0 and te.active == 0
    assert te.latency.summary()["count"] == len(reqs)


def test_host_row_state_equals_jax_after_every_tick():
    """A chunk runs all ``admit_every`` steps: rows that finish inside it
    emit EOS, and iterations after every row is done change no state, so
    positions, tokens, the done mask, budgets and ``steps`` equal JAX's
    early-exiting loop tick by tick (budgets 2-3 finish mid-chunk)."""
    jp, tp = _setup(seed=5)
    reqs = list(zip(_prompts(21, (4, 7, 6, 9, 3)), (2, 3, 11, 2, 6)))
    je, te = _engines(jp, tp, admit_every=8)
    for eng in (je, te):
        for prompt, budget in reqs:
            eng.submit(prompt, budget)
    ticks = 0
    while True:
        more = je.tick()
        assert te.tick() == more
        if not more:
            break
        ticks += 1
        for name in ("_tok", "_pos", "_start", "_done", "_remaining"):
            np.testing.assert_array_equal(getattr(te, name), getattr(je, name), err_msg=name)
    assert ticks >= 3
    _assert_same(je, te)


@pytest.mark.parametrize("sampling", [
    dict(temperature=0.8), dict(temperature=1.1, top_k=5, top_p=0.9),
], ids=["temperature", "top_k+top_p"])
def test_sampled_stream_with_jax_draws_equals_jax(sampling):
    jp, tp = _setup()
    reqs = list(zip(_prompts(11, (4, 10, 6, 17)), (5, 7, 4, 6)))
    watch = _Watch()
    je, te = _engines(jp, tp, sampling=dict(sampling, seed=8), admit_every=3)
    _drive((je, te), reqs)
    _assert_same(je, te)
    watch.check()
    structure = (False, sampling.get("top_k", 0), "top_p" in sampling)
    assert ("chunk", 3, 2, structure) in te.compile_stats()["programs"]


def test_sampled_stream_with_a_generator_is_reproducible():
    _, tp = _setup()
    prompts = _prompts(11, (4, 10, 6))

    def serve(seed):
        eng = TE.DecodeEngine(tp, n_heads=HEADS, eos_id=EOS, batch_size=2, admit_every=3,
                              temperature=0.9, rng=torch.Generator().manual_seed(seed))
        ids = [eng.submit(p, 6) for p in prompts]
        eng.run()
        return [eng.completions[i].tokens for i in ids]

    a, b = serve(4), serve(4)
    for ta, tb, p in zip(a, b, prompts):
        np.testing.assert_array_equal(ta, tb)
        assert ((ta[len(p):] >= 0) & (ta[len(p):] < 17)).all()


@pytest.mark.parametrize("dispatch", ["dense", "capacity"])
def test_moe_stream_equals_jax(dispatch):
    """Capacity routing runs the MoE once a row in the dense chunk (JAX's
    ``vmap``: one token's capacity) and over the padded prompt at admit."""
    jp, tp = _setup(moe_experts=4, seed=31)
    moe = dict(moe_top_k=2, moe_dispatch=dispatch)
    reqs = list(zip(_prompts(13, (5, 11, 8)), (6, 5, 7)))
    watch = _Watch()
    je, te = _engines(jp, tp, **moe)
    _drive((je, te), reqs)
    _assert_same(je, te)
    watch.check()
    if dispatch == "dense":  # dense routing is per token: batching cannot change it
        for rid, (prompt, budget) in enumerate(reqs):
            np.testing.assert_array_equal(te.completions[rid].tokens,
                                          _reference(tp, prompt, budget, **moe))


def test_instant_retirement_and_a_second_engine_make_no_programs():
    """Budget-1 requests retire at admission and the slot keeps pulling
    from the queue; a second engine of the same geometry reuses the
    process-wide ledger on both sides (its own programs, no new ledger
    entry or compile count)."""
    jp, tp = _setup()
    reqs = list(zip(_prompts(17, (4, 6, 8, 5, 7)), (1, 1, 1, 6, 5)))
    je, te = _engines(jp, tp)
    _drive((je, te), reqs)
    _assert_same(je, te)
    watch = _Watch()
    je2, te2 = _engines(jp, tp)
    _drive((je2, te2), reqs[3:])
    _assert_same(je2, te2)
    delta = watch.check()
    assert not any(k[0] == "znicz_serve_compiles_total" for k in delta)
    assert te2.compile_stats()["programs"] == {("admit", 16, GREEDY): 1, ("chunk", 4, 2, GREEDY): 1}
    assert set(te2.capture_s) == set(te2.compile_stats()["programs"])


def test_abort_and_reap_equal_jax():
    jp, tp = _setup()
    reqs = list(zip(_prompts(19, (5, 9, 7, 4)), (9, 9, 9, 9)))
    je, te = _engines(jp, tp)
    got = []
    for eng in (je, te):
        for prompt, budget in reqs:
            eng.submit(prompt, budget)
        eng.tick()  # requests 0 and 1 in slots, 2 and 3 queued
        a = eng.abort(1, "cancelled")
        q = eng.abort(3, "deadline_exceeded")
        assert eng.abort(3, "cancelled") is None and eng.abort(99, "cancelled") is None
        eng.run()
        eng.reap(0)
        got.append((a, q))
    (ja, jq), (ta, tq) = got
    for j, t in ((ja, ta), (jq, tq)):
        np.testing.assert_array_equal(t.tokens, j.tokens)
        assert (t.n_new, t.finish_reason) == (j.n_new, j.finish_reason)
    assert tq.n_new == 0 and ta.n_new > 0
    assert 0 not in te.completions and [c.id for c in te._order] == [1, 3, 2]
    _assert_same(je, te)


def _raised(fn):
    try:
        fn()
    except Exception as exc:  # the message is held to JAX's
        return type(exc).__name__, str(exc)
    return None


def test_typed_errors_equal_jax():
    jp, tp = _setup()
    je, te = _engines(jp, tp)
    for fn in (
        lambda e: e.submit(np.asarray([], np.int32), 4),
        lambda e: e.submit(np.asarray([1, 2], np.int32), 0),
        lambda e: e.submit(np.arange(5, dtype=np.int32), 60),
    ):
        j, t = _raised(lambda: fn(je)), _raised(lambda: fn(te))
        assert j is not None and t == j
    with pytest.raises(RequestTooLargeError, match="dense KV buffer"):
        te.submit(np.arange(5, dtype=np.int32), 60)
    builds = [
        dict(eos_id=99), dict(prefix_cache=True), dict(spec_k=2), dict(spec_buckets=(2, 4)),
        dict(batch_size=0), dict(max_seq=65), dict(temperature=0.5), dict(top_p=0.0),
    ]
    for kw in builds:
        args = dict(dict(n_heads=HEADS, eos_id=EOS), **kw)
        j = _raised(lambda: JE.DecodeEngine(jp, **args))
        t = _raised(lambda: TE.DecodeEngine(tp, **args))
        assert j is not None and t is not None and t[0] == j[0], kw
        if "temperature" not in kw:  # the port asks for a torch.Generator there
            assert t == j, kw
    with pytest.raises(SpeculationUnsupportedError):
        TE.DecodeEngine(tp, n_heads=HEADS, eos_id=EOS, spec_k=2)
    assert te.prefix_probe([1, 2, 3]) == je.prefix_probe([1, 2, 3])
    assert te.spec_stats() == je.spec_stats() == {"enabled": False}


def test_decode_step_fault_fires_where_jax_fires():
    jp, tp = _setup()
    reqs = list(zip(_prompts(23, (5, 9, 7)), (9, 9, 9)))
    je, te = _engines(jp, tp)
    states = []
    for eng, faults in ((je, jfaults), (te, tfaults)):
        for prompt, budget in reqs:
            eng.submit(prompt, budget)
        faults.inject("engine.decode_step", after=1, times=1)
        with pytest.raises(faults.FaultInjected):
            eng.run()
        states.append(([st and list(st["emitted"]) for st in eng._slots], eng.pending,
                       sorted(eng.completions)))
        eng.run()  # disarmed after one fire: the stream completes
    assert states[1] == states[0]
    _assert_same(je, te)
