"""The port's paged continuous-batching engine against the JAX package's, on
the CPU.

``services/engine.py``'s :class:`PagedDecodeEngine` at the JAX engine tests'
size (vocab 17, d_model 32, 2 layers, 4 heads, max_seq 64, block 8 or 4):
the JAX LM's params carried across with ``params_from_jax``, the same
submissions to both engines.  Every request's tokens (exact), ``n_new``,
``finish_reason``, ``bucket`` and timing counts (preemptions, cached
tokens), ``compile_stats()["programs"]`` (one prefill program, the x2
window rungs, the COW copy), the pool and prefix-cache tallies, the
white-box pool state (free list, refcounts, tables, cache map, LRU order)
and the ``znicz_serve_*`` registry series are equal: growth past one
block, preemption, the prefix cache (shared prefixes, multi-turn reuse, the
fully-cached COW re-run, mid-block divergence, the decode write guard's
copying split), eviction before preemption, survivors' shared blocks,
sampled decoding with JAX's draws, the MoE LM in both dispatches, the host
row state after every tick (done rows freeze), ``abort``/``reap``, the
``engine.prefill`` and ``pool.pressure`` fault points, typed errors, and
``prefix_block_keys`` byte-identical to JAX's.
"""

import jax
import numpy as np
import pytest
import torch

from znicz_tpu import observability as jobs
from znicz_tpu.core import prng as jprng
from znicz_tpu.services import engine as JE
from znicz_tpu.utils import faults as jfaults
from znicz_tpu.workflow.transformer import init_lm_params as jinit
from znicz_tpu_torch import observability as tobs
from znicz_tpu_torch.services import engine as TE
from znicz_tpu_torch.utils import faults as tfaults
from znicz_tpu_torch.workflow import generate as G, model as model_lib

torch.set_float32_matmul_precision("highest")

EOS = 14
HEADS = 4
T_MAX = 64
BS = 8
GREEDY = (True, 0, False)


@pytest.fixture(autouse=True)
def _fresh_program_ledgers():
    """Empty first-make ledgers on both sides for each test (the JAX
    package's set is restored to what it holds plus what the test
    compiled)."""
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
    def rng(path, shape, kind):
        k = key
        for p in path:
            k = jax.random.fold_in(k, p)
        draw = jax.random.gumbel if kind == "gumbel" else jax.random.uniform
        return np.asarray(draw(k, shape))
    return rng


def _engines(jp, tp, *, sampling=None, **kw):
    kw = {**dict(n_heads=HEADS, eos_id=EOS, batch_size=2, block_size=BS, max_seq=T_MAX,
                 admit_every=4), **kw}
    jkw, tkw = dict(kw), dict(kw)
    if sampling:
        key = jax.random.key(sampling.pop("seed", 3))
        jkw.update(sampling, rng=key)
        tkw.update(sampling, rng=_jax_rng(key))
    return JE.PagedDecodeEngine(jp, **jkw), TE.PagedDecodeEngine(tp, **tkw)


# the gauges an engine sets (other serving code in the process sets others)
ENGINE_GAUGES = ("znicz_serve_queue_depth", "znicz_serve_active_slots",
                 "znicz_serve_kv_pool_blocks", "znicz_serve_kv_pool_bytes")


def _series(obs):
    out = {}
    for name, m in obs.get_registry().metrics().items():
        if not name.startswith("znicz_serve_") or name.startswith("znicz_serve_cache"):
            continue
        if m.kind == "gauge" and name not in ENGINE_GAUGES:
            continue
        for labels, child in m.children().items():
            if m.kind == "histogram":
                out[(name, labels, "count")] = child.count
            else:
                out[(name, labels, m.kind)] = child.value
    return out


def _delta(before, after):
    return {k: v if k[-1] == "gauge" else v - before.get(k, 0) for k, v in after.items()
            if k[-1] == "gauge" or v != before.get(k, 0)}


class _Watch:
    def __init__(self):
        self.before = (_series(jobs), _series(tobs))

    def check(self):
        td = _delta(self.before[1], _series(tobs))
        assert td == _delta(self.before[0], _series(jobs))
        return td


COUNTED = ("preemptions", "cached_tokens", "spec_drafted", "spec_accepted")
POOL = ("pool_blocks", "pool_blocks_free", "pool_blocks_cached", "block_size", "block_bytes",
        "pool_bytes", "preemptions", "prefix_cache")


def _assert_pool(je, te):
    assert te._free == je._free
    np.testing.assert_array_equal(te._ref, je._ref)
    np.testing.assert_array_equal(te._tables, je._tables)
    assert te._row_blocks == je._row_blocks
    assert te._cache == je._cache and te._block_hash == je._block_hash
    assert list(te._lru) == list(je._lru)


def _assert_same(je, te):
    assert sorted(je.completions) == sorted(te.completions)
    for rid, jc in je.completions.items():
        tc = te.completions[rid]
        np.testing.assert_array_equal(tc.tokens, jc.tokens, err_msg=f"request {rid}")
        assert (tc.n_new, tc.finish_reason, tc.bucket) == (jc.n_new, jc.finish_reason, jc.bucket)
        assert {k: tc.timings[k] for k in COUNTED} == {k: jc.timings[k] for k in COUNTED}
    assert [c.id for c in te._order] == [c.id for c in je._order]
    js, ts = je.stats(), te.stats()
    for k in ("kv_backend", "completed", "generated_tokens", "peak_active", "programs",
              "n_programs", "program_hits", "spec") + POOL:
        assert ts[k] == js[k], k
    assert ts["tick_occupancy"]["ticks"] == js["tick_occupancy"]["ticks"]
    assert te.pool_free_frac == je.pool_free_frac
    _assert_pool(je, te)


def _no_leaks(eng):
    assert eng.active == 0 and eng.prefilling == 0 and eng.pending == 0
    eng.flush_prefix_cache()
    assert len(eng._cache) == 0 and len(eng._lru) == 0
    assert sorted(eng._free) == list(range(1, eng.n_blocks))
    assert (eng._ref == 0).all()


def _submit_run(engines, reqs):
    ids = []
    for eng in engines:
        ids = [eng.submit(p, b) for p, b in reqs]
        eng.run()
    return ids


def _reference(tp, prompt, budget, eos=EOS, **moe):
    """The port's single-request ``generate()`` trimmed at EOS."""
    out = G.generate(tp, prompt[None], n_heads=HEADS, max_new_tokens=budget, eos_id=eos,
                     **moe).numpy()[0]
    new = out[len(prompt):]
    hit = np.where(new == eos)[0]
    return np.concatenate([prompt, new[: hit[0] + 1] if len(hit) else new])


def _tokens(rng, n, lo=0):
    return rng.integers(lo, 17, (n,)).astype(np.int32)


@pytest.mark.parametrize("prefix", [False, True], ids=["no-prefix-cache", "prefix-cache"])
def test_growth_stream_equals_jax_and_generate(prefix):
    """Block 4, budgets past several blocks: one prefill program and one
    decode chunk a x2 window rung on both sides; a second engine of the
    geometry makes no ledger entry."""
    jp, tp = _setup()
    gen = np.random.default_rng(31)
    reqs = [(_tokens(gen, n), b) for n, b in ((3, 9), (6, 11), (10, 7), (5, 12), (13, 20))]
    kw = dict(block_size=4, admit_every=5, batch_size=3, eos_id=15, prefix_cache=prefix)
    watch = _Watch()
    je, te = _engines(jp, tp, **kw)
    ids = _submit_run((je, te), reqs)
    _assert_same(je, te)
    delta = watch.check()
    progs = te.compile_stats()["programs"]
    windows = sorted(k[3] for k in progs if k[0] == "paged_chunk")
    assert ("prefill", 4, GREEDY) in progs and len(windows) >= 2
    assert all(w & (w - 1) == 0 for w in windows)
    assert sum(v for k, v in delta.items() if k[0] == "znicz_serve_compiles_total") == len(progs)
    for rid, (p, b) in zip(ids, reqs):
        np.testing.assert_array_equal(te.completions[rid].tokens, _reference(tp, p, b, eos=15))
    watch = _Watch()
    je2, te2 = _engines(jp, tp, **kw)
    _submit_run((je2, te2), reqs[:2])
    _assert_same(je2, te2)
    assert not any(k[0] == "znicz_serve_compiles_total" for k in watch.check())
    _no_leaks(te)


def test_pool_pressure_preempts_the_youngest_as_jax():
    """6 usable blocks, two full-budget requests: the younger is preempted,
    requeued at the head and recomputed; one admission event each."""
    jp, tp = _setup()
    gen = np.random.default_rng(7)
    reqs = [(_tokens(gen, 10), 20), (_tokens(gen, 5), 20)]
    watch = _Watch()
    je, te = _engines(jp, tp, eos_id=15, n_blocks=7)
    ids = _submit_run((je, te), reqs)
    _assert_same(je, te)
    delta = watch.check()
    assert te.stats()["preemptions"] >= 1
    assert delta[("znicz_serve_requests_admitted_total", (), "counter")] == 2
    assert te.completions[ids[1]].timings["preemptions"] >= 1
    for rid, (p, b) in zip(ids, reqs):
        np.testing.assert_array_equal(te.completions[rid].tokens, _reference(tp, p, b, eos=15))


def test_prefix_cache_reuse_equals_jax():
    """Shared two-block prefix, multi-turn reuse of generated blocks, the
    fully-cached prompt's COW re-run (the cached block stays pristine: a
    third run hits it again) and a divergence mid-block, in one engine."""
    jp, tp = _setup()
    rng = np.random.default_rng(41)
    s = _tokens(rng, 2 * BS)
    pa, pb = np.concatenate([s, _tokens(rng, 5)]), np.concatenate([s, _tokens(rng, 7)])
    aligned = _tokens(rng, 2 * BS)
    diverged = np.concatenate([s, _tokens(rng, 2)])
    diverged[BS + 4] = (diverged[BS + 4] + 1) % 17
    je, te = _engines(jp, tp)
    watch = _Watch()
    _submit_run((je, te), [(pa, 6)])
    for reqs in ([(pb, 6)], [(aligned, 6)], [(aligned, 6)], [(aligned, 6)], [(diverged, 5)]):
        _submit_run((je, te), reqs)
        _assert_same(je, te)
    turn2 = np.concatenate([te.completions[0].tokens, _tokens(rng, 4)])
    _submit_run((je, te), [(turn2, 5)])
    _assert_same(je, te)
    delta = watch.check()
    st = te.stats()["prefix_cache"]
    assert st["hits"] >= 8 and st["cow_splits"] >= 2 and st["cached_tokens"] >= 4 * BS
    assert delta[("znicz_serve_prefix_misses_total", (), "counter")] >= 1
    for c in te.completions.values():
        prompt = c.tokens[: c.tokens.size - c.n_new]
        np.testing.assert_array_equal(c.tokens, _reference(tp, prompt, 6 if c.id < 5 else 5))
    _no_leaks(te)
    _no_leaks(je)
    _assert_pool(je, te)


def test_decode_write_guard_copies_shared_content_as_jax():
    """White box: the row's prompt block cached mid-flight (as an eager
    publish policy would) makes the decode write guard COW-split it with a
    copy (the ``("cow", block_size)`` program)."""
    jp, tp = _setup()
    p = _tokens(np.random.default_rng(51), 5)
    je, te = _engines(jp, tp, batch_size=1)
    for eng in (je, te):
        eng.submit(p, 8)
        eng._admit_pending()
        eng._prefill_tick()
        blk = int(eng._row_blocks[0][0])
        eng._cache[b"eager-fill"] = blk
        eng._block_hash[blk] = b"eager-fill"
        eng.run()
    _assert_same(je, te)
    assert ("cow", BS) in te.compile_stats()["programs"]
    assert te.stats()["prefix_cache"]["cow_splits"] >= 1
    np.testing.assert_array_equal(te.completions[0].tokens, _reference(tp, p, 8))


def test_eviction_before_preemption_and_shared_survivors_equal_jax():
    """A pool too small for two cached prefixes evicts (nobody live to
    preempt) and recomputes what it evicted; then two requests mapping one
    cached prefix under pressure: the younger is preempted and the
    refcounts keep the shared blocks for the survivor."""
    jp, tp = _setup()
    rng = np.random.default_rng(53)
    pa, pb = _tokens(rng, 2 * BS), _tokens(rng, 2 * BS)
    je, te = _engines(jp, tp, batch_size=1, n_blocks=5)
    watch = _Watch()
    for reqs in ([(pa, 8)], [(pb, 8)], [(pa, 8)]):
        _submit_run((je, te), reqs)
        _assert_same(je, te)
    assert watch.check()[("znicz_serve_prefix_evictions_total", (), "counter")] >= 1
    assert te.stats()["preemptions"] == 0
    rng = np.random.default_rng(59)
    s = _tokens(rng, 2 * BS)
    je, te = _engines(jp, tp, n_blocks=7)
    _submit_run((je, te), [(s, 1)])
    _submit_run((je, te), [(np.concatenate([s, _tokens(rng, 3)]), 12),
                           (np.concatenate([s, _tokens(rng, 6)]), 12)])
    _assert_same(je, te)
    assert te.stats()["preemptions"] >= 1
    _no_leaks(te)


@pytest.mark.parametrize("sampling", [
    dict(temperature=0.9), dict(temperature=1.2, top_k=4, top_p=0.85),
], ids=["temperature", "top_k+top_p"])
def test_sampled_paged_stream_with_jax_draws_equals_jax(sampling):
    jp, tp = _setup()
    gen = np.random.default_rng(61)
    reqs = [(_tokens(gen, n), b) for n, b in ((4, 6), (11, 9), (19, 5))]
    watch = _Watch()
    je, te = _engines(jp, tp, sampling=dict(sampling, seed=9), admit_every=3)
    _submit_run((je, te), reqs)
    _assert_same(je, te)
    watch.check()


@pytest.mark.parametrize("dispatch", ["dense", "capacity"])
def test_moe_paged_stream_equals_jax(dispatch):
    """The paged chunk routes the whole batch at once (pad and done rows
    included), a prefill chunk its block."""
    jp, tp = _setup(moe_experts=4, seed=31)
    gen = np.random.default_rng(63)
    reqs = [(_tokens(gen, n), b) for n, b in ((5, 7), (12, 9), (9, 6))]
    je, te = _engines(jp, tp, moe_top_k=2, moe_dispatch=dispatch)
    _submit_run((je, te), reqs)
    _assert_same(je, te)


def test_host_row_state_and_tables_equal_jax_after_every_tick():
    """Done rows freeze at their position and write to the null block;
    iterations after every row is done change nothing: the row state and
    the block tables equal JAX's tick by tick."""
    jp, tp = _setup(seed=5)
    gen = np.random.default_rng(21)
    reqs = [(_tokens(gen, n), b) for n, b in ((4, 2), (7, 3), (6, 11), (9, 2), (3, 6))]
    je, te = _engines(jp, tp, admit_every=8)
    for eng in (je, te):
        for p, b in reqs:
            eng.submit(p, b)
    ticks = 0
    while True:
        more = je.tick()
        assert te.tick() == more
        if not more:
            break
        ticks += 1
        for name in ("_tok", "_pos", "_start", "_done", "_remaining"):
            np.testing.assert_array_equal(getattr(te, name), getattr(je, name), err_msg=name)
        _assert_pool(je, te)
    assert ticks >= 3
    _assert_same(je, te)


def test_abort_in_prefill_and_decode_and_reap_equal_jax():
    """Abort one request a state (prefilling, decoding, queued): the slot's
    blocks are released, completed full blocks publish, and the typed
    completions equal JAX's."""
    jp, tp = _setup()
    gen = np.random.default_rng(67)
    reqs = [(_tokens(gen, 5), 12), (_tokens(gen, 30), 9), (_tokens(gen, 6), 9),
            (_tokens(gen, 7), 9), (_tokens(gen, 9), 9)]
    je, te = _engines(jp, tp, batch_size=3, prefill_budget=4)
    got = []
    for eng in (je, te):
        for p, b in reqs:
            eng.submit(p, b)
        for _ in range(6):  # until a row prefills, one decodes and one waits
            eng.tick()
            by_mode = {st["mode"]: st["req"].id for st in eng._slots if st is not None}
            if len(by_mode) == 2 and eng._queue:
                break
        targets = [by_mode["prefill"], by_mode["decode"], eng._queue[0].id]
        comps = [eng.abort(rid, reason) for rid, reason in
                 zip(targets, ("cancelled", "deadline_exceeded", "cancelled"))]
        assert eng.abort(targets[0], "cancelled") is None
        eng.run()
        eng.reap(targets[1])
        got.append((targets, comps))
    (jt, jc), (tt, tc) = got
    assert tt == jt
    for j, t in zip(jc, tc):
        np.testing.assert_array_equal(t.tokens, j.tokens)
        assert (t.n_new, t.finish_reason) == (j.n_new, j.finish_reason)
    assert tc[2].n_new == 0 and tc[1].n_new > 0 and tt[1] not in te.completions
    _assert_same(je, te)
    _no_leaks(te)


def test_prefix_block_keys_are_byte_identical_to_jax():
    gen = np.random.default_rng(71)
    for bs in (1, 4, 8, 32):
        for n in (0, 3, 8, 33, 100):
            p = gen.integers(0, 8192, (n,))
            assert TE.prefix_block_keys(p, bs) == JE.prefix_block_keys(p, bs)
            assert TE.prefix_block_keys(list(p), bs) == JE.prefix_block_keys(list(p), bs)
    jp, tp = _setup()
    rng = np.random.default_rng(73)
    s = _tokens(rng, 3 * BS)
    je, te = _engines(jp, tp)
    _submit_run((je, te), [(s, 4)])
    for probe in (s, np.concatenate([s, _tokens(rng, 9)]), s[:BS + 2], _tokens(rng, 20)):
        assert te.prefix_probe(probe) == je.prefix_probe(probe)
    assert te.prefix_probe(s)["cached_blocks"] == 3


def test_prefill_and_pool_faults_fire_where_jax_fires():
    """``engine.prefill`` raises at the same chunk; ``pool.pressure``
    (behavioral) starves one allocation, which preempts as JAX does."""
    jp, tp = _setup()
    gen = np.random.default_rng(79)
    reqs = [(_tokens(gen, 20), 6), (_tokens(gen, 7), 6)]
    je, te = _engines(jp, tp)
    states = []
    for eng, faults in ((je, jfaults), (te, tfaults)):
        for p, b in reqs:
            eng.submit(p, b)
        faults.inject("engine.prefill", after=2, times=1)
        with pytest.raises(faults.FaultInjected):
            eng.run()
        states.append(([st and (st["mode"], st["chunks_done"]) for st in eng._slots],
                       eng.pending))
        eng.run()
        faults.inject("pool.pressure", flag=True, after=1, times=1)
        for p, b in reqs:
            eng.submit(p, b)
        eng.run()
    assert states[1] == states[0]
    _assert_same(je, te)
    assert te.stats()["preemptions"] >= 1


def _raised(fn):
    try:
        fn()
    except Exception as exc:
        return type(exc).__name__, str(exc)
    return None


def test_paged_validation_errors_equal_jax():
    jp, tp = _setup()
    je, te = _engines(jp, tp, n_blocks=5)
    for fn in (
        lambda e: e.submit(np.asarray([], np.int32), 4),
        lambda e: e.submit(np.asarray([1, 2], np.int32), 0),
        lambda e: e.submit(np.arange(5, dtype=np.int32), 30),
        lambda e: e.submit(np.arange(5, dtype=np.int32), 60),
    ):
        j, t = _raised(lambda: fn(je)), _raised(lambda: fn(te))
        assert j is not None and t == j
    for kw in (dict(block_size=0), dict(n_blocks=1), dict(spec_k=-1), dict(spec_buckets=(1, 4)),
               dict(spec_buckets=(4, 2)), dict(drafter=object()), dict(prefill_budget=0)):
        args = {**dict(n_heads=HEADS, eos_id=EOS, block_size=BS, max_seq=T_MAX), **kw}
        j = _raised(lambda: JE.PagedDecodeEngine(jp, **args))
        t = _raised(lambda: TE.PagedDecodeEngine(tp, **args))
        assert j is not None and t == j, kw


def test_pool_packs_more_rows_than_the_dense_layout_as_jax():
    """16 usable blocks of 8 hold 128 tokens: the dense layout's 2 slots of
    64 in that memory, and 4 rows decode at once."""
    jp, tp = _setup()
    gen = np.random.default_rng(35)
    reqs = [(_tokens(gen, 5), 9) for _ in range(4)]
    je, te = _engines(jp, tp, batch_size=4, n_blocks=17, eos_id=15, admit_every=2)
    _submit_run((je, te), reqs)
    _assert_same(je, te)
    st = te.stats()
    assert st["peak_active"] == 4 and st["preemptions"] == 0
    assert st["pool_blocks"] * BS // T_MAX == 2


@pytest.mark.parametrize("verify", [False, True], ids=["decode-step", "verify-chunk"])
def test_masked_writes_leave_the_null_block_as_jax_does(verify):
    """Rows with nothing to write all land in the null block, several at one
    slot: each takes the last such write's value, so the block ends as JAX's
    serial scatter leaves it (and as any order of the card's stores would)."""
    from znicz_tpu.workflow import generate as JG

    jp, tp = _setup()
    gen = np.random.default_rng(83)
    b = 5
    tables = np.stack([np.arange(1 + 2 * r, 3 + 2 * r) for r in range(b)]).astype(np.int32)
    pos = np.asarray([3, 11, 3, 3, 11], np.int32)  # three rows at slot 3, two at 11 % 8
    mask = np.asarray([False, False, True, False, False])
    tpools = G.init_paged_kv(tp, 1 + 2 * b, BS, n_heads=HEADS)
    jpools = JG.init_paged_kv(jp, 1 + 2 * b, BS, n_heads=HEADS)
    if verify:
        tokens = gen.integers(0, 17, (b, 3)).astype(np.int32)
        wmask = np.repeat(mask[:, None], 3, axis=1)
        tpools, _ = G.paged_verify_chunk(
            tp, tpools, torch.from_numpy(tables), torch.from_numpy(tokens).long(),
            torch.from_numpy(pos).long(), n_heads=HEADS, block_size=BS,
            write_mask=torch.from_numpy(wmask))
        jpools, _ = JG.paged_verify_chunk(
            jp, jpools, jax.numpy.asarray(tables), jax.numpy.asarray(tokens),
            jax.numpy.asarray(pos), n_heads=HEADS, block_size=BS,
            write_mask=jax.numpy.asarray(wmask))
    else:
        token = gen.integers(0, 17, (b,)).astype(np.int32)
        tpools, _ = G.paged_decode_step(
            tp, tpools, torch.from_numpy(tables), torch.from_numpy(token).long(),
            torch.from_numpy(pos).long(), n_heads=HEADS, block_size=BS,
            write_mask=torch.from_numpy(mask))
        jpools, _ = JG.paged_decode_step(
            jp, jpools, jax.numpy.asarray(tables), jax.numpy.asarray(token),
            jax.numpy.asarray(pos), n_heads=HEADS, block_size=BS,
            write_mask=jax.numpy.asarray(mask))
    for t, j in zip(tpools, jpools):
        for name in ("k", "v"):
            np.testing.assert_allclose(t[name].numpy(), np.asarray(j[name]), rtol=1e-4,
                                       atol=1e-5)
            assert float(t[name][0].abs().sum()) > 0  # the null block was written
