"""The port's speculative decoding on the paged engine against the JAX
package's, on the CPU.

``services/engine.py``'s :class:`PagedDecodeEngine` with ``spec_k`` at the
JAX spec tests' size (vocab 17, d_model 32, 2 layers, 4 heads, max_seq 96,
block 8): the JAX LM's params carried across with ``params_from_jax``, the
same submissions and drafters on both sides.  Every request's tokens
(exact), ``n_new``, ``finish_reason`` and its ``spec_drafted`` /
``spec_accepted`` counts, ``spec_stats()``, ``compile_stats()["programs"]``
(the verify widths and window rungs), the pool state and the
``znicz_serve_*`` registry series (the accept-length histogram's sum too)
are equal: the prompt-lookup drafter on a repetitive stream, an oracle
drafter (every draft accepted, EOS inside an accepted prefix) and a junk
one (every draft rolled back), preemption under speculative allocation, a
multi-turn prefix over spec-filled blocks, sampled speculation with JAX's
uniform and residual draws handed in, and the MoE LM in both dispatches.
Greedy speculation also equals the spec-off engine token for token.
"""

import jax
import numpy as np
import pytest
import torch

from znicz_tpu import observability as jobs
from znicz_tpu.core import prng as jprng
from znicz_tpu.services import engine as JE
from znicz_tpu.workflow.transformer import init_lm_params as jinit
from znicz_tpu_torch import observability as tobs
from znicz_tpu_torch.services import engine as TE
from znicz_tpu_torch.workflow import generate as G, model as model_lib

torch.set_float32_matmul_precision("highest")

EOS = 15  # never greedily emitted by this seed's LM at small budgets
HEADS = 4
T_MAX = 96
BS = 8


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


def _engines(jp, tp, *, sampling=None, drafter=None, **kw):
    """A JAX engine and a port engine; ``drafter`` is a factory, so each
    side drafts from its own instance."""
    kw = {**dict(n_heads=HEADS, eos_id=EOS, batch_size=2, block_size=BS, max_seq=T_MAX,
                 admit_every=4, spec_k=7), **kw}
    jkw, tkw = dict(kw), dict(kw)
    if drafter is not None:
        jkw["drafter"], tkw["drafter"] = drafter(), drafter()
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
                if name == "znicz_serve_spec_accept_length":
                    out[(name, labels, "sum")] = child.sum
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


def _assert_same(je, te):
    assert sorted(je.completions) == sorted(te.completions)
    for rid, jc in je.completions.items():
        tc = te.completions[rid]
        np.testing.assert_array_equal(tc.tokens, jc.tokens, err_msg=f"request {rid}")
        assert (tc.n_new, tc.finish_reason, tc.bucket) == (jc.n_new, jc.finish_reason, jc.bucket)
        assert {k: tc.timings[k] for k in COUNTED} == {k: jc.timings[k] for k in COUNTED}
    js, ts = je.stats(), te.stats()
    for k in ("completed", "generated_tokens", "peak_active", "programs", "n_programs",
              "program_hits", "spec", "preemptions", "prefix_cache", "pool_blocks_free"):
        assert ts[k] == js[k], k
    assert ts["tick_occupancy"]["ticks"] == js["tick_occupancy"]["ticks"]
    assert te._free == je._free and te._row_blocks == je._row_blocks
    np.testing.assert_array_equal(te._ref, je._ref)


def _no_leaks(eng):
    assert eng.active == 0 and eng.prefilling == 0 and eng.pending == 0
    eng.flush_prefix_cache()
    assert sorted(eng._free) == list(range(1, eng.n_blocks))
    assert (eng._ref == 0).all()


def _submit_run(engines, reqs):
    ids = []
    for eng in engines:
        ids = [eng.submit(p, b) for p, b in reqs]
        eng.run()
    return ids


def _reference(tp, prompt, budget, **moe):
    out = G.generate(tp, prompt[None], n_heads=HEADS, max_new_tokens=budget, eos_id=EOS,
                     **moe).numpy()[0]
    new = out[len(prompt):]
    hit = np.where(new == EOS)[0]
    return np.concatenate([prompt, new[: hit[0] + 1] if len(hit) else new])


def _tokens(rng, n):
    return rng.integers(0, 17, (n,)).astype(np.int32)


class _Oracle:
    """Proposes the reference continuation of whatever context it is shown
    (every draft accepted); ``sizes`` cycles the draft length."""

    def __init__(self, refs, sizes=None):
        self.refs = [np.asarray(r, np.int32) for r in refs]
        self.sizes = list(sizes) if sizes else None
        self._call = 0

    def propose(self, context, k):
        ctx = np.asarray(context, np.int32)
        if self.sizes:
            k = min(k, self.sizes[self._call % len(self.sizes)])
            self._call += 1
        for ref in self.refs:
            if ctx.size < ref.size and np.array_equal(ref[:ctx.size], ctx):
                return ref[ctx.size:ctx.size + k].copy()
        return np.zeros((0,), np.int32)


class _Junk:
    def propose(self, context, k):
        return np.full((k,), 2, np.int32)


def test_prompt_lookup_stream_equals_jax_and_spec_off():
    jp, tp = _setup()
    rng = np.random.default_rng(5)
    prompts = [_tokens(rng, n) for n in (5, 12, 20, 9, 17)]
    prompts.append(np.tile(np.array([3, 5, 7, 2], np.int32), 8))
    reqs = [(p, 24) for p in prompts]
    watch = _Watch()
    je, te = _engines(jp, tp, drafter=lambda: G.PromptLookupDrafter(3, 1))
    ids = _submit_run((je, te), reqs)
    _assert_same(je, te)
    delta = watch.check()
    sp = te.spec_stats()
    assert sp["verify_steps"] > 0 and sp["drafted"] > 0 and 0 < sp["accepted"] <= sp["drafted"]
    assert delta[("znicz_serve_spec_accept_length", (), "sum")] == sp["accepted"]
    progs = te.compile_stats()["programs"]
    widths = {k[1] for k in progs if k[0] == "spec_verify"}
    assert widths <= {2, 4, 8} and len(widths) >= 2
    off = TE.PagedDecodeEngine(tp, n_heads=HEADS, eos_id=EOS, batch_size=2, block_size=BS,
                               max_seq=T_MAX, admit_every=4)
    off_ids = [off.submit(p, b) for p, b in reqs]
    off.run()
    for i, j, (p, b) in zip(ids, off_ids, reqs):
        np.testing.assert_array_equal(te.completions[i].tokens, off.completions[j].tokens)
        np.testing.assert_array_equal(te.completions[i].tokens, _reference(tp, p, b))
    assert off.compile_stats()["spec_verify_graph_entries"] == 0
    assert not any(k[0] == "spec_verify" for k in off.compile_stats()["programs"])
    _no_leaks(te)


def test_oracle_and_junk_drafters_equal_jax():
    """Oracle drafts: every draft accepted, variable draft lengths, EOS
    inside an accepted prefix retires exactly there; junk drafts: every
    draft rolled back by truncating the table."""
    jp, tp = _setup()
    rng = np.random.default_rng(17)
    prompts = [_tokens(rng, n) for n in (4, 11, 19)]
    refs = [_reference(tp, p, 40) for p in prompts]
    je, te = _engines(jp, tp, drafter=lambda: _Oracle(refs, sizes=(7, 2, 5, 1)))
    _submit_run((je, te), [(p, 40) for p in prompts])
    _assert_same(je, te)
    sp = te.spec_stats()
    assert sp["accepted"] == sp["drafted"] > 0 and sp["acceptance_rate"] == 1.0
    for c, ref in zip(te._order, (refs[i] for i in [c.id for c in te._order])):
        np.testing.assert_array_equal(c.tokens, ref)
    je, te = _engines(jp, tp, drafter=_Junk, prefix_cache=False)
    _submit_run((je, te), [(_tokens(rng, n), 16) for n in (6, 14)])
    _assert_same(je, te)
    assert te.spec_stats()["rejected"] > te.spec_stats()["accepted"]
    _no_leaks(te)


def test_spec_under_pool_pressure_and_prefix_reuse_equal_jax():
    """A tight pool with oracle drafts allocating the full width must
    preempt; then a multi-turn prompt maps blocks speculative decode
    filled."""
    jp, tp = _setup()
    rng = np.random.default_rng(29)
    prompts = [_tokens(rng, n) for n in (BS, BS + 2, BS - 1)]
    refs = [_reference(tp, p, 30) for p in prompts]
    je, te = _engines(jp, tp, batch_size=3, n_blocks=9, drafter=lambda: _Oracle(refs))
    _submit_run((je, te), [(p, 30) for p in prompts])
    _assert_same(je, te)
    assert te.stats()["preemptions"] >= 1
    p1 = _tokens(rng, BS)
    ref1 = _reference(tp, p1, 18)
    je, te = _engines(jp, tp, drafter=lambda: _Oracle([ref1]))
    _submit_run((je, te), [(p1, 18)])
    _submit_run((je, te), [(np.concatenate([ref1, _tokens(rng, 3)]), 6)])
    _assert_same(je, te)
    assert te.completions[1].timings["cached_tokens"] > 0
    _no_leaks(te)


@pytest.mark.parametrize("sampling", [
    dict(temperature=0.8, top_k=5), dict(temperature=1.0, top_p=0.9),
], ids=["top_k", "top_p"])
def test_sampled_speculation_with_jax_draws_equals_jax(sampling):
    """Rejection sampling against the point-mass draft: the port takes
    JAX's ``uniform(fold_in(key, 0))`` and residual ``categorical(fold_in(
    key, 1))`` draws and accepts and corrects exactly as JAX does."""
    jp, tp = _setup()
    rng = np.random.default_rng(47)
    reqs = [(np.tile(_tokens(rng, 3), n), 12) for n in (2, 3, 5, 7)]
    watch = _Watch()
    je, te = _engines(jp, tp, sampling=dict(sampling, seed=3), spec_k=3,
                      drafter=lambda: G.PromptLookupDrafter(3, 1))
    _submit_run((je, te), reqs)
    _assert_same(je, te)
    watch.check()
    sp = te.spec_stats()
    assert sp["drafted"] == sp["accepted"] + sp["rejected"] and sp["verify_steps"] > 0


@pytest.mark.parametrize("dispatch", ["dense", "capacity"])
def test_moe_speculation_equals_jax(dispatch):
    """The verify pass routes the whole ``[B, W]`` batch at once."""
    jp, tp = _setup(moe_experts=4, seed=31)
    reqs = [(np.tile(np.array([3, 5, 7, 2], np.int32), n), 14) for n in (2, 5)]
    je, te = _engines(jp, tp, moe_top_k=2, moe_dispatch=dispatch,
                      drafter=lambda: G.PromptLookupDrafter(3, 1))
    _submit_run((je, te), reqs)
    _assert_same(je, te)
    assert te.spec_stats()["verify_steps"] > 0


def test_spec_stats_and_config_errors_equal_jax():
    jp, tp = _setup()
    je, te = _engines(jp, tp)
    assert te.spec_stats() == je.spec_stats()
    assert te.spec_stats()["k"] == 7 and te.spec_stats()["buckets"] == [2, 4, 8]
    for kw in (dict(spec_k=-2), dict(spec_buckets=()), dict(spec_buckets=(2, 2, 4)),
               dict(spec_k=0, drafter=_Junk())):
        args = {**dict(n_heads=HEADS, eos_id=EOS, block_size=BS, max_seq=T_MAX), **kw}
        errs = []
        for cls, p in ((JE.PagedDecodeEngine, jp), (TE.PagedDecodeEngine, tp)):
            with pytest.raises(ValueError) as exc:
                cls(p, **args)
            errs.append(str(exc.value))
        assert errs[1] == errs[0], kw
